"""Tracking-priority device scheduling for single-device online mode.

Premise (NOT YET CHECKED ON THE GPU): the device runs one program at a
time from one compute stream, so a fused tracking step enqueued behind a
longer mapping program waits that program out.  The reference never faces
this — its threads each own a CPU core (System.cc:87-96 spawns
LocalMapping on its own std::thread) — but on one device the two
pipelines share the compute stream, and the tracking thread's latency
budget (Camera.fps) is the hard one.

TrackingGate restores the priority: the tracking thread holds the gate
across its per-frame device window (host pack -> fused-step dispatch ->
result read), and the mapping/loop/GBA workers poll ``wait()`` right
before each of their own dispatches, deferring while tracking is in the
window.  Since every mapping-side program is enqueued only when
tracking is between frames, the fused step lands on an idle stream and
runs at its standalone latency.

The wait is bounded (default 0.25 s) so a stalled tracking thread can
never deadlock mapping, and the gate is a no-op unless installed by the
System in online mode (offline is single-threaded and synchronous).
"""
from __future__ import annotations

import threading


class TrackingGate:
    def __init__(self, timeout: float = 0.25):
        self._clear = threading.Event()
        self._clear.set()
        self._timeout = timeout

    # ---- tracking side: context manager around the device window -----
    def __enter__(self):
        self._clear.clear()
        return self

    def __exit__(self, *exc):
        self._clear.set()
        return False

    # ---- worker side: call right before enqueuing a device program ---
    def wait(self):
        self._clear.wait(self._timeout)


def gate_wait(gate) -> None:
    """Defer a worker-thread dispatch while tracking is in its device
    window; no-op when no gate is installed (offline / single-thread)."""
    if gate is not None:
        gate.wait()
