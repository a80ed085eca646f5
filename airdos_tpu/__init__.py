"""airdos_tpu — stereo dynamic SLAM in JAX.

A ground-up rebuild of the capabilities of AirDOS (haleqiu/AirDOS, ICRA 2022:
stereo dynamic visual SLAM with articulated human trajectory optimization):

- Host Python owns the sequential state machine (tracking states, map
  bookkeeping, covisibility graphs) — tiny, pointer-rich, latency-bound.
- The accelerator owns every dense per-frame computation (image pyramid,
  FAST, rBRIEF descriptors, Hamming matching, stereo disparity) and every
  iterative-numeric inner loop (pose-only LM, local bundle adjustment with
  Schur complement, dynamic human-trajectory BA, vmapped RANSAC solvers)
  as jit-compiled XLA programs with static shapes.

Public API mirrors the reference surface (src/System.h:75-149):
``System``, ``track_stereo``, ``track_stereo_human``, ``shutdown``,
``save_trajectory_tum`` with identical 8-column output.
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

import jax as _jax

# Persistent XLA compilation cache.  JAX itself reads
# JAX_COMPILATION_CACHE_DIR; only when it is unset does the package pick a
# fixed directory inside the checkout (a path that never moves keeps the
# cache's entries reachable from one process to the next).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        str(_Path(__file__).resolve().parent.parent / ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# Full float32 matmul precision for every contraction.  SLAM estimation is
# cancellation-heavy: bundle adjustment's Schur complements subtract
# near-equal ~1e7-magnitude normal-equation blocks down to ~1e4.  On the
# GPU the default precision runs float32 matmuls in TF32 (about three
# decimal digits), which makes those solves diverge.
_jax.config.update("jax_default_matmul_precision", "highest")

from airdos_tpu.config import SlamConfig  # noqa: F401
