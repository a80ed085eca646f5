"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated on the CPU through
--xla_force_host_platform_device_count.  Tests marked ``gpu`` need the
card; they decide inside the ``gpu_device`` fixture whether one is
present and skip here (``python chip_smoke.py`` runs what they cover on
the GPU)."""
import importlib
import os
import subprocess
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def native_ext():
    """The C++ host runtime, built from source by the one documented
    command.  The script links to a temporary name and renames it into
    place, so parallel test workers building at once never collide."""
    subprocess.run(["sh", str(REPO / "tools" / "build_native.sh")],
                   check=True, capture_output=True,
                   env={**os.environ, "PYTHON": sys.executable})
    importlib.invalidate_caches()
    return importlib.import_module("airdos_tpu.native.airdos_native")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips where JAX sees none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return devs[0]
