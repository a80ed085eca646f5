"""Platform guards: the compile-cache location, the GPU-only entry points,
the peak table, and the card-only parity test."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(args, env_extra=None, drop=(), timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the package uses
    <checkout>/.jax_cache."""
    extra = {}
    want = str(REPO / ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        extra["JAX_COMPILATION_CACHE_DIR"] = want
    res = _run(["-c", "import jax, airdos_tpu; "
                "print(jax.config.jax_compilation_cache_dir); "
                "print(jax.config.jax_default_matmul_precision)"],
               env_extra=extra, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr[-2000:]
    got, precision = res.stdout.split()[-2:]
    assert got == want
    assert precision == "highest"


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    res = _run([script], timeout=600)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert '"metric"' not in res.stdout


def test_peak_table_keyed_by_device_kind():
    import bench
    peaks = bench._peaks("NVIDIA H100 80GB HBM3")
    assert peaks["bf16_flops"] == 989e12
    assert peaks["f32_flops"] == 67e12
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    for kind in ("cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(KeyError):
            bench._peaks(kind)


@pytest.mark.gpu
def test_frontend_ops_on_gpu_match_reference(gpu_device):
    """On the card: Hamming exact and descriptors bit-exact against the
    numpy references (chip_smoke.py phase 1 runs this at full width)."""
    import jax
    import jax.numpy as jnp
    from airdos_tpu.ops import reference
    from airdos_tpu.ops.brief import compute_descriptors
    from airdos_tpu.ops.hamming import hamming_matrix

    rng = np.random.default_rng(0)
    a = rng.integers(0, 1 << 32, (300, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (200, 8), dtype=np.uint64).astype(np.uint32)
    d = jax.jit(hamming_matrix)(jax.device_put(a, gpu_device),
                                jax.device_put(b, gpu_device))
    np.testing.assert_array_equal(np.asarray(d),
                                  reference.hamming_matrix(a, b))
    img = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    xs = rng.integers(16, 144, 64).astype(np.int32)
    ys = rng.integers(16, 104, 64).astype(np.int32)
    ang = rng.uniform(0, 360, 64).astype(np.float32)
    desc = jax.jit(compute_descriptors)(
        *(jax.device_put(jnp.asarray(v), gpu_device)
          for v in (img, xs, ys, ang)))
    want, tie = reference.brief_descriptors(img, xs, ys, ang)
    np.testing.assert_array_equal(np.asarray(desc)[~tie], want[~tie])
