"""Closed-form point-set alignment (Horn 1987) — batched.

Core of the reference's Sim3Solver (src/Sim3Solver.cc:226-365, quaternion
from the 4x4 N-matrix eigenvector, symmetric-ratio scale) and of EPnP's
final R, t recovery.  All ops batch over leading axes so RANSAC hypotheses
vmap into one batched program.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import quat_to_rot


def horn_align(P1: jnp.ndarray, P2: jnp.ndarray,
               weights: jnp.ndarray | None = None,
               fix_scale: bool = True):
    """Find (R, t, s) minimizing || P1 - (s R P2 + t) ||^2.

    P1, P2: [..., N, 3]; weights: [..., N] optional.
    Returns R [..., 3, 3], t [..., 3], s [...].
    """
    if weights is None:
        w = jnp.ones(P1.shape[:-1], P1.dtype)
    else:
        w = weights
    wsum = jnp.sum(w, axis=-1, keepdims=True)
    wn = w / jnp.maximum(wsum, 1e-12)
    c1 = jnp.sum(P1 * wn[..., None], axis=-2)
    c2 = jnp.sum(P2 * wn[..., None], axis=-2)
    Q1 = P1 - c1[..., None, :]
    Q2 = P2 - c2[..., None, :]

    # M = sum w q2 q1^T — this orientation of the correlation matrix yields
    # R mapping frame 2 into frame 1 (Horn's convention)
    M = jnp.einsum("...ni,...n,...nj->...ij", Q2, wn, Q1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], axis=-2)
    evals, evecs = jnp.linalg.eigh(N)
    q_wxyz = evecs[..., :, -1]                 # largest eigenvalue
    q = jnp.stack([q_wxyz[..., 1], q_wxyz[..., 2], q_wxyz[..., 3],
                   q_wxyz[..., 0]], axis=-1)   # to (x, y, z, w)
    R = quat_to_rot(q)

    if fix_scale:
        s = jnp.ones(P1.shape[:-2], P1.dtype)
    else:
        # symmetric-ratio scale (Horn): s = sum w q1 . (R q2) / sum w |q2|^2
        RQ2 = jnp.einsum("...ij,...nj->...ni", R, Q2)
        num = jnp.sum(wn * jnp.sum(Q1 * RQ2, axis=-1), axis=-1)
        den = jnp.sum(wn * jnp.sum(Q2 * Q2, axis=-1), axis=-1)
        s = num / jnp.maximum(den, 1e-12)
    t = c1 - s[..., None] * jnp.einsum("...ij,...j->...i", R, c2)
    return R, t, s
