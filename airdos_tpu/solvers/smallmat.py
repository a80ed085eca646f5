"""Small-matrix linear algebra for the BA inner loops.

``jnp.linalg.inv`` / ``jnp.linalg.solve`` lower to LU library calls.
Inside an LM loop (the reference runs 5+10 g2o iterations,
Optimizer.cc:1019-1021) any per-call latency multiplies by the iteration
count, so the BA drivers use these closed-form / Cholesky paths instead
(not yet compared with the GPU's solver libraries):

- ``inv3x3``: adjugate-over-determinant, pure elementwise (the point
  Hessian blocks of the Schur complement are damped SPD 3x3s).
- ``inv6x6``: 2x2-of-3x3 block inversion via the Schur complement —
  used by the global-BA block-Jacobi preconditioner.
- ``cho_solve_dense``: Cholesky + two triangular solves for the damped
  (SPD) reduced systems.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / det). M: [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack([jnp.stack([A, D, G], -1),
                     jnp.stack([B, E, H], -1),
                     jnp.stack([C, F, I], -1)], -2)
    return adj * inv_det[..., None, None]


def inv6x6(M: jnp.ndarray) -> jnp.ndarray:
    """Batched 6x6 inverse by 3x3-blockwise Schur complement.
    M: [..., 6, 6], must have an invertible leading 3x3 block (true for
    the damped SPD pose blocks this is used on)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    S = D - C @ Ai @ B                 # Schur complement of A
    Si = inv3x3(S)
    AiB = Ai @ B
    CAi = C @ Ai
    top_left = Ai + AiB @ Si @ CAi
    top_right = -AiB @ Si
    bot_left = -Si @ CAi
    return jnp.concatenate([
        jnp.concatenate([top_left, top_right], axis=-1),
        jnp.concatenate([bot_left, Si], axis=-1)], axis=-2)


def cho_solve_dense(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve H x = b for damped-SPD H via Cholesky (no pivoting).
    H: [D, D]; b: [D] or [D, K]."""
    L = jax.lax.linalg.cholesky(H)
    b2 = b[:, None] if b.ndim == 1 else b
    y = jax.lax.linalg.triangular_solve(L, b2, left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(L, y, left_side=True, lower=True,
                                        transpose_a=True)
    return x[:, 0] if b.ndim == 1 else x
