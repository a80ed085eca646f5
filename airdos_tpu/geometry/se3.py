"""Lie-group operations: SO(3), SE(3), Sim(3).

Pure-functional JAX, batch-friendly (every op broadcasts over leading axes).
Poses are stored as (R, t): rotation matrix [..., 3, 3] and translation
[..., 3]; Sim3 adds a scalar scale [...].  Tangent vectors follow the
g2o::SE3Quat convention used throughout the reference's solvers
(Thirdparty/g2o types/se3quat.h): [upsilon (trans), omega (rot)].

Small-angle branches use jnp.where-based Taylor guards so everything is
differentiable and jit/vmap-safe.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def EINSUM_MV(A, x):
    return jnp.einsum("...ij,...j->...i", A, x, precision="highest")


def so3_hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix [..., 3, 3] from [..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # sin(t)/t and (1-cos t)/t^2 with Taylor guards
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    W = so3_hat(w)
    W2 = jnp.matmul(W, W, precision="highest")
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    # vee of the antisymmetric part
    v = jnp.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], axis=-1)
    # atan2 form: arccos has an infinite derivative at theta = 0, which
    # poisons autodiff (pose-graph Jacobians); atan2(|sin|, cos) is smooth
    sin_t_n = 0.5 * jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1), 1e-12))
    theta = jnp.arctan2(sin_t_n, cos_t)
    sin_t = jnp.sin(theta)
    small = jnp.abs(sin_t) < 1e-6
    near_pi = cos_t < -0.999

    scale_generic = jnp.where(small, 0.5 + theta * theta / 12.0,
                              theta / (2.0 * jnp.where(small, 1.0, sin_t)))
    w_generic = scale_generic[..., None] * v

    # Near theta = pi: extract axis from the symmetric part.
    S = 0.5 * (R + jnp.swapaxes(R, -1, -2))
    diag = jnp.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_t[..., None]) / jnp.clip(1.0 - cos_t[..., None], 1e-12, None), 0.0, None)
    # lower-bounded sqrt keeps jacfwd/jacrev finite through the untaken
    # branch of the jnp.where below (sqrt'(0) = inf would leak as NaN)
    axis = jnp.sqrt(jnp.maximum(axis_sq, 1e-12))
    # fix signs using the off-diagonal terms of the vee vector (sign of v)
    sign = jnp.where(v >= 0, 1.0, -1.0)
    # when v ~ 0 (theta exactly pi) pick signs from largest components consistently
    k = jnp.argmax(axis, axis=-1)
    ref_sign = jnp.take_along_axis(sign, k[..., None], axis=-1)
    axis = axis * sign * ref_sign
    nrm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    axis = axis / jnp.clip(nrm, 1e-12, None)
    w_pi = axis * theta[..., None]

    return jnp.where(near_pi[..., None], w_pi, w_generic)


def quat_to_rot(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion [..., 4] (x, y, z, w — TUM order) -> rotation matrix."""
    q = q / jnp.clip(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12, None)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return jnp.stack([
        jnp.stack([r00, r01, r02], axis=-1),
        jnp.stack([r10, r11, r12], axis=-1),
        jnp.stack([r20, r21, r22], axis=-1),
    ], axis=-2)


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion [..., 4] (x, y, z, w), w >= 0.

    Branch-free Shepperd's method: compute all four candidate quaternions and
    select by the largest denominator (jit/vmap safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.clip(x, 1e-12, None))

    # candidate 0: w largest
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], axis=-1)
    # candidate 1: x largest
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], axis=-1)
    # candidate 2: y largest
    s2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], axis=-1)
    # candidate 3: z largest
    s3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], axis=-1)

    cands = jnp.stack([q0, q1, q2, q3], axis=-2)           # [..., 4, 4]
    scores = jnp.stack([tr, m00, m11, m22], axis=-1)       # [..., 4]
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cands, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.clip(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12, None)
    # canonical sign: w >= 0
    return q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)


# ---------------------------------------------------------------- SE(3)

def se3_identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype)


def _so3_left_jacobian(w: jnp.ndarray) -> jnp.ndarray:
    """Left Jacobian J of SO(3) such that exp([w] + J v) composes SE(3)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    W2 = jnp.matmul(W, W, precision="highest")
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0,
                  (theta - jnp.sin(theta)) / (theta2 * theta + _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    W2 = jnp.matmul(W, W, precision="highest")
    half_theta = 0.5 * theta
    cot = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - half_theta * jnp.cos(half_theta) / jnp.where(small, 1.0, jnp.sin(half_theta)))
                    / (theta2 + _EPS * _EPS))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi: jnp.ndarray):
    """Tangent [..., 6] ([upsilon, omega]) -> (R [...,3,3], t [...,3])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    J = _so3_left_jacobian(w)
    t = EINSUM_MV(J, v)
    return R, t


def se3_log(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) -> tangent [..., 6] ([upsilon, omega])."""
    w = so3_log(R)
    Jinv = _so3_left_jacobian_inv(w)
    v = EINSUM_MV(Jinv, t)
    return jnp.concatenate([v, w], axis=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) ∘ (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    R = jnp.matmul(Ra, Rb, precision="highest")
    t = EINSUM_MV(Ra, tb) + ta
    return R, t


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -EINSUM_MV(Rt, t)


def se3_apply(R, t, x):
    """Apply pose to points: R x + t.  x: [..., 3] broadcastable."""
    return EINSUM_MV(R, x) + t


# ---------------------------------------------------------------- Sim(3)

def sim3_identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype), jnp.ones((), dtype=dtype)


def sim3_apply(R, t, s, x):
    return s[..., None] * EINSUM_MV(R, x) + t


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """x -> sa Ra (sb Rb x + tb) + ta."""
    R = jnp.matmul(Ra, Rb, precision="highest")
    s = sa * sb
    t = sa[..., None] * EINSUM_MV(Ra, tb) + ta
    return R, t, s


def sim3_inverse(R, t, s):
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * EINSUM_MV(Rt, t), s_inv


def sim3_exp(xi: jnp.ndarray):
    """Tangent [..., 7] ([upsilon, omega, sigma]) -> (R, t, s).

    Uses the closed-form Sim(3) W matrix (Strasdat's thesis convention, as in
    the reference's g2o sim3.h)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(w)
    s = jnp.exp(sigma)
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    W = so3_hat(w)
    W2 = jnp.matmul(W, W, precision="highest")
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)

    small_s = jnp.abs(sigma) < 1e-6
    small_t = theta2 < 1e-8
    sigma_safe = jnp.where(small_s, 1.0, sigma)
    a = jnp.where(small_s & small_t, 1.0, sigma * sigma + theta2)
    s_cos = s * jnp.cos(theta)
    s_sin = s * jnp.sin(theta)
    # V = A I + B W + C W2; the three regimes of the closed form:
    c1 = (s - 1.0) / sigma_safe                              # generic A (sigma != 0)
    A_gen = c1
    B_gen = (sigma * s_sin + theta * (1.0 - s_cos)) / (theta * a)
    C_gen = (c1 - ((s_cos - 1.0) * sigma + s_sin * theta) / a) / jnp.where(small_t, 1.0, theta2)
    # sigma ~ 0: V is the SE(3) left Jacobian
    B_se3 = jnp.where(small_t, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    C_se3 = jnp.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                      (theta - jnp.sin(theta)) / (theta2 * theta + _EPS))
    # sigma != 0, theta ~ 0
    B_sig = ((sigma - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    A = jnp.where(small_s, 1.0, A_gen)
    B = jnp.where(small_s, B_se3, jnp.where(small_t, B_sig, B_gen))
    C = jnp.where(small_s, C_se3, jnp.where(small_t, 0.0, C_gen))
    V = A[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2
    t = EINSUM_MV(V, v)
    return R, t, s


def sim3_log(R, t, s):
    """(R, t, s) -> tangent [..., 7].  Inverse of sim3_exp via linear solve."""
    w = so3_log(R)
    sigma = jnp.log(s)
    # Rebuild V from (w, sigma) by probing with basis vectors, solve V v = t.
    eye = jnp.eye(3, dtype=w.dtype)

    def col(e):
        xi = jnp.concatenate([jnp.broadcast_to(e, w.shape), w, sigma[..., None]], axis=-1)
        _, tc, _ = sim3_exp(xi)
        return tc

    V = jnp.stack([col(eye[0]), col(eye[1]), col(eye[2])], axis=-1)
    v = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([v, w, sigma[..., None]], axis=-1)


# ------------------------------------------------------- numpy (host-side)
def se3_log_np(R, t):
    """Host-side SE3 log for single poses (no jit dispatch — used by the
    per-frame velocity bookkeeping in tracking)."""
    import numpy as np
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-8:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) * 0.5
        return np.concatenate([t, w])
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(th))
    w = th * axis
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    Jinv = (np.eye(3) - 0.5 * W +
            (1.0 / th ** 2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
            * (W @ W))
    return np.concatenate([Jinv @ t, w])


def se3_exp_np(xi):
    """Host-side SE3 exp for single tangents (inverse of se3_log_np)."""
    import numpy as np
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + W
        J = np.eye(3) + 0.5 * W
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * W2
        J = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * W +
             (th - np.sin(th)) / th ** 3 * W2)
    return R, J @ v


def project_so3_np(R):
    """Nearest rotation matrix (Frobenius) via 3x3 SVD — host-side.

    Every tracked frame's pose passes through ~80 f32 se3_exp/compose
    operations (4 LM rounds x 10 iterations x 2 tracking stages); the
    accumulated non-orthonormality COMPOUNDS through the velocity
    composition Rv = Rcw_f @ Rcw_{f-1}.T (transpose-as-inverse doubles
    the defect instead of cancelling it).  Measured on a 150-frame run:
    det(R) drifted 0.99999 -> 0.990 with |R R^T - I| growing ~x1.5 per
    frame, while the TRUE rotation stayed within 0.2 deg — a uniform
    scale in R cancels in projection (u = fx sx/sz), so tracking looks
    healthy right up until R^T-as-inverse errors (~|defect|) poison
    triangulation, Ow, and matching windows, and the system collapses.
    Projecting to SO(3) once per host-boundary set_pose caps the defect
    at one frame's worth (~1e-5) forever."""
    import numpy as np
    R64 = np.asarray(R, np.float64)
    U, _, Vt = np.linalg.svd(R64)
    Ro = U @ Vt
    if np.linalg.det(Ro) < 0:
        Ro = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    return Ro
