"""Essential-graph (Sim3 pose-graph) optimization.

Rebuild of Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:2225-2473): vertices are all keyframes as Sim3 (scale
fixed to 1 for stereo), edges are loop edges, spanning-tree edges,
high-covisibility edges (>=100 shared points) and previous loop edges;
relative-Sim3 measurements from the poses at graph-build time; 20 LM
iterations.  Map points are corrected afterwards via their reference KF
(done by the caller).

Dense form: per-edge residual e = log_sim3(S_meas_ji * S_i * S_j^-1) with
autodiff Jacobians (vmapped jacfwd over the two 7-dim perturbations); the
H/b system is scatter-assembled dense (7K x 7K) and solved in one program.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from airdos_tpu.geometry.se3 import (sim3_compose, sim3_inverse, sim3_log,
                                     so3_exp)
from airdos_tpu.solvers.smallmat import cho_solve_dense


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """e = log_sim3( S_meas * S_i * S_j^-1 ), 7-dim."""
    Rinv, tinv, sinv = sim3_inverse(Rj, tj, sj)
    Rij, tij, sij = sim3_compose(Ri, ti, si, Rinv, tinv, sinv)
    Re, te, se = sim3_compose(Rm, tm, sm, Rij, tij, sij)
    return sim3_log(Re, te, se)


@partial(jax.jit, static_argnames=("n_iters", "fix_scale"))
def optimize_essential_graph(
        kf_R, kf_t, kf_s,          # [K, ...] current Sim3 vertex estimates
        kf_fixed,                  # [K] bool (the loop KF is fixed)
        e_i, e_j,                  # [E] vertex indices
        e_Rm, e_tm, e_sm,          # [E, ...] relative measurements S_ji... (i->j)
        e_valid,                   # [E]
        n_iters: int = 20, fix_scale: bool = True):
    K = kf_R.shape[0]
    dtype = kf_t.dtype
    D = 7 * K

    def perturb(R, t, s, xi):
        dR = so3_exp(xi[3:6])
        return (jnp.matmul(dR, R, precision="highest"),
                t + xi[:3], s * jnp.exp(xi[6]))

    def residual_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        Ri2, ti2, si2 = perturb(Ri, ti, si, xi_i)
        Rj2, tj2, sj2 = perturb(Rj, tj, sj, xi_j)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)

    zero7 = jnp.zeros(7, dtype)

    def edge_system(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        e = residual_fn(zero7, zero7, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
        Ji = jax.jacfwd(residual_fn, argnums=0)(
            zero7, zero7, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
        Jj = jax.jacfwd(residual_fn, argnums=1)(
            zero7, zero7, Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
        return e, Ji, Jj

    v_edge = jax.vmap(edge_system)

    def gn_step(R, t, s, lam):
        e, Ji, Jj = v_edge(R[e_i], t[e_i], s[e_i], R[e_j], t[e_j], s[e_j],
                           e_Rm, e_tm, e_sm)
        w = e_valid.astype(dtype)
        gi = e_i[:, None] * 7 + jnp.arange(7)[None, :]
        gj = e_j[:, None] * 7 + jnp.arange(7)[None, :]
        gidx = jnp.concatenate([gi, gj], axis=1)                 # [E, 14]
        Jl = jnp.concatenate([Ji, Jj], axis=2)                   # [E, 7, 14]
        JtWJ = jnp.einsum("erq,e,erp->eqp", Jl, w, Jl)
        Jtwe = -jnp.einsum("erq,e,er->eq", Jl, w, e)
        H = jnp.zeros((D, D), dtype).at[gidx[:, :, None], gidx[:, None, :]].add(JtWJ)
        b = jnp.zeros((D,), dtype).at[gidx].add(Jtwe)

        free = ~jnp.repeat(kf_fixed, 7)
        if fix_scale:
            scale_dims = (jnp.arange(D) % 7) == 6
            free = free & ~scale_dims
        freef = free.astype(dtype)
        H = H * freef[:, None] * freef[None, :] + jnp.diag(1.0 - freef)
        b = b * freef
        Hd = H + lam * jnp.diag(jnp.diag(H)) + 1e-6 * jnp.eye(D, dtype=dtype)
        dx = (cho_solve_dense(Hd, b) * freef).reshape(K, 7)
        Rn = jnp.matmul(so3_exp(dx[:, 3:6]), R, precision="highest")
        tn = t + dx[:, :3]
        sn = s * jnp.exp(dx[:, 6])
        return Rn, tn, sn

    def cost(R, t, s):
        e, _, _ = v_edge(R[e_i], t[e_i], s[e_i], R[e_j], t[e_j], s[e_j],
                         e_Rm, e_tm, e_sm)
        return jnp.sum(jnp.sum(e * e, axis=1) * e_valid.astype(dtype))

    def body(_, carry):
        R, t, s, lam, f_prev = carry
        Rn, tn, sn = gn_step(R, t, s, lam)
        f_new = cost(Rn, tn, sn)
        better = f_new < f_prev
        return (jnp.where(better, Rn, R), jnp.where(better, tn, t),
                jnp.where(better, sn, s),
                jnp.where(better, lam * 0.3, lam * 8.0),
                jnp.where(better, f_new, f_prev))

    R, t, s, _, _ = jax.lax.fori_loop(
        0, n_iters, body,
        (kf_R, kf_t, kf_s, jnp.asarray(1e-6, dtype), cost(kf_R, kf_t, kf_s)))
    return R, t, s
