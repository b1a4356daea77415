"""SE(3) pose-graph optimizer — the gtsam/iSAM2 replacement.

Reference usage: ``src/mapOptmization.cpp:36-47,229-232,347-350,939-942,
1375-1399,1456-1478`` — a prior factor on the first keyframe, a between-factor
chain along the trajectory, loop-closure between-factors with ICP-fitness
noise, incremental ``isam->update()`` after every keyframe, and ``correctPoses``
rewriting the keyframe store after a loop closes.

Design (SURVEY.md §7 hard-part 5): instead of reproducing iSAM2's
Bayes-tree incremental bookkeeping — pointer-chasing that dense array code
cannot express — we re-solve the full graph with Gauss-Newton in LINK SPACE.  The variables are
per-link corrections u_k (node perturbation v_k = Σ_{m<=k} u_m, a plain
cumsum): in these coordinates every chain factor touches exactly ONE variable,
so the chain Hessian is block-diagonal (D_k = B_kᵀ W B_k with B_k = Ad(x_k⁻¹),
whose inverse is the EXACT adjoint identity Ad(x_k) W⁻¹ Ad(x_k)ᵀ — no linear
solve, f32-stable at any lever arm), and each loop factor is a rank-6 term
over a contiguous link range (a prefix-sum gather).  CG preconditioned by
D⁻¹ then sees identity + rank-6L and converges in ~6·n_loops+1 iterations
REGARDLESS of the chain/loop stiffness ratio — the reference's gtsam noise
model (chain variance 1e-8 vs loop fitness ~1e-1, a 10^7 conditioning gap,
mapOptmization.cpp:347-350,932-934) made naive pose-space block-Jacobi PCG
stall with near-zero correction (round-5 finding; the load-bearing closure
experiment exposed it).  Everything is cumsums, batched 6x6 block ops, and
L-sized gathers — no sparse matrix, no elimination ordering; a full re-solve
stays sub-millisecond device work at <=20K poses and is strictly MORE
accurate than incremental relinearization.  The factor-block assembly is the
distribution point (parallel/posegraph_dist).

Parameterization: left-multiplicative world-frame tangent updates
x_k <- exp(v_k)·x_k with between-factor linearization
r(v) ≈ r₀ + Ad(x_j⁻¹)(v_j − v_i) (J_r⁻¹ ≈ I, exact as residuals -> 0, the
regime GN operates in).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PoseGraphConfig
from ..ops import se3
from ..ops.se3 import Pose


class LoopFactors(NamedTuple):
    """Fixed-cap loop-closure between-factors: measurement Z = T_i⁻¹ T_j."""

    i: jax.Array        # (L,) int32 from-node
    j: jax.Array        # (L,) int32 to-node
    R: jax.Array        # (L, 3, 3)
    t: jax.Array        # (L, 3)
    var: jax.Array      # (L,) isotropic VARIANCE (ICP fitness, mapOpt.cpp:932-934)
    valid: jax.Array    # (L,)
    count: jax.Array    # ()
    # Accepted closures discarded because the factor store was full, plus
    # factors invalidated by keyframe decimation (no-silent-caps discipline;
    # gtsam's graph is unbounded, mapOptmization.cpp:939 — here the cap is a
    # compile-time shape, so drivers watch this and raise max_loop_factors).
    dropped: jax.Array  # () int32


def init_loop_factors(cap: int) -> LoopFactors:
    return LoopFactors(
        i=jnp.zeros(cap, jnp.int32), j=jnp.zeros(cap, jnp.int32),
        R=jnp.broadcast_to(jnp.eye(3), (cap, 3, 3)).copy(),
        t=jnp.zeros((cap, 3)), var=jnp.ones(cap),
        valid=jnp.zeros(cap, bool), count=jnp.int32(0),
        dropped=jnp.int32(0))


def add_loop_factor(lf: LoopFactors, i, j, meas: Pose, variance) -> LoopFactors:
    k = lf.count
    ok = k < lf.i.shape[0]

    def w(arr, val):
        return jnp.where(ok, arr.at[k].set(val), arr)

    return LoopFactors(
        i=w(lf.i, jnp.int32(i)), j=w(lf.j, jnp.int32(j)),
        R=w(lf.R, meas.R), t=w(lf.t, meas.t), var=w(lf.var, variance),
        valid=w(lf.valid, True),
        count=k + jnp.where(ok, 1, 0).astype(jnp.int32),
        dropped=lf.dropped + jnp.where(ok, 0, 1).astype(jnp.int32))


def _adjoint(p: Pose) -> jax.Array:
    """SE(3) adjoint for [w; v] twist ordering: [[R, 0], [ [t]x R, R ]]."""
    R = p.R
    tx = se3.hat(p.t)
    top = jnp.concatenate([R, jnp.zeros_like(R)], axis=-1)
    bot = jnp.concatenate([se3.mat3_mul(tx, R), R], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _between_residual(xi_pose: Pose, xj_pose: Pose, Z: Pose):
    """r = log(Z⁻¹ x_i⁻¹ x_j), batched."""
    E = se3.compose(se3.inverse(Z), se3.relative(xi_pose, xj_pose))
    return se3.se3_log(E)


class _Factors(NamedTuple):
    """All between-factors (chain + loops) in one batched layout."""

    i: jax.Array
    j: jax.Array
    R: jax.Array
    t: jax.Array
    w: jax.Array      # (F, 6) diagonal information weights 1/variance
    valid: jax.Array


def _assemble_factors(
    chain_R, chain_t, n_nodes, lf: LoopFactors, cfg: PoseGraphConfig, max_nodes
) -> _Factors:
    """Chain factor k connects (k-1, k) with stored measurement; loops append."""
    m = chain_R.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    chain_valid = (idx >= 1) & (idx < n_nodes)
    ci = idx - 1
    cj = idx
    cw = jnp.broadcast_to(
        jnp.array([1.0 / cfg.odom_rot_var] * 3
                  + [1.0 / cfg.odom_trans_var] * 3), (m, 6))
    lw = (1.0 / jnp.maximum(lf.var, 1e-9))[:, None] * jnp.ones((1, 6))
    return _Factors(
        i=jnp.concatenate([jnp.maximum(ci, 0), lf.i]),
        j=jnp.concatenate([cj, lf.j]),
        R=jnp.concatenate([chain_R, lf.R], axis=0),
        t=jnp.concatenate([chain_t, lf.t], axis=0),
        w=jnp.concatenate([cw, lw], axis=0),
        valid=jnp.concatenate([chain_valid, lf.valid]),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def optimize(
    R: jax.Array, t: jax.Array, n_nodes: jax.Array,
    chain_R: jax.Array, chain_t: jax.Array,
    loops: LoopFactors,
    prior: Pose,
    cfg: PoseGraphConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Full GN re-solve in link space (module docstring).  R/t: (M, 3, 3)/
    (M, 3) node estimates (rows >= n_nodes inert); chain_R/chain_t: (M, ...)
    between measurement from node k-1 to k (row 0 unused); prior anchors
    node 0.

    Returns updated (R, t)."""
    M = R.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    node_ok = idx < n_nodes
    chain_ok = (idx >= 1) & (idx < n_nodes)
    inert = ~node_ok

    W_c = jnp.array([1.0 / cfg.odom_rot_var] * 3
                    + [1.0 / cfg.odom_trans_var] * 3)
    W_p = jnp.array([1.0 / cfg.prior_rot_var] * 3
                    + [1.0 / cfg.prior_trans_var] * 3)

    # Loop ranges: r ≈ r₀ + sgn·B_l·S_l(u), S_l = Σ_{lo<m<=hi} u_m.
    l_lo = jnp.minimum(loops.i, loops.j)
    l_hi = jnp.maximum(loops.i, loops.j)
    sgn = jnp.where(loops.j >= loops.i, 1.0, -1.0)
    wl6 = jnp.where(loops.valid,
                    1.0 / jnp.maximum(loops.var, 1e-9), 0.0)[:, None] \
        * jnp.ones((1, 6))                                       # (L, 6)

    def gn_body(_, Rt):
        R_cur, t_cur = Rt
        x_self = Pose(R_cur, t_cur)
        x_prev = Pose(R_cur[jnp.maximum(idx - 1, 0)],
                      t_cur[jnp.maximum(idx - 1, 0)])

        # Chain linearization: per-link residual + B_m = Ad(x_m⁻¹).
        r_c = _between_residual(x_prev, x_self, Pose(chain_R, chain_t))
        r_c = jnp.where(chain_ok[:, None], r_c, 0.0)
        B = _adjoint(se3.inverse(x_self))                        # (M, 6, 6)
        B_inv = _adjoint(x_self)                                 # exact B⁻¹

        # Prior on node 0 rides the same row (B[0] = Ad(x_0⁻¹) = B_p).
        r_p = se3.se3_log(se3.compose(se3.inverse(prior),
                                      Pose(R_cur[0], t_cur[0])))
        Wrow = jnp.where(chain_ok[:, None], W_c[None, :], 0.0)
        Wrow = Wrow.at[0].set(jnp.where(node_ok[0], W_p, jnp.zeros(6)))
        Winv_row = jnp.where(Wrow > 0, 1.0 / jnp.maximum(Wrow, 1e-30), 0.0)
        r_rows = r_c.at[0].set(jnp.where(node_ok[0], r_p, jnp.zeros(6)))

        # Block-diagonal chain Hessian D = Bᵀ W B and its EXACT inverse
        # D⁻¹ = B⁻¹ W⁻¹ B⁻ᵀ (adjoint identity — no linear solve).  Neither
        # is ever FORMED: with |t| ~ 10²-m lever arms, D's entries span
        # w_v·|t|² ~ 1e12 down to w_r ~ 1e6, and materializing that matrix
        # in f32 loses the small scales (measured: D·D⁻¹ off identity by
        # 4e4, CG curvature pᵀHp goes negative, solve NaNs).  Applying the
        # FACTORED form keeps every stage near unit relative error and the
        # quadratic form PSD by construction.
        def D_apply(v):
            # Bᵀ (W ⊙ (B v))
            return jnp.einsum("mab,ma->mb", B,
                              Wrow * jnp.einsum("mab,mb->ma", B, v))

        def D_inv_apply(v):
            # B⁻¹ (W⁻¹ ⊙ (B⁻ᵀ v))
            return jnp.einsum("mab,mb->ma", B_inv,
                              Winv_row * jnp.einsum("mab,ma->mb", B_inv, v))

        # Loop linearization.
        x_i = Pose(R_cur[loops.i], t_cur[loops.i])
        x_j = Pose(R_cur[loops.j], t_cur[loops.j])
        r_l = _between_residual(x_i, x_j, Pose(loops.R, loops.t))
        B_l = _adjoint(se3.inverse(x_j))                         # (L, 6, 6)

        def range_scatter(vals):
            """Σ_l 1[lo<m<=hi]·vals_l via boundary-diff + cumsum, (L,6)->(M,6)."""
            d = jnp.zeros((M + 1, 6))
            d = d.at[l_lo + 1].add(vals)
            d = d.at[l_hi + 1].add(-vals)
            return jnp.cumsum(d, axis=0)[:M]

        # Gradient g = Jᵀ W r in link space.
        g = jnp.einsum("mab,ma->mb", B, Wrow * r_rows)
        a_l = sgn[:, None] * jnp.einsum("lab,la->lb", B_l, wl6 * r_l)
        g = g + range_scatter(a_l)
        g = jnp.where(inert[:, None], 0.0, g)

        def hvp(v):
            out = D_apply(v)
            Qv = jnp.cumsum(jnp.where(node_ok[:, None], v, 0.0), axis=0)
            S = Qv[l_hi] - Qv[l_lo]                              # (L, 6)
            y = jnp.einsum("lab,la->lb", B_l,
                           wl6 * jnp.einsum("lab,lb->la", B_l, S))
            out = out + range_scatter(y)
            return jnp.where(inert[:, None], v, out)

        def precond(v):
            return jnp.where(inert[:, None], v, D_inv_apply(v))

        b = -g
        b2 = jnp.sum(b * b)

        # CG on D + rank-6L: with the exact D⁻¹ preconditioner the spectrum
        # is 1 + at-most-6L outliers, so the tolerance exit fires in
        # ~6·n_loops+1 iterations independent of the 10^7 stiffness ratio.
        def pcg_cond(st):
            i, x, rr, p, rz = st
            return (i < cfg.pcg_iters) & (jnp.sum(rr * rr)
                                          > cfg.pcg_tol * b2)

        def pcg_body(st):
            i, x, rr, p, rz = st
            Hp = hvp(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Hp), 1e-30)
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return i + 1, x, rr, p, rz_new

        x0 = jnp.zeros((M, 6))
        z0 = precond(b)
        st = (jnp.int32(0), x0, b, z0, jnp.sum(b * z0))
        _, du, _, _, _ = jax.lax.while_loop(pcg_cond, pcg_body, st)

        # Links -> nodes (v = cumsum u) and left-multiplicative update.
        du = jnp.where(node_ok[:, None], du, 0.0)
        v = jnp.cumsum(du, axis=0)
        v = jnp.where(node_ok[:, None], v, 0.0)
        upd = se3.se3_exp(v)
        R_new = se3.mat3_mul(upd.R, R_cur)   # exact f32 (se3.mat3_mul)
        t_new = se3.rotate_vec(upd.R, t_cur) + upd.t
        return R_new, t_new

    R_out, t_out = jax.lax.fori_loop(0, cfg.gn_iters, gn_body, (R, t))
    return R_out, t_out
