"""Point-to-point ICP — the PCL ``IterativeClosestPoint`` replacement.

Reference usage: loop-closure alignment (``src/mapOptmization.cpp:875-945``)
with maxCorrespondenceDistance=100, 100 iterations, eps 1e-6, no RANSAC, and
acceptance by ``getFitnessScore() < 0.3`` (mean squared NN distance).

Design: correspondences are one brute-force 1-NN search per iteration
(``knn_pallas.search``); the rigid update is the closed-form Umeyama/Kabsch solve (SVD of
the 3x3 cross-covariance) over masked correspondences — no per-point loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import se3
from .se3 import Pose
from .knn_pallas import search as knn_search


class IcpResult(NamedTuple):
    pose: Pose          # transform mapping src into dst's frame
    fitness: jax.Array  # mean squared NN distance (PCL getFitnessScore)
    # PCL-compatible ``hasConverged()``: true on ANY termination — the eps
    # criterion OR the iteration cap — as long as correspondences exist.
    # PCL's flag is set by align() reaching its termination condition
    # (max-iterations counts), so the reference's acceptance at
    # mapOptmization.cpp:904 is effectively fitness-only; gate on THIS field
    # plus the fitness threshold to reproduce it.
    has_converged: jax.Array
    # Strict flag: the eps criterion fired BEFORE the iteration cap.  A
    # still-improving alignment that used every iteration has
    # ``converged``=False but ``has_converged``=True — the reference accepts
    # it; don't gate acceptance on this field.
    converged: jax.Array
    n_corr: jax.Array


@functools.partial(jax.jit, static_argnames=("max_iters",))
def icp(
    src: jax.Array, src_valid: jax.Array,
    dst: jax.Array, dst_valid: jax.Array,
    init: Pose,
    max_corr_dist: float = 100.0,
    max_iters: int = 100,
    eps: float = 1e-6,
) -> IcpResult:
    """Align src onto dst starting from ``init``."""
    max_corr_sq = max_corr_dist * max_corr_dist

    def corr_stats(T: Pose):
        moved = se3.transform_points(T, src)
        # No culling gate: the reference's maxCorrespondenceDistance=100
        # reaches across the whole history cloud.
        d, i = knn_search(moved, src_valid, dst, dst_valid, k=1, q_tile=512)
        match = src_valid & (d[:, 0] < max_corr_sq)
        return moved, dst[i[:, 0]], match, d[:, 0]

    def body(st):
        it, T, prev_err, done = st
        moved, target, match, d = corr_stats(T)
        w = match.astype(jnp.float32)
        wsum = jnp.maximum(jnp.sum(w), 1.0)
        mu_s = jnp.sum(moved * w[:, None], axis=0) / wsum
        mu_t = jnp.sum(target * w[:, None], axis=0) / wsum
        # Kabsch: SVD of cross-covariance.
        X = (moved - mu_s) * w[:, None]
        Y = target - mu_t
        H = X.T @ Y
        U, _, Vt = jnp.linalg.svd(H)
        S = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(
            jnp.sign(jnp.linalg.det(Vt.T @ U.T)))
        R_delta = Vt.T @ S @ U.T
        t_delta = mu_t - R_delta @ mu_s
        T_new = Pose(se3.mat3_mul(R_delta, T.R),
                     se3.rotate_vec(R_delta, T.t) + t_delta)
        err = jnp.sum(d * w) / wsum
        done = jnp.abs(prev_err - err) < eps
        return it + 1, T_new, err, done

    def cond(st):
        it, T, prev_err, done = st
        return (it < max_iters) & ~done

    init_err = jnp.float32(jnp.inf)
    it, T, err, done = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init, init_err, jnp.array(False)))

    moved, target, match, d = corr_stats(T)
    n_corr = jnp.sum(match)
    fitness = jnp.sum(jnp.where(match, d, 0.0)) / jnp.maximum(n_corr, 1)
    return IcpResult(pose=T, fitness=fitness,
                     has_converged=n_corr > 10,
                     converged=done & (n_corr > 10), n_corr=n_corr)
