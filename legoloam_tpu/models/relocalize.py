"""Kidnapped-robot relocalization against a saved keyframe map.

The reference has no relocalization: a LeGO-LOAM run always starts at the
origin of a fresh map, and its only map-reuse machinery is the loop-closure
ICP (``src/mapOptmization.cpp:875-945``), which assumes the drifted pose is
already within ``historyKeyframeSearchRadius`` (7 m) of the truth.  This
module generalizes exactly that machinery to the multi-session /
checkpoint-resume case the rebuild supports (utils/checkpoint.py): given a
restored keyframe store and a first scan taken at an UNKNOWN pose (possibly
tens of meters and a half-turn away from any belief), find the pose by
scoring ICP alignments of the scan against candidate keyframe neighborhoods
and re-anchor the pipeline there.

Search structure (one jitted program):
  1. Candidates: keyframe positions deduped at ``candidate_leaf`` (one per
     occupied cell — the same position-dedup idiom as the surrounding-
     keyframe search, mapOptmization.cpp:1009-1010), ranked by distance to
     the prior belief, top ``n_candidates``.  With ``n_candidates`` at or
     above the number of occupied cells the search is GLOBAL — the prior
     only orders the sweep.
  2. Hypotheses: each candidate spawns ``yaw_hypotheses`` headings (the
     candidate keyframe's attitude rotated about world z), since a revisit
     may approach from any direction and point-to-point ICP only converges
     from a rough heading.
  3. Each hypothesis runs the loop-closure ICP (ops/icp.py — the PCL
     replacement with reference settings) of the scan cloud placed at the
     hypothesis pose against a ±``window``-keyframe submap around the
     candidate (the detectLoopClosure history-cloud construction,
     mapOptmization.cpp:838-861, without the same-pass time-gap exclusion —
     a restored map has no "current pass" to leak).
  4. Best fitness wins; accept if converged and below ``fitness_thresh``
     (getFitnessScore < 0.3, mapOptmization.cpp:904).

The scan-side cloud is the union of the odometry step's feature clouds
(scan-end frame), size-bounded by representative-point voxel dedup.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig, RelocalizeConfig
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import voxel_representative
from .mapping import KeyframeStore, dedup_positions


class RelocDiag(NamedTuple):
    accepted: jax.Array        # () bool
    candidate: jax.Array       # () int32 keyframe index of the winner
    fitness: jax.Array         # () best ICP fitness (mean sq NN dist)
    n_candidates: jax.Array    # () int32 candidates actually in range


def _window_cloud(kf: KeyframeStore, center: jax.Array,
                  cfg: RelocalizeConfig):
    """±window-keyframe submap around keyframe ``center`` in world frame,
    representative-deduped to ``hist_cap`` (loopclosure._history_cloud minus
    the current-pass exclusion)."""
    offs = jnp.arange(-cfg.window, cfg.window + 1)
    idxs = jnp.clip(center + offs, 0, jnp.maximum(kf.count - 1, 0))
    in_range = (center + offs >= 0) & (center + offs < kf.count)
    poses = Pose(kf.R[idxs], kf.t[idxs])
    cpts = se3.transform_points(poses, kf.corner[idxs])
    spts = se3.transform_points(poses, kf.surf[idxs])
    pts = jnp.concatenate([cpts, spts], axis=1).reshape(-1, 3)
    val = jnp.concatenate(
        [kf.corner_valid[idxs] & in_range[:, None],
         kf.surf_valid[idxs] & in_range[:, None]], axis=1).reshape(-1)
    return voxel_representative(pts, val, cfg.submap_leaf, cfg.hist_cap)


@functools.partial(jax.jit, static_argnames=("cfg",))
def relocalize(
    kf: KeyframeStore,
    scan_pts: jax.Array,       # (N, 3) scan cloud, sensor (scan-end) frame
    scan_valid: jax.Array,     # (N,)
    prior: Pose,               # belief — may be arbitrarily wrong
    cfg: RelocalizeConfig,
) -> Tuple[Pose, RelocDiag]:
    """Find the scan's world pose in the keyframe map.  Returns the corrected
    pose (the prior when rejected) and diagnostics."""
    m = kf.t.shape[0]
    kf_ok = jnp.arange(m) < kf.count

    # 1. Candidate cells: position dedup + distance-to-prior ranking.
    rep = dedup_positions(kf.t, kf_ok, prior.t, cfg.candidate_leaf)
    d2 = jnp.sum((kf.t - prior.t[None]) ** 2, axis=-1)
    d2 = jnp.where(rep, d2, jnp.inf)
    n_cand = min(cfg.n_candidates, m)
    cand_score, cand = jax.lax.top_k(-d2, n_cand)
    cand_ok = jnp.isfinite(-cand_score)

    # Scan cloud bounded to cur_cap.
    pts, val = voxel_representative(scan_pts, scan_valid, cfg.scan_leaf,
                                    cfg.cur_cap)

    yaws = jnp.arange(cfg.yaw_hypotheses) * (
        2.0 * jnp.pi / max(cfg.yaw_hypotheses, 1))

    def try_hypothesis(_, h):
        """Coarse stage: a few ICP iterations per hypothesis — enough to
        separate plausible places from hopeless ones by fitness."""
        ci, yi = h // cfg.yaw_hypotheses, h % cfg.yaw_hypotheses
        idx = cand[ci]
        ok = cand_ok[ci]
        hist_pts, hist_val = _window_cloud(kf, idx, cfg)
        Rz = se3.so3_exp(jnp.array([0.0, 0.0, 1.0]) * yaws[yi])
        T_h = Pose(se3.mat3_mul(Rz, kf.R[idx]), kf.t[idx])
        placed = se3.transform_points(T_h, pts)
        res = icp_ops.icp(placed, val & ok, hist_pts, hist_val & ok,
                          Pose.identity(),
                          max_corr_dist=cfg.icp_max_corr_dist,
                          max_iters=cfg.coarse_iters,
                          eps=cfg.icp_eps)
        # PCL hasConverged() + fitness gate (the reference's check,
        # mapOptmization.cpp:904): true on ANY termination incl. the
        # iteration cap — same semantics as models/loopclosure.py.
        fit = jnp.where(ok & res.has_converged, res.fitness, jnp.inf)
        T_fix = Pose(se3.mat3_mul(res.pose.R, T_h.R),
                     se3.rotate_vec(res.pose.R, T_h.t) + res.pose.t)
        return None, (fit, T_fix.R, T_fix.t, idx)

    n_hyp = n_cand * max(cfg.yaw_hypotheses, 1)
    _, (fits, Rs, ts, idxs) = jax.lax.scan(
        try_hypothesis, None, jnp.arange(n_hyp))

    # Refine stage: the top-K coarse hypotheses each run the full-length ICP
    # (the reference's 100-iteration setting) and the best REFINED fitness
    # wins.  Refining only the single coarse winner is not enough: on
    # self-similar worlds a WRONG place can out-score the true one at coarse
    # depth (measured on the ring world: false match coarse-refined to
    # fitness 0.23 < the 0.3 gate while the true place sat in coarse rank
    # 2-4 and refines to ~0.05).
    k_ref = min(cfg.refine_top_k, n_hyp)
    _, top = jax.lax.top_k(-fits, k_ref)

    best_fit, best_T, best_idx = (jnp.float32(jnp.inf), prior,
                                  jnp.int32(-1))
    for r in range(k_ref):
        h = top[r]
        ok_r = jnp.isfinite(fits[h])
        T_c = Pose(Rs[h], ts[h])
        hist_pts, hist_val = _window_cloud(kf, jnp.maximum(idxs[h], 0), cfg)
        placed = se3.transform_points(T_c, pts)
        res = icp_ops.icp(placed, val & ok_r, hist_pts, hist_val & ok_r,
                          Pose.identity(),
                          max_corr_dist=cfg.icp_max_corr_dist,
                          max_iters=cfg.icp_max_iters,
                          eps=cfg.icp_eps)
        fit_r = jnp.where(ok_r & res.has_converged, res.fitness, jnp.inf)
        T_r = Pose(se3.mat3_mul(res.pose.R, T_c.R),
                   se3.rotate_vec(res.pose.R, T_c.t) + res.pose.t)
        better = fit_r < best_fit
        best_T = jax.tree.map(lambda a, b: jnp.where(better, a, b), T_r,
                              best_T)
        best_fit = jnp.where(better, fit_r, best_fit)
        best_idx = jnp.where(better, idxs[h], best_idx)

    accepted = (best_fit < cfg.fitness_thresh) & (kf.count > 0)
    T_out = jax.tree.map(lambda a, b: jnp.where(accepted, a, b), best_T,
                         prior)
    # Orthonormality insurance: T chains yaw-hypothesis and ICP rotation
    # products (see se3.so3_project).
    T_out = Pose(se3.so3_project(T_out.R), T_out.t)
    diag = RelocDiag(accepted=accepted, candidate=best_idx, fitness=best_fit,
                     n_candidates=jnp.sum(cand_ok.astype(jnp.int32)))
    return T_out, diag


def relocalize_slam_state(state, cfg: PipelineConfig):
    """Host-level re-anchor: relocalize the CURRENT scan (the odometry
    state's ``last_*`` clouds — call after at least one ``slam_scan_step``)
    in the restored keyframe map, then rebase the mapping correction so the
    fused output continues on the map.

    Rebase semantics mirror a mapping correction (models/fusion.py): with
    P = the current odometry pose and T = the relocalized world pose,
    setting ``t_bef = P`` and ``t_aft = T`` makes every subsequent fused
    pose ``T ∘ P⁻¹ ∘ odom`` — the odometry frame itself is untouched, the
    correction absorbs the kidnap offset.  Returns (state, diag); the state
    is unchanged when relocalization is rejected."""
    od = state.odom
    pts = jnp.concatenate([od.last_corner.xyz, od.last_surf.xyz], axis=0)
    val = jnp.concatenate([od.last_corner.valid, od.last_surf.valid], axis=0)
    prior = state.mapping.t_aft
    T, diag = relocalize(state.mapping.kf, pts, val, prior, cfg.reloc)
    ok = diag.accepted
    mp = state.mapping
    t_bef = jax.tree.map(lambda a, b: jnp.where(ok, a, b), od.pose, mp.t_bef)
    t_aft = jax.tree.map(lambda a, b: jnp.where(ok, a, b), T, mp.t_aft)
    # The submap cache origin predates the jump — force a rebuild around the
    # relocalized pose on the next mapping step.
    cache = mp.cache._replace(stale=mp.cache.stale | ok)
    mapping = mp._replace(t_bef=t_bef, t_aft=t_aft, cache=cache,
                          initialized=mp.initialized | ok)
    return state._replace(mapping=mapping), diag
