"""ICP loop closure — the reference's loopClosureThread rebuilt.

Reference behavior: ``src/mapOptmization.cpp:802-945`` (``loopClosureThread``,
``detectLoopClosure``, ``performLoopClosure``) and ``correctPoses``
(mapOptmization.cpp:1456-1478).

The reference runs this on a 1 Hz POSIX thread sharing state under a mutex;
here it is a pure function the host calls at the same cadence — the
deterministic single-driver design removes the reference's (tolerated) races
(SURVEY.md §5 "race detection").

Pipeline per invocation (all one jitted program):
  1. detect: nearest keyframe within ``search_radius`` (7 m) whose time gap
     exceeds 30 s (mapOptmization.cpp:828-834).
  2. build clouds: the latest keyframe's corner+surf in world; a ±25-keyframe
     history submap around the candidate, voxel-downsampled at 0.4 m
     (mapOptmization.cpp:838-861).
  3. ICP (ops/icp.py) with the reference's settings; accept if converged and
     fitness < 0.3 (mapOptmization.cpp:892-904).
  4. add a between-factor with the ICP fitness as isotropic variance, re-solve
     the full pose graph, and rewrite every keyframe pose (correctPoses).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import LoopClosureConfig, PoseGraphConfig
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.se3 import Pose
from ..ops.voxel import voxel_representative
from . import posegraph
from .mapping import KeyframeStore
from .posegraph import LoopFactors


class LoopDiag(NamedTuple):
    candidate: jax.Array   # () int32, -1 if none
    fitness: jax.Array
    closed: jax.Array      # () bool


def detect(kf: KeyframeStore, cfg: LoopClosureConfig) -> jax.Array:
    """Index of the closure candidate for the LATEST keyframe, or -1."""
    m = kf.t.shape[0]
    cur = kf.count - 1
    cur_t = kf.t[cur]
    cur_time = kf.time[cur]
    ok = (jnp.arange(m) < kf.count) \
        & (cur_time - kf.time > cfg.min_time_gap)
    d2 = jnp.sum((kf.t - cur_t[None]) ** 2, axis=-1)
    d2 = jnp.where(ok, d2, jnp.inf)
    best = jnp.argmin(d2)
    found = d2[best] < cfg.search_radius ** 2
    return jnp.where(found, best, -1).astype(jnp.int32)


def _world_cloud(kf: KeyframeStore, idx, corner=True, surf=True):
    """One keyframe's stored scan in world coordinates."""
    pose = Pose(kf.R[idx], kf.t[idx])
    parts, vals = [], []
    if corner:
        parts.append(se3.transform_points(pose, kf.corner[idx]))
        vals.append(kf.corner_valid[idx])
    if surf:
        parts.append(se3.transform_points(pose, kf.surf[idx]))
        vals.append(kf.surf_valid[idx])
    return jnp.concatenate(parts, axis=0), jnp.concatenate(vals, axis=0)


def _history_cloud(kf: KeyframeStore, center, cfg: LoopClosureConfig):
    """±history_num-keyframe submap around ``center``, 0.4 m downsampled
    (historyKeyframeSearchNum=25, utility.h:133).

    Unlike the reference (which takes the raw index window,
    mapOptmization.cpp:852-858, and relies on keyframe density to keep the
    current pass out of it), keyframes within ``min_time_gap`` of the latest
    one are explicitly excluded — otherwise the drifted current pass leaks
    into the history submap and ICP happily aligns the cloud onto itself."""
    offs = jnp.arange(-cfg.history_num, cfg.history_num + 1)
    idxs = jnp.clip(center + offs, 0, jnp.maximum(kf.count - 1, 0))
    cur_time = kf.time[jnp.maximum(kf.count - 1, 0)]
    in_range = (center + offs >= 0) & (center + offs < kf.count) \
        & (cur_time - kf.time[idxs] > cfg.min_time_gap)
    poses = Pose(kf.R[idxs], kf.t[idxs])
    cpts = se3.transform_points(poses, kf.corner[idxs])
    spts = se3.transform_points(poses, kf.surf[idxs])
    pts = jnp.concatenate([cpts, spts], axis=1).reshape(-1, 3)
    val = jnp.concatenate(
        [kf.corner_valid[idxs] & in_range[:, None],
         kf.surf_valid[idxs] & in_range[:, None]], axis=1).reshape(-1)
    # Representative-point dedup instead of exact centroids: the history
    # cloud is only an ICP TARGET, where duplicates don't change NN
    # distances and a hash-dropped voxel can only raise (never lower) the
    # fitness, i.e. acceptance stays conservative.  ~2.5x cheaper on the
    # 0.5M-point gather.
    return voxel_representative(pts, val, cfg.submap_leaf, cfg.hist_cap)


@functools.partial(jax.jit, static_argnames=("cfg", "pg_cfg"))
def close_and_correct(
    kf: KeyframeStore,
    loops: LoopFactors,
    cfg: LoopClosureConfig,
    pg_cfg: PoseGraphConfig,
) -> Tuple[KeyframeStore, LoopFactors, Pose, LoopDiag]:
    """One loop-closure attempt + (on success) full pose-graph re-solve and
    keyframe correction.  Returns the (possibly corrected) store, factors, the
    corrected latest pose (the reference overwrites transformAftMapped with it,
    mapOptmization.cpp:1429-1441), and diagnostics."""
    cur = jnp.maximum(kf.count - 1, 0)
    cand = detect(kf, cfg)
    has_cand = (cand >= 0) & (kf.count >= 2)

    cur_pts, cur_val = _world_cloud(kf, cur)
    cur_val = cur_val & has_cand
    hist_pts, hist_val = _history_cloud(kf, jnp.maximum(cand, 0), cfg)
    hist_val = hist_val & has_cand

    res = icp_ops.icp(
        cur_pts, cur_val, hist_pts, hist_val, Pose.identity(),
        max_corr_dist=cfg.icp_max_corr_dist, max_iters=cfg.icp_max_iters,
        eps=cfg.icp_eps)

    # PCL-compatible acceptance (mapOptmization.cpp:904): hasConverged() is
    # true on ANY termination including the iteration cap, so acceptance is
    # effectively fitness-gated — a still-improving alignment that used all
    # 100 iterations must be accepted, not rejected for missing the eps exit
    # (tests/test_loopclosure.py::test_cap_terminated_icp_accepted).
    accept = has_cand & res.has_converged & (res.fitness < cfg.fitness_thresh)

    # Corrected current pose; factor Z = T_cor⁻¹ ∘ T_old
    # (performLoopClosure poseFrom.between(poseTo), mapOptmization.cpp:919-939).
    T_cur = Pose(kf.R[cur], kf.t[cur])
    T_cor = se3.compose(res.pose, T_cur)
    T_old = Pose(kf.R[jnp.maximum(cand, 0)], kf.t[jnp.maximum(cand, 0)])
    Z = se3.relative(T_cor, T_old)

    new_loops = posegraph.add_loop_factor(
        loops, cur, jnp.maximum(cand, 0), Z, res.fitness)
    loops = jax.tree.map(lambda a, b: jnp.where(accept, a, b), new_loops, loops)

    def do_optimize(args):
        kf_in, loops_in = args
        prior = Pose(kf_in.R[0], kf_in.t[0])
        R_out, t_out = posegraph.optimize(
            kf_in.R, kf_in.t, kf_in.count, kf_in.chain_R, kf_in.chain_t,
            loops_in, prior, pg_cfg)
        return kf_in._replace(R=R_out, t=t_out)

    kf = jax.lax.cond(accept, do_optimize, lambda args: args[0], (kf, loops))

    corrected_latest = Pose(kf.R[cur], kf.t[cur])
    diag = LoopDiag(candidate=cand, fitness=res.fitness, closed=accept)
    return kf, loops, corrected_latest, diag
