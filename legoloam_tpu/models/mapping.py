"""Scan-to-map refinement + keyframe store — MapOptimization rebuilt.

Reference behavior: ``src/mapOptmization.cpp:376-1522`` (``run``,
``transformAssociateToMap``, ``extractSurroundingKeyFrames``,
``downsampleCurrentScan``, ``cornerOptimization``, ``surfOptimization``,
``LMOptimization``, ``transformUpdate``, ``saveKeyFramesAndFactor``).

Design:
  * The keyframe store is a preallocated ring of fixed-cap clouds + poses
    (the reference's ``cornerCloudKeyFrames``/``surfCloudKeyFrames`` vectors +
    ``cloudKeyPoses6D``, mapOptmization.cpp:84-86,320-334).  Appends are
    dynamic-index writes; no allocation ever happens on the hot path.
  * Submap assembly (the reference's KD-tree radius search + cloud cache,
    mapOptmization.cpp:1005-1055) becomes: brute-force distances over keyframe
    positions -> top-S nearest within the radius -> batched gather + transform
    of their clouds -> one exact voxel downsample.  No cache is needed because
    the whole assembly is a few fused matmuls.
  * The scan-to-map LM is the reference's full 6-DOF Gauss-Newton (no step
    damping, unlike odometry; matB = -d2, mapOptmization.cpp:1272) with
    correspondences recomputed EVERY iteration, eigenvalue-100 degeneracy
    clamp, and 0.05°/0.05 cm convergence — expressed as a ``lax.while_loop``
    over a left-multiplicative se(3) update.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import MappingConfig
from ..ops import lm, se3, smallalg
from ..ops.features import FeatureCloud
from ..ops.se3 import Pose
from ..ops.knn_pallas import search as knn_search
from ..ops.voxel import voxel_downsample


class KeyframeStore(NamedTuple):
    R: jax.Array            # (M, 3, 3) optimized keyframe rotations
    t: jax.Array            # (M, 3)
    time: jax.Array         # (M,)
    chain_R: jax.Array      # (M, 3, 3) between-factor measurement from the
    chain_t: jax.Array      # (M, 3)    previous keyframe, captured at insertion
                            # (gtsam BetweenFactor, mapOptmization.cpp:1384-1390)
    corner: jax.Array       # (M, Ck, 3) scan-frame downsampled corner clouds
    corner_valid: jax.Array
    surf: jax.Array         # (M, Cs, 3) scan-frame surf(+outlier) clouds
    surf_valid: jax.Array
    count: jax.Array        # () int32
    # Mapping steps where a keyframe was WARRANTED (moved >= keyframe_dist)
    # but the store was full — no-silent-caps discipline.  The reference's
    # store is unbounded (mapOptmization.cpp:84-86); here the cap is a
    # compile-time shape, so drivers watch this counter and call
    # ``decimate_keyframes`` (graceful sparsification) before it ever
    # increments (pipeline.maybe_decimate).
    overflow: jax.Array     # () int32


class SubmapCache(NamedTuple):
    """Incrementally maintained world-frame voxel submap (corner + surf).

    The reference re-voxelizes ~50 keyframe clouds (0.4M points) every
    mapping step (mapOptmization.cpp:1005-1064, softened by its transformed-
    cloud cache).  Here the deduped voxel set itself is the cache: pending
    keyframes accumulate and FOLD in one weighted-centroid merge every
    ``submap_merge_batch`` insertions (associative, so bit-for-bit the same
    centroids a full rebuild would give — and 3 of 4 mapping steps touch no
    sort at all), pruned outside ``search_radius + submap_rebuild_dist`` of
    the rebuild origin; the expensive full rebuild runs only when the pose
    strays ``submap_rebuild_dist`` from the origin, a loop correction moves
    the keyframes, or the cache falls more than a batch behind.  Arrays stay
    Morton-sorted around ``origin`` (what the culled kNN kernel feeds on)."""
    c_pts: jax.Array     # (Cc, 3) corner voxel centroids, world frame
    c_cnt: jax.Array     # (Cc,)  accumulated point counts (merge weights)
    c_valid: jax.Array
    s_pts: jax.Array     # (Cs, 3) surf voxel centroids
    s_cnt: jax.Array
    s_valid: jax.Array
    origin: jax.Array    # (3,) Morton origin = pose at last rebuild
    merged: jax.Array    # () int32: keyframes folded in so far
    stale: jax.Array     # () bool: loop correction moved keyframes -> rebuild
    prune_r: jax.Array   # () adaptive prune radius: shrinks when the voxel
                         # census approaches the cap so overflow drops FAR
                         # voxels (by radius) instead of a Morton-biased
                         # corner of the map, recovers when occupancy falls
    voxel_overflow: jax.Array  # () int32 cumulative occupied voxels dropped
                               # beyond the corner/surf caps (should stay 0:
                               # the adaptive prune radius backs off first)


class MapState(NamedTuple):
    kf: KeyframeStore
    cache: SubmapCache
    t_bef: Pose             # transformBefMapped: odometry pose at last mapping
    t_aft: Pose             # transformAftMapped: mapped pose at last mapping
    ground_ref: jax.Array   # () anchor height of the first keyframe's ground
    ground_ref_ok: jax.Array  # () bool: ground_ref captured
    initialized: jax.Array


class MappingDiag(NamedTuple):
    n_corner_res: jax.Array
    n_surf_res: jax.Array
    iters: jax.Array
    new_keyframe: jax.Array
    n_submap_corner: jax.Array
    n_submap_surf: jax.Array
    kf_overflow: jax.Array      # () bool: keyframe warranted but store full
    submap_overflow: jax.Array  # () int32: cumulative submap voxels dropped


def init_state(cfg: MappingConfig) -> MapState:
    m = cfg.max_keyframes
    kf = KeyframeStore(
        R=jnp.broadcast_to(jnp.eye(3), (m, 3, 3)).copy(),
        t=jnp.zeros((m, 3)),
        time=jnp.zeros((m,)),
        chain_R=jnp.broadcast_to(jnp.eye(3), (m, 3, 3)).copy(),
        chain_t=jnp.zeros((m, 3)),
        corner=jnp.zeros((m, cfg.scan_corner_cap, 3)),
        corner_valid=jnp.zeros((m, cfg.scan_corner_cap), bool),
        surf=jnp.zeros((m, cfg.scan_surf_cap, 3)),
        surf_valid=jnp.zeros((m, cfg.scan_surf_cap), bool),
        count=jnp.int32(0),
        overflow=jnp.int32(0),
    )
    cache = SubmapCache(
        c_pts=jnp.zeros((cfg.submap_corner_cap, 3)),
        c_cnt=jnp.zeros((cfg.submap_corner_cap,)),
        c_valid=jnp.zeros((cfg.submap_corner_cap,), bool),
        s_pts=jnp.zeros((cfg.submap_surf_cap, 3)),
        s_cnt=jnp.zeros((cfg.submap_surf_cap,)),
        s_valid=jnp.zeros((cfg.submap_surf_cap,), bool),
        origin=jnp.zeros((3,)),
        merged=jnp.int32(0),
        stale=jnp.array(True),
        prune_r=jnp.float32(cfg.search_radius + cfg.submap_rebuild_dist),
        voxel_overflow=jnp.int32(0),
    )
    return MapState(kf=kf, cache=cache, t_bef=Pose.identity(),
                    t_aft=Pose.identity(), ground_ref=jnp.float32(0.0),
                    ground_ref_ok=jnp.array(False),
                    initialized=jnp.array(False))


# ---------------------------------------------------------------------------
# Submap assembly
# ---------------------------------------------------------------------------

def _pos_cell(t: jax.Array, center: jax.Array, leaf: float) -> jax.Array:
    """Absolute ``leaf``-grid cell key of each position, packed into int32
    relative to ``center``'s cell (7 bits/axis; positions > 63 cells out
    collapse, which only matters outside any search radius)."""
    q = jnp.floor(t / leaf).astype(jnp.int32) \
        - jnp.floor(center[None] / leaf).astype(jnp.int32)
    q = jnp.clip(q, -63, 63) + 64
    return (q[:, 0] << 14) | (q[:, 1] << 7) | q[:, 2]


def dedup_positions(t: jax.Array, ok: jax.Array, center: jax.Array,
                    leaf: float):
    """One representative per ``leaf``-sized position voxel — the reference's
    1 m pose downsample before submap assembly
    (downSizeFilterSurroundingKeyPoses, mapOptmization.cpp:1009-1010).
    Without it, dense revisit areas (post loop closure) fill a top-S
    selection with near-duplicate keyframes and truncate the radius coverage
    the reference gets from its radius search over DEDUPED poses.

    The representative is the LOWEST-index keyframe of the cell, on the
    ABSOLUTE grid: the choice never changes as later keyframes arrive or the
    query center moves, which keeps the incremental submap cache exactly
    consistent with a from-scratch rebuild (update_submap_cache)."""
    key = jnp.where(ok, _pos_cell(t, center, leaf), jnp.int32(0x7FFFFFFF))
    perm = jnp.argsort(key)                  # stable: ties keep index order
    sk = key[perm]
    first = jnp.concatenate([jnp.array([True]), sk[1:] != sk[:-1]])
    rep = first & (sk != 0x7FFFFFFF)
    return jnp.zeros(t.shape[:1], bool).at[perm].set(rep)


def extract_submap(kf: KeyframeStore, center: jax.Array, cfg: MappingConfig,
                   return_counts: bool = False,
                   return_overflow: bool = False):
    """Gather the nearest position-deduped keyframes within the search
    radius, transform their clouds to world, and voxel-downsample into
    fixed-cap submap arrays.  Selection follows the reference's radius mode
    (mapOptmization.cpp:1001-1056): radius search over keyframe positions
    DEDUPED at ``surrounding_leaf`` (1 m), one keyframe per occupied cell.
    ``search_num`` caps the deduped selection (the reference's loop-closure
    mode cap, surroundingKeyframeSearchNum=50; after dedup a 50-cap covers a
    50 m disk rather than 50 raw trajectory steps ~ 15 m).

    ``cfg.submap_mode == "recent"`` instead selects the most recent
    ``search_num`` keyframes regardless of distance — the reference's
    loop-closure-mode recency deque (mapOptmization.cpp:961-1000)."""
    m = kf.t.shape[0]
    if cfg.submap_mode == "recent":
        S = min(cfg.search_num, m)
        sel = kf.count - S + jnp.arange(S)
        sel_ok = sel >= 0
        sel = jnp.clip(sel, 0, m - 1)
    elif cfg.submap_mode == "radius":
        kf_ok = jnp.arange(m) < kf.count
        d2 = jnp.sum((kf.t - center[None, :]) ** 2, axis=-1)
        rep = dedup_positions(kf.t, kf_ok, center, cfg.surrounding_leaf)
        d2 = jnp.where(rep, d2, jnp.inf)
        sel_score, sel = jax.lax.top_k(-d2, min(cfg.search_num, m))
        sel_ok = (-sel_score) <= cfg.search_radius ** 2
    else:
        raise ValueError(f"submap_mode must be 'radius' or 'recent', "
                         f"got {cfg.submap_mode!r}")

    def gather(cloud, valid):
        pts = cloud[sel]                       # (S, C, 3)
        v = valid[sel] & sel_ok[:, None]
        world = se3.transform_points(Pose(kf.R[sel], kf.t[sel]), pts)
        return world.reshape(-1, 3), v.reshape(-1)

    cpts, cval = gather(kf.corner, kf.corner_valid)
    spts, sval = gather(kf.surf, kf.surf_valid)
    # Morton-ordered output (origin=center): the scan-to-map kNN kernel culls
    # reference chunks by AABB, which needs spatially sorted submaps.
    sub_c = voxel_downsample(cpts, cval, cfg.corner_leaf,
                             cfg.submap_corner_cap, origin=center,
                             return_counts=return_counts,
                             return_overflow=return_overflow)
    sub_s = voxel_downsample(spts, sval, cfg.surf_leaf,
                             cfg.submap_surf_cap, origin=center,
                             return_counts=return_counts,
                             return_overflow=return_overflow)
    return sub_c, sub_s


def update_submap_cache(cache: SubmapCache, kf: KeyframeStore,
                        center: jax.Array, cfg: MappingConfig) -> SubmapCache:
    """Bring the cached submap up to date with the keyframe store.

    Fast path (every mapping step): weighted-centroid merge of the one
    keyframe added since the last merge into the cached voxels — a ~57K-row
    sort instead of the ~0.5M-row full re-voxelization.  Slow path (pose
    strayed ``submap_rebuild_dist`` from the origin / loop correction /
    cache more than one keyframe behind): full ``extract_submap`` rebuild
    around the current pose.

    In ``submap_mode == "recent"`` the selection is the recency deque, whose
    membership changes with every keyframe — the incremental merge cannot
    express departures, so every step rebuilds (matching the reference's
    per-step deque re-concatenation, mapOptmization.cpp:984-1000).

    BATCHED FOLDS (``cfg.submap_merge_batch`` = B > 1): pending keyframes
    accumulate and fold in ONE sort every B mapping steps instead of a
    ~57K-row re-voxelization per step, which otherwise dominates the
    mapping step.  Between folds the submap lags at most B-1 keyframes, which
    are the most recent (hence most redundant with the current scan) of a
    50 m radius set; while the map is young (< 8 keyframes) every pending
    keyframe folds immediately so the cold-start submap never lags."""
    B = max(int(cfg.submap_merge_batch), 1)
    m = kf.t.shape[0]
    pending = kf.count - cache.merged
    moved = jnp.linalg.norm(center - cache.origin) > cfg.submap_rebuild_dist
    behind = pending > B
    needs_rebuild = cache.stale | moved | behind
    if cfg.submap_mode == "recent":
        needs_rebuild = jnp.array(True)

    max_prune = cfg.search_radius + cfg.submap_rebuild_dist

    def rebuild():
        (c, cv, cc, c_of), (s, sv, sc, s_of) = extract_submap(
            kf, center, cfg, return_counts=True, return_overflow=True)
        return SubmapCache(c_pts=c, c_cnt=cc, c_valid=cv,
                           s_pts=s, s_cnt=sc, s_valid=sv,
                           origin=center, merged=kf.count,
                           stale=jnp.array(False),
                           prune_r=jnp.float32(max_prune),
                           voxel_overflow=cache.voxel_overflow + c_of + s_of)

    def incremental():
        # Young-map regime: while the map is small (< 2 batches of
        # keyframes), a B-1-keyframe lag would be a large fraction of the
        # whole submap — fold every pending keyframe immediately until the
        # map is big enough that the lagged tail is redundant.
        fold_now = (pending >= B) \
            | ((kf.count <= 2 * B) & (pending >= 1))
        n_fold = jnp.minimum(pending, B)
        idxs = jnp.minimum(cache.merged + jnp.arange(B), m - 1)
        take = (jnp.arange(B) < n_fold) & fold_now
        # Position-dedup consistency with extract_submap: fold a pending
        # keyframe's points only if it is its 1 m cell's representative (no
        # EARLIER keyframe occupies the cell; dedup_positions picks the
        # lowest index, which never changes as keyframes accrete, so
        # skipping non-representatives here reproduces the rebuild's dedup
        # exactly).  Non-representatives still advance ``merged``.
        cells = _pos_cell(kf.t, cache.origin, cfg.surrounding_leaf)
        earlier = jnp.arange(m)[None, :] < idxs[:, None]        # (B, m)
        is_rep = ~jnp.any(earlier & (cells[None, :] == cells[idxs][:, None]),
                          axis=1)                               # (B,)
        has_new = take & is_rep
        R, t = kf.R[idxs], kf.t[idxs]                           # (B, 3, 3)
        prune_r2 = cache.prune_r ** 2

        def merge(cached_pts, cached_cnt, cached_valid, clouds, clouds_valid,
                  leaf, cap):
            world = se3.transform_points(Pose(R, t), clouds)    # (B, C, 3)
            new_pts = world.reshape(-1, 3)
            new_ok = (clouds_valid & has_new[:, None]).reshape(-1)
            pts = jnp.concatenate([cached_pts, new_pts], axis=0)
            w = jnp.concatenate(
                [cached_cnt, new_ok.astype(cached_cnt.dtype)], axis=0)
            ok = jnp.concatenate([cached_valid, new_ok], axis=0)
            ok = ok & (jnp.sum((pts - cache.origin) ** 2, axis=-1) < prune_r2)
            return voxel_downsample(pts, ok, leaf, cap, origin=cache.origin,
                                    weights=w, return_counts=True,
                                    return_overflow=True)

        def fold():
            c, cv, cc, c_of = merge(cache.c_pts, cache.c_cnt, cache.c_valid,
                                    kf.corner[idxs], kf.corner_valid[idxs],
                                    cfg.corner_leaf, cfg.submap_corner_cap)
            s, sv, sc, s_of = merge(cache.s_pts, cache.s_cnt, cache.s_valid,
                                    kf.surf[idxs], kf.surf_valid[idxs],
                                    cfg.surf_leaf, cfg.submap_surf_cap)
            return c, cv, cc, s, sv, sc, c_of + s_of

        def skip():
            return (cache.c_pts, cache.c_valid, cache.c_cnt,
                    cache.s_pts, cache.s_valid, cache.s_cnt, jnp.int32(0))

        if B == 1:
            # Per-step merge: fold unconditionally (``take`` masks out the
            # no-pending case) — the round-3 behavior, without the cond
            # branch duplicating the merge in the compiled program.
            c, cv, cc, s, sv, sc, n_of = fold()
        else:
            c, cv, cc, s, sv, sc, n_of = jax.lax.cond(fold_now, fold, skip)
        # Adapt the prune radius from voxel occupancy: when either channel
        # nears its cap, overflow would drop the HIGHEST Morton keys — a
        # spatially biased corner of the map.  Shrinking the radius instead
        # discards the farthest voxels (rotationally fair) and backs off
        # before overflow triggers; it recovers toward the maximum when
        # occupancy falls.  Never shrinks inside the kNN search radius.
        occ = jnp.maximum(jnp.sum(cv) / float(cfg.submap_corner_cap),
                          jnp.sum(sv) / float(cfg.submap_surf_cap))
        new_r = jnp.where(occ > 0.9, cache.prune_r * 0.95,
                          jnp.minimum(cache.prune_r * 1.02,
                                      jnp.float32(max_prune)))
        new_r = jnp.maximum(new_r, jnp.float32(cfg.search_radius))
        if B > 1:
            new_r = jnp.where(fold_now, new_r, cache.prune_r)
        return SubmapCache(c_pts=c, c_cnt=cc, c_valid=cv,
                           s_pts=s, s_cnt=sc, s_valid=sv,
                           origin=cache.origin,
                           merged=cache.merged
                           + jnp.where(fold_now, n_fold, 0).astype(jnp.int32),
                           stale=jnp.array(False),
                           prune_r=new_r.astype(jnp.float32),
                           voxel_overflow=cache.voxel_overflow + n_of)

    return jax.lax.cond(needs_rebuild, rebuild, incremental)


# ---------------------------------------------------------------------------
# Scan-to-map LM
# ---------------------------------------------------------------------------

def _knn5(p, pv, sub, sv, cfg: MappingConfig):
    """5-NN of each scan point in the submap.  gate = the acceptance radius
    (nn_max_dist is the SQUARED 5th-NN threshold, mapOptmization.cpp:1101,
    1183): beyond it results only need to exceed the gate, which lets the GPU
    kernel cull whole reference chunks."""
    return knn_search(p, pv, sub, sv, k=5, gate=float(cfg.nn_max_dist) ** 0.5)


class _CorrGeom(NamedTuple):
    """Frozen correspondence geometry between refreshes: per corner point a
    fitted 3D line (two points), per surf point a fitted plane."""
    c_t1: jax.Array      # (Nc, 3) line endpoints
    c_t2: jax.Array
    c_gate: jax.Array    # (Nc,) NN-distance + line-shape gates
    s_n: jax.Array       # (Ns, 3) unit plane normals
    s_off: jax.Array     # (Ns,)  plane offsets
    s_gate: jax.Array


def _fit_corner(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """cornerOptimization fit half (mapOptmization.cpp:1093-1127):
    5-NN + PCA line through the neighbors."""
    d, i = _knn5(p_world, q_valid, sub, sub_valid, cfg)
    gate = q_valid & (d[:, 4] < cfg.nn_max_dist)
    nn = sub[i]                                   # (N, 5, 3)
    c, v1, evals = lm.pca_line(nn)
    line_ok = evals[:, 2] > cfg.line_eig_ratio * evals[:, 1]
    return c + 0.1 * v1, c - 0.1 * v1, gate & line_ok


def _fit_surf(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """surfOptimization fit half (mapOptmization.cpp:1176-1207):
    5-NN + LSQ plane through the neighbors."""
    d, i = _knn5(p_world, q_valid, sub, sub_valid, cfg)
    gate = q_valid & (d[:, 4] < cfg.nn_max_dist)
    nn = sub[i]
    n, off, max_off = lm.fit_plane_lstsq(nn)
    plane_ok = max_off <= cfg.plane_fit_tol
    return n, off, gate & plane_ok


def _corner_residuals_from(p_world, t1, t2, gate, cfg: MappingConfig):
    """Point-to-line residual + robust weight vs the frozen line
    (mapOptmization.cpp:1128-1170)."""
    dir_, ld2 = lm.point_to_line(p_world, t1, t2)
    w = 1.0 - cfg.robust_weight_scale * jnp.abs(ld2)
    ok = gate & (w > cfg.robust_weight_min) & (ld2 > 0)
    w = jnp.where(ok, w, 0.0)
    return dir_ * w[:, None], ld2 * w, ok


def _surf_residuals_from(p_world, n, off, gate, cfg: MappingConfig):
    """Point-to-plane residual + robust weight vs the frozen plane
    (mapOptmization.cpp:1210-1222)."""
    pd2 = jnp.sum(n * p_world, axis=-1) + off
    rng = jnp.linalg.norm(p_world, axis=-1)
    w = 1.0 - cfg.robust_weight_scale * jnp.abs(pd2) / jnp.sqrt(
        jnp.maximum(jnp.sqrt(jnp.maximum(rng, 1e-9)), 1e-9))
    ok = gate & (w > cfg.robust_weight_min) & (jnp.abs(pd2) > 0)
    w = jnp.where(ok, w, 0.0)
    return n * w[:, None], pd2 * w, ok


def _corner_residuals(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """Fit + residual in one shot (reference per-iteration behavior)."""
    t1, t2, gate = _fit_corner(p_world, q_valid, sub, sub_valid, cfg)
    return _corner_residuals_from(p_world, t1, t2, gate, cfg)


def _surf_residuals(p_world, q_valid, sub, sub_valid, cfg: MappingConfig):
    """Fit + residual in one shot (reference per-iteration behavior)."""
    n, off, gate = _fit_surf(p_world, q_valid, sub, sub_valid, cfg)
    return _surf_residuals_from(p_world, n, off, gate, cfg)


def scan_to_map(
    guess: Pose,
    corner: jax.Array, corner_valid: jax.Array,
    surf: jax.Array, surf_valid: jax.Array,
    sub_c, sub_cv, sub_s, sub_sv,
    cfg: MappingConfig,
    reduce_fn=None,
):
    """Reference scan2MapOptimization (mapOptmization.cpp:1329-1350).

    The reference re-searches 5-NN correspondences and re-fits the line/plane
    every iteration.  With ``cfg.corr_refresh_every`` = R > 1, the (dominant)
    kNN + fit half runs only on iterations 0, R, 2R, ... and the fitted
    geometry is frozen in between — the same lagged-correspondence idiom the
    reference itself uses in odometry (featureAssociation.cpp:1163, re-search
    every 5th iteration).  Residual distances and robust weights are still
    recomputed from the CURRENT pose every iteration.

    ``reduce_fn``: cross-device sum hook (e.g. ``lax.psum`` inside a
    shard_map) applied to residual counts and the assembled 6x6 normal
    equations — with the scan point axis sharded over a mesh and the submap
    replicated, every device solves the identical reduced system and the
    result matches the single-device solve exactly."""
    map_ok = (jnp.sum(sub_cv) >= cfg.min_corner_map) & (
        jnp.sum(sub_sv) >= cfg.min_surf_map)

    nc = corner.shape[0]

    def search(T):
        pc_w = se3.transform_points(T, corner)
        ps_w = se3.transform_points(T, surf)
        t1, t2, c_gate = _fit_corner(pc_w, corner_valid, sub_c, sub_cv, cfg)
        n, off, s_gate = _fit_surf(ps_w, surf_valid, sub_s, sub_sv, cfg)
        return _CorrGeom(t1, t2, c_gate, n, off, s_gate)

    # Odometry-prior information matrix (see MappingConfig.prior_*): a
    # quadratic penalty on the accumulated twist from the guess.
    if cfg.prior_trans_std > 0 and cfg.prior_rot_std_deg > 0:
        import math as _math
        w_rot = 1.0 / _math.radians(cfg.prior_rot_std_deg) ** 2
        w_trans = 1.0 / cfg.prior_trans_std ** 2
        prior_w = jnp.asarray([w_rot] * 3 + [w_trans] * 3, jnp.float32)
    else:
        prior_w = jnp.zeros((6,), jnp.float32)

    def cond(st):
        i, T, xi_acc, deg, done, geom, _, _, _ = st
        return (i < cfg.max_iterations) & ~done & map_ok

    def body(st):
        i, T, xi_acc, deg, done, geom, _, _, _ = st
        if cfg.corr_refresh_every > 1:
            geom = jax.lax.cond(i % cfg.corr_refresh_every == 0,
                                lambda: search(T), lambda: geom)
        else:
            geom = search(T)
        pc_w = se3.transform_points(T, corner)
        ps_w = se3.transform_points(T, surf)
        cdir, cres, c_ok = _corner_residuals_from(pc_w, geom.c_t1, geom.c_t2,
                                                  geom.c_gate, cfg)
        sdir, sres, s_ok = _surf_residuals_from(ps_w, geom.s_n, geom.s_off,
                                                geom.s_gate, cfg)
        p_all = jnp.concatenate([pc_w, ps_w], axis=0)
        dir_all = jnp.concatenate([cdir, sdir], axis=0)
        res_all = jnp.concatenate([cres, sres], axis=0)
        ok_all = jnp.concatenate([c_ok, s_ok], axis=0)
        n_c_ok = jnp.sum(c_ok)
        n_s_ok = jnp.sum(s_ok)
        if reduce_fn is not None:
            n_c_ok, n_s_ok = reduce_fn(n_c_ok), reduce_fn(n_s_ok)
        enough = (n_c_ok + n_s_ok) >= cfg.min_residuals  # mapOptmization.cpp:1238
        # Linearize the rotation about the CURRENT POSE position, not the
        # world origin: J_rot = (p − T.t) × n with the matching
        # ``retract_about`` update.  This reproduces the reference's
        # sensor-local conditioning (mapOptmization.cpp:1252-1271, its Euler
        # Jacobians use scan-frame point coords); a world-origin lever arm
        # makes the f32 normal equations ill-conditioned as the trajectory
        # leaves the origin and the LM stops converging (verified: with a
        # ground-truth map it introduced 0.18 m / 3.2° at zero perturbation
        # 60 m out, and the full pipeline diverged superlinearly).
        lin_center = T.t
        J = jnp.concatenate(
            [jnp.cross(p_all - lin_center[None, :], dir_all), dir_all], axis=1)
        AtA, AtB = lm.assemble_normal_equations(J, res_all, ok_all & enough,
                                                1.0)
        if reduce_fn is not None:
            AtA, AtB = reduce_fn(AtA), reduce_fn(AtB)
        # MAP solve: map normal equations + odometry prior anchored at the
        # guess (xi_acc = accumulated twist away from it).
        AtA = AtA + jnp.diag(prior_w)
        AtB = AtB - prior_w * xi_acc
        delta, deg = lm.solve_assembled(AtA, AtB, deg, i == 0,
                                        cfg.degeneracy_eig_thresh)
        T_new = se3.retract_about(T, delta, lin_center)
        T = jax.tree.map(lambda a, b: jnp.where(enough, a, b), T_new, T)
        xi_acc = jnp.where(enough, xi_acc + delta, xi_acc)
        rot_deg = jnp.degrees(jnp.linalg.norm(delta[:3]))
        t_cm = jnp.linalg.norm(delta[3:]) * 100.0
        done = ((rot_deg < cfg.conv_rot_deg) & (t_cm < cfg.conv_trans_cm)) \
            | ~enough
        return (i + 1, T, xi_acc, deg, done, geom, n_c_ok, n_s_ok, enough)

    geom0 = _CorrGeom(
        c_t1=jnp.zeros((nc, 3)), c_t2=jnp.ones((nc, 3)),
        c_gate=jnp.zeros((nc,), bool),
        s_n=jnp.zeros((surf.shape[0], 3)), s_off=jnp.zeros((surf.shape[0],)),
        s_gate=jnp.zeros((surf.shape[0],), bool))
    init = (jnp.int32(0), guess, jnp.zeros((6,), jnp.float32),
            lm.identity_degeneracy(6), jnp.array(False),
            geom0, jnp.int32(0), jnp.int32(0), jnp.array(False))
    i, T, _, _, _, _, n_c, n_s, _ = jax.lax.while_loop(cond, body, init)
    return T, i, n_c, n_s


def _ground_anchor(T: Pose, ground: FeatureCloud, ref_h, ref_ok,
                   cfg: MappingConfig):
    """Rotate roll/pitch (about the pose position) + shift z so the scan's
    ground plane matches the anchor height (see MappingConfig.ground_anchor).

    Returns (anchored pose, new ref_h, new ref_ok).  The first successful fit
    CAPTURES the reference height; later fits pull toward it."""
    gw = se3.transform_points(T, ground.xyz)
    v = ground.valid
    n_pts = jnp.sum(v)
    w = v.astype(gw.dtype)
    c = jnp.sum(gw * w[:, None], axis=0) / jnp.maximum(n_pts, 1)
    q = (gw - c) * w[:, None]
    cov = q.T @ q
    evals, evecs = smallalg.eigh3x3(cov)
    n = evecs[:, 0]
    n = n * jnp.sign(n[2] + 1e-12)            # point up
    max_tilt = jnp.cos(jnp.radians(cfg.ground_anchor_max_tilt_deg))
    ok = (n_pts >= cfg.ground_anchor_min_pts) & (n[2] > max_tilt)

    # Roll/pitch: rotate n -> z about the pose position.
    axis = jnp.cross(n, jnp.array([0.0, 0.0, 1.0]))
    sin_a = jnp.linalg.norm(axis)
    angle = jnp.arcsin(jnp.clip(sin_a, -1.0, 1.0))
    axis = axis / jnp.maximum(sin_a, 1e-12)
    blend = jnp.float32(cfg.ground_anchor)
    Rc = se3.so3_exp(axis * angle * blend)
    t_rot = T.t                                # rotation center = pose position
    T_rot = Pose(se3.mat3_mul(Rc, T.R),
                 se3.rotate_vec(Rc, T.t - t_rot) + t_rot)

    # Height: plane height at the pose position, after the rotation.
    h = c[2] + (se3.rotate_vec(Rc, c - t_rot) + t_rot - c)[2]
    new_ref = jnp.where(ref_ok, ref_h, h)
    dz = (new_ref - h) * blend
    T_anch = Pose(T_rot.R, T_rot.t + jnp.array([0.0, 0.0, 1.0]) * dz)

    T_out = jax.tree.map(lambda a, b: jnp.where(ok, a, b), T_anch, T)
    return T_out, jnp.where(ref_ok, ref_h, jnp.where(ok, h, ref_h)), \
        ref_ok | ok


def _trust_region(guess: Pose, T: Pose, cfg: MappingConfig) -> Pose:
    """Scale the LM's correction (relative to the odometry-projected guess)
    down to the per-step caps, preserving its direction.  The guess already
    carries the previous correction, so legitimate new corrections are small;
    oversized ones are symptomatic of a smeared/spurious map optimum."""
    xi = se3.se3_log(se3.relative(guess, T))       # guess -> T twist
    rot = jnp.linalg.norm(xi[:3])
    trans = jnp.linalg.norm(xi[3:])
    max_rot = jnp.float32(jnp.radians(cfg.max_step_rot_deg))
    scale = jnp.minimum(
        1.0, jnp.minimum(
            jnp.where(rot > 0, max_rot / jnp.maximum(rot, 1e-12), 1.0),
            jnp.where(trans > 0,
                      cfg.max_step_trans / jnp.maximum(trans, 1e-12), 1.0)))
    return se3.compose(guess, se3.se3_exp(xi * scale))


# ---------------------------------------------------------------------------
# Full mapping step
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(0,))
def mapping_step(
    state: MapState,
    corner_cloud: FeatureCloud,     # odometry's last_corner (scan-end frame)
    surf_cloud: FeatureCloud,       # odometry's last_surf
    outlier_cloud: FeatureCloud,    # segmentation outliers (scan-end frame)
    odom_pose: Pose,
    scan_time: jax.Array,
    cfg: MappingConfig,
    imu_rpy: jax.Array | None = None,
    ground_cloud: FeatureCloud | None = None,
) -> Tuple[MapState, Pose, MappingDiag]:
    """One mapping update (the reference's throttled ``run`` body,
    mapOptmization.cpp:1487-1522).

    DONATION CONTRACT: ``state`` is donated (the ~500 MB keyframe store
    aliases in place — measured ~3-7% of full-SLAM throughput).  The
    returned state/pose may alias the new state's buffers: callers that
    KEEP a returned pose across a later ``mapping_step`` call must fetch it
    to host (``np.asarray``) or copy it first — the next call invalidates
    the donated buffers."""
    # 1. transformAssociateToMap: project odometry through the last correction.
    guess_raw = se3.project_through_correction(odom_pose, state.t_bef,
                                               state.t_aft)
    guess = jax.tree.map(
        lambda a, b: jnp.where(state.initialized, a, b), guess_raw, odom_pose)

    # 2. downsampleCurrentScan (mapOptmization.cpp:1067-1091).  Scan-frame
    # Morton ordering (origin=0, the sensor): rigid transforms preserve
    # locality, so the world-frame queries stay chunk-coherent for culling.
    zero3 = jnp.zeros((3,), corner_cloud.xyz.dtype)
    c_pts, c_ok = voxel_downsample(corner_cloud.xyz, corner_cloud.valid,
                                   cfg.corner_leaf, cfg.scan_corner_cap,
                                   origin=zero3)
    surf_all = jnp.concatenate([surf_cloud.xyz, outlier_cloud.xyz], axis=0)
    surf_all_ok = jnp.concatenate([surf_cloud.valid, outlier_cloud.valid],
                                  axis=0)
    s_pts, s_ok = voxel_downsample(surf_all, surf_all_ok, cfg.surf_leaf,
                                   cfg.scan_surf_cap, origin=zero3)

    # 3. Submap around the guess (incremental cache; full rebuild when stale).
    cache = update_submap_cache(state.cache, state.kf, guess.t, cfg)
    sub_c, sub_cv = cache.c_pts, cache.c_valid
    sub_s, sub_sv = cache.s_pts, cache.s_valid

    # 4. Scan-to-map LM — gated on submap maturity (min_lm_keyframes) and
    # trust-regioned against the guess (see MappingConfig docstrings).
    T_lm, iters, n_c, n_s = scan_to_map(
        guess, c_pts, c_ok, s_pts, s_ok, sub_c, sub_cv, sub_s, sub_sv, cfg)
    lm_on = state.kf.count >= cfg.min_lm_keyframes
    # max_step_trans <= 0 disables the trust region (config.REFERENCE —
    # the reference applies the raw LM result).
    T = _trust_region(guess, T_lm, cfg) if cfg.max_step_trans > 0 else T_lm
    T = jax.tree.map(lambda a, b: jnp.where(lm_on, a, b), T, guess)

    # 4b'. Ground-plane attitude/height anchor (MappingConfig.ground_anchor).
    ground_ref, ground_ref_ok = state.ground_ref, state.ground_ref_ok
    if ground_cloud is not None and cfg.ground_anchor > 0:
        T, ground_ref, ground_ref_ok = _ground_anchor(
            T, ground_cloud, ground_ref, ground_ref_ok, cfg)

    # 4b. transformUpdate (mapOptmization.cpp:463-496): blend roll/pitch
    # toward the IMU attitude with weight imu_blend (0.998/0.002).
    if imu_rpy is not None:
        roll, pitch, yaw = se3.mat_to_euler_zyx(T.R)
        w = cfg.imu_blend
        roll = (1.0 - w) * roll + w * imu_rpy[0]
        pitch = (1.0 - w) * pitch + w * imu_rpy[1]
        T = Pose(se3.euler_zyx_to_mat(roll, pitch, yaw), T.t)

    # Orthonormality insurance on the accumulated mapped rotation: T chains
    # guess-projection composes + LM retracts every mapping step; projecting
    # here bounds f32 rounding drift before T enters the keyframe store and
    # the next step's correction (see se3.so3_project).
    T = Pose(se3.so3_project(T.R), T.t)

    # 5. saveKeyFramesAndFactor gate: moved >= keyframe_dist since last KF
    # (mapOptmization.cpp:1360-1364); the first frame always becomes one.
    kf = state.kf
    last_idx = jnp.maximum(kf.count - 1, 0)
    moved = jnp.linalg.norm(T.t - kf.t[last_idx]) >= cfg.keyframe_dist
    has_room = kf.count < kf.t.shape[0]
    is_new = (~state.initialized) | (moved & has_room)
    # Saturation is counted, never silent: a warranted-but-dropped keyframe
    # increments kf.overflow (and flags the diag) so drivers know to
    # decimate (pipeline.maybe_decimate calls decimate_keyframes below).
    overflow_now = state.initialized & moved & ~has_room

    # Between-factor measurement from the previous (optimized) keyframe pose,
    # captured NOW — later pose-graph corrections must not rewrite it.
    prev_pose = Pose(kf.R[last_idx], kf.t[last_idx])
    meas = se3.relative(prev_pose, T)

    def write(arr, val):
        return jnp.where(is_new, arr.at[kf.count].set(val), arr)

    kf = kf._replace(
        R=write(kf.R, T.R),
        t=write(kf.t, T.t),
        time=write(kf.time, scan_time),
        chain_R=write(kf.chain_R, meas.R),
        chain_t=write(kf.chain_t, meas.t),
        corner=write(kf.corner, c_pts),
        corner_valid=write(kf.corner_valid, c_ok),
        surf=write(kf.surf, s_pts),
        surf_valid=write(kf.surf_valid, s_ok),
        count=kf.count + jnp.where(is_new, 1, 0).astype(jnp.int32),
        overflow=kf.overflow
        + jnp.where(overflow_now, 1, 0).astype(jnp.int32),
    )

    new_state = MapState(
        kf=kf,
        cache=cache,
        t_bef=odom_pose,       # transformUpdate latch (mapOptmization.cpp:490-495)
        t_aft=T,
        ground_ref=ground_ref,
        ground_ref_ok=ground_ref_ok,
        initialized=jnp.array(True),
    )
    diag = MappingDiag(
        n_corner_res=n_c, n_surf_res=n_s, iters=iters, new_keyframe=is_new,
        n_submap_corner=jnp.sum(sub_cv), n_submap_surf=jnp.sum(sub_sv),
        kf_overflow=overflow_now, submap_overflow=cache.voxel_overflow)
    return new_state, T, diag


# ---------------------------------------------------------------------------
# Keyframe decimation (graceful eviction at the fixed cap)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("keep_recent",))
def decimate_keyframes(kf: KeyframeStore, loops, keep_recent: int = 512):
    """Halve a (nearly) full keyframe store by trajectory sparsification.

    The reference's store is unbounded (``cornerCloudKeyFrames`` etc.,
    mapOptmization.cpp:84-86) — its 20K-scan validation runs simply grow RAM.
    The store is a compile-time shape, so long runs must SPARSIFY
    instead of growing: keep keyframe 0 (the pose-graph prior anchor) + the
    most recent ``keep_recent`` keyframes + every 2nd of the older rest, and
    compact survivors to the front (order preserved).  At the reference's
    0.3 m keyframe spacing one decimation coarsens old trajectory to 0.6 m —
    still ~80x denser than the 50 m submap search radius needs.

    Graph bookkeeping (exact given the current estimates):
      * chain between-factors are re-derived between now-adjacent survivors
        from the CURRENT optimized poses — the dropped node's two chain
        constraints compose into one (standard pose-graph sparsification);
      * loop factors remap each endpoint to its nearest surviving
        predecessor, with the measurement compensated by the estimate-
        relative offset  Z' = (T_a_i⁻¹ T_i) · Z · (T_j⁻¹ T_a_j);  factors
        whose endpoints collapse onto one node are invalidated and counted
        in ``loops.dropped``.

    Host drivers call this when ``count`` approaches the cap
    (``pipeline.maybe_decimate``); the per-scan hot path never pays for it.
    The submap cache must be marked stale afterward (indices moved).
    Returns ``(kf, loops)``.
    """
    M = kf.t.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    count = kf.count
    active = idx < count
    keep = active & ((idx >= count - keep_recent) | (idx % 2 == 0))
    n_keep = jnp.sum(keep).astype(jnp.int32)

    # Survivors to the front, order preserved (stable sort: kept first).
    src = jnp.argsort(~keep, stable=True).astype(jnp.int32)   # new slot -> old
    new_active = idx < n_keep

    def take(arr, inert):
        g = arr[src]
        shape = (M,) + (1,) * (arr.ndim - 1)
        m = new_active.reshape(shape)
        return jnp.where(m, g, inert)

    eye = jnp.broadcast_to(jnp.eye(3, dtype=kf.R.dtype), (M, 3, 3))
    R_new = take(kf.R, eye)
    t_new = take(kf.t, jnp.zeros_like(kf.t))

    # Chain measurement for new slot s >= 1: relative pose between the now-
    # adjacent survivors, from the current estimates.
    prev = Pose(jnp.roll(R_new, 1, axis=0), jnp.roll(t_new, 1, axis=0))
    meas = se3.relative(prev, Pose(R_new, t_new))
    chain_R = jnp.where(new_active[:, None, None] & (idx > 0)[:, None, None],
                        meas.R, eye)
    chain_t = jnp.where(new_active[:, None] & (idx > 0)[:, None],
                        meas.t, 0.0)

    kf_out = KeyframeStore(
        R=R_new, t=t_new,
        time=take(kf.time, jnp.zeros_like(kf.time)),
        chain_R=chain_R, chain_t=chain_t,
        corner=take(kf.corner, jnp.zeros_like(kf.corner)),
        corner_valid=take(kf.corner_valid, jnp.zeros_like(kf.corner_valid)),
        surf=take(kf.surf, jnp.zeros_like(kf.surf)),
        surf_valid=take(kf.surf_valid, jnp.zeros_like(kf.surf_valid)),
        count=n_keep, overflow=kf.overflow)

    # Loop-factor remap.  old2new[i] = new slot of i's nearest surviving
    # predecessor (cumsum of keeps up to i, minus 1).
    old2new = jnp.maximum(jnp.cumsum(keep.astype(jnp.int32)) - 1, 0)
    ni = old2new[loops.i]
    nj = old2new[loops.j]
    ai = src[ni]                       # anchors' OLD indices
    aj = src[nj]
    Ti = Pose(kf.R[loops.i], kf.t[loops.i])
    Tai = Pose(kf.R[ai], kf.t[ai])
    Tj = Pose(kf.R[loops.j], kf.t[loops.j])
    Taj = Pose(kf.R[aj], kf.t[aj])
    Z = Pose(loops.R, loops.t)
    Z_new = se3.compose(se3.relative(Tai, Ti),
                        se3.compose(Z, se3.relative(Tj, Taj)))
    collapsed = loops.valid & (ni == nj)
    loops_out = loops._replace(
        i=jnp.where(loops.valid, ni, loops.i),
        j=jnp.where(loops.valid, nj, loops.j),
        R=jnp.where(loops.valid[:, None, None], Z_new.R, loops.R),
        t=jnp.where(loops.valid[:, None], Z_new.t, loops.t),
        valid=loops.valid & ~collapsed,
        dropped=loops.dropped + jnp.sum(collapsed).astype(jnp.int32))
    return kf_out, loops_out
