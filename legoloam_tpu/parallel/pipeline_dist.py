"""Multi-chip SLAM loop: the distributed mapping backend composed into a
RUNNABLE pipeline (BASELINE.json config 5).

The reference holds the whole map in one process — keyframe cloud vectors +
pose arrays in mapOptmization's RAM (``src/mapOptmization.cpp:84-86``).  The
rebuild's scaling axis shards exactly that state over a device mesh:

  * keyframe CLOUDS (the memory hogs: ``max_keyframes`` x scan-cap points)
    live cyclically sharded over the mesh — keyframe k's clouds on shard
    k % n_dev, local slot k // n_dev (cyclic so a radius submap's contiguous
    index run spreads evenly, see ``mapping_dist.shard_keyframes``);
  * keyframe POSES / times / chain factors (a few hundred KB at the 4096-kf
    cap) stay replicated — every collective-free decision (keyframe gating,
    loop detection, fusion) reads them locally;
  * submap assembly = per-shard select + voxelize + ``all_gather``
    (``extract_submap_dist``);
  * the scan-to-map LM shards the residual-row axis and ``psum``s the 6x6
    normal equations (``mapping_dist.scan_to_map_sharded``);
  * the pose-graph solve shards the factor axis
    (``posegraph_dist.optimize_sharded``);
  * loop closure gathers only the +-history_num keyframe clouds it needs via
    a masked-psum window gather (``gather_keyframe_clouds``) instead of
    replicating the store.

Per-step submaps are FULL rebuilds (select + re-voxelize): the single-device
incremental voxel cache (``mapping.SubmapCache``) is a latency optimization
for the one-chip case; distributed, each shard's rebuild touches only its
M/n_dev keyframes, which is the point.

Everything else (guess projection, current-scan downsample, trust region,
ground anchor, keyframe gating) is identical replicated math to
``models/mapping.py:mapping_step`` — tests/test_pipeline_dist.py asserts the
mesh trajectory matches the single-device pipeline.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import LoopClosureConfig, MappingConfig, PipelineConfig, \
    PoseGraphConfig
from ..models import fusion as fusion_mod
from ..models import mapping as mapping_mod
from ..models import odometry as odom
from ..models import pipeline as pipeline_mod
from ..models import posegraph
from ..models.mapping import MappingDiag, dedup_positions
from ..models.posegraph import LoopFactors
from ..ops import icp as icp_ops
from ..ops import se3
from ..ops.features import FeatureCloud
from ..ops.se3 import Pose
from ..ops.voxel import voxel_downsample, voxel_representative
from . import mapping_dist, posegraph_dist


class DistKeyframes(NamedTuple):
    """Keyframe store split by memory class.

    Pose-sized arrays (R/t/time/chain) are replicated; cloud arrays are
    cyclically sharded on the keyframe axis (keyframe k -> shard k % n_dev,
    local slot k // n_dev)."""

    R: jax.Array            # (M, 3, 3) replicated
    t: jax.Array            # (M, 3)    replicated
    time: jax.Array         # (M,)      replicated
    chain_R: jax.Array      # (M, 3, 3) replicated
    chain_t: jax.Array      # (M, 3)    replicated
    corner: jax.Array       # (M, Ck, 3) SHARDED (cyclic keyframe axis)
    corner_valid: jax.Array
    surf: jax.Array         # (M, Cs, 3) SHARDED
    surf_valid: jax.Array
    count: jax.Array        # () replicated
    overflow: jax.Array     # () replicated: warranted-but-dropped keyframes
                            # (no-silent-caps; see mapping.KeyframeStore)


class DistMapState(NamedTuple):
    kf: DistKeyframes
    t_bef: Pose
    t_aft: Pose
    ground_ref: jax.Array
    ground_ref_ok: jax.Array
    initialized: jax.Array


class DistSlamState(NamedTuple):
    odom: "odom.OdometryState"
    mapping: DistMapState
    loops: LoopFactors


def init_dist_state(cfg: PipelineConfig, mesh: Mesh, axis: str = "data"
                    ) -> DistSlamState:
    """Allocate the sharded SLAM state on the mesh."""
    m = cfg.mapping.max_keyframes
    n_dev = mesh.shape[axis]
    assert m % n_dev == 0, "max_keyframes must divide the mesh"
    sharded = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def repl(x):
        return jax.device_put(x, rep)

    def shrd(x):
        return jax.device_put(x, sharded)

    kf = DistKeyframes(
        R=repl(jnp.broadcast_to(jnp.eye(3), (m, 3, 3)).copy()),
        t=repl(jnp.zeros((m, 3))),
        time=repl(jnp.zeros((m,))),
        chain_R=repl(jnp.broadcast_to(jnp.eye(3), (m, 3, 3)).copy()),
        chain_t=repl(jnp.zeros((m, 3))),
        corner=shrd(jnp.zeros((m, cfg.mapping.scan_corner_cap, 3))),
        corner_valid=shrd(jnp.zeros((m, cfg.mapping.scan_corner_cap), bool)),
        surf=shrd(jnp.zeros((m, cfg.mapping.scan_surf_cap, 3))),
        surf_valid=shrd(jnp.zeros((m, cfg.mapping.scan_surf_cap), bool)),
        count=repl(jnp.int32(0)),
        overflow=repl(jnp.int32(0)),
    )
    mstate = DistMapState(
        kf=kf, t_bef=Pose.identity(), t_aft=Pose.identity(),
        ground_ref=jnp.float32(0.0), ground_ref_ok=jnp.array(False),
        initialized=jnp.array(False))
    return DistSlamState(
        odom=odom.init_state(cfg.odom, cfg.feat),
        mapping=mstate,
        loops=posegraph.init_loop_factors(cfg.posegraph.max_loop_factors))


def _cloud_perm(m: int, n_dev: int) -> jnp.ndarray:
    """Physical row p of a sharded cloud array holds keyframe
    ``(p % m_loc) * n_dev + p // m_loc`` (shard p // m_loc owns local slot
    p % m_loc = keyframe's k // n_dev; see ``mapping_dist.shard_keyframes``)."""
    m_loc = m // n_dev
    p = jnp.arange(m)
    return (p % m_loc) * n_dev + p // m_loc


def from_keyframe_store(kf, mesh: Mesh, axis: str = "data") -> DistKeyframes:
    """Convert a single-device ``mapping.KeyframeStore`` (e.g. a loaded
    checkpoint) into the sharded layout."""
    n_dev = mesh.shape[axis]
    m = kf.t.shape[0]
    assert m % n_dev == 0
    perm = _cloud_perm(m, n_dev)
    sharded = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    return DistKeyframes(
        R=jax.device_put(kf.R, rep), t=jax.device_put(kf.t, rep),
        time=jax.device_put(kf.time, rep),
        chain_R=jax.device_put(kf.chain_R, rep),
        chain_t=jax.device_put(kf.chain_t, rep),
        corner=jax.device_put(kf.corner[perm], sharded),
        corner_valid=jax.device_put(kf.corner_valid[perm], sharded),
        surf=jax.device_put(kf.surf[perm], sharded),
        surf_valid=jax.device_put(kf.surf_valid[perm], sharded),
        count=jax.device_put(kf.count, rep),
        overflow=jax.device_put(kf.overflow, rep))


def to_keyframe_store(kf: DistKeyframes, mesh: Mesh | None = None):
    """Inverse of ``from_keyframe_store`` (host-side, for export/checkpoint):
    un-permute the cloud axis back to keyframe order.

    The cyclic stride is ``mesh.size`` when given; otherwise it is inferred
    from ``kf.corner.sharding``.  Inference failing on a sharded array would
    silently shuffle keyframe order, so an array that carries no
    mesh-exposing sharding (e.g. a GSPMD-sharded transform output) is an
    error unless ``mesh`` is passed explicitly."""
    from ..models.mapping import KeyframeStore
    if mesh is not None:
        n_dev = int(mesh.size)
    else:
        sh = getattr(kf.corner, "sharding", None)
        if sh is None or not hasattr(sh, "mesh"):
            raise ValueError(
                "to_keyframe_store: cannot infer the cyclic shard stride "
                "from kf.corner.sharding; pass mesh= explicitly")
        n_dev = int(sh.mesh.size) or 1
    m = kf.t.shape[0]
    perm = _cloud_perm(m, n_dev)
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(m))
    return KeyframeStore(
        R=kf.R, t=kf.t, time=kf.time, chain_R=kf.chain_R, chain_t=kf.chain_t,
        corner=kf.corner[inv], corner_valid=kf.corner_valid[inv],
        surf=kf.surf[inv], surf_valid=kf.surf_valid[inv], count=kf.count,
        overflow=kf.overflow)


# ---------------------------------------------------------------------------
# Sharded submap assembly (poses replicated, clouds sharded)
# ---------------------------------------------------------------------------

def extract_submap_dist(kf: DistKeyframes, center: jax.Array,
                        cfg: MappingConfig, mesh: Mesh, axis: str = "data"):
    """Distributed ``mapping.extract_submap`` with EXACT single-device
    selection: keyframe POSES are replicated, so every shard redundantly runs
    the identical global dedup + top-``search_num`` selection (cheap position
    math over M rows — no collective needed), then gathers/transforms only
    the selected keyframes IT OWNS, voxelizes them to ``cap/n_dev``, and one
    ``all_gather`` replicates the result.

    This replaces an earlier per-shard-local selection whose per-shard dedup
    could not see cross-shard duplicates — in dense revisit areas (1 m cells
    holding several keyframes spread cyclically over shards) the per-shard
    budget filled with near-duplicates and coverage collapsed to a fraction
    of the single-device radius (caught by
    tests/test_scale_mesh.py at 16K keyframes).  With the replicated global
    selection the chosen keyframe SET equals the single-device one exactly;
    only the voxel-downsample partitioning differs (per-shard caps, same
    as before)."""
    n_dev = mesh.shape[axis]
    m = kf.t.shape[0]
    n_sel = min(cfg.search_num, m)
    # Each shard owns ~n_sel/n_dev of the selection (cyclic layout spreads
    # the trajectory-ordered selection evenly); 2x margin absorbs imbalance.
    own_cap = min(n_sel, max(1, 2 * (-(-n_sel // n_dev))))
    # Per-shard voxel caps, floored at one scan's cloud cap: when keyframes
    # are fewer than shards (startup, small maps) a shard may hold a SINGLE
    # keyframe whose cloud alone exceeds submap_cap/n_dev — without the floor
    # its Morton-tail voxels would silently truncate
    # (tests/test_pipeline_dist.py::test_dist_submap_covers_single_device).
    c_cap = max(cfg.submap_corner_cap // n_dev, cfg.scan_corner_cap)
    s_cap = max(cfg.submap_surf_cap // n_dev, cfg.scan_surf_cap)
    kspec, rspec = P(axis), P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(kspec, kspec, kspec, kspec, rspec, rspec, rspec, rspec),
        out_specs=(rspec, rspec, rspec, rspec),
        check_vma=False,
    )
    def solve(corner, corner_valid, surf, surf_valid, R_all, t_all, count,
              ctr):
        shard = jax.lax.axis_index(axis)
        # --- replicated global selection (identical on every shard) ---
        kf_ok = jnp.arange(m) < count
        d2 = jnp.sum((t_all - ctr[None]) ** 2, axis=-1)
        rep = dedup_positions(t_all, kf_ok, ctr, cfg.surrounding_leaf)
        d2 = jnp.where(rep, d2, jnp.inf)
        sel_score, sel = jax.lax.top_k(-d2, n_sel)       # global kf indices
        sel_ok = (-sel_score) <= cfg.search_radius ** 2
        # --- compact to the selections THIS shard owns ---
        own = (sel % n_dev) == shard
        own_d2 = jnp.where(own & sel_ok, -sel_score, jnp.inf)
        _, osel = jax.lax.top_k(-own_d2, own_cap)        # indices into sel
        o_ok = jnp.isfinite(own_d2[osel])
        gsel = sel[osel]                                 # owned global ids
        lsel = gsel // n_dev                             # local slots

        def gather(cloud, valid, cap, leaf):
            pts = cloud[lsel]                            # (own_cap, C, 3)
            v = valid[lsel] & o_ok[:, None]
            world = se3.transform_points(Pose(R_all[gsel], t_all[gsel]), pts)
            return voxel_downsample(world.reshape(-1, 3), v.reshape(-1),
                                    leaf, cap, origin=ctr)

        sub_c, sub_cv = gather(corner, corner_valid, c_cap, cfg.corner_leaf)
        sub_s, sub_sv = gather(surf, surf_valid, s_cap, cfg.surf_leaf)
        return (
            jax.lax.all_gather(sub_c, axis).reshape(-1, 3),
            jax.lax.all_gather(sub_cv, axis).reshape(-1),
            jax.lax.all_gather(sub_s, axis).reshape(-1, 3),
            jax.lax.all_gather(sub_sv, axis).reshape(-1),
        )

    c, cv, s, sv = solve(kf.corner, kf.corner_valid, kf.surf, kf.surf_valid,
                         kf.R, kf.t, kf.count, center)
    return (c, cv), (s, sv)


def _append_clouds_dist(kf: DistKeyframes, k: jax.Array, is_new: jax.Array,
                        c_pts, c_ok, s_pts, s_ok, mesh: Mesh,
                        axis: str = "data"):
    """Write keyframe ``k``'s clouds into the owning shard's local slot."""
    n_dev = mesh.shape[axis]
    kspec, rspec = P(axis), P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(kspec, kspec, kspec, kspec,
                  rspec, rspec, rspec, rspec, rspec, rspec, rspec),
        out_specs=(kspec, kspec, kspec, kspec),
        check_vma=False,
    )
    def write(corner, corner_valid, surf, surf_valid,
              kk, new, cp, cv, sp, sv_, _count):
        shard = jax.lax.axis_index(axis)
        own = new & ((kk % n_dev) == shard)
        slot = kk // n_dev
        corner = jnp.where(own, corner.at[slot].set(cp), corner)
        corner_valid = jnp.where(own, corner_valid.at[slot].set(cv),
                                 corner_valid)
        surf = jnp.where(own, surf.at[slot].set(sp), surf)
        surf_valid = jnp.where(own, surf_valid.at[slot].set(sv_), surf_valid)
        return corner, corner_valid, surf, surf_valid

    corner, corner_valid, surf, surf_valid = write(
        kf.corner, kf.corner_valid, kf.surf, kf.surf_valid,
        k, is_new, c_pts, c_ok, s_pts, s_ok, kf.count)
    return kf._replace(corner=corner, corner_valid=corner_valid,
                       surf=surf, surf_valid=surf_valid)


def gather_keyframe_clouds(kf: DistKeyframes, idxs: jax.Array, mesh: Mesh,
                           axis: str = "data"):
    """Replicated (K, cap, 3) clouds for a small index window ``idxs``:
    each shard contributes the rows it owns (masked local gather), one
    ``psum`` sums the contributions.  Communication is K x cap points — the
    window, not the store."""
    n_dev = mesh.shape[axis]
    kspec, rspec = P(axis), P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(kspec, kspec, kspec, kspec, rspec),
        out_specs=(rspec, rspec, rspec, rspec),
        check_vma=False,
    )
    def gather(corner, corner_valid, surf, surf_valid, ii):
        shard = jax.lax.axis_index(axis)
        own = (ii % n_dev) == shard
        slot = ii // n_dev

        def pick(cloud, valid):
            g = cloud[slot] * own[:, None, None].astype(cloud.dtype)
            gv = valid[slot] & own[:, None]
            return (jax.lax.psum(g, axis),
                    jax.lax.psum(gv.astype(jnp.int32), axis) > 0)

        c, cv = pick(corner, corner_valid)
        s, sv = pick(surf, surf_valid)
        return c, cv, s, sv

    return gather(kf.corner, kf.corner_valid, kf.surf, kf.surf_valid, idxs)


# ---------------------------------------------------------------------------
# Distributed mapping step
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis"))
def mapping_step_dist(
    state: DistMapState,
    corner_cloud: FeatureCloud,
    surf_cloud: FeatureCloud,
    outlier_cloud: FeatureCloud,
    odom_pose: Pose,
    scan_time: jax.Array,
    cfg: MappingConfig,
    mesh: Mesh,
    axis: str = "data",
    imu_rpy: jax.Array | None = None,
    ground_cloud: FeatureCloud | None = None,
) -> Tuple[DistMapState, Pose, MappingDiag]:
    """``mapping.mapping_step`` over the mesh: identical replicated math for
    guess / downsample / gating / stabilizers; sharded submap + sharded LM."""
    # 1. transformAssociateToMap (replicated).
    guess_raw = se3.project_through_correction(odom_pose, state.t_bef,
                                               state.t_aft)
    guess = jax.tree.map(
        lambda a, b: jnp.where(state.initialized, a, b), guess_raw, odom_pose)

    # 2. downsampleCurrentScan (replicated; scan-frame Morton order).
    zero3 = jnp.zeros((3,), corner_cloud.xyz.dtype)
    c_pts, c_ok = voxel_downsample(corner_cloud.xyz, corner_cloud.valid,
                                   cfg.corner_leaf, cfg.scan_corner_cap,
                                   origin=zero3)
    surf_all = jnp.concatenate([surf_cloud.xyz, outlier_cloud.xyz], axis=0)
    surf_all_ok = jnp.concatenate([surf_cloud.valid, outlier_cloud.valid],
                                  axis=0)
    s_pts, s_ok = voxel_downsample(surf_all, surf_all_ok, cfg.surf_leaf,
                                   cfg.scan_surf_cap, origin=zero3)

    # 3. Sharded submap rebuild around the guess.
    (sub_c, sub_cv), (sub_s, sub_sv) = extract_submap_dist(
        state.kf, guess.t, cfg, mesh, axis)

    # 4. Sharded scan-to-map LM (residual rows over the mesh, psum'd normal
    # equations) + the same gating/stabilizers as the single-device step.
    T_lm, iters, n_c, n_s = mapping_dist.scan_to_map_sharded(
        guess, c_pts, c_ok, s_pts, s_ok, sub_c, sub_cv, sub_s, sub_sv,
        cfg, mesh, axis)
    lm_on = state.kf.count >= cfg.min_lm_keyframes
    T = mapping_mod._trust_region(guess, T_lm, cfg) \
        if cfg.max_step_trans > 0 else T_lm
    T = jax.tree.map(lambda a, b: jnp.where(lm_on, a, b), T, guess)

    ground_ref, ground_ref_ok = state.ground_ref, state.ground_ref_ok
    if ground_cloud is not None and cfg.ground_anchor > 0:
        T, ground_ref, ground_ref_ok = mapping_mod._ground_anchor(
            T, ground_cloud, ground_ref, ground_ref_ok, cfg)

    # transformUpdate: IMU roll/pitch blend (mapOptmization.cpp:463-496).
    if imu_rpy is not None:
        roll, pitch, yaw = se3.mat_to_euler_zyx(T.R)
        w = cfg.imu_blend
        roll = (1.0 - w) * roll + w * imu_rpy[0]
        pitch = (1.0 - w) * pitch + w * imu_rpy[1]
        T = Pose(se3.euler_zyx_to_mat(roll, pitch, yaw), T.t)

    # Orthonormality insurance on the accumulated mapped rotation (same as
    # the single-device step — see se3.so3_project).
    T = Pose(se3.so3_project(T.R), T.t)

    # 5. saveKeyFramesAndFactor gate (replicated) + sharded cloud append.
    kf = state.kf
    last_idx = jnp.maximum(kf.count - 1, 0)
    moved = jnp.linalg.norm(T.t - kf.t[last_idx]) >= cfg.keyframe_dist
    has_room = kf.count < kf.t.shape[0]
    is_new = (~state.initialized) | (moved & has_room)
    overflow_now = state.initialized & moved & ~has_room
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
    )
    kf = _append_clouds_dist(kf, kf.count, is_new, c_pts, c_ok, s_pts, s_ok,
                             mesh, axis)
    kf = kf._replace(
        count=kf.count + jnp.where(is_new, 1, 0).astype(jnp.int32),
        overflow=kf.overflow
        + jnp.where(overflow_now, 1, 0).astype(jnp.int32))

    new_state = DistMapState(
        kf=kf, t_bef=odom_pose, t_aft=T,
        ground_ref=ground_ref, ground_ref_ok=ground_ref_ok,
        initialized=jnp.array(True))
    diag = MappingDiag(
        n_corner_res=n_c, n_surf_res=n_s, iters=iters, new_keyframe=is_new,
        n_submap_corner=jnp.sum(sub_cv), n_submap_surf=jnp.sum(sub_sv),
        kf_overflow=overflow_now, submap_overflow=jnp.int32(0))
    return new_state, T, diag


# ---------------------------------------------------------------------------
# Distributed loop closure
# ---------------------------------------------------------------------------

def _detect_dist(kf: DistKeyframes, cfg: LoopClosureConfig) -> jax.Array:
    """``loopclosure.detect`` on the replicated pose arrays."""
    m = kf.t.shape[0]
    cur = kf.count - 1
    ok = (jnp.arange(m) < kf.count) \
        & (kf.time[cur] - kf.time > cfg.min_time_gap)
    d2 = jnp.sum((kf.t - kf.t[cur][None]) ** 2, axis=-1)
    d2 = jnp.where(ok, d2, jnp.inf)
    best = jnp.argmin(d2)
    found = d2[best] < cfg.search_radius ** 2
    return jnp.where(found, best, -1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cfg", "pg_cfg", "mesh", "axis"))
def close_and_correct_dist(
    kf: DistKeyframes,
    loops: LoopFactors,
    cfg: LoopClosureConfig,
    pg_cfg: PoseGraphConfig,
    mesh: Mesh,
    axis: str = "data",
):
    """``loopclosure.close_and_correct`` over the mesh: detection on the
    replicated poses, the +-history_num cloud window gathered via masked psum,
    ICP replicated (the clouds are submap-sized either way), and the pose
    graph re-solved with the factor axis sharded
    (``posegraph_dist.optimize_sharded``).  correctPoses rewrites only the
    REPLICATED pose arrays — the sharded clouds are scan-frame and never
    move (same as the reference's keyframe payloads,
    mapOptmization.cpp:1456-1478)."""
    from ..models.loopclosure import LoopDiag

    cur = jnp.maximum(kf.count - 1, 0)
    cand = _detect_dist(kf, cfg)
    has_cand = (cand >= 0) & (kf.count >= 2)

    offs = jnp.arange(-cfg.history_num, cfg.history_num + 1)
    hist_idx = jnp.clip(jnp.maximum(cand, 0) + offs, 0,
                        jnp.maximum(kf.count - 1, 0))
    idxs = jnp.concatenate([cur[None], hist_idx])
    c_g, cv_g, s_g, sv_g = gather_keyframe_clouds(kf, idxs, mesh, axis)

    # Current keyframe cloud in world frame.
    pose0 = Pose(kf.R[cur], kf.t[cur])
    cur_pts = jnp.concatenate([se3.transform_points(pose0, c_g[0]),
                               se3.transform_points(pose0, s_g[0])], axis=0)
    cur_val = jnp.concatenate([cv_g[0], sv_g[0]], axis=0) & has_cand

    # History submap (excluding the drifted current pass, like
    # loopclosure._history_cloud).
    hist_poses = Pose(kf.R[hist_idx], kf.t[hist_idx])
    in_range = (jnp.maximum(cand, 0) + offs >= 0) \
        & (jnp.maximum(cand, 0) + offs < kf.count) \
        & (kf.time[cur] - kf.time[hist_idx] > cfg.min_time_gap)
    cpts = se3.transform_points(hist_poses, c_g[1:])
    spts = se3.transform_points(hist_poses, s_g[1:])
    pts = jnp.concatenate([cpts, spts], axis=1).reshape(-1, 3)
    val = jnp.concatenate(
        [cv_g[1:] & in_range[:, None], sv_g[1:] & in_range[:, None]],
        axis=1).reshape(-1)
    hist_pts, hist_val = voxel_representative(pts, val, cfg.submap_leaf,
                                              cfg.hist_cap)
    hist_val = hist_val & has_cand

    res = icp_ops.icp(
        cur_pts, cur_val, hist_pts, hist_val, Pose.identity(),
        max_corr_dist=cfg.icp_max_corr_dist, max_iters=cfg.icp_max_iters,
        eps=cfg.icp_eps)
    # PCL hasConverged() semantics — cap-terminated good alignments accepted
    # (matches models/loopclosure.py; mapOptmization.cpp:904).
    accept = has_cand & res.has_converged & (res.fitness < cfg.fitness_thresh)

    T_cur = Pose(kf.R[cur], kf.t[cur])
    T_cor = se3.compose(res.pose, T_cur)
    T_old = Pose(kf.R[jnp.maximum(cand, 0)], kf.t[jnp.maximum(cand, 0)])
    Z = se3.relative(T_cor, T_old)
    new_loops = posegraph.add_loop_factor(
        loops, cur, jnp.maximum(cand, 0), Z, res.fitness)
    loops = jax.tree.map(lambda a, b: jnp.where(accept, a, b), new_loops,
                         loops)

    def do_optimize(args):
        R_in, t_in, loops_in = args
        prior = Pose(R_in[0], t_in[0])
        return posegraph_dist.optimize_sharded(
            R_in, t_in, kf.count, kf.chain_R, kf.chain_t, loops_in, prior,
            pg_cfg, mesh, axis)

    R_out, t_out = jax.lax.cond(
        accept, do_optimize, lambda args: (args[0], args[1]),
        (kf.R, kf.t, loops))
    kf = kf._replace(R=R_out, t=t_out)

    corrected_latest = Pose(kf.R[cur], kf.t[cur])
    diag = LoopDiag(candidate=cand, fitness=res.fitness, closed=accept)
    return kf, loops, corrected_latest, diag


# ---------------------------------------------------------------------------
# Full distributed SLAM step + host driver
# ---------------------------------------------------------------------------

def slam_scan_step_dist(
    state: DistSlamState,
    points: jax.Array,
    valid: jax.Array,
    ring: jax.Array,
    cfg: PipelineConfig,
    mesh: Mesh,
    scan_time,
    run_mapping: bool,
    run_loop: bool = False,
    axis: str = "data",
    imu_integral=None,
    bootstrap: bool = False,
):
    """One full SLAM step on the mesh.  The frontend + odometry are the
    sequential single-program stages (replicated); mapping and the pose graph
    run sharded.  Mirrors ``pipeline.slam_scan_step`` (including its IMU
    path: de-skew + gyro-seeded initial guess + mapping attitude blend, and
    the STATIC ``bootstrap`` scan-1 double-resolve — see
    ``pipeline.slam_scan_step``'s bootstrap doc)."""
    imu_rpy_end = None
    if imu_integral is not None:
        feats, dsk = pipeline_mod.process_scan_with_imu(
            points, valid, ring, cfg, imu_integral, scan_time)
        seed = pipeline_mod.imu_xi_seed(dsk, cfg.sensor.scan_period)
        xi_seed = jnp.concatenate([seed[:3], state.odom.xi[3:]])
        if bootstrap:
            for _ in range(2):
                ns, _, _ = odom.odometry_step(state.odom, feats, cfg.odom,
                                              xi_seed=xi_seed,
                                              imu_rot=dsk.ang_delta)
                xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(
            state.odom, feats, cfg.odom, xi_seed=xi_seed,
            imu_rot=dsk.ang_delta)
        out = pipeline_mod.OdometryOutput(pose=pose, diag=diag)
        imu_rpy_end = dsk.rpy_start + dsk.ang_delta
    elif bootstrap:
        feats = pipeline_mod.process_scan(points, valid, ring, cfg)
        xi_seed = state.odom.xi
        for _ in range(2):
            ns, _, _ = odom.odometry_step(state.odom, feats, cfg.odom,
                                          xi_seed=xi_seed)
            xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(
            state.odom, feats, cfg.odom, xi_seed=xi_seed)
        out = pipeline_mod.OdometryOutput(pose=pose, diag=diag)
    else:
        odom_state, out = pipeline_mod.odometry_scan_step(
            state.odom, points, valid, ring, cfg)
    map_state = state.mapping
    loops = state.loops
    if run_mapping:
        map_state, _mapped, _mdiag = mapping_step_dist(
            map_state, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, out.pose, jnp.asarray(scan_time),
            cfg.mapping, mesh, axis, imu_rpy=imu_rpy_end,
            ground_cloud=odom_state.last_flat)
    if run_loop and cfg.loop.enabled:
        kf, loops, corrected, ldiag = close_and_correct_dist(
            map_state.kf, loops, cfg.loop, cfg.posegraph, mesh, axis)
        t_aft = jax.tree.map(
            lambda a, b: jnp.where(ldiag.closed, a, b), corrected,
            map_state.t_aft)
        map_state = map_state._replace(kf=kf, t_aft=t_aft)
    fused = fusion_mod.fuse(out.pose, map_state.t_bef, map_state.t_aft)
    return DistSlamState(odom=odom_state, mapping=map_state, loops=loops), \
        pipeline_mod.SlamOutput(
            odom_pose=out.pose, mapped_pose=map_state.t_aft,
            fused_pose=fused, diag=out.diag)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "axis",
                                             "run_loop", "bootstrap"))
def slam_scan_block_dist(
    state: DistSlamState,
    points: jax.Array,      # (B, P, 3) — B consecutive scans
    valid: jax.Array,       # (B, P)
    ring: jax.Array,        # (B, P)
    cfg: PipelineConfig,
    mesh: Mesh,
    scan_times: jax.Array,  # (B,)
    run_loop: bool = False,
    axis: str = "data",
    imu_integrals=None,     # ImuIntegral with leaves stacked on a leading B
    bootstrap: bool = False,
):
    """B consecutive distributed SLAM scans fused into ONE XLA program — the
    mesh counterpart of ``pipeline.slam_scan_block``, with identical
    semantics: scan-to-map (sharded) on the block's first scan, odometry +
    fusion every scan, optional loop closure after the mapping step,
    ``bootstrap`` double-resolve on local scan 1 of the FIRST block.  On real
    multi-chip hardware this amortizes the per-program dispatch overhead the
    single-chip block modes exist for (PERF.md); the streaming
    ``slam_scan_step_dist`` launches one program per stage per scan."""
    if bootstrap and points.shape[0] < 2:
        raise ValueError(
            "slam_scan_block_dist(bootstrap=True) needs a block of >= 2 "
            "scans (the double-resolve applies to scan index 1)")
    odom_state = state.odom
    map_state = state.mapping
    loops = state.loops
    outs = []
    for j in range(points.shape[0]):
        imu_rpy_end = None
        imu_rot = None
        if imu_integrals is not None:
            integ_j = jax.tree.map(lambda a: a[j], imu_integrals)
            feats, dsk = pipeline_mod.process_scan_with_imu(
                points[j], valid[j], ring[j], cfg, integ_j, scan_times[j])
            seed = pipeline_mod.imu_xi_seed(dsk, cfg.sensor.scan_period)
            xi_seed = jnp.concatenate([seed[:3], odom_state.xi[3:]])
            imu_rot = dsk.ang_delta
            imu_rpy_end = dsk.rpy_start + dsk.ang_delta
        else:
            feats = pipeline_mod.process_scan(points[j], valid[j], ring[j],
                                              cfg)
            xi_seed = odom_state.xi
        if bootstrap and j == 1:
            for _ in range(2):
                ns, _, _ = odom.odometry_step(odom_state, feats, cfg.odom,
                                              xi_seed=xi_seed,
                                              imu_rot=imu_rot)
                xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(
            odom_state, feats, cfg.odom, xi_seed=xi_seed, imu_rot=imu_rot)
        if j == 0:
            map_state, _mapped, _mdiag = mapping_step_dist(
                map_state, odom_state.last_corner, odom_state.last_surf,
                odom_state.last_outlier, pose, scan_times[j], cfg.mapping,
                mesh, axis, imu_rpy=imu_rpy_end,
                ground_cloud=odom_state.last_flat)
            if run_loop and cfg.loop.enabled:
                kf, loops, corrected, ldiag = close_and_correct_dist(
                    map_state.kf, loops, cfg.loop, cfg.posegraph, mesh, axis)
                t_aft = jax.tree.map(
                    lambda a, b: jnp.where(ldiag.closed, a, b), corrected,
                    map_state.t_aft)
                map_state = map_state._replace(kf=kf, t_aft=t_aft)
        fused = fusion_mod.fuse(pose, map_state.t_bef, map_state.t_aft)
        outs.append(pipeline_mod.SlamOutput(
            odom_pose=pose, mapped_pose=map_state.t_aft, fused_pose=fused,
            diag=diag))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    return DistSlamState(odom=odom_state, mapping=map_state, loops=loops), \
        stacked


def run_slam_sequence_dist(scans, cfg: PipelineConfig, mesh: Mesh,
                           times=None, axis: str = "data",
                           imu_integrals=None):
    """Host driver for the distributed pipeline; returns fused trajectory.

    Full parity with the single-device ``pipeline.run_slam_sequence``:
    scan-1 ``bootstrap`` double-resolve, per-scan IMU integrals
    (``imu_integrals``: a sequence of ``deskew.ImuIntegral``, one per scan,
    or None), loop-closure cadence on data time."""
    state = init_dist_state(cfg, mesh, axis)
    sched = pipeline_mod.LoopScheduler(cfg)
    fused_R, fused_t = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        t = float(k) * cfg.sensor.scan_period if times is None else times[k]
        state, out = slam_scan_step_dist(
            state, pts, valid, ring, cfg, mesh, t,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(t), axis=axis,
            imu_integral=None if imu_integrals is None else imu_integrals[k],
            bootstrap=(k == 1))
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
    return Pose(jnp.stack(fused_R), jnp.stack(fused_t)), state
