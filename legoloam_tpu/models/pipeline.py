"""Per-scan pipeline assembly: the four ROS processes collapsed into jitted
stages passing device arrays (SURVEY.md §7 design stance).

The reference wires imageProjection -> featureAssociation -> mapOptmization ->
transformFusion over TCPROS topics (``launch/run.launch:8-11``); here each
stage is a pure function and the "topics" are NamedTuples.  The host driver
(``run_sequence``) streams scans and collects trajectories; everything inside
a step is one XLA program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..ops import deskew as deskew_ops
from ..ops import features as feat_ops
from ..ops import projection, se3, segmentation
from ..ops.features import ScanFeatures
from ..ops.se3 import Pose
from . import odometry as odom
from .odometry import OdometryDiag, OdometryState


@functools.partial(jax.jit, static_argnames=("cfg",))
def process_scan(
    points: jax.Array,
    valid: jax.Array,
    ring: jax.Array,
    cfg: PipelineConfig,
    imu_integral: Optional[deskew_ops.ImuIntegral] = None,
    scan_start_time: jax.Array | float = 0.0,
) -> ScanFeatures:
    """Frontend: raw scan -> features (imageProjection + the feature half of
    featureAssociation)."""
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    if not cfg.deskew:
        # Pre-deskewed / rigid clouds: every point sits at the scan-END
        # frame, i.e. rel_time ≡ 1 (NOT 0: the warp Jacobian scales with s,
        # so s=0 would zero all twist information; with s=1 the odometry
        # estimates the full rigid scan-to-scan transform).
        img = img._replace(rel_time=jnp.ones_like(img.rel_time))
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    xyz = None
    if imu_integral is not None:
        dsk = deskew_ops.deskew_image(
            img.xyz, img.rel_time, img.valid, jnp.asarray(scan_start_time),
            imu_integral, scan_period=cfg.sensor.scan_period)
        xyz = dsk.xyz
    return feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat,
                                     xyz_deskewed=xyz)


def process_scan_with_imu(
    points, valid, ring, cfg: PipelineConfig,
    imu_integral: deskew_ops.ImuIntegral, scan_start_time,
):
    """Frontend + de-skew, also returning the de-skew metadata needed for the
    IMU-seeded initial guess (updateInitialGuess, featureAssociation.cpp:
    1639-1664) and the mapping attitude blend."""
    img = projection.project_scan(points, valid, cfg.sensor, ring=ring)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    dsk = deskew_ops.deskew_image(
        img.xyz, img.rel_time, img.valid, jnp.asarray(scan_start_time),
        imu_integral, scan_period=cfg.sensor.scan_period)
    feats = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat,
                                      xyz_deskewed=dsk.xyz)
    return feats, dsk


def imu_xi_seed(dsk: deskew_ops.DeskewResult, scan_period: float) -> jax.Array:
    """Initial-guess twist from IMU: rotation = integrated gyro over the scan,
    translation = scan-start velocity (sensor frame) x scan period."""
    R_s = se3.euler_zyx_to_mat(dsk.rpy_start[0], dsk.rpy_start[1],
                               dsk.rpy_start[2])
    v_sensor = R_s.T @ dsk.velo_start
    return jnp.concatenate([dsk.ang_delta, v_sensor * scan_period])


class OdometryOutput(NamedTuple):
    pose: Pose
    diag: OdometryDiag


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry_scan_step(
    state: OdometryState,
    points: jax.Array,
    valid: jax.Array,
    ring: jax.Array,
    cfg: PipelineConfig,
) -> Tuple[OdometryState, OdometryOutput]:
    """Fused frontend + odometry for one scan (the flagship single-chip step)."""
    feats = process_scan(points, valid, ring, cfg)
    new_state, pose, diag = odom.odometry_step(state, feats, cfg.odom)
    return new_state, OdometryOutput(pose=pose, diag=diag)


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry_scan_block(
    state: OdometryState,
    points: jax.Array,   # (B, P, 3)
    valid: jax.Array,    # (B, P)
    ring: jax.Array,     # (B, P)
    cfg: PipelineConfig,
) -> Tuple[OdometryState, OdometryOutput]:
    """Process a BLOCK of B scans sequentially inside one XLA program.

    Identical math and results to B calls of ``odometry_scan_step`` — the
    block amortizes the per-execution dispatch overhead B-fold.  Streaming (B=1) stays
    available for latency-critical use; throughput benchmarks and offline
    mapping use B=8..32.
    """
    def body(st, scan):
        pts, v, r = scan
        st2, out = _scan_step_core(st, pts, v, r, cfg)
        return st2, out

    return jax.lax.scan(body, state, (points, valid, ring))


def _scan_step_core(state, pts, v, r, cfg):
    feats = process_scan(pts, v, r, cfg)
    new_state, pose, diag = odom.odometry_step(state, feats, cfg.odom)
    return new_state, OdometryOutput(pose=pose, diag=diag)


class SlamState(NamedTuple):
    odom: OdometryState
    mapping: "object"   # mapping.MapState (kept loose to avoid cyclic import)
    loops: "object"     # posegraph.LoopFactors


class SlamOutput(NamedTuple):
    odom_pose: Pose     # 10 Hz odometry pose (/laser_odom_to_init)
    mapped_pose: Pose   # latest mapped pose (/aft_mapped_to_init)
    fused_pose: Pose    # odometry rate + mapping accuracy (/integrated_to_init)
    diag: OdometryDiag


def init_slam_state(cfg: PipelineConfig) -> SlamState:
    from . import mapping as mapping_mod
    from . import posegraph as pg_mod

    return SlamState(
        odom=odom.init_state(cfg.odom, cfg.feat),
        mapping=mapping_mod.init_state(cfg.mapping),
        loops=pg_mod.init_loop_factors(cfg.posegraph.max_loop_factors))


def slam_scan_step(
    state: SlamState,
    points: jax.Array,
    valid: jax.Array,
    ring: jax.Array,
    cfg: PipelineConfig,
    scan_time: jax.Array | float,
    run_mapping: bool,
    run_loop: bool = False,
    imu_integral: Optional[deskew_ops.ImuIntegral] = None,
    bootstrap: bool = False,
):
    """One full SLAM step.  ``run_mapping``/``run_loop`` are STATIC host-side
    decisions (the reference's 2-frame feed + 0.3 s mapping throttle and 1 Hz
    loop-closure thread collapsed into cadence counters), so each step variant
    jits into its own program and the common case stays cheap.

    ``bootstrap`` (STATIC; drivers pass it on scan index 1, the first scan
    with a reference cloud): re-seed and re-solve the odometry twice before
    the final solve.  The constant-velocity prior starts at zero, so the
    damped compressed schedule recovers only ~72% of the first scan's motion
    in one call — at fast per-scan motion (0.8 m/scan circuit course) the
    residual bakes a ~1 m / 1 deg transient into the first keyframes.
    Measured: circuit err@scan50 1.52 -> 0.81 m, end drift 2.36 -> 1.60 m;
    slow starts unaffected.  One extra program variant, compiled once."""
    from . import fusion as fusion_mod
    from . import loopclosure as loop_mod
    from . import mapping as mapping_mod

    imu_rpy_end = None
    if imu_integral is not None:
        feats, dsk = process_scan_with_imu(points, valid, ring, cfg,
                                           imu_integral, scan_time)
        # Rotation seed from the gyro; translation keeps the constant-velocity
        # prior (the IMU "velocity" is integration-from-rest deviation only —
        # the reference seeds translation from it anyway,
        # featureAssociation.cpp:1657-1663, which is strictly worse).
        seed = imu_xi_seed(dsk, cfg.sensor.scan_period)
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
        out = OdometryOutput(pose=pose, diag=diag)
        imu_rpy_end = dsk.rpy_start + dsk.ang_delta
    elif bootstrap:
        feats = process_scan(points, valid, ring, cfg)
        xi_seed = state.odom.xi
        for _ in range(2):
            ns, _, _ = odom.odometry_step(state.odom, feats, cfg.odom,
                                          xi_seed=xi_seed)
            xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(state.odom, feats,
                                                    cfg.odom, xi_seed=xi_seed)
        out = OdometryOutput(pose=pose, diag=diag)
    else:
        odom_state, out = odometry_scan_step(state.odom, points, valid, ring,
                                             cfg)
    map_state = state.mapping
    loops = state.loops
    if run_mapping:
        map_state, mapped_pose, _mdiag = mapping_mod.mapping_step(
            map_state, odom_state.last_corner, odom_state.last_surf,
            odom_state.last_outlier, out.pose, jnp.asarray(scan_time),
            cfg.mapping, imu_rpy=imu_rpy_end,
            ground_cloud=odom_state.last_flat)
    if run_loop and cfg.loop.enabled:
        kf, loops, corrected, ldiag = loop_mod.close_and_correct(
            map_state.kf, loops, cfg.loop, cfg.posegraph)
        # correctPoses: adopt the corrected store and re-anchor the mapping
        # correction at the corrected latest pose (mapOptmization.cpp:1429-1478).
        t_aft = jax.tree.map(
            lambda a, b: jnp.where(ldiag.closed, a, b), corrected,
            map_state.t_aft)
        # A closed loop moves keyframe poses, so the world-frame submap cache
        # no longer matches the store -> force a rebuild next mapping step
        # (the reference likewise invalidates its transformed-cloud cache,
        # mapOptmization.cpp:1456-1478).
        cache = map_state.cache._replace(
            stale=map_state.cache.stale | ldiag.closed)
        map_state = map_state._replace(kf=kf, t_aft=t_aft, cache=cache)
    fused = fusion_mod.fuse(out.pose, map_state.t_bef, map_state.t_aft)
    return SlamState(odom=odom_state, mapping=map_state, loops=loops), \
        SlamOutput(
            odom_pose=out.pose, mapped_pose=map_state.t_aft, fused_pose=fused,
            diag=out.diag)


@functools.partial(jax.jit, static_argnames=("cfg", "run_loop", "bootstrap"))
def slam_scan_block(
    state: SlamState,
    points: jax.Array,     # (B, P, 3) — B consecutive scans
    valid: jax.Array,      # (B, P)
    ring: jax.Array,       # (B, P)
    cfg: PipelineConfig,
    scan_times: jax.Array,  # (B,)
    run_loop: bool = False,
    imu_integrals: Optional[deskew_ops.ImuIntegral] = None,  # (B, L) leaves
    bootstrap: bool = False,
):
    """B consecutive SLAM scans fused into ONE XLA program.

    With ``B = cfg.mapping_every`` this is exactly the reference cadence —
    scan-to-map runs on the first scan of each block (the 0.3 s
    ``mappingProcessInterval``), odometry + fusion run for every scan — and
    the outputs are numerically equivalent to B streaming ``slam_scan_step``
    calls with ``run_mapping=(position == 0)`` (same math; XLA may
    reassociate float ops across the different compile boundaries — verified
    to 1e-5 in tests/test_slam_block.py).  The packing amortizes the
    per-program dispatch overhead ~2(B+1)/(B+2)-fold (streaming launches
    odometry + fusion per scan plus mapping per block; this launches one
    program per block).  Loop closure, when requested, runs once after the
    block's mapping step.  ``imu_integrals`` (each leaf stacked on a leading
    B axis) enables the full IMU path per scan — de-skew, gyro-seeded guess,
    mapping attitude blend — matching B streaming steps with
    ``imu_integral`` set.  ``bootstrap`` (STATIC): pass True for the FIRST
    block of a run — applies the scan-1 double-resolve exactly as the
    streaming driver does (``slam_scan_step(bootstrap=...)``), keeping block
    and streaming trajectories equivalent on fast starts.  The double-resolve
    targets the block's LOCAL scan 1, so bootstrap requires B >= 2 — with
    B == 1 the first block holds only scan 0 and the re-solve would be lost."""
    if bootstrap and points.shape[0] < 2:
        raise ValueError(
            "slam_scan_block(bootstrap=True) needs a block of >= 2 scans "
            "(the double-resolve applies to scan index 1; a 1-scan first "
            "block would silently skip it — use the streaming driver)")
    from . import fusion as fusion_mod
    from . import loopclosure as loop_mod
    from . import mapping as mapping_mod

    odom_state = state.odom
    map_state = state.mapping
    loops = state.loops
    outs = []
    for j in range(points.shape[0]):
        imu_rpy_end = None
        imu_rot = None
        if imu_integrals is not None:
            integ_j = jax.tree.map(lambda a: a[j], imu_integrals)
            feats, dsk = process_scan_with_imu(points[j], valid[j], ring[j],
                                               cfg, integ_j, scan_times[j])
            seed = imu_xi_seed(dsk, cfg.sensor.scan_period)
            xi_seed = jnp.concatenate([seed[:3], odom_state.xi[3:]])
            imu_rot = dsk.ang_delta
            imu_rpy_end = dsk.rpy_start + dsk.ang_delta
        else:
            feats = process_scan(points[j], valid[j], ring[j], cfg)
            xi_seed = odom_state.xi
        if bootstrap and j == 1:
            # Scan-1 double-resolve (see slam_scan_step's bootstrap doc).
            for _ in range(2):
                ns, _, _ = odom.odometry_step(odom_state, feats, cfg.odom,
                                              xi_seed=xi_seed,
                                              imu_rot=imu_rot)
                xi_seed = ns.xi
        odom_state, pose, diag = odom.odometry_step(
            odom_state, feats, cfg.odom, xi_seed=xi_seed, imu_rot=imu_rot)
        if j == 0:
            map_state, _mapped, _mdiag = mapping_mod.mapping_step(
                map_state, odom_state.last_corner, odom_state.last_surf,
                odom_state.last_outlier, pose, scan_times[j], cfg.mapping,
                imu_rpy=imu_rpy_end,
                ground_cloud=odom_state.last_flat)
            if run_loop and cfg.loop.enabled:
                kf, loops, corrected, ldiag = loop_mod.close_and_correct(
                    map_state.kf, loops, cfg.loop, cfg.posegraph)
                t_aft = jax.tree.map(
                    lambda a, b: jnp.where(ldiag.closed, a, b), corrected,
                    map_state.t_aft)
                cache = map_state.cache._replace(
                    stale=map_state.cache.stale | ldiag.closed)
                map_state = map_state._replace(kf=kf, t_aft=t_aft,
                                               cache=cache)
        fused = fusion_mod.fuse(pose, map_state.t_bef, map_state.t_aft)
        outs.append(SlamOutput(odom_pose=pose, mapped_pose=map_state.t_aft,
                               fused_pose=fused, diag=diag))
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
    return SlamState(odom=odom_state, mapping=map_state, loops=loops), stacked


def maybe_decimate(state: SlamState, cfg: PipelineConfig, margin: int = 16):
    """Host-side keyframe-store saturation guard.

    When ``count`` is within ``margin`` of ``max_keyframes``, decimate the
    store (``mapping.decimate_keyframes``: keep the anchor + recent +
    every 2nd older keyframe) and mark the submap cache stale.  Drivers call
    this at a convenient cadence (the ``count`` read syncs to host — keep it
    off the per-scan hot path); ``margin`` must cover the keyframes that can
    accrete between checks (~1 per mapping step).  Returns
    ``(state, decimated)``."""
    from . import mapping as mapping_mod

    cap = cfg.mapping.max_keyframes
    if int(state.mapping.kf.count) < cap - margin:
        return state, False
    kf, loops = mapping_mod.decimate_keyframes(
        state.mapping.kf, state.loops,
        keep_recent=cfg.mapping.decimate_keep_recent)
    cache = state.mapping.cache._replace(stale=jnp.array(True))
    return state._replace(
        mapping=state.mapping._replace(kf=kf, cache=cache),
        loops=loops), True


class LoopScheduler:
    """Loop-closure attempt cadence on DATA time.

    The reference runs closure attempts from a 1 Hz wall-clock thread
    (``mapOptmization.cpp:802-812``); a deterministic replay has no wall
    clock, so attempts are scheduled by scan timestamp: one attempt each time
    ``cfg.loop.cadence`` seconds of data have elapsed since the previous
    attempt.  Host-side (the decision becomes the static ``run_loop`` flag),
    so cadence changes never recompile the common no-loop step."""

    def __init__(self, cfg: PipelineConfig):
        self.cadence = cfg.loop.cadence
        self.enabled = cfg.loop.enabled
        self._last: float | None = None

    def due(self, scan_time: float) -> bool:
        if not self.enabled:
            return False
        if self._last is None:
            # First scan arms the timer; no attempt before one full period
            # (matches the reference thread's initial sleep).
            self._last = scan_time
            return False
        if scan_time - self._last >= self.cadence:
            self._last = scan_time
            return True
        return False


def run_slam_sequence(scans, cfg: PipelineConfig, times=None):
    """Host driver for the full pipeline; returns fused trajectory."""
    state = init_slam_state(cfg)
    sched = LoopScheduler(cfg)
    fused_R, fused_t = [], []
    for k, (pts, valid, ring) in enumerate(scans):
        t = float(k) * cfg.sensor.scan_period if times is None else times[k]
        state, out = slam_scan_step(
            state, pts, valid, ring, cfg, t,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=sched.due(t), bootstrap=(k == 1))
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        if k % 32 == 31:
            state, _ = maybe_decimate(state, cfg)
    return Pose(jnp.stack(fused_R), jnp.stack(fused_t)), state


def run_odometry_sequence(scans, cfg: PipelineConfig):
    """Host driver: iterate (points, valid, ring) triples, return stacked
    world poses.  ``scans`` is an iterable; each element stays on device."""
    state = odom.init_state(cfg.odom, cfg.feat)
    poses_R, poses_t = [], []
    diags = []
    for pts, valid, ring in scans:
        state, out = odometry_scan_step(state, pts, valid, ring, cfg)
        poses_R.append(out.pose.R)
        poses_t.append(out.pose.t)
        diags.append(out.diag)
    poses = Pose(jnp.stack(poses_R), jnp.stack(poses_t))
    return poses, diags
