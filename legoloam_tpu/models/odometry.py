"""Two-step LM scan-to-scan odometry — the FeatureAssociation solver rebuilt.

Reference behavior: ``src/featureAssociation.cpp:1044-1725``
(``findCorrespondingSurfFeatures/CornerFeatures``, ``calculateTransformationSurf/
Corner``, ``updateTransformation``, ``integrateTransformation``).

Design:
  * The scan motion is a single se(3) twist ξ: a point measured at scan
    fraction s has scan-start coordinates exp(s·ξ)·p.  This replaces the
    reference's inverse-warp Euler 6-vector ``transformCur`` and its per-point
    trig cascade ``TransformToStart`` (featureAssociation.cpp:854-877) with one
    batched Rodrigues evaluation.
  * LeGO-LOAM's signature two-step solve is kept exactly: step A uses
    ground/planar matches to update only the ground-observable DOF
    [roll, pitch, t_z]; step B uses edge matches for [yaw, t_x, t_y]
    (camera-frame [rx, rz, ty] / [ry, tx, tz] in the reference).
  * KD-tree NN + index-window ring search becomes fused matmul+argmin kNN
    passes (ops/voxel.py); the ring-window rules (second point same-or-lower
    ring, third strictly higher, all within ±2.5 rings and 25 m²,
    featureAssociation.cpp:1163-1221) are applied by masked argmin over the
    k candidates.
  * The LM schedule is the compressed equivalent of the reference's
    (config.OdometryConfig): 5 statically-unrolled iterations at step 0.2262
    with per-iteration correspondence refresh, robust reweighting from
    iteration 1, degeneracy projection on iteration 0 (eigenvalue threshold
    10), convergence freeze at 0.1°/0.1 cm.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import OdometryConfig
from ..ops import lm, se3
from ..ops.features import FeatureCloud, ScanFeatures
from ..ops.se3 import Pose
from ..ops.voxel import class_nn, knn

_SURF_DOF = jnp.array([0, 1, 5])    # twist components [wx(roll), wy(pitch), vz]
_CORNER_DOF = jnp.array([2, 3, 4])  # [wz(yaw), vx, vy]


class OdometryState(NamedTuple):
    pose: Pose               # world pose at the latest scan end (transformSum)
    xi: jax.Array            # (6,) twist of the previous scan (const-vel prior)
    last_corner: FeatureCloud
    last_surf: FeatureCloud
    last_outlier: FeatureCloud   # pass-through for mapping (scan-end frame)
    last_flat: FeatureCloud      # ground picks (scan-end frame) — mapping's
                                 # ground-plane attitude anchor input
    initialized: jax.Array   # () bool


class OdometryDiag(NamedTuple):
    n_surf_corr: jax.Array
    n_corner_corr: jax.Array
    surf_iters: jax.Array
    corner_iters: jax.Array
    # Feature points dropped beyond the FeatureConfig caps this scan
    # ([sharp, less_sharp, flat, less_flat, outlier] — ScanFeatures.overflow,
    # surfaced here so drivers can warn; no-silent-caps discipline).
    feat_overflow: jax.Array   # (5,) int32


def init_state(odom_cfg, feat_cfg) -> OdometryState:
    def empty(cap):
        return FeatureCloud(
            xyz=jnp.zeros((cap, 3)), ring=jnp.zeros((cap,)),
            rel_time=jnp.zeros((cap,)), valid=jnp.zeros((cap,), bool))

    return OdometryState(
        pose=Pose.identity(),
        xi=jnp.zeros(6),
        last_corner=empty(feat_cfg.max_less_sharp),
        last_surf=empty(feat_cfg.max_less_flat),
        last_outlier=empty(feat_cfg.max_outlier),
        last_flat=empty(feat_cfg.max_flat),
        initialized=jnp.array(False),
    )


def _warp_to_start(xi: jax.Array, cloud: FeatureCloud) -> jax.Array:
    """p_start = exp(s ξ) p — vectorized TransformToStart."""
    p = se3.se3_exp(cloud.rel_time[:, None] * xi[None, :])
    return se3.apply(p, cloud.xyz)


def _warp_to_end(xi: jax.Array, cloud: FeatureCloud) -> FeatureCloud:
    """p_end = exp((s-1) ξ) p — vectorized TransformToEnd
    (featureAssociation.cpp:880-953, sans the IMU terms which de-skew owns)."""
    p = se3.se3_exp((cloud.rel_time[:, None] - 1.0) * xi[None, :])
    return cloud._replace(xyz=se3.apply(p, cloud.xyz),
                          rel_time=jnp.zeros_like(cloud.rel_time))


class _Corr(NamedTuple):
    """Fixed-shape correspondence set: plane/line as (normal, offset)."""

    n: jax.Array       # (F, 3) unit normal / line-distance gradient direction
    off: jax.Array     # (F,) offset: residual = n·p + off  (planes)
    t1: jax.Array      # (F, 3) line anchor 1 (corners; unused for planes)
    t2: jax.Array      # (F, 3) line anchor 2
    valid: jax.Array   # (F,)


def _find_surf_corr(p_warped, q_valid, last: FeatureCloud,
                    cfg: OdometryConfig) -> _Corr:
    """Reference findCorrespondingSurfFeatures (featureAssociation.cpp:1155-1232):
    j = NN; l = nearest same-or-lower ring; m = nearest strictly-higher ring;
    plane through (j, l, m).  Each is one fused matmul->penalty->argmin pass
    over the full reference cloud (nearest-in-ring-class, exactly the
    reference's windowed search — not a filter over k candidates)."""
    Q = p_warped.shape[0]
    gate = cfg.nearest_sq_dist
    ninf = jnp.full((1, Q), -jnp.inf)
    # Pass 1: unconstrained NN.
    d0, i0 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      ninf, -ninf, ninf, q_tile=512)
    j_ok = q_valid & (d0[0] < gate)
    ring_j = last.ring[i0[0]][None, :]        # (1, Q)
    # Passes 2+3: nearest in [ring_j-w, ring_j] excluding j (same ring class
    # contains j; a strict-distance exclusion removes it), and in
    # (ring_j, ring_j+w] (j not in class, no exclusion needed).
    lo = jnp.concatenate([ring_j - cfg.ring_window, ring_j + 0.5])
    hi = jnp.concatenate([ring_j, ring_j + cfg.ring_window])
    ex = jnp.concatenate([d0, ninf])
    d2, i2 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      lo, hi, ex, q_tile=512, n_classes=2)
    l_ok = d2[0] < gate
    m_ok = d2[1] < gate
    t1 = last.xyz[i0[0]]
    t2 = last.xyz[i2[0]]
    t3 = last.xyz[i2[1]]
    n, _ = lm.point_to_plane(p_warped, t1, t2, t3)
    off = -jnp.sum(n * t1, axis=-1)
    ok = j_ok & l_ok & m_ok
    if cfg.surf_tripod_max_dz > 0:
        # Height-consistency gate on the correspondence tripod (a
        # stabilizer; reference has none, 0 disables): step A's queries are
        # GROUND picks (featureAssociation.cpp:736-749), but the (j,l,m)
        # tripod comes from the full less-flat cloud within a 5 m search
        # radius (nearestFeatureSearchSqDist=25) — near structure bases it
        # mixes ground with wall/crate points, and the slightly-tilted
        # mixed plane couples the un-modeled along-track displacement into
        # the [pitch, roll, height] solve.  Measured on the 0.8 m/scan
        # circuit straights: -0.29 deg pitch per scan (the dominant
        # odometry drift there, corkscrewing z to +116 m over 600 scans);
        # gating tripods to a dz window kills it 22x (-0.013 deg) while
        # keeping ~80% of the correspondences (tools/diag_odo_pair.py,
        # PERF.md round 4).  Sensor-frame ground stays height-consistent on
        # slopes (the vehicle tilts with the terrain), so the gate only
        # drops genuine mixed-structure tripods.
        zs = jnp.stack([t1[:, 2], t2[:, 2], t3[:, 2]], axis=1)
        spread = zs.max(axis=1) - zs.min(axis=1)
        qz = jnp.abs(p_warped[:, 2] - t1[:, 2])
        ok = ok & (spread < cfg.surf_tripod_max_dz)             & (qz < cfg.surf_tripod_max_dz)
    return _Corr(n=n, off=off, t1=t1, t2=t3, valid=ok)


def _find_corner_corr(p_warped, q_valid, last: FeatureCloud,
                      cfg: OdometryConfig) -> _Corr:
    """Reference findCorrespondingCornerFeatures (featureAssociation.cpp:
    1044-1121): j = NN; m = nearest point on a DIFFERENT ring within ±2.5;
    line through (j, m)."""
    Q = p_warped.shape[0]
    gate = cfg.nearest_sq_dist
    ninf = jnp.full((1, Q), -jnp.inf)
    d0, i0 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      ninf, -ninf, ninf, q_tile=512)
    j_ok = q_valid & (d0[0] < gate)
    ring_j = last.ring[i0[0]][None, :]
    # Different ring within the window: search BOTH side classes and keep the
    # closer (the strictly-lower and strictly-higher ring intervals).
    lo = jnp.concatenate([ring_j - cfg.ring_window, ring_j + 0.5])
    hi = jnp.concatenate([ring_j - 0.5, ring_j + cfg.ring_window])
    ex = jnp.full((2, Q), -jnp.inf)
    d2, i2 = class_nn(p_warped, last.xyz, last.valid, last.ring,
                      lo, hi, ex, q_tile=512, n_classes=2)
    pick_low = d2[0] <= d2[1]
    dm = jnp.where(pick_low, d2[0], d2[1])
    im = jnp.where(pick_low, i2[0], i2[1])
    m_ok = dm < gate
    t1 = last.xyz[i0[0]]
    t2 = last.xyz[im]
    return _Corr(n=jnp.zeros_like(t1), off=jnp.zeros(Q),
                 t1=t1, t2=t2, valid=j_ok & m_ok)


def _residuals(p_warped, corr: _Corr, is_line: bool):
    """(direction (F,3), signed distance (F,)) for planes or lines."""
    if is_line:
        dir_, dist = lm.point_to_line(p_warped, corr.t1, corr.t2)
        return dir_, dist
    dist = jnp.sum(corr.n * p_warped, axis=-1) + corr.off
    return corr.n, dist


def _robust_weight(dist, p_warped, iter_count, cfg: OdometryConfig, is_line):
    """featureAssociation.cpp:1137-1146 (corner), 1251-1260 (surf)."""
    if is_line:
        s = 1.0 - cfg.robust_weight_scale * jnp.abs(dist)
    else:
        rng = jnp.linalg.norm(p_warped, axis=-1)
        s = 1.0 - cfg.robust_weight_scale * jnp.abs(dist) / jnp.sqrt(
            jnp.maximum(jnp.sqrt(jnp.maximum(rng, 1e-9)), 1e-9))
    s = jnp.where(iter_count >= cfg.robust_after_iter, s, 1.0)
    keep = (s > cfg.robust_weight_min) & (jnp.abs(dist) > 0)
    return jnp.where(keep, s, 0.0), keep


def _lm_loop(cloud: FeatureCloud, last: FeatureCloud, xi0, cfg: OdometryConfig,
             find_corr, dof: jax.Array, is_line: bool):
    """One of the two LM solves (surf or corner).

    STATICALLY UNROLLED: with the compressed default schedule (5 iterations,
    correspondences refreshed every iteration) a Python-unrolled loop with a
    "converged" freeze mask replaces the reference's early-exit while-loop —
    identical math, and it removes ``lax.while_loop``/``lax.cond`` from the
    program, whose every trip costs a device-to-host predicate check.
    Iterations after convergence still run but are no-ops (delta zeroed by
    the freeze mask)."""
    deg = lm.identity_degeneracy(3)
    xi = xi0
    done = jnp.array(False)
    corr = None
    n_used = jnp.int32(0)
    iters = jnp.int32(0)
    for i in range(cfg.max_iterations):
        p_warped = _warp_to_start(xi, cloud)
        if i % cfg.corr_refresh_every == 0 or corr is None:
            corr = find_corr(p_warped, cloud.valid, last, cfg)
        direction, dist = _residuals(p_warped, corr, is_line)
        w, keep = _robust_weight(dist, p_warped, i, cfg, is_line)
        row_ok = corr.valid & keep & cloud.valid & ~done
        s = cloud.rel_time[:, None]
        # Left-perturbation Jacobian scaled by the per-point warp fraction:
        # d(exp(sδ)p')/dδ = s[-[p']x | I]  ->  J_w = s (p'×n), J_v = s n.
        Jw = s * jnp.cross(p_warped, direction)
        Jv = s * direction
        J6 = jnp.concatenate([Jw, Jv], axis=1)           # (F, 6)
        J = J6[:, dof] * w[:, None]
        r = dist * w
        delta, deg = lm.solve_normal_equations(
            J, r, row_ok, cfg.step_damping, deg, i == 0,
            cfg.degeneracy_eig_thresh)
        delta = delta * ~done                            # freeze once converged
        xi = xi.at[dof].add(delta)
        rot_deg = jnp.degrees(jnp.linalg.norm(delta[:2] if not is_line
                                              else delta[:1]))
        t_cm = jnp.linalg.norm(delta[2:] if not is_line else delta[1:]) * 100.0
        n_used = jnp.where(done, n_used, jnp.sum(row_ok))
        iters = iters + jnp.where(done, 0, 1)
        done = done | ((rot_deg < cfg.conv_rot_deg)
                       & (t_cm < cfg.conv_trans_cm))
    return xi, iters, n_used


@functools.partial(jax.jit, static_argnames=("cfg",))
def odometry_step(
    state: OdometryState,
    feats: ScanFeatures,
    cfg: OdometryConfig,
    xi_seed: jax.Array | None = None,
    imu_rot: jax.Array | None = None,
) -> Tuple[OdometryState, Pose, OdometryDiag]:
    """Process one scan's features; returns (new state, world pose at scan end,
    diagnostics).  ``xi_seed`` optionally overrides the constant-velocity prior
    with an IMU-derived initial guess (updateInitialGuess,
    featureAssociation.cpp:1639-1664).  ``imu_rot`` is the gyro-integrated
    rotation increment over the scan; with
    ``cfg.imu_rotation_blend`` > 0 the solved per-scan rotation is pulled
    toward it (PluginIMURotation analogue, featureAssociation.cpp:955-1013 —
    see OdometryConfig.imu_rotation_blend)."""
    xi0 = state.xi if xi_seed is None else xi_seed

    can_solve = (
        state.initialized
        & (state.last_corner.count >= cfg.min_corner_last)
        & (state.last_surf.count >= cfg.min_surf_last)
    )

    # Step A: planar features constrain [roll, pitch, tz].
    xi_a, it_a, n_surf = _lm_loop(
        feats.flat, state.last_surf, xi0, cfg, _find_surf_corr, _SURF_DOF,
        is_line=False)
    # Step B: edge features constrain [yaw, tx, ty], starting from step A.
    xi_b, it_b, n_corner = _lm_loop(
        feats.sharp, state.last_corner, xi_a, cfg, _find_corner_corr,
        _CORNER_DOF, is_line=True)

    xi = jnp.where(can_solve, xi_b, xi0)

    # PluginIMURotation analogue: blend the solved rotation increment toward
    # the gyro-integrated one (small angles, ~5e-2 rad — linear blend of the
    # rotation vectors matches the exact log/exp blend to O(angle^3)).
    if imu_rot is not None and cfg.imu_rotation_blend > 0:
        b = cfg.imu_rotation_blend
        xi = xi.at[:3].set((1.0 - b) * xi[:3] + b * imu_rot)

    # integrateTransformation (featureAssociation.cpp:1697-1725):
    # world pose advances by the scan motion.  so3_project keeps the
    # ACCUMULATED rotation orthonormal: per-compose f32 rounding would
    # otherwise random-walk over 20K-scan runs (see se3.so3_project).
    motion = se3.se3_exp(xi)
    integrated = se3.compose(state.pose, motion)
    integrated = Pose(se3.so3_project(integrated.R), integrated.t)
    new_pose = jax.tree.map(
        lambda a, b: jnp.where(state.initialized, a, b),
        integrated, state.pose)

    # publishCloudsLast (featureAssociation.cpp:1759-1815): warp this scan's
    # broad feature sets to scan end; they become the next scan's reference.
    # The warp twist is damped toward the previous scan's twist (see
    # OdometryConfig.warp_blend) to break the estimation-error feedback
    # oscillation the reference's own-transform warp creates.
    xi_warp = cfg.warp_blend * xi + (1.0 - cfg.warp_blend) * state.xi
    xi_warp = jnp.where(state.initialized, xi_warp, xi)
    last_corner = _warp_to_end(xi_warp, feats.less_sharp)
    last_surf = _warp_to_end(xi_warp, feats.less_flat)
    last_outlier = _warp_to_end(xi_warp, feats.outlier)
    last_flat = _warp_to_end(xi_warp, feats.flat)

    new_state = OdometryState(
        pose=new_pose,
        xi=xi,
        last_corner=last_corner,
        last_surf=last_surf,
        last_outlier=last_outlier,
        last_flat=last_flat,
        initialized=jnp.array(True),
    )
    diag = OdometryDiag(n_surf_corr=n_surf, n_corner_corr=n_corner,
                        surf_iters=it_a, corner_iters=it_b,
                        feat_overflow=feats.overflow)
    return new_state, new_pose, diag
