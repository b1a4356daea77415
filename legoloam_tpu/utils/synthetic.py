"""Synthetic LiDAR worlds: ray-cast VLP-16-style scans with ground-truth poses.

The reference ecosystem validates by playing rosbags of real Velodyne data and
eyeballing RViz (reference: ``README.md:90-106``); no datasets ship with this
environment, so we generate scans by ray casting against parametric scenes
(ground plane + axis-aligned box "walls/buildings" + vertical cylinder "poles"
+ optional range noise).  Ground truth poses make ATE exact.

Ray casting is jitted and vmapped over all N_SCAN*H rays — generating a scan is
a few hundred microseconds, so 1K-scan sequences are cheap even in tests.

Scan point order mimics a real Velodyne: the head spins clockwise (azimuth from
+x decreasing), one column (all rings) per firing, so per-point time increases
with emission index — exactly the assumption behind the reference's
``findStartEndAngle`` / ``adjustDistortion`` timing recovery
(``src/imageProjection.cpp:199-209``, ``src/featureAssociation.cpp:504-522``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SensorConfig
from ..ops import se3
from ..ops.se3 import Pose

MAX_RANGE = 100.0


class Scene(NamedTuple):
    """Axis-aligned boxes (K, 6) [xmin ymin zmin xmax ymax zmax], vertical
    cylinders (M, 4) [cx cy radius height], ground plane z = 0."""

    boxes: jax.Array
    cylinders: jax.Array


def default_scene() -> Scene:
    """A small urban block: walls, building corners, poles. Rich in both planar
    (ground/walls) and edge (corners/poles) features."""
    boxes = np.array(
        [
            # Perimeter walls of a ~50x40 m courtyard (0.4 m thick, 3 m tall)
            [-25.0, -20.0, 0.0, 25.0, -19.6, 3.0],
            [-25.0, 19.6, 0.0, 25.0, 20.0, 3.0],
            [-25.0, -20.0, 0.0, -24.6, 20.0, 3.0],
            [24.6, -20.0, 0.0, 25.0, 20.0, 3.0],
            # Interior buildings
            [5.0, 5.0, 0.0, 12.0, 12.0, 4.0],
            [-14.0, 6.0, 0.0, -8.0, 14.0, 5.0],
            [-12.0, -14.0, 0.0, -4.0, -8.0, 3.5],
            [10.0, -12.0, 0.0, 18.0, -6.0, 4.5],
            # Low blocks / planters
            [-2.0, 15.0, 0.0, 2.0, 17.0, 1.0],
            [-20.0, -4.0, 0.0, -18.0, 0.0, 1.2],
        ],
        np.float32,
    )
    cyl = np.array(
        [
            [3.0, -3.0, 0.15, 4.0],
            [-5.0, 2.0, 0.2, 5.0],
            [15.0, 3.0, 0.15, 4.0],
            [-16.0, -10.0, 0.18, 4.5],
            [0.0, 9.0, 0.15, 4.0],
            [20.0, 14.0, 0.2, 5.0],
            [-20.0, 12.0, 0.15, 4.0],
            [8.0, -16.0, 0.15, 4.0],
        ],
        np.float32,
    )
    return Scene(boxes=jnp.asarray(boxes), cylinders=jnp.asarray(cyl))


def loop_scene() -> Scene:
    """A large block designed for LONG trajectories: a collision-free ring
    lane of radius ~30 m around (0, 30) — matching ``circle_trajectory``,
    which circles through (0, 0) -> (0, 2r) — with buildings inside and
    outside the lane and poles alongside it, so every scan sees both planar
    and edge features.  ``default_scene``'s 50x40 m courtyard cannot host a
    full revisit loop (a radius > ~8 m circle clips its walls/buildings)."""
    cx, cy = 0.0, 30.0
    boxes = [
        # Perimeter walls, 90 x 90 m, 4 m tall
        [-45.0, -15.0, 0.0, 45.0, -14.6, 4.0],
        [-45.0, 74.6, 0.0, 45.0, 75.0, 4.0],
        [-45.0, -15.0, 0.0, -44.6, 75.0, 4.0],
        [44.6, -15.0, 0.0, 45.0, 75.0, 4.0],
        # Central block (inside the lane, r < 20 from the lane center)
        [cx - 9.0, cy - 8.0, 0.0, cx + 9.0, cy + 8.0, 6.0],
        [cx - 16.0, cy + 10.0, 0.0, cx - 10.0, cy + 16.0, 4.0],
        [cx + 10.0, cy - 17.0, 0.0, cx + 17.0, cy - 10.0, 5.0],
        # Outer-corner buildings (outside the lane, r > 38)
        [-43.0, -13.0, 0.0, -32.0, -2.0, 5.0],
        [32.0, -13.0, 0.0, 43.0, -4.0, 4.5],
        [-43.0, 62.0, 0.0, -33.0, 73.0, 5.5],
        [31.0, 63.0, 0.0, 43.0, 73.0, 4.0],
    ]
    # Poles flanking the lane: rings at r=23 and r=37 from the lane center,
    # every 10 deg (offset on the outer ring).  Real outdoor scans (the
    # reference's Stevens dataset is dense foliage) carry hundreds of edge
    # features per scan; a pole every 30 deg starved the corner map and made
    # the ring world's rotational symmetry a free gauge mode.
    cyl = []
    for k in range(36):
        a = np.radians(10.0 * k)
        cyl.append([cx + 23.0 * np.cos(a), cy + 23.0 * np.sin(a), 0.18, 5.0])
        b = a + np.radians(5.0)
        cyl.append([cx + 37.0 * np.cos(b), cy + 37.0 * np.sin(b), 0.18, 5.0])
    # Crates/pillars scattered along both sides of the lane (deterministic
    # pseudo-random sizes/offsets): dense vertical-edge structure at close
    # range, breaking the ring symmetry at fine granularity.
    rng = np.random.RandomState(7)
    for k in range(28):
        a = np.radians(360.0 / 28 * k + 6.0 * rng.rand())
        r = 20.5 if k % 2 == 0 else 39.5
        bx = cx + r * np.cos(a)
        by = cy + r * np.sin(a)
        w = 0.6 + 1.2 * rng.rand()
        d = 0.6 + 1.2 * rng.rand()
        hgt = 0.8 + 2.2 * rng.rand()
        boxes.append([bx - w / 2, by - d / 2, 0.0,
                      bx + w / 2, by + d / 2, hgt])
    return Scene(boxes=jnp.asarray(np.array(boxes, np.float32)),
                 cylinders=jnp.asarray(np.array(cyl, np.float32)))


def circuit_scene(half: float = 100.0) -> Scene:
    """A perimeter-circuit world LARGER than the mapping submap radius.

    The ``loop_scene`` ring (90x90 m) always keeps the whole map within the
    50 m surrounding-keyframes radius, so scan-to-map continuously re-aligns
    to old keyframes and explicit loop closure never has residual drift to
    fix.  This course is a rounded-square lane of half-size ``half`` (e.g.
    100 -> a ~766 m circuit): once the vehicle is a side away, the start-area
    keyframes are ~200 m out of range, drift accumulates on fresh terrain,
    and the return to start is a REAL loop-closure event — the reference's
    Stevens-dataset regime (reference ``README.md:104-106``).

    Geometry: outer wall square at half+12, inner wall square at half-12
    (a 24 m lane), poles + crates along both lane edges for edge features.
    Use with ``circuit_trajectory(n, half=half)``."""
    ho, hi = half + 12.0, half - 12.0
    t = 0.4          # wall thickness
    boxes = [
        # outer walls (4 m tall)
        [-ho, -ho, 0.0, ho, -ho + t, 4.0],
        [-ho, ho - t, 0.0, ho, ho, 4.0],
        [-ho, -ho, 0.0, -ho + t, ho, 4.0],
        [ho - t, -ho, 0.0, ho, ho, 4.0],
        # inner block walls (5 m tall)
        [-hi, -hi, 0.0, hi, -hi + t, 5.0],
        [-hi, hi - t, 0.0, hi, hi, 5.0],
        [-hi, -hi, 0.0, -hi + t, hi, 5.0],
        [hi - t, -hi, 0.0, hi, hi, 5.0],
    ]
    cyl = []
    rng = np.random.RandomState(11)
    # Poles + crates along both lane edges, ~every 8 m of perimeter.
    for side in range(4):
        n_feat = max(10, int(half / 4))      # ~one every 8 m of side length
        for k in range(n_feat):
            u = -half + (2.0 * half) * (k + 0.5) / n_feat
            for r, jitter in ((half - 8.0, 1.5), (half + 8.0, 1.5)):
                uu = u + jitter * (rng.rand() - 0.5) * 4.0
                if side == 0:
                    x, y = uu, -r
                elif side == 1:
                    x, y = r, uu
                elif side == 2:
                    x, y = -uu, r
                else:
                    x, y = -r, -uu
                if rng.rand() < 0.6:
                    cyl.append([x, y, 0.18, 4.0 + 2.0 * rng.rand()])
                else:
                    w = 0.6 + 1.2 * rng.rand()
                    d = 0.6 + 1.2 * rng.rand()
                    boxes.append([x - w / 2, y - d / 2, 0.0,
                                  x + w / 2, y + d / 2,
                                  0.8 + 2.0 * rng.rand()])
    return Scene(boxes=jnp.asarray(np.array(boxes, np.float32)),
                 cylinders=jnp.asarray(np.array(cyl, np.float32)))


def circuit_trajectory(n_scans: int, half: float = 100.0,
                       corner: float = 18.0, step: float = 0.8,
                       height: float = 0.8) -> Pose:
    """Poses along the rounded-square lane centerline of ``circuit_scene``
    (counter-clockwise, yaw tangent to the path), ``step`` meters per scan.
    One lap = 4*(2*(half-corner)) + 2*pi*corner meters (~766 m at the
    defaults -> ~957 scans/lap)."""
    L = half - corner                       # straight half-length
    seg = 2.0 * L                           # straight length
    arc = 0.5 * np.pi * corner              # quarter-corner length
    P = 4.0 * (seg + arc)
    s = (np.arange(n_scans, dtype=np.float64) * step) % P
    x = np.zeros(n_scans)
    y = np.zeros(n_scans)
    yaw = np.zeros(n_scans)
    for i, si in enumerate(s):
        q, r = divmod(si, seg + arc)        # quadrant 0..3, offset within
        q = int(q)
        if r < seg:                         # straight
            u = -L + r
            px, py, hd = u, -half, 0.0
        else:                               # corner arc
            a = (r - seg) / corner          # 0..pi/2
            cxx, cyy = L, -L                # corner center (quadrant 0)
            px = cxx + corner * np.sin(a)
            py = -half + corner * (1.0 - np.cos(a))
            # recenter: arc from (L,-half) toward (half,-L)
            px = L + corner * np.sin(a)
            py = -half + corner * (1.0 - np.cos(a))
            hd = a
        # rotate by quadrant (90 deg each)
        for _ in range(q):
            px, py = -py, px
            hd += 0.5 * np.pi
        x[i], y[i], yaw[i] = px, py, hd
    t = jnp.asarray(np.stack([x, y, np.full_like(x, height)], axis=-1),
                    jnp.float32)
    R = se3.rot_z(jnp.asarray(yaw, jnp.float32))
    return Pose(R, t)


def _ray_ground(o, d):
    """Intersection with plane z=0; +inf if none."""
    s = -o[2] / jnp.where(jnp.abs(d[2]) < 1e-9, 1e-9, d[2])
    return jnp.where((s > 0) & (d[2] < 0), s, jnp.inf)


def _ray_boxes(o, d, boxes):
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-9, 1e-9, d)
    t0 = (boxes[:, :3] - o) * inv
    t1 = (boxes[:, 3:] - o) * inv
    tmin = jnp.max(jnp.minimum(t0, t1), axis=1)
    tmax = jnp.min(jnp.maximum(t0, t1), axis=1)
    hit = (tmax >= tmin) & (tmax > 0)
    s = jnp.where(tmin > 0, tmin, tmax)  # inside-the-box rays exit through tmax
    return jnp.min(jnp.where(hit, s, jnp.inf))


def _ray_cylinders(o, d, cyl):
    ox, oy = o[0] - cyl[:, 0], o[1] - cyl[:, 1]
    dx, dy = d[0], d[1]
    a = dx * dx + dy * dy
    b = 2 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[:, 2] ** 2
    disc = b * b - 4 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    a_safe = jnp.where(a < 1e-12, 1e-12, a)
    s0 = (-b - sq) / (2 * a_safe)
    s1 = (-b + sq) / (2 * a_safe)
    s = jnp.where(s0 > 0, s0, s1)
    z = o[2] + s * d[2]
    hit = (disc > 0) & (s > 0) & (z >= 0) & (z <= cyl[:, 3])
    return jnp.min(jnp.where(hit, s, jnp.inf))


def _cast_one(o, d, scene: Scene):
    s = jnp.minimum(_ray_ground(o, d), _ray_boxes(o, d, scene.boxes))
    s = jnp.minimum(s, _ray_cylinders(o, d, scene.cylinders))
    return s


def _ray_dirs(sensor: SensorConfig) -> jax.Array:
    """Local-frame unit directions in EMISSION order: (H*N_SCAN, 3).
    Column c fires at azimuth psi = -(c_time) * res (clockwise spin); the
    projection's column formula maps psi back to image column
    (imageProjection.cpp:233-242)."""
    h, n = sensor.horizon_scan, sensor.n_scan
    # Elevation of ring r: bottom ring at -ang_bottom (+0.1 fudge in config).
    elev = jnp.radians(
        -sensor.ang_bottom_deg + sensor.ang_res_y_deg * jnp.arange(n)
    )
    # Emission k-th column has azimuth starting at +pi going clockwise.
    psi = jnp.radians(180.0 - sensor.ang_res_x_deg * jnp.arange(h))
    ce, se_ = jnp.cos(elev), jnp.sin(elev)
    cp, sp = jnp.cos(psi), jnp.sin(psi)
    # (h, n, 3): all rings fire per column step.
    dirs = jnp.stack(
        [
            cp[:, None] * ce[None, :],
            sp[:, None] * ce[None, :],
            jnp.broadcast_to(se_[None, :], (h, n)),
        ],
        axis=-1,
    )
    return dirs.reshape(h * n, 3)


@functools.partial(jax.jit, static_argnames=("sensor", "motion",
                                             "noise_sigma", "spin_warp"))
def raycast_scan(
    scene: Scene,
    pose: Pose,
    sensor: SensorConfig,
    noise_key: Optional[jax.Array] = None,
    noise_sigma: float = 0.0,
    next_pose: Optional[Pose] = None,
    motion: bool = False,
    spin_warp: float = 0.0,
):
    """Simulate one scan from ``pose`` (sensor frame origin).

    Returns (points (P,3) in the scan frame, valid (P,), ring (P,)) in emission
    order, P = H*N_SCAN.  If ``motion`` and ``next_pose`` are given, the sensor
    interpolates from pose to next_pose during the sweep (motion distortion, for
    de-skew testing); points are still expressed in the SCAN-START frame's
    sensor coordinates, matching what a real (un-deskewed) lidar outputs in its
    own spinning frame: each point is measured in the sensor frame at its firing
    time.

    ``spin_warp``: non-uniform rotation speed — a real spindle under load does
    not sweep azimuth linearly in time, so the azimuth-proportional per-point
    time every LOAM-style pipeline infers (``src/featureAssociation.cpp:
    504-522``; ``ops/projection.py`` rel_time) is systematically wrong by up
    to ``spin_warp`` scan-fractions.  Here the firing TIME of column u in
    [0,1] becomes  t(u) = u + spin_warp*sin(2*pi*u)/(2*pi)  (one full
    speed oscillation per revolution, ~spin_warp peak-to-peak rate change)
    while geometry stays azimuth-indexed — exactly the real-sensor mismatch.
    """
    h, n = sensor.horizon_scan, sensor.n_scan
    dirs = _ray_dirs(sensor)  # (P, 3) emission order
    p_total = h * n

    if motion and next_pose is not None:
        frac = (jnp.arange(p_total) // n).astype(jnp.float32) / h
        if spin_warp:
            frac = frac + spin_warp * jnp.sin(2.0 * jnp.pi * frac) \
                / (2.0 * jnp.pi)
        R_t = se3.so3_interp(
            jnp.broadcast_to(pose.R, (p_total, 3, 3)),
            jnp.broadcast_to(next_pose.R, (p_total, 3, 3)),
            frac,
        )
        t_t = pose.t[None] + frac[:, None] * (next_pose.t - pose.t)[None]
    else:
        R_t = jnp.broadcast_to(pose.R, (p_total, 3, 3))
        t_t = jnp.broadcast_to(pose.t, (p_total, 3))

    d_world = jnp.einsum("pij,pj->pi", R_t, dirs)
    s = jax.vmap(lambda o, d: _cast_one(o, d, scene))(t_t, d_world)
    if noise_key is not None and noise_sigma > 0:
        s = s + noise_sigma * jax.random.normal(noise_key, s.shape)
    valid = (s > sensor.min_range) & (s < MAX_RANGE)
    pts = dirs * jnp.where(valid, s, 0.0)[:, None]
    ring = jnp.tile(jnp.arange(n, dtype=jnp.int32), h)
    return pts, valid, ring


def make_imu(poses: Pose, scan_period: float = 0.1, rate_hz: float = 200.0):
    """Synthesize IMU samples along a scan-pose trajectory.

    Returns (time (L,), rpy (L, 3), acc (L, 3) specific force in sensor frame,
    gyro (L, 3) sensor-frame angular rate) at ``rate_hz``, with poses assumed
    ``scan_period`` apart.  The physics inverts what ``ops/deskew`` integrates:
    attitude from the pose spline, gyro from finite rotation differences,
    specific force = Rᵀ(a_world - g_world) with g = (0,0,-9.81).
    """
    n = poses.t.shape[0]
    total = (n - 1) * scan_period
    L = int(total * rate_hz) + 1
    ts = jnp.arange(L) / rate_hz
    seg = jnp.clip((ts / scan_period).astype(jnp.int32), 0, n - 2)
    frac = ts / scan_period - seg
    R_t = se3.so3_interp(poses.R[seg], poses.R[seg + 1], frac)
    from .. import ops
    roll, pitch, yaw = se3.mat_to_euler_zyx(R_t)
    rpy = jnp.stack([roll, pitch, yaw], axis=-1)
    # Gyro: body rate from consecutive interpolated attitudes.
    dt = 1.0 / rate_hz
    seg2 = jnp.clip(((ts + dt) / scan_period).astype(jnp.int32), 0, n - 2)
    frac2 = (ts + dt) / scan_period - seg2
    R_t2 = se3.so3_interp(poses.R[seg2], poses.R[seg2 + 1], frac2)
    gyro = se3.so3_log(jnp.swapaxes(R_t, -1, -2) @ R_t2) / dt
    # World acceleration from the position spline (piecewise-linear → zero
    # within segments, impulses at knots; smooth with a centered difference).
    pos = poses.t[seg] + frac[:, None] * (poses.t[seg + 1] - poses.t[seg])
    vel = jnp.gradient(pos, dt, axis=0)
    acc_w = jnp.gradient(vel, dt, axis=0)
    g = jnp.array([0.0, 0.0, -9.81])
    f_body = jnp.einsum("lji,lj->li", R_t, acc_w - g)  # Rᵀ(a - g)
    return ts, rpy, f_body, gyro


def circle_trajectory(n_scans: int, radius: float = 8.0, height: float = 0.8,
                      angular_rate: float = 0.02) -> Pose:
    """Batch of poses driving a circle (yaw tangent to the path)."""
    th = angular_rate * jnp.arange(n_scans)
    t = jnp.stack(
        [radius * jnp.sin(th), radius * (1 - jnp.cos(th)),
         jnp.full_like(th, height)], axis=-1)
    yaw = th
    R = se3.rot_z(yaw)
    return Pose(R, t)


def figure8_trajectory(n_scans: int, radius: float = 10.0, height: float = 0.8
                       ) -> Pose:
    """Figure-eight with a revisit through the origin — exercises loop closure."""
    th = jnp.linspace(0.0, 4.0 * jnp.pi, n_scans)
    x = radius * jnp.sin(th)
    y = radius * jnp.sin(th) * jnp.cos(th)
    t = jnp.stack([x, y, jnp.full_like(th, height)], axis=-1)
    dx = jnp.gradient(x)
    dy = jnp.gradient(y)
    yaw = jnp.arctan2(dy, dx)
    return Pose(se3.rot_z(yaw), t)
