"""Real-sensor pathology hardening (no real VLP-16 bag ships in this
environment, so the artifacts are synthesized into the replay path):

  * dropped-packet wedges (contiguous azimuth spans with no returns)
  * dead rings / sparse non-dense clouds — the reference SHUTS DOWN on
    these (``src/imageProjection.cpp:174-177`` ros::shutdown on a
    non-dense ring cloud); the rebuild must degrade gracefully instead
  * random specular dropouts
  * non-uniform spin rate (azimuth-proportional per-point time is wrong —
    the half-pass proxy assumption in ops/projection.py)
  * moving-object clusters (geometry inconsistent with ego-motion)

Acceptance: no NaNs anywhere, the pipeline keeps producing poses, and
accuracy degrades gracefully (bounded multiple of the clean run).
Reference contrast: reference ``README.md:98-106`` validates only on
clean dense bags."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic

N_SCANS = 30
N, H = DEFAULT.sensor.n_scan, DEFAULT.sensor.horizon_scan


@pytest.fixture(scope="module")
def clean_run():
    """Base scans + the clean-trajectory error to compare against."""
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(N_SCANS + 1, radius=18.0,
                                        angular_rate=0.0075)
    scans = []
    for k in range(N_SCANS):
        scans.append(synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), DEFAULT.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True))
    fused, _ = pipeline.run_slam_sequence(scans, DEFAULT)
    gt = np.asarray(poses.t[:N_SCANS]) - np.asarray(poses.t[0])
    err = np.linalg.norm(np.asarray(fused.t) - gt, axis=1)
    return scans, poses, gt, float(err.max())


def _run(scans, gt, clean_max, degrade_factor, floor=0.15):
    fused, state = pipeline.run_slam_sequence(scans, DEFAULT)
    t = np.asarray(fused.t)
    assert np.isfinite(t).all(), "NaN/inf pose under pathology"
    err = np.linalg.norm(t - gt, axis=1)
    bound = max(clean_max * degrade_factor, floor)
    assert float(err.max()) < bound, (float(err.max()), bound)
    return err


def _col_of(p_idx):
    """Emission order: index // n_scan = column."""
    return p_idx // N


def test_dropped_packet_wedges(clean_run):
    """Two 18-deg azimuth wedges of missing returns per scan (UDP packet
    loss), at scan-varying positions."""
    scans, poses, gt, clean_max = clean_run
    cols = _col_of(np.arange(N * H))
    out = []
    for k, (p, v, r) in enumerate(scans):
        w = H // 20                                  # 18 deg
        s1 = (k * 131) % H
        s2 = (s1 + H // 3) % H
        in_wedge = (((cols - s1) % H) < w) | (((cols - s2) % H) < w)
        out.append((p, v & jnp.asarray(~in_wedge), r))
    _run(out, gt, clean_max, degrade_factor=4.0)


def test_dead_rings_non_dense(clean_run):
    """Rings 3 and 11 never return (the reference's ros::shutdown case)."""
    scans, poses, gt, clean_max = clean_run
    out = []
    for p, v, r in scans:
        dead = (r == 3) | (r == 11)
        out.append((p, v & ~dead, r))
    _run(out, gt, clean_max, degrade_factor=4.0)


def test_specular_dropout(clean_run):
    """35% of returns randomly missing (wet asphalt / glass)."""
    scans, poses, gt, clean_max = clean_run
    out = []
    for k, (p, v, r) in enumerate(scans):
        keep = jax.random.uniform(jax.random.PRNGKey(k), v.shape) > 0.35
        out.append((p, v & keep, r))
    _run(out, gt, clean_max, degrade_factor=4.0)


def test_nonuniform_spin_rate(clean_run):
    """10% spin-rate oscillation: per-point firing times deviate from the
    azimuth-proportional model by up to ~1.6% of the scan period.  The
    inferred rel_time is now WRONG (as it is for the reference on a real
    spindle) — de-skew must degrade gracefully, not diverge."""
    scans, poses, gt, clean_max = clean_run
    scene = synthetic.default_scene()
    out = []
    for k in range(N_SCANS):
        out.append(synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), DEFAULT.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True,
            spin_warp=0.1))
    _run(out, gt, clean_max, degrade_factor=6.0)


def test_moving_object_cluster(clean_run):
    """A 2x3x2 m box (a car) drives through the scene against ego-motion —
    its returns are inconsistent between scans and must be outvoted by the
    static world in both LM solves."""
    scans, poses, gt, clean_max = clean_run
    base = synthetic.default_scene()
    out = []
    for k in range(N_SCANS):
        # The box crosses the courtyard at ~1.2 m/scan, opposite the path.
        bx = 15.0 - 1.2 * k
        by = -2.0 + 0.4 * k
        car = jnp.asarray([[bx, by, 0.0, bx + 3.0, by + 2.0, 2.0]],
                          jnp.float32)
        scene = base._replace(boxes=jnp.concatenate([base.boxes, car]))
        out.append(synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), DEFAULT.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True))
    _run(out, gt, clean_max, degrade_factor=6.0)


def test_everything_at_once(clean_run):
    """All pathologies stacked: wedges + dead ring + dropout + noise."""
    scans, poses, gt, clean_max = clean_run
    scene = synthetic.default_scene()
    cols = _col_of(np.arange(N * H))
    out = []
    for k in range(N_SCANS):
        p, v, r = synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), DEFAULT.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True,
            spin_warp=0.05, noise_key=jax.random.PRNGKey(k),
            noise_sigma=0.02)
        w = H // 24
        s1 = (k * 173) % H
        in_wedge = ((cols - s1) % H) < w
        keep = jax.random.uniform(jax.random.PRNGKey(1000 + k), v.shape) > 0.2
        v = v & jnp.asarray(~in_wedge) & keep & (r != 7)
        out.append((p, v, r))
    _run(out, gt, clean_max, degrade_factor=8.0, floor=0.3)
