"""config.REFERENCE — the reference-exact preset — must run end-to-end.

This makes the "set X to reproduce the reference" notes in config.py
executable: picks 2/20/4 (featureAssociation.cpp:709,711,747), the LM
schedule 25 iterations / refresh every 5 / step damping 0.05 / robust
weights after iteration 5 (featureAssociation.cpp:1163,1251,1321),
warp_blend 1.0 (featureAssociation.cpp:885), scan-to-map correspondence
refresh every iteration (mapOptmization.cpp:1093-1227), and every added
stabilizer (min_lm_keyframes / trust region / odometry prior / ground
anchor) OFF, as in the reference.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT, REFERENCE
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import metrics, synthetic


def test_reference_preset_values():
    """The preset flips exactly the documented knobs."""
    assert REFERENCE.feat.edge_per_section == 2
    assert REFERENCE.feat.edge_less_per_section == 20
    assert REFERENCE.feat.surf_per_section == 4
    assert REFERENCE.odom.max_iterations == 25
    assert REFERENCE.odom.corr_refresh_every == 5
    assert REFERENCE.odom.step_damping == 0.05
    assert REFERENCE.odom.robust_after_iter == 5
    assert REFERENCE.odom.warp_blend == 1.0
    assert REFERENCE.mapping.corr_refresh_every == 1
    assert REFERENCE.mapping.min_lm_keyframes == 0
    assert REFERENCE.mapping.max_step_trans == 0.0
    assert REFERENCE.mapping.prior_trans_std == 0.0
    assert REFERENCE.mapping.ground_anchor == 0.0
    # Shared constants stay at the reference values (utility.h:104-136).
    assert REFERENCE.loop.enabled == DEFAULT.loop.enabled is False
    assert REFERENCE.mapping.keyframe_dist == 0.3
    assert REFERENCE.sensor == DEFAULT.sensor


def _ref_cfg():
    return REFERENCE.replace(mapping=dataclasses.replace(
        REFERENCE.mapping, max_keyframes=128, submap_corner_cap=8192,
        submap_surf_cap=16384, scan_corner_cap=1024, scan_surf_cap=4096))


def test_reference_preset_smoke():
    """Default-tier: one mapping cadence of full SLAM under the
    reference-exact configuration compiles and stays finite (the 33-scan
    accuracy run is the slow-tier test below)."""
    cfg = _ref_cfg()
    scene = synthetic.default_scene()
    n = 5
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    state = pipeline.init_slam_state(cfg)
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scan = synthetic.raycast_scan(scene, pk, cfg.sensor, next_pose=nxt,
                                      motion=k + 1 < n)
        state, out = pipeline.slam_scan_step(
            state, *scan, cfg, k * 0.1,
            run_mapping=(k % cfg.mapping_every == 0))
    assert np.all(np.isfinite(np.asarray(out.fused_pose.t)))
    assert int(state.mapping.kf.count) >= 1


@pytest.mark.slow
def test_reference_preset_end_to_end():
    """30+ scans of full SLAM (odometry + mapping + fusion) under the
    reference-exact configuration: finite output, bounded ATE."""
    cfg = _ref_cfg()
    scene = synthetic.default_scene()
    n = 33
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    state = pipeline.init_slam_state(cfg)
    fused = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scan = synthetic.raycast_scan(scene, pk, cfg.sensor, next_pose=nxt,
                                      motion=k + 1 < n)
        state, out = pipeline.slam_scan_step(
            state, *scan, cfg, k * 0.1,
            run_mapping=(k % cfg.mapping_every == 0))
        fused.append(np.asarray(out.fused_pose.t))
    fused = np.stack(fused)
    assert np.all(np.isfinite(fused))
    assert int(state.mapping.kf.count) >= 2
    # The last scan's pose is the scan-START pose convention offset by one
    # scan of motion; compare against ground truth excluding the final scan.
    ate = float(metrics.ate_rmse(jnp.asarray(fused[:-1]),
                                 poses.t[1:]))
    # Without the added stabilizers the reference configuration drifts
    # more than the default preset (~0.05 m here); this bound catches
    # divergence, not parity.
    assert ate < 0.60, ate
