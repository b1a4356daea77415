"""No-IMU full-SLAM accuracy: mapping must IMPROVE on odometry.

The reference runs IMU-less by default and stays stable over 20K scans
(``src/mapOptmization.cpp:463-496`` blends IMU only when present;
``README.md:42`` "9-DOF IMU optional").  Round 2's rebuild regressed here
under reduced-precision matmuls (fused ATE far worse than odometry-only on
the 800-scan ring world — root-caused to rotation-matmul contraction, see
test_rotation_precision.py); this locks the fixed behavior: over a partial
ring-world lap with no IMU, the fused trajectory must beat odometry-only by
a wide margin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import metrics, synthetic


@pytest.mark.slow
def test_noimu_fused_beats_odometry_on_ring_lap():
    cfg = DEFAULT
    scene = synthetic.loop_scene()
    n = 90
    poses = synthetic.circle_trajectory(n + 1, radius=30.0,
                                        angular_rate=0.009)
    ray = jax.jit(lambda pk_R, pk_t, nx_R, nx_t: synthetic.raycast_scan(
        scene, Pose(pk_R, pk_t), cfg.sensor,
        next_pose=Pose(nx_R, nx_t), motion=True))

    state = pipeline.init_slam_state(cfg)
    fused, odoms = [], []
    for k in range(n):
        pts, valid, ring = ray(poses.R[k], poses.t[k],
                               poses.R[k + 1], poses.t[k + 1])
        state, out = pipeline.slam_scan_step(
            state, pts, valid, ring, cfg, 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0))
        fused.append(out.fused_pose.t)
        odoms.append(out.odom_pose.t)
    fused = jnp.stack(fused)
    odoms = jnp.stack(odoms)
    gt = jnp.asarray(poses.t)[:n]

    ate_f = float(metrics.ate_rmse(fused, gt))
    ate_o = float(metrics.ate_rmse(odoms, gt))
    # Odometry alone drifts ~0.5-1 m over 90 scans; mapping must cut that
    # by at least 2x (chip runs achieve ~10-60x over full laps).
    assert np.isfinite(ate_f) and np.isfinite(ate_o)
    assert ate_f < 0.5 * ate_o, (ate_f, ate_o)
    assert ate_f < 0.4, (ate_f, ate_o)
    # The accumulated mapped rotation must still be orthonormal.
    R = np.asarray(state.mapping.t_aft.R, np.float64)
    assert abs(np.linalg.det(R) - 1.0) < 1e-4
