"""IMU-enabled pipeline tests: de-skew + seeded initial guess + attitude blend
(the full featureAssociation IMU path, SURVEY.md §2.2)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops import deskew, se3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import metrics, synthetic

CFG = DEFAULT.replace(mapping=dataclasses.replace(
    DEFAULT.mapping, max_keyframes=64, submap_corner_cap=4096,
    submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096,
    # batch=1 keeps the block-mode programs (already the
    # suite's biggest compiles) free of the fold/skip cond
    # branch; batched folds are covered by test_mapping +
    # the GPU bench.
    submap_merge_batch=1))


def test_make_imu_consistent_with_deskew_integration():
    """integrate_imu(make_imu(traj)) must reproduce the trajectory's velocity
    and attitude (the two modules are inverses)."""
    n = 10
    poses = synthetic.circle_trajectory(n, radius=15.0, angular_rate=0.01)
    ts, rpy, acc, gyro = synthetic.make_imu(poses, scan_period=0.1)
    w = deskew.ImuWindow(time=ts, rpy=rpy, acc=acc, gyro=gyro,
                         valid=jnp.ones(ts.shape[0], bool))
    integ = deskew.integrate_imu(w)
    # Acceleration integration recovers the velocity CHANGE only (the sensor
    # starts already moving and integration starts from rest — the reference
    # has the identical limitation, featureAssociation.cpp:392-429).  On the
    # circle, |v(t) - v(0)| = 2 v sin(theta/2).
    mid = ts.shape[0] // 2
    v = 15.0 * 0.01 / 0.1
    theta_mid = 0.01 * (n - 1) / 2
    expected_dv = 2 * v * np.sin(theta_mid / 2)
    got_dv = float(jnp.linalg.norm(integ.velo[mid]))
    assert abs(got_dv - expected_dv) < 0.5 * expected_dv + 0.05
    # Attitude yaw advances with the trajectory.
    yaw_end = float(integ.rpy[-1, 2])
    assert abs(yaw_end - 0.01 * (n - 1)) < 0.02


def test_slam_with_imu_runs_and_is_accurate():
    scene = synthetic.default_scene()
    n = 12
    poses = synthetic.circle_trajectory(n, radius=18.0, angular_rate=0.009)
    ts, rpy, acc, gyro = synthetic.make_imu(poses, scan_period=0.1)
    w = deskew.ImuWindow(time=ts, rpy=rpy, acc=acc, gyro=gyro,
                         valid=jnp.ones(ts.shape[0], bool))
    integ = deskew.integrate_imu(w)

    scans = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scans.append(synthetic.raycast_scan(scene, pk, CFG.sensor,
                                            next_pose=nxt, motion=k + 1 < n))

    state = pipeline.init_slam_state(CFG)
    fused = []
    for k, s in enumerate(scans):
        state, out = pipeline.slam_scan_step(
            state, *s, CFG, k * 0.1,
            run_mapping=(k % CFG.mapping_every == 0),
            imu_integral=integ)
        fused.append(np.asarray(out.fused_pose.t))
    fused = np.array(fused)
    assert np.all(np.isfinite(fused))
    gt = np.asarray(poses.t)[1:]
    ate = float(metrics.ate_rmse(jnp.asarray(fused[:-1]), jnp.asarray(gt)))
    assert ate < 0.2, f"IMU-enabled pipeline ATE {ate:.3f}"


def test_imu_xi_seed_matches_motion():
    """The IMU-derived initial guess must approximate the true scan twist."""
    n = 6
    poses = synthetic.circle_trajectory(n, radius=15.0, angular_rate=0.012)
    ts, rpy, acc, gyro = synthetic.make_imu(poses, scan_period=0.1)
    w = deskew.ImuWindow(time=ts, rpy=rpy, acc=acc, gyro=gyro,
                         valid=jnp.ones(ts.shape[0], bool))
    integ = deskew.integrate_imu(w)
    dsk = deskew.deskew_image(
        jnp.zeros((16, 1800, 3)), jnp.zeros((16, 1800)),
        jnp.zeros((16, 1800), bool), jnp.float32(0.2), integ)
    seed = pipeline.imu_xi_seed(dsk, 0.1)
    gt = se3.se3_log(se3.relative(Pose(poses.R[2], poses.t[2]),
                                  Pose(poses.R[3], poses.t[3])))
    # The ROTATION seed comes from the gyro and must match the true motion;
    # the translation seed is velocity-from-rest (deviation only — see above)
    # so it is NOT compared against absolute motion.
    np.testing.assert_allclose(np.asarray(seed[:3]), np.asarray(gt[:3]),
                               atol=0.02)


@pytest.mark.xdist_group("blockcompile")
def test_slam_block_imu_matches_streaming():
    """slam_scan_block with stacked per-scan IMU integrals must match B
    streaming slam_scan_step calls with the same windows (the block fast path
    covers BASELINE config 4's loop+IMU pipeline too)."""
    import jax

    from legoloam_tpu.utils import io as lio

    scene = synthetic.default_scene()
    B = CFG.mapping_every
    n = 2 * B
    poses = synthetic.circle_trajectory(n + 1, radius=18.0, angular_rate=0.009)
    ts, rpy, acc, gyro = synthetic.make_imu(poses, scan_period=0.1)
    seq = lio.ImuSequence(np.asarray(ts), np.asarray(rpy), np.asarray(acc),
                          np.asarray(gyro), window=64)

    scans, integs = [], []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[k + 1], poses.t[k + 1])
        scans.append(synthetic.raycast_scan(scene, pk, CFG.sensor,
                                            next_pose=nxt, motion=True))
        integs.append(deskew.integrate_imu(seq.window_for(k * 0.1, 0.1)))

    st1 = pipeline.init_slam_state(CFG)
    stream = []
    for k, s in enumerate(scans):
        st1, out = pipeline.slam_scan_step(
            st1, *s, CFG, k * 0.1, run_mapping=(k % B == 0),
            imu_integral=integs[k])
        stream.append(np.asarray(out.fused_pose.t))

    st2 = pipeline.init_slam_state(CFG)
    block = []
    for b in range(n // B):
        blk = tuple(jnp.stack([scans[b * B + i][j] for i in range(B)])
                    for j in range(3))
        times = jnp.arange(b * B, (b + 1) * B, dtype=jnp.float32) * 0.1
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                               *integs[b * B:(b + 1) * B])
        st2, outs = pipeline.slam_scan_block(st2, *blk, CFG, times,
                                             imu_integrals=stacked)
        block.append(np.asarray(outs.fused_pose.t))
    block = np.concatenate(block)

    # Streaming runs separately-jitted programs; the block fuses one — XLA
    # reassociates float ops across the boundaries, and with
    # min_lm_keyframes=2 the scan-to-map LM runs inside this window, where a
    # borderline correspondence-gate flip amplifies the reassociation noise
    # to a few mm through the solver.
    np.testing.assert_allclose(block, np.stack(stream), atol=8e-3)
    assert int(st2.mapping.kf.count) == int(st1.mapping.kf.count)
