"""Scan-1 bootstrap double-resolve (pipeline.slam_scan_step(bootstrap=True)).

The constant-velocity prior starts at zero, so the first solved scan recovers
only part of the true motion under the damped compressed LM schedule; on fast
trajectories that residual bakes a transient into the first keyframes.  The
bootstrap re-seeds and re-solves twice before the final solve.  These tests
lock:

  1. on a FAST start (~0.8 m/scan, the 766 m circuit regime) the bootstrap
     recovers strictly more of scan 1's true motion;
  2. on a slow start (the default ring world rate) it is a no-op to mm level;
  3. block mode with ``bootstrap=True`` matches streaming with
     ``bootstrap=(k == 1)`` (extends tests/test_slam_block.py's equivalence
     to the bootstrap program variant).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic

SMALL_MAP = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=128, submap_corner_cap=8192,
    submap_surf_cap=16384, scan_corner_cap=1024, scan_surf_cap=4096,
    # batch=1 keeps the block-mode programs (already the
    # suite's biggest compiles) free of the fold/skip cond
    # branch; batched folds are covered by test_mapping +
    # the GPU bench.
    submap_merge_batch=1)
CFG = DEFAULT.replace(mapping=SMALL_MAP)


def _scans(n, angular_rate, radius=20.0):
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(n, radius=radius,
                                        angular_rate=angular_rate)
    scans = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scans.append(synthetic.raycast_scan(
            scene, pk, CFG.sensor, next_pose=nxt, motion=k + 1 < n))
    return scans, poses


def _run(scans, bootstrap):
    st = pipeline.init_slam_state(CFG)
    outs = []
    for k, s in enumerate(scans):
        st, out = pipeline.slam_scan_step(
            st, *s, CFG, k * 0.1, run_mapping=(k % CFG.mapping_every == 0),
            bootstrap=(bootstrap and k == 1))
        outs.append(np.asarray(out.odom_pose.t))
    return st, np.stack(outs)


@pytest.mark.slow
def test_bootstrap_recovers_fast_start():
    """Circuit regime (0.8 m/scan straight start): without the bootstrap the
    under-recovered scan-1 motion bakes a transient into the first keyframes
    that scan-to-map then anchors to; with it the early fused trajectory
    tracks ground truth measurably closer (measured on the 766 m course:
    err@scan50 1.52 -> 0.81 m — pipeline.slam_scan_step docstring)."""
    half = 60.0
    n = 13                                # 4 mapping steps at cadence 3
    scene = synthetic.circuit_scene(half)
    poses = synthetic.circuit_trajectory(n + 1, half=half)

    scans = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[k + 1], poses.t[k + 1])
        scans.append(synthetic.raycast_scan(scene, pk, CFG.sensor,
                                            next_pose=nxt, motion=True))

    def run(bootstrap):
        st = pipeline.init_slam_state(CFG)
        traj = []
        for k, s in enumerate(scans):
            st, out = pipeline.slam_scan_step(
                st, *s, CFG, k * 0.1,
                run_mapping=(k % CFG.mapping_every == 0),
                bootstrap=(bootstrap and k == 1))
            traj.append(np.asarray(out.fused_pose.t))
        return np.stack(traj)

    # Ground truth rebased to the scan-0 frame (SLAM starts at identity).
    R0 = np.asarray(poses.R[0])
    gt = (np.asarray(poses.t[:n]) - np.asarray(poses.t[0])) @ R0

    plain = run(False)
    boot = run(True)
    e_plain = float(np.linalg.norm(plain[-1] - gt[-1]))
    e_boot = float(np.linalg.norm(boot[-1] - gt[-1]))
    # Measured on the CPU: plain ~1.35 m, boot ~0.53 m.
    assert e_boot < 0.8 * e_plain, (e_boot, e_plain)
    assert e_boot < 0.8, e_boot


def test_bootstrap_noop_on_slow_start():
    scans, _ = _scans(3, angular_rate=0.0075)   # ~0.15 m/scan (ring world)
    _, plain = _run(scans, bootstrap=False)
    _, boot = _run(scans, bootstrap=True)
    # Slow starts converge in one call; the extra resolves shift the
    # trajectory only at cm scale (measured max delta ~3.5 cm on a
    # 0.15 m/scan start — the residual per-call convergence gap, not a
    # transient that mapping would lock in).
    np.testing.assert_allclose(boot, plain, atol=0.08)


def test_block_bootstrap_matches_streaming():
    B = CFG.mapping_every
    scans, _ = _scans(B, angular_rate=0.04)

    st1 = pipeline.init_slam_state(CFG)
    stream = []
    for k, s in enumerate(scans):
        st1, out = pipeline.slam_scan_step(
            st1, *s, CFG, k * 0.1, run_mapping=(k % B == 0),
            bootstrap=(k == 1))
        stream.append(np.asarray(out.fused_pose.t))

    st2 = pipeline.init_slam_state(CFG)
    blk = tuple(jnp.stack([scans[i][j] for i in range(B)]) for j in range(3))
    times = jnp.arange(B, dtype=jnp.float32) * 0.1
    st2, outs = pipeline.slam_scan_block(st2, *blk, CFG, times,
                                         bootstrap=True)

    np.testing.assert_allclose(np.asarray(outs.fused_pose.t),
                               np.stack(stream), atol=1e-5)
    np.testing.assert_allclose(np.asarray(st2.odom.xi),
                               np.asarray(st1.odom.xi), atol=1e-6)
