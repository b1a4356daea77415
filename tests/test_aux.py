"""Auxiliary subsystem tests: checkpoint/resume, map export, CLI runner."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

import dataclasses

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import checkpoint, export, synthetic

# CPU-sized map capacities (the default submaps are accelerator-scale).
CFG = DEFAULT.replace(mapping=dataclasses.replace(
    DEFAULT.mapping, max_keyframes=128, submap_corner_cap=4096,
    submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096))


def _short_run(n=8):
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    state = pipeline.init_slam_state(CFG)
    scans = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scans.append(synthetic.raycast_scan(scene, pk, CFG.sensor,
                                            next_pose=nxt, motion=k + 1 < n))
    outs = []
    for k, s in enumerate(scans):
        state, out = pipeline.slam_scan_step(
            state, *s, CFG, k * 0.1,
            run_mapping=(k % CFG.mapping_every == 0))
        outs.append(out)
    return state, scans, outs


def test_checkpoint_roundtrip_and_resume(tmp_path):
    state, scans, outs = _short_run(5)
    p = tmp_path / "ck.npz"
    checkpoint.save_state(str(p), state)
    template = pipeline.init_slam_state(CFG)
    loaded = checkpoint.load_state(str(p), template)
    np.testing.assert_array_equal(np.asarray(loaded.odom.xi),
                                  np.asarray(state.odom.xi))
    np.testing.assert_array_equal(np.asarray(loaded.mapping.kf.count),
                                  np.asarray(state.mapping.kf.count))
    # Resumed continuation == uninterrupted continuation (determinism).
    s_direct, out_a = pipeline.slam_scan_step(state, *scans[2], CFG, 0.5,
                                              run_mapping=True)
    s_resumed, out_b = pipeline.slam_scan_step(loaded, *scans[2], CFG, 0.5,
                                               run_mapping=True)
    np.testing.assert_array_equal(np.asarray(out_a.fused_pose.t),
                                  np.asarray(out_b.fused_pose.t))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    state, _, _ = _short_run(2)
    p = tmp_path / "ck.npz"
    checkpoint.save_state(str(p), state)
    small = CFG.replace(mapping=dataclasses.replace(
        CFG.mapping, max_keyframes=7))
    template = pipeline.init_slam_state(small)
    try:
        checkpoint.load_state(str(p), template)
        assert False, "should reject shape mismatch"
    except ValueError:
        pass


def test_global_map_export(tmp_path):
    state, _, _ = _short_run(7)
    pts, val = export.assemble_global_map(state.mapping.kf, leaf=0.4,
                                          cap=1 << 16)
    n = int(val.sum())
    assert n > 1000
    p = tmp_path / "map.pcd"
    export.write_pcd(str(p), np.asarray(pts), np.asarray(val))
    back = export.read_pcd_xyz(str(p))
    assert back.shape == (n, 3)
    # Ground plane present: the SLAM world frame is the first SENSOR pose
    # (0.8 m above ground), so the plane sits at z ~= -0.8.
    assert (np.abs(back[:, 2] + 0.8) < 0.15).sum() > 300


def test_trajectory_tum_format(tmp_path):
    poses = Pose(jnp.stack([jnp.eye(3)] * 3),
                 jnp.asarray([[0., 0, 0], [1, 0, 0], [2, 0, 0]]))
    p = tmp_path / "traj.txt"
    export.write_trajectory_tum(str(p), [0.0, 0.1, 0.2], poses)
    lines = open(p).read().strip().split("\n")
    assert len(lines) == 3
    parts = lines[1].split()
    assert len(parts) == 8
    assert abs(float(parts[1]) - 1.0) < 1e-6
    assert abs(float(parts[7]) - 1.0) < 1e-6  # identity quat w=1


def test_cli_synthetic_end_to_end(tmp_path):
    out = tmp_path / "run"
    env = dict(os.environ)
    r = subprocess.run(
        [sys.executable, "-m", "legoloam_tpu", "--synthetic", "12",
         "--out", str(out), "--backend", "cpu", "--preset", "small"],
        capture_output=True, text=True, env=env, timeout=900,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert (out / "trajectory_fused.txt").exists()
    assert (out / "global_map.pcd").exists()
    assert (out / "checkpoint.npz").exists()
    assert (out / "profile.txt").exists()
    traj = open(out / "trajectory_fused.txt").read().strip().split("\n")
    assert len(traj) == 12
