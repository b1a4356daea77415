"""Circuit-course drift lock: the rounded-square course
LARGER than the submap radius — drift accumulates on fresh terrain instead
of being absorbed by implicit re-localization.

Runs at realistic sensor noise (sigma=2 cm, the VLP-16's own floor): the
noiseless case is dominated by deterministic sampling aliasing that cannot
occur on real returns (PERF.md round-4 noise-paradox section).  Reference
numbers from a full-length run on the previous accelerator (1150 scans /
919 m): odometry end drift 1.43%, fused 0.20% — the bounds here are looser
to absorb CPU/accelerator reassociation and the
shorter course (360 scans ~ 290 m keeps the slow tier's
CPU cost bounded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic


@pytest.mark.slow
def test_circuit_end_drift_under_one_percent():
    cfg = DEFAULT
    n = 360
    scene = synthetic.circuit_scene(100.0)
    poses = synthetic.circuit_trajectory(n + 1, half=100.0)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ray = jax.jit(lambda a, b, c, d, key: synthetic.raycast_scan(
        scene, Pose(a, b), cfg.sensor, next_pose=Pose(c, d), motion=True,
        noise_key=key, noise_sigma=0.02))

    state = pipeline.init_slam_state(cfg)
    fused, odoms = [], []
    for k in range(n):
        pts, valid, ring = ray(poses.R[k], poses.t[k],
                               poses.R[k + 1], poses.t[k + 1], keys[k])
        state, out = pipeline.slam_scan_step(
            state, pts, valid, ring, cfg, 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0), bootstrap=(k == 1))
        fused.append(np.asarray(out.fused_pose.t))
        odoms.append(np.asarray(out.odom_pose.t))
    fused, odoms = np.array(fused), np.array(odoms)

    R0, t0 = np.asarray(poses.R[0]), np.asarray(poses.t[0])
    gt = (np.asarray(poses.t)[:n] - t0) @ R0
    path = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    fused_drift = float(np.linalg.norm(fused[-1] - gt[-1]))
    odo_drift = float(np.linalg.norm(odoms[-1] - gt[-1]))
    assert np.isfinite(fused).all()
    # The FUSED stream is the system output and the verdict metric (full
    # runs on the previous accelerator: 0.83% at scan 360, 0.20% at the
    # full 1150-scan lap).  Odometry end drift is course-PHASE-dependent
    # (yaw-integrated errors partially cancel over a closed lap: 6.4% at
    # scan 360 -> 1.43% at 1150, same on the CPU), so it only gets a sanity
    # bound here.
    assert fused_drift < 0.01 * path, (fused_drift, path)
    assert odo_drift < 0.08 * path, (odo_drift, path)
