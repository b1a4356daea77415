"""Full-SLAM block mode must match per-scan streaming exactly
(pipeline.slam_scan_block: B scans + one mapping step per XLA program)."""

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


@pytest.mark.xdist_group("blockcompile")
def test_slam_block_matches_streaming():
    scene = synthetic.default_scene()
    B = CFG.mapping_every
    n = 2 * B   # two full blocks; streaming maps on scans 0, B, ...
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.0075)
    scans = []
    for k in range(n):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
        scans.append(synthetic.raycast_scan(
            scene, pk, CFG.sensor, next_pose=nxt, motion=k + 1 < n))

    # Streaming: mapping on scans 0, B, ... (the reference 0.3 s cadence).
    st1 = pipeline.init_slam_state(CFG)
    stream_fused, stream_mapped = [], []
    for k, s in enumerate(scans):
        st1, out = pipeline.slam_scan_step(
            st1, *s, CFG, k * 0.1, run_mapping=(k % B == 0))
        stream_fused.append(np.asarray(out.fused_pose.t))
        stream_mapped.append(np.asarray(out.mapped_pose.t))

    # Two blocks of B: mapping at block position 0 — identical cadence.
    st2 = pipeline.init_slam_state(CFG)
    block_fused, block_mapped = [], []
    for b in range(n // B):
        blk = tuple(jnp.stack([scans[b * B + i][j] for i in range(B)])
                    for j in range(3))
        times = jnp.arange(b * B, (b + 1) * B, dtype=jnp.float32) * 0.1
        st2, outs = pipeline.slam_scan_block(st2, *blk, CFG, times)
        block_fused.append(np.asarray(outs.fused_pose.t))
        block_mapped.append(np.asarray(outs.mapped_pose.t))
    block_fused = np.concatenate(block_fused)
    block_mapped = np.concatenate(block_mapped)

    np.testing.assert_allclose(block_fused, np.stack(stream_fused), atol=1e-5)
    np.testing.assert_allclose(block_mapped, np.stack(stream_mapped),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(st2.odom.xi),
                               np.asarray(st1.odom.xi), atol=1e-6)
    assert int(st2.mapping.kf.count) == int(st1.mapping.kf.count)
