"""Analytic device-memory accounting (utils/memory.py): shape-only byte
budgets of the SLAM state, checkable without a device."""

import dataclasses

import jax

from legoloam_tpu.config import DEFAULT, HDL32E
from legoloam_tpu.models import pipeline
from legoloam_tpu.utils import memory


def test_analytic_matches_real_allocation():
    """eval_shape tally == bytes of the actually-initialized state."""
    cfg = DEFAULT.replace(mapping=dataclasses.replace(
        DEFAULT.mapping, max_keyframes=32, scan_corner_cap=64,
        scan_surf_cap=128, submap_corner_cap=256, submap_surf_cap=512))
    b = memory.slam_state_bytes(cfg)
    real = memory.tree_bytes(pipeline.init_slam_state(cfg))
    assert b["total"] == real


def test_default_config_budget():
    """The default VLP-16 config's persistent state stays under 4 GiB (~2 GiB,
    dominated by the 4096-keyframe store)."""
    b = memory.slam_state_bytes(DEFAULT)
    assert b["total"] < 4 * 2**30, b
    assert b["kf_store"] > 0.25 * b["total"]


def test_hdl32e_16_shard_budget():
    """A 32K-keyframe HDL-32E map (8x the default VLP-16 capacity, double
    per-scan caps for the 32-ring sensor) sharded 16 ways stays under 4 GiB
    per shard, with the sharded clouds dominating and the replicated
    pose/odometry arrays in the low MBs."""
    cfg = DEFAULT.replace(
        sensor=HDL32E,
        mapping=dataclasses.replace(
            DEFAULT.mapping, max_keyframes=32768,
            scan_corner_cap=4096, scan_surf_cap=16384))
    d = memory.dist_state_bytes(cfg, 16)
    assert d["per_shard_total"] < 4 * 2**30, d      # plenty of headroom
    assert d["kf_clouds_per_shard"] > 0.9 * d["per_shard_total"] * 0.5
    # Replicated overhead must stay small (it does not scale down with the
    # mesh): poses + odometry + loops under 64 MiB.
    rep = (d["kf_poses_replicated"] + d["odom_replicated"]
           + d["loops_replicated"])
    assert rep < 64 * 2**20, rep
    # Sanity vs single-device: sharding must actually shrink the dominant
    # term ~16x.
    single = memory.slam_state_bytes(cfg)
    assert d["kf_clouds_per_shard"] < single["kf_store"] / 8
