"""Analytic memory accounting for the SLAM state pytree.

Device-memory budgets tallied HOST-SIDE from shapes alone, before a run and
without a device: ``jax.eval_shape`` traces the state constructors without
allocating, and the per-field byte counts follow from ``shape × itemsize``.
This is exact for the persistent state (the arrays are dense, fixed-shape,
and donated in place); transient compiler workspace is not covered (XLA's
per-program scratch).  ``device.memory_stats()`` reports what a run really
peaked at (bench.py and chip_smoke.py print both).

Reference contrast: the reference's map RAM grows without bound
(``src/mapOptmization.cpp:84-86`` keyframe vectors); here every config has a
closed-form budget checkable before a run (``python bench.py`` prints it;
tests/test_memory.py pins the default and a 16-shard HDL-32E config to
absolute byte budgets).
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import numpy as np


def tree_bytes(tree) -> int:
    """Total bytes of a pytree of (possibly abstract) arrays."""
    return sum(int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
               for l in jax.tree.leaves(tree))


def _field_bytes(nt) -> Dict[str, int]:
    return {name: tree_bytes(getattr(nt, name)) for name in nt._fields}


def slam_state_bytes(cfg) -> Dict[str, int]:
    """Byte budget of the single-device ``pipeline.SlamState`` for ``cfg``,
    computed WITHOUT allocating (jax.eval_shape)."""
    from ..models import pipeline

    shapes = jax.eval_shape(lambda: pipeline.init_slam_state(cfg))
    out = {
        "odom": tree_bytes(shapes.odom),
        "loops": tree_bytes(shapes.loops),
        "kf_store": tree_bytes(shapes.mapping.kf),
        "submap_cache": tree_bytes(shapes.mapping.cache),
    }
    out["total"] = tree_bytes(shapes)
    return out


def dist_state_bytes(cfg, n_devices: int) -> Dict[str, int]:
    """PER-SHARD byte budget of the distributed state
    (``pipeline_dist.DistSlamState``) on an ``n_devices`` mesh: keyframe
    CLOUD arrays are sharded on the keyframe axis (1/n_devices per shard),
    everything else (poses, chain, odometry state, loop factors) is
    replicated.  Matches the layout in ``parallel/pipeline_dist.py:
    DistKeyframes``/``init_dist_state``."""
    from ..models import odometry, posegraph

    m = cfg.mapping.max_keyframes
    f32 = 4
    sharded_clouds = (
        m * cfg.mapping.scan_corner_cap * (3 * f32 + 1)     # corner + valid
        + m * cfg.mapping.scan_surf_cap * (3 * f32 + 1))    # surf + valid
    replicated_poses = (
        m * (9 + 3 + 9 + 3) * f32   # R, t, chain_R, chain_t
        + m * f32                   # time
        + 8)                        # count + overflow
    odom_shapes = jax.eval_shape(
        lambda: odometry.init_state(cfg.odom, cfg.feat))
    loops_shapes = jax.eval_shape(
        lambda: posegraph.init_loop_factors(cfg.posegraph.max_loop_factors))
    out = {
        "kf_clouds_per_shard": math.ceil(sharded_clouds / n_devices),
        "kf_poses_replicated": replicated_poses,
        "odom_replicated": tree_bytes(odom_shapes),
        "loops_replicated": tree_bytes(loops_shapes),
    }
    out["per_shard_total"] = sum(out.values())
    return out


def fmt_gib(n: int) -> str:
    return f"{n / 2**30:.3f} GiB"


def summary(cfg, n_devices: int | None = None) -> str:
    """Human-readable budget block (printed by bench.py)."""
    lines = []
    b = slam_state_bytes(cfg)
    lines.append(
        f"[mem] single-device state {fmt_gib(b['total'])} "
        f"(kf store {fmt_gib(b['kf_store'])}, submap cache "
        f"{fmt_gib(b['submap_cache'])}, odom {fmt_gib(b['odom'])})")
    if n_devices:
        d = dist_state_bytes(cfg, n_devices)
        lines.append(
            f"[mem] per-shard on a {n_devices}-device mesh "
            f"{fmt_gib(d['per_shard_total'])} "
            f"(sharded clouds {fmt_gib(d['kf_clouds_per_shard'])}, "
            f"replicated poses {fmt_gib(d['kf_poses_replicated'])})")
    return "\n".join(lines)
