"""Sharded keyframe map: submap assembly over a device mesh.

BASELINE.json config 5: keyframes/map blocks sharded over a mesh.  The
keyframe axis of the ``KeyframeStore`` shards across the mesh; submap assembly
becomes:

  1. each device measures distances for ITS keyframe shard and selects its
     nearest in-radius keyframes (local top-S/n);
  2. each device gathers + world-transforms its selected clouds and runs a
     LOCAL exact voxel downsample to submap_cap/n points;
  3. one ``all_gather`` over NVLink (all to all) replicates the per-shard submaps; the caller
     concatenates (duplicate voxels across shards are impossible — each
     keyframe lives on exactly one shard; voxels co-populated by keyframes on
     different shards simply contribute one centroid per shard, the same
     behavior as the reference's per-keyframe cloud concatenation before its
     final downsample, mapOptmization.cpp:1057-1064).

This is the memory-scaling axis: each device holds M/n keyframes' clouds, so
the 20K-keyframe Stevens-scale map fits a small mesh with room to spare.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MappingConfig
from ..models.mapping import KeyframeStore
from ..ops import se3
from ..ops.se3 import Pose as SE3Pose
from ..ops.voxel import voxel_downsample


def shard_keyframes(kf: KeyframeStore, mesh: Mesh, axis: str = "data"
                    ) -> KeyframeStore:
    """Place the keyframe-axis arrays sharded over the mesh, CYCLICALLY.

    Keyframe k lives on shard k % n_dev (local slot k // n_dev).  Cyclic
    assignment matters: keyframes are trajectory-ordered, so a radius submap
    selects a CONTIGUOUS index run — block sharding would put the whole
    submap on one or two shards and their per-shard caps would truncate it
    (found by end-to-end verification).  Cyclic spreads any contiguous run
    evenly over all shards.
    """
    n_dev = mesh.shape[axis]
    m = kf.t.shape[0]
    m_loc = m // n_dev
    # Physical row p (on shard p // m_loc, local slot p % m_loc) holds
    # keyframe (p % m_loc) * n_dev + p // m_loc.
    p_idx = jnp.arange(m)
    perm = (p_idx % m_loc) * n_dev + p_idx // m_loc
    sharded = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x, name):
        if x.ndim == 0:            # scalars (count, overflow): replicated
            return jax.device_put(x, rep)
        return jax.device_put(x[perm], sharded)

    return KeyframeStore(**{
        name: put(getattr(kf, name), name) for name in kf._fields
    })


def extract_submap_sharded(
    kf: KeyframeStore, center: jax.Array, cfg: MappingConfig,
    mesh: Mesh, axis: str = "data", submap_kf: int = 64,
):
    """Distributed ``mapping.extract_submap``: per-shard select + downsample,
    then all_gather.  Returns ((corner (C, 3), valid), (surf (S, 3), valid))
    replicated, where C/S are the configured submap caps."""
    n_dev = mesh.shape[axis]
    m = kf.t.shape[0]
    assert m % n_dev == 0, "max_keyframes must divide the mesh"
    local_sel = max(1, min(submap_kf // n_dev, m // n_dev))
    c_cap = cfg.submap_corner_cap // n_dev
    s_cap = cfg.submap_surf_cap // n_dev

    kspec = P(axis)
    rspec = P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(kspec, kspec, kspec, kspec, kspec, kspec, rspec, rspec),
        out_specs=(rspec, rspec, rspec, rspec),
        check_vma=False,
    )
    def solve(t, R, corner, corner_valid, surf, surf_valid, count, ctr):
        shard = jax.lax.axis_index(axis)
        m_loc = t.shape[0]
        # Cyclic layout (see shard_keyframes): local slot i holds keyframe
        # i * n_dev + shard.
        gidx = jnp.arange(m_loc) * n_dev + shard
        ok = gidx < count
        d2 = jnp.sum((t - ctr[None]) ** 2, axis=-1)
        within = ok & (d2 <= cfg.search_radius ** 2)
        # Per-shard position dedup (mapping.dedup_positions): cross-shard
        # duplicates can survive (each shard dedups its own keyframes), which
        # only adds coverage — same spirit as the reference's 1 m pose
        # downsample before submap assembly (mapOptmization.cpp:1009-1010).
        from ..models.mapping import dedup_positions
        rep = dedup_positions(t, within, ctr, cfg.surrounding_leaf)
        d2 = jnp.where(rep, d2, jnp.inf)
        sel_score, sel = jax.lax.top_k(-d2, local_sel)
        sel_ok = (-sel_score) <= cfg.search_radius ** 2

        def gather(cloud, valid, cap, leaf):
            pts = cloud[sel]
            v = valid[sel] & sel_ok[:, None]
            world = se3.transform_points(SE3Pose(R[sel], t[sel]), pts)
            # Morton origin: each shard's slice of the concatenated submap is
            # then spatially sorted, which the culled kNN kernel exploits.
            return voxel_downsample(world.reshape(-1, 3), v.reshape(-1),
                                    leaf, cap, origin=ctr)

        sub_c, sub_cv = gather(corner, corner_valid, c_cap, cfg.corner_leaf)
        sub_s, sub_sv = gather(surf, surf_valid, s_cap, cfg.surf_leaf)
        # Replicate via all_gather over the mesh axis.
        return (
            jax.lax.all_gather(sub_c, axis).reshape(-1, 3),
            jax.lax.all_gather(sub_cv, axis).reshape(-1),
            jax.lax.all_gather(sub_s, axis).reshape(-1, 3),
            jax.lax.all_gather(sub_sv, axis).reshape(-1),
        )

    c, cv, s, sv = solve(kf.t, kf.R, kf.corner, kf.corner_valid,
                         kf.surf, kf.surf_valid, kf.count, center)
    return (c, cv), (s, sv)


def scan_to_map_sharded(
    guess, corner, corner_valid, surf, surf_valid,
    sub_c, sub_cv, sub_s, sub_sv,
    cfg: MappingConfig, mesh: Mesh, axis: str = "data",
):
    """Distributed ``mapping.scan_to_map``: the residual-row (scan point)
    axis shards over the mesh, the submap stays replicated, and each LM
    iteration ``psum``s the residual counts + assembled 6x6 normal equations
    so every device applies the identical pose update.  Exactly the
    batch-parallel-LM row of SURVEY.md §2's parallelism inventory.

    Returns (pose, iters, n_corner, n_surf) replicated — matching the
    single-device ``scan_to_map`` output bit-for-bit up to f32 reduction
    order."""
    from ..models import mapping as mapping_mod
    from ..ops.se3 import Pose

    qspec = P(axis)
    rspec = P()

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=((rspec, rspec), qspec, qspec, qspec, qspec,
                  rspec, rspec, rspec, rspec),
        out_specs=((rspec, rspec), rspec, rspec, rspec),
        check_vma=False,
    )
    def solve(g, c, cv, s, sv, sc, scv, ss, ssv):
        red = lambda x: jax.lax.psum(x, axis)
        T, iters, n_c, n_s = mapping_mod.scan_to_map(
            Pose(*g), c, cv, s, sv, sc, scv, ss, ssv, cfg, reduce_fn=red)
        return (T.R, T.t), iters, n_c, n_s

    (R_out, t_out), iters, n_c, n_s = solve(
        (guess.R, guess.t), corner, corner_valid, surf, surf_valid,
        sub_c, sub_cv, sub_s, sub_sv)
    return Pose(R_out, t_out), iters, n_c, n_s
