"""Voxel-grid downsampling and nearest-neighbor search — the PCL replacements.

Reference usage:
  * PCL ``VoxelGrid`` (leaf 0.2/0.4/1.0): ``src/featureAssociation.cpp:225``,
    ``src/mapOptmization.cpp:249-257``  -> ``voxel_downsample`` here.
  * PCL ``KdTreeFLANN`` K-NN / radius search: ``src/featureAssociation.cpp:
    1054,1165``, ``src/mapOptmization.cpp:1099,1181,1006,825,771``
    -> ``knn`` here (tiled brute force), and its GPU kernel
    ``knn_pallas.knn_pallas``; ``knn_pallas.search`` picks per platform.

Why brute force instead of a KD-tree: at this problem's sizes (queries <=
8K, references <= 64K) the distance computation is dense, regular work,
while tree traversal is branchy scalar code that maps badly onto wide
vector hardware.  The classic ||q - r||² = ||q||² + ||r||² - 2 q·r
decomposition turns the search into k fused matmul->mask->argmin reduction
passes.

Voxel downsampling is sort-based and exact up to 32-bit hash birthday
collisions (expected < 0.05 colliding voxel pairs at 20K occupied voxels):
points sort by voxel hash, segment boundaries define voxels, segment means are
the output.  Deterministic, unlike scatter-add orderings.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .masking import masked_fill, masked_fill_u32


def _hash_voxel(ijk: jax.Array) -> jax.Array:
    """3D integer coords -> 32-bit hash (spatial hashing constants from
    Teschner et al. 2003, the standard grid-hash primes)."""
    p1, p2, p3 = jnp.uint32(73856093), jnp.uint32(19349663), jnp.uint32(83492791)
    u = ijk.astype(jnp.uint32)
    return (u[..., 0] * p1) ^ (u[..., 1] * p2) ^ (u[..., 2] * p3)


def _part1by2(x: jax.Array) -> jax.Array:
    """Spread a 10-bit integer so its bits occupy positions 0,3,6,... (the
    standard Morton-code magic-number expansion)."""
    x = x & jnp.uint32(0x3FF)
    x = (x | (x << 16)) & jnp.uint32(0x30000FF)
    x = (x | (x << 8)) & jnp.uint32(0x300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x30C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x9249249)
    return x


def _morton_voxel(ijk: jax.Array) -> jax.Array:
    """3D integer cell coords -> 30-bit Morton (Z-order) key.  Coordinates are
    clamped to [0, 1024); the caller recenters so the region of interest fits.
    Unlike ``_hash_voxel`` this is collision-free within range AND
    locality-preserving: sorting by it leaves nearby cells in nearby array
    positions, which is what the culled kNN kernel's chunk-AABB test feeds on.
    """
    u = jnp.clip(ijk + 512, 0, 1023).astype(jnp.uint32)
    return (_part1by2(u[..., 0]) | (_part1by2(u[..., 1]) << 1)
            | (_part1by2(u[..., 2]) << 2))


@functools.partial(jax.jit,
                   static_argnames=("cap", "return_counts",
                                    "return_overflow"))
def voxel_downsample(
    points: jax.Array, valid: jax.Array, leaf: jax.Array | float, cap: int,
    origin: jax.Array | None = None, return_counts: bool = False,
    weights: jax.Array | None = None, return_overflow: bool = False,
):
    """Centroid-per-voxel downsampling (PCL VoxelGrid equivalent).

    points: (N, 3), valid: (N,) bool, leaf: scalar edge length.
    Returns (out (cap, 3), out_valid (cap,)) — plus per-voxel point counts
    when ``return_counts``.  If more than ``cap`` voxels are occupied the
    highest-key voxels are dropped (deterministic).

    ``origin``: when given, voxels key by a Morton code of the cell relative
    to ``origin`` (clamped to +-512 cells) instead of a spatial hash — the
    output is then SPATIALLY SORTED (Z-order), which the culled kNN kernel
    exploits, and the dedup is collision-free within range.

    ``weights``: per-point weights for merging pre-aggregated centroids
    (weight = how many raw points a row already represents); the output is
    then the weighted centroid and ``counts`` the total weight.  Weighted
    centroid merging is associative, so incremental submap maintenance is
    exact.
    """
    ijk = jnp.floor((points - origin if origin is not None else points)
                    / leaf).astype(jnp.int32)
    # The sorted channels ride ONE stacked gather and the voxel stats ONE
    # segment_sum (these arrays reach ~0.5M elements in submap assembly).
    key = _morton_voxel(ijk) if origin is not None else _hash_voxel(ijk)
    h = masked_fill_u32(key, valid, 0xFFFFFFFF)
    order = jnp.argsort(h)
    hs = h[order]
    w = valid.astype(points.dtype) if weights is None else \
        weights * valid.astype(points.dtype)
    stacked = jnp.concatenate(
        [points, valid.astype(points.dtype)[:, None], w[:, None]],
        axis=1)[order]
    ps, vf, wf = stacked[:, :3], stacked[:, 3], stacked[:, 4]
    vs = vf > 0.5
    new_group = jnp.concatenate([jnp.array([True]), hs[1:] != hs[:-1]]) & vs
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1
    gid = masked_fill(gid, vs & (gid < cap) & (gid >= 0), cap)
    acc = jax.ops.segment_sum(
        jnp.concatenate([ps * wf[:, None], wf[:, None]], axis=1), gid,
        num_segments=cap + 1)[:cap]
    sums, counts = acc[:, :3], acc[:, 3]
    out_valid = counts > 0
    out = sums / jnp.maximum(counts, 1e-9)[:, None]
    res = (out * out_valid[:, None], out_valid)
    if return_counts:
        res = res + (counts,)
    if return_overflow:
        # Occupied voxels beyond the cap (dropped, highest-key-first —
        # no-silent-caps discipline; callers surface this in their diag).
        n_groups = jnp.sum(new_group).astype(jnp.int32)
        res = res + (jnp.maximum(n_groups - cap, 0),)
    return res


@functools.partial(jax.jit, static_argnames=("cap", "return_overflow"))
def voxel_downsample_with_payload(
    points: jax.Array, payload: jax.Array, valid: jax.Array,
    leaf: jax.Array | float, cap: int, return_overflow: bool = False
) -> Tuple[jax.Array, ...]:
    """As ``voxel_downsample`` but also averages a per-point payload (K,) or
    (K, D) over each voxel (used to carry ring ids / timestamps through).
    ``return_overflow`` appends the count of occupied voxels dropped beyond
    ``cap`` (no-silent-caps discipline)."""
    ijk = jnp.floor(points / leaf).astype(jnp.int32)
    h = masked_fill_u32(_hash_voxel(ijk), valid, 0xFFFFFFFF)
    order = jnp.argsort(h)
    hs = h[order]
    pay2 = payload if payload.ndim > 1 else payload[:, None]
    pd = pay2.shape[1]
    stacked = jnp.concatenate(
        [points, pay2.astype(points.dtype),
         valid.astype(points.dtype)[:, None]], axis=1)[order]
    ps, pay_s, vf = stacked[:, :3], stacked[:, 3:3 + pd], stacked[:, 3 + pd]
    vs = vf > 0.5
    new_group = jnp.concatenate([jnp.array([True]), hs[1:] != hs[:-1]]) & vs
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1
    gid = masked_fill(gid, vs & (gid < cap) & (gid >= 0), cap)
    acc = jax.ops.segment_sum(
        jnp.concatenate([ps * vf[:, None], pay_s * vf[:, None],
                         vf[:, None]], axis=1), gid,
        num_segments=cap + 1)[:cap]
    sums, psums, counts = acc[:, :3], acc[:, 3:3 + pd], acc[:, 3 + pd]
    out_valid = counts > 0
    c = jnp.maximum(counts, 1.0)
    out = (sums / c[:, None]) * out_valid[:, None]
    outp = (psums / c[:, None]) * out_valid[:, None]
    if payload.ndim == 1:
        outp = outp[:, 0]
    if return_overflow:
        n_groups = jnp.sum(new_group).astype(jnp.int32)
        return out, outp, out_valid, jnp.maximum(n_groups - cap, 0)
    return out, outp, out_valid


@functools.partial(jax.jit, static_argnames=("cap",))
def voxel_representative(
    points: jax.Array, valid: jax.Array, leaf: jax.Array | float, cap: int
) -> Tuple[jax.Array, jax.Array]:
    """One representative POINT per voxel via a ``cap``-slot hash table and a
    single scatter-min (deterministic: lowest input index wins).

    Approximate where ``voxel_downsample`` is exact — hash collisions drop one
    of the colliding voxels entirely — but ~2-3x cheaper at >100K inputs (no
    sort, no reorder gather, no segment sum).  Intended for consumers where
    voxel dedup only BOUNDS SIZE, e.g. an ICP target cloud: nearest-neighbor
    distances are unchanged by duplicates, and a dropped voxel can only raise
    the fitness score (conservative for loop-closure acceptance,
    mapOptmization.cpp:904)."""
    assert cap & (cap - 1) == 0, cap   # power of two
    n = points.shape[0]
    slot = (_hash_voxel(jnp.floor(points / leaf).astype(jnp.int32))
            & jnp.uint32(cap - 1)).astype(jnp.int32)
    slot = masked_fill(slot, valid, cap)
    rep = jnp.full((cap + 1,), n, jnp.int32).at[slot].min(
        jnp.arange(n, dtype=jnp.int32))[:cap]
    ok = rep < n
    out = points[jnp.where(ok, rep, 0)]
    return out * ok[:, None], ok


BIG = jnp.float32(1e30)


@functools.partial(jax.jit, static_argnames=("q_tile", "n_classes"))
def class_nn(
    query: jax.Array,
    ref: jax.Array,
    r_valid: jax.Array,
    ref_key: jax.Array,
    key_lo: jax.Array,
    key_hi: jax.Array,
    excl_le: jax.Array,
    q_tile: int = 512,
    n_classes: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Per-query nearest reference within a KEY CLASS, one fused pass each.

    For class c, query q: the nearest ref r with
    ``key_lo[c, q] <= ref_key[r] <= key_hi[c, q]`` and squared distance
    strictly greater than ``excl_le[c, q]`` (pass -inf to disable the
    exclusion; pass the previous pass's distance to exclude earlier picks).

    This is the array-native form of the reference's ring-windowed secondary
    correspondence searches (featureAssociation.cpp:1170-1221): instead of
    k-NN then filtering k candidates, each class is ONE matmul->penalty->
    argmin fusion over the full reference cloud — fewer passes and exactly
    the reference's nearest-in-class semantics.

    query (Q, 3); ref (R, 3); ref_key (R,) float; key_lo/key_hi/excl_le
    (n_classes, Q).  Returns (sq_dists (n_classes, Q), indices (n_classes, Q)).
    """
    q_n = query.shape[0]
    ref_m = masked_fill(ref, r_valid[:, None], 1e6)
    r_sq = jnp.sum(ref_m * ref_m, axis=-1)
    q_sq = jnp.sum(query * query, axis=-1)

    out_d, out_i = [], []
    for qs in range(0, q_n, q_tile):
        qe = min(qs + q_tile, q_n)
        qb, qsq = query[qs:qe], q_sq[qs:qe]
        ds, is_ = [], []
        for c in range(n_classes):
            lo = key_lo[c, qs:qe, None]
            hi = key_hi[c, qs:qe, None]
            ex = excl_le[c, qs:qe, None]
            d = (
                qsq[:, None]
                - 2.0 * jnp.dot(qb, ref_m.T,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
                + r_sq[None, :]
            )
            pen = ((ref_key[None, :] < lo) | (ref_key[None, :] > hi)
                   | (d <= ex)) * BIG
            d_eff = d + pen
            is_.append(jnp.argmin(d_eff, axis=1).astype(jnp.int32))
            ds.append(jnp.min(d_eff, axis=1))
        out_d.append(jnp.stack(ds))
        out_i.append(jnp.stack(is_))
    dists = jnp.concatenate(out_d, axis=1) if len(out_d) > 1 else out_d[0]
    idxs = jnp.concatenate(out_i, axis=1) if len(out_i) > 1 else out_i[0]
    return jnp.maximum(dists, 0.0), idxs


@functools.partial(jax.jit, static_argnames=("k", "q_tile", "r_tile"))
def knn(
    query: jax.Array,
    q_valid: jax.Array,
    ref: jax.Array,
    r_valid: jax.Array,
    k: int,
    q_tile: int = 8192,
    r_tile: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest references for each query, by squared Euclidean distance.

    query: (Q, 3), ref: (R, 3) with validity masks.  Returns
    (sq_dists (Q, k), indices (Q, k)); invalid refs never appear (they are
    moved to a far sentinel coordinate), invalid queries get all-BIG rows.

    k FUSED PASSES, each recomputing the distance matrix inside a single
    matmul->mask->argmin fusion and excluding all previous picks by a
    distance threshold — no sort/top_k/gather ever sees the (Q, R) matrix.
    This is the plain reference path; on CUDA ``knn_pallas.search`` runs the
    Triton kernel instead.
    """
    q_n, r_n = query.shape[0], ref.shape[0]
    # Recenter by the valid-reference AABB center: the matmul-form distance
    # error scales with coordinate magnitude squared; submap-local
    # coordinates make selection offset-independent.
    lo_v = jnp.min(jnp.where(r_valid[:, None], ref, jnp.inf), axis=0)
    hi_v = jnp.max(jnp.where(r_valid[:, None], ref, -jnp.inf), axis=0)
    c = jnp.where(jnp.any(r_valid), 0.5 * (lo_v + hi_v), 0.0)
    ref = ref - c[None, :]
    query = query - c[None, :]
    ref_m = masked_fill(ref, r_valid[:, None], 1e6)
    r_sq = jnp.sum(ref_m * ref_m, axis=-1)
    q_sq = jnp.sum(query * query, axis=-1)

    out_d, out_i = [], []
    for qs in range(0, q_n, q_tile):
        qe = min(qs + q_tile, q_n)
        qb = query[qs:qe]
        qsq = q_sq[qs:qe]
        m_prev = jnp.full((qe - qs,), -jnp.inf)
        ds, is_ = [], []
        for _ in range(k):
            # One fused kernel: matmul -> broadcast add -> exclusion mask ->
            # (arg)min.  The exclusion is a FLOAT compare (d <= last pick's
            # distance).  Exactly co-distant references collapse to one pick —
            # harmless for correspondence search (identical constraints) and
            # essentially impossible for real float point data.
            d = (
                qsq[:, None]
                - 2.0 * jnp.dot(qb, ref_m.T,
                                preferred_element_type=jnp.float32,
                                precision=jax.lax.Precision.HIGHEST)
                + r_sq[None, :]
            )
            d_eff = d + (d <= m_prev[:, None]) * BIG
            am = jnp.argmin(d_eff, axis=1).astype(jnp.int32)
            dv = jnp.min(d_eff, axis=1)
            ds.append(dv)
            is_.append(am)
            m_prev = dv
        out_d.append(jnp.stack(ds, axis=1))
        out_i.append(jnp.stack(is_, axis=1))
    dists = jnp.concatenate(out_d, axis=0) if len(out_d) > 1 else out_d[0]
    idxs = jnp.concatenate(out_i, axis=0) if len(out_i) > 1 else out_i[0]
    # Exact-distance refinement: the matmul-form distances carry cancellation noise growing with the
    # coordinate offset from the origin; recompute the k winners in the
    # difference form (exact at any offset) and re-sort.
    nn = ref_m[idxs]                             # (Q, k, 3)
    diff = query[:, None, :] - nn
    d_exact = jnp.sum(diff * diff, axis=-1)
    d_exact = jnp.where(dists >= BIG, BIG, d_exact)
    order = jnp.argsort(d_exact, axis=1)
    dists = jnp.take_along_axis(d_exact, order, axis=1)
    idxs = jnp.take_along_axis(idxs, order, axis=1)
    dists = dists + masked_fill(jnp.zeros_like(dists), q_valid[:, None], BIG)
    dists = jnp.maximum(dists, 0.0)  # clamp matmul-form negatives near zero
    return dists, idxs
