"""Curvature features: smoothness, occlusion masks, sectioned edge/planar picks.

Reference behavior: ``src/featureAssociation.cpp:621-784``
(``calculateSmoothness``, ``markOccludedPoints``, ``extractFeatures``).

The reference works on the COMPACTED segmented cloud (ring-by-ring contiguous,
``src/imageProjection.cpp:319-355``) with per-ring start/end indices carrying
5-point guard bands.  We reproduce that layout as a fixed-shape per-ring
compaction: each ring's segmented cells are sorted to the front in column order
(one argsort of a (N_SCAN, H) key — no dynamic shapes), so curvature windows,
section arithmetic, and neighbor suppression all match the reference
semantics while staying dense.

The greedy pick loops (top-2 / top-20 edges, top-4 planar per section, each
pick suppressing +-5 compacted neighbors up to a >10-column gap,
featureAssociation.cpp:699-767) become a fixed-trip argmax/argmin loop
vectorized over all (ring x section) lanes at once: per trip, every lane picks
its best remaining candidate and scatters the suppression window.  This is
exactly the reference's selection order (both pick in curvature order; the
suppression sets are identical), with all 96 lanes running in parallel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import FeatureConfig, SensorConfig
from .projection import RangeImage
from .segmentation import Segmentation
from .masking import masked_fill
from .voxel import voxel_downsample_with_payload


class FeatureCloud(NamedTuple):
    """Fixed-capacity feature point set."""

    xyz: jax.Array       # (cap, 3)
    ring: jax.Array      # (cap,) float32 ring index
    rel_time: jax.Array  # (cap,) scan-relative time in [0, 1]
    valid: jax.Array     # (cap,) bool

    @property
    def count(self):
        return jnp.sum(self.valid)


class ScanFeatures(NamedTuple):
    sharp: FeatureCloud        # cornerPointsSharp     (label 2)
    less_sharp: FeatureCloud   # cornerPointsLessSharp (label 1, superset)
    flat: FeatureCloud         # surfPointsFlat        (label -1, ground only)
    less_flat: FeatureCloud    # surfPointsLessFlat    (0.2 m downsampled rest)
    outlier: FeatureCloud      # thinned invalid-cluster points (outlierCloud;
                               # mapping folds these into the surf map)
    # Points dropped beyond each cloud's fixed cap this scan, in field order
    # [sharp, less_sharp, flat, less_flat, outlier] — no-silent-caps
    # discipline: the reference's std::vector clouds never truncate
    # (featureAssociation.cpp:702-783), so a nonzero entry here means the
    # FeatureConfig caps are undersized for this sensor/scene and should be
    # raised (the CLI warns; tests/test_features.py pins the counter).
    overflow: jax.Array        # (5,) int32


class FeatureDebug(NamedTuple):
    """Internals of the XLA pick path, exposed for the reference-parity
    oracle tests (tests/test_oracle_parity.py).  All arrays are in the
    per-ring COMPACTED layout (ring r's segmented cells first, column
    order)."""
    label: jax.Array       # (N, H) int8: 2 sharp, 1 less-sharp, -1 flat, 0
    curvature: jax.Array   # (N, H) float32
    curv_ok: jax.Array     # (N, H) bool: position has a full curvature window
    occl_picked: jax.Array  # (N, H) bool: suppressed by occlusion/parallel
                            # marking BEFORE any pick
    col: jax.Array         # (N, H) int32 original column of compacted cell
    ground: jax.Array      # (N, H) bool ground flag of compacted cell
    count: jax.Array       # (N,) segmented cells per ring
    lf_mask: jax.Array     # (N, H) bool: less-flat membership pre-downsample


def _compaction_perm(segmented: jax.Array):
    """Per-ring stable-partition permutation: segmented cells first (in column
    order), the rest after.  Equivalent to ``argsort(where(seg, col, col+h))``
    but built with two cumsums + one scatter instead of a per-row sort."""
    n, h = segmented.shape
    cols = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32), (n, h))
    count = jnp.sum(segmented, axis=1).astype(jnp.int32)
    pos_seg = jnp.cumsum(segmented, axis=1, dtype=jnp.int32) - 1
    pos_rest = jnp.cumsum(~segmented, axis=1, dtype=jnp.int32) - 1 \
        + count[:, None]
    target = jnp.where(segmented, pos_seg, pos_rest)       # row-wise bijection
    rows = jnp.arange(n, dtype=jnp.int32)[:, None] * h
    perm = jnp.zeros((n * h,), jnp.int32).at[
        (rows + target).reshape(-1)].set(cols.reshape(-1))
    return perm.reshape(n, h), count, cols


def _compact_rings(img: RangeImage, seg: Segmentation,
                   xyz_deskewed: jax.Array | None = None):
    """Per-ring stable compaction of segmented cells into column order.

    Returns dict of (N_SCAN, H) arrays in compacted layout + per-ring counts.
    Position i of ring r holds that ring's i-th segmented point; tail entries
    (i >= count[r]) are invalid.

    All channels are stacked and permuted with ONE gather (gather ops carry a
    large flat cost on this backend); float32 carries column indices (< 2^24)
    and flags exactly.
    """
    perm, count, cols = _compaction_perm(seg.segmented)
    chans = [
        img.xyz if xyz_deskewed is None else xyz_deskewed,  # 0:3
        img.rng[..., None],                                 # 3
        cols.astype(jnp.float32)[..., None],                # 4
        seg.seg_ground_flag.astype(jnp.float32)[..., None],  # 5
        img.rel_time[..., None],                            # 6
        seg.segmented.astype(jnp.float32)[..., None],       # 7
    ]
    stacked = jnp.concatenate(chans, axis=-1)
    g = jnp.take_along_axis(stacked, perm[..., None], axis=1)
    return {
        "xyz": g[..., 0:3],
        "rng": g[..., 3],
        "col": g[..., 4].astype(jnp.int32),
        "ground": g[..., 5] > 0.5,
        "rel": g[..., 6],
        "seg": g[..., 7] > 0.5,
    }, count


def _shift(a, k, fill):
    """Shift along axis 1 by k (positive = look right), constant fill."""
    if k == 0:
        return a
    if k > 0:
        return jnp.concatenate(
            [a[:, k:], jnp.full(a.shape[:1] + (k,) + a.shape[2:], fill, a.dtype)],
            axis=1)
    return jnp.concatenate(
        [jnp.full(a.shape[:1] + (-k,) + a.shape[2:], fill, a.dtype), a[:, :k]],
        axis=1)


@functools.partial(jax.jit, static_argnames=("sensor", "cfg", "return_debug"))
def extract_features(
    img: RangeImage,
    seg: Segmentation,
    sensor: SensorConfig,
    cfg: FeatureConfig,
    xyz_deskewed: jax.Array | None = None,
    return_debug: bool = False,
) -> ScanFeatures:
    """Full feature extraction.  ``xyz_deskewed`` (N, H, 3) optionally replaces
    the raw cell coordinates (after IMU de-skew), matching the reference's
    ordering where ``adjustDistortion`` precedes feature extraction; curvature
    always uses the PRE-deskew projection ranges exactly like the reference
    (segMsg ranges, featureAssociation.cpp:624-629)."""
    n, h = img.rng.shape
    c, count = _compact_rings(img, seg, xyz_deskewed=xyz_deskewed)

    idx = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32), (n, h))
    in_ring = idx < count[:, None]
    rng = jnp.where(in_ring, c["rng"], 0.0)

    # ---- calculateSmoothness (featureAssociation.cpp:621-641) ----
    halfwin = cfg.curvature_halfwin
    acc = -2.0 * halfwin * rng
    for k in range(1, halfwin + 1):
        acc = acc + _shift(rng, k, 0.0) + _shift(rng, -k, 0.0)
    curvature = acc * acc
    curv_ok = in_ring & (idx >= halfwin) & (idx < count[:, None] - halfwin)

    # ---- markOccludedPoints (featureAssociation.cpp:643-678) ----
    rng_r = _shift(rng, 1, 0.0)
    col_r = _shift(c["col"], 1, 10 ** 6)
    both = in_ring & (_shift(in_ring, 1, False))
    col_close = both & (jnp.abs(col_r - c["col"]) < cfg.occlusion_col_gap)
    occl_self = col_close & (rng > rng_r + cfg.occlusion_range_jump)
    occl_next = col_close & (rng_r > rng + cfg.occlusion_range_jump)
    picked = jnp.zeros((n, h), bool)
    # occl_self at i marks i-5..i; occl_next at i marks i+1..i+6.
    for k in range(0, 6):
        picked = picked | _shift(occl_self, k, False)       # i = j+k marks j
        picked = picked | _shift(occl_next, -(k + 1), False)
    diff_prev = jnp.abs(_shift(rng, -1, 0.0) - rng)
    diff_next = jnp.abs(rng_r - rng)
    parallel = (
        in_ring
        & (diff_prev > cfg.parallel_beam_frac * rng)
        & (diff_next > cfg.parallel_beam_frac * rng)
    )
    picked = picked | parallel
    picked = picked & in_ring
    occl_picked = picked

    # ---- extractFeatures (featureAssociation.cpp:680-784) ----
    # Section boundaries in compacted indices with 5-pt guards:
    # s = 5, e = count - 6 (the reference's startRingIndex/endRingIndex).
    s = jnp.full((n,), halfwin, jnp.int32)
    e = count - halfwin - 1
    j = jnp.arange(cfg.sections, dtype=jnp.int32)
    sp = (s[:, None] * (cfg.sections - j) + e[:, None] * j) // cfg.sections
    ep = (s[:, None] * (cfg.sections - 1 - j) + e[:, None] * (j + 1)) \
        // cfg.sections - 1
    ep = ep.at[:, -1].set(e - 1)  # featureAssociation.cpp:695
    sec_ok = (sp <= ep) & (e[:, None] > s[:, None])  # ring has enough points

    # Lane layout: (n * sections,) flattened ring-section pairs.  Everything
    # below is DENSE (one-hot compares + shifts, no scatter/gather) over these
    # (96, H)/(16, H) grids, which stay cache-resident between fusions.
    sec_lo = sp.reshape(-1)
    sec_hi = ep.reshape(-1)
    lane_ok = sec_ok.reshape(-1)
    n_lanes = n * cfg.sections

    gap = jnp.abs(col_r - c["col"]) > cfg.occlusion_col_gap  # between i and i+1

    SENT = jnp.float32(1e30)  # finite sentinel (arithmetic masking; masking.py)
    pos = jnp.broadcast_to(jnp.arange(h), (n_lanes, h))
    in_sec = (pos >= sec_lo[:, None]) & (pos <= sec_hi[:, None]) \
        & lane_ok[:, None]

    def lane_pick(mask_grid, values_grid, sign):
        """One greedy trip over all 96 ring-section lanes at once: the best
        remaining candidate per lane, as a dense (n, h) one-hot grid."""
        fill = -SENT if sign > 0 else SENT
        v = masked_fill(values_grid, mask_grid, fill)
        v = masked_fill(jnp.repeat(v, cfg.sections, axis=0), in_sec, fill)
        if sign > 0:
            pick = jnp.argmax(v, axis=1).astype(jnp.int32)
            ok = jnp.max(v, axis=1) > -1e29
        else:
            pick = jnp.argmin(v, axis=1).astype(jnp.int32)
            ok = jnp.min(v, axis=1) < 1e29
        onehot = in_sec & (pos == pick[:, None]) & ok[:, None]  # (n_lanes, h)
        return jnp.any(onehot.reshape(n, cfg.sections, h), axis=1)  # (n, h)

    def suppress(picked_grid, pick_grid):
        """The reference's +-5 suppression window around each pick, stopping at
        >10-column gaps (featureAssociation.cpp:721-732) — as 10 shifted ANDs."""
        picked_grid = picked_grid | pick_grid
        chain_r = pick_grid
        chain_l = pick_grid
        for _ in range(5):
            # right: cell j+1 suppressed if j reached and no gap between j, j+1
            chain_r = _shift(chain_r & ~gap, -1, False)
            # left: cell j-1 suppressed if j reached and no gap between j-1, j
            chain_l = _shift(chain_l, 1, False) & ~gap
            picked_grid = picked_grid | chain_r | chain_l
        return picked_grid

    picked_grid = picked
    label = jnp.zeros((n, h), jnp.int8)  # 2 sharp, 1 less-sharp, -1 flat

    # Edge picks: descending curvature, non-ground, curvature > edgeThreshold.
    edge_ok = curv_ok & ~c["ground"] & (curvature > cfg.edge_threshold)
    for t in range(cfg.edge_less_per_section):
        pick_grid = lane_pick(edge_ok & ~picked_grid, curvature, sign=+1)
        lab = jnp.int8(2) if t < cfg.edge_per_section else jnp.int8(1)
        label = jnp.where(pick_grid, lab, label)
        picked_grid = suppress(picked_grid, pick_grid)

    # Planar picks: ascending curvature, GROUND ONLY, curvature < surfThreshold
    # (featureAssociation.cpp:736-749).
    surf_ok = curv_ok & c["ground"] & (curvature < cfg.surf_threshold)
    for t in range(cfg.surf_per_section):
        pick_grid = lane_pick(surf_ok & ~picked_grid, curvature, sign=-1)
        label = jnp.where(pick_grid, jnp.int8(-1), label)
        picked_grid = suppress(picked_grid, pick_grid)

    clouds = _build_clouds(img, seg, c, count, in_ring, label, cfg,
                           xyz_deskewed)
    if return_debug:
        dbg = FeatureDebug(
            label=label, curvature=curvature, curv_ok=curv_ok,
            occl_picked=occl_picked, col=c["col"], ground=c["ground"],
            count=count, lf_mask=in_ring & (label <= 0))
        return clouds, dbg
    return clouds


def _compact_cloud(mask, cap, xyz, ring, rel):
    """Index-order compaction of a dense mask into fixed-cap arrays via
    cumsum + ONE stacked one-winner scatter.  Overflow beyond ``cap`` is
    dropped — and COUNTED: returns (cloud, n_dropped)."""
    mflat = mask.reshape(-1)
    slot = jnp.cumsum(mflat, dtype=jnp.int32) - 1
    tgt = jnp.where(mflat & (slot < cap), slot, cap)
    vals = jnp.concatenate([
        xyz.reshape(-1, 3), ring.reshape(-1, 1), rel.reshape(-1, 1),
        mflat.astype(jnp.float32).reshape(-1, 1)], axis=1)
    out = jnp.zeros((cap + 1, 6), vals.dtype).at[tgt].set(vals)[:cap]
    out_ok = out[:, 5] > 0.5
    z = out_ok.astype(jnp.float32)
    n_total = jnp.sum(mflat).astype(jnp.int32)
    n_dropped = jnp.maximum(n_total - cap, 0)
    return FeatureCloud(xyz=out[:, :3] * z[:, None], ring=out[:, 3] * z,
                        rel_time=out[:, 4] * z, valid=out_ok), n_dropped


def _build_clouds(img, seg, c, count, in_ring, label, cfg, xyz_deskewed):
    """Shared tail of extract_features: label grid -> the five fixed-cap
    feature clouds (featureAssociation.cpp:702-783 output sets)."""
    n, h = img.rng.shape
    ring_f = jnp.broadcast_to(
        jnp.arange(n, dtype=jnp.float32)[:, None], (n, h))

    def gather_cloud(mask, cap):
        return _compact_cloud(mask, cap, c["xyz"], ring_f, c["rel"])

    sharp, sharp_drop = gather_cloud(label == 2, cfg.max_sharp)
    less_sharp, ls_drop = gather_cloud(label >= 1, cfg.max_less_sharp)
    flat, flat_drop = gather_cloud(label == -1, cfg.max_flat)

    # Less-flat: every segmented point with label <= 0 (includes flat picks),
    # downsampled at 0.2 m (featureAssociation.cpp:771-783, per-ring
    # VoxelGrid).  See FeatureConfig.less_flat_method.
    lf_mask = in_ring & (label <= 0)
    if cfg.less_flat_method == "run":
        # First-of-run adjacent-cell dedup along each (azimuth-ordered)
        # ring: keeps one real point per contiguous same-voxel run — the
        # vectorized equivalent of the reference's per-ring voxel thinning.
        cell = jnp.floor(c["xyz"] / cfg.less_flat_leaf).astype(jnp.int32)
        same = jnp.all(cell == jnp.roll(cell, 1, axis=1), axis=-1)
        prev_lf = jnp.roll(lf_mask, 1, axis=1)
        keep = lf_mask & ~(same & prev_lf)
        keep = keep.at[:, 0].set(lf_mask[:, 0])   # ring start begins a run
        less_flat, lf_drop = _compact_cloud(keep, cfg.max_less_flat, c["xyz"],
                                            ring_f, c["rel"])
    else:
        payload = jnp.stack([ring_f, c["rel"]], axis=-1).reshape(-1, 2)
        pts, pay, v, lf_drop = voxel_downsample_with_payload(
            c["xyz"].reshape(-1, 3), payload, lf_mask.reshape(-1),
            cfg.less_flat_leaf, cfg.max_less_flat, return_overflow=True,
        )
        less_flat = FeatureCloud(xyz=pts, ring=pay[:, 0], rel_time=pay[:, 1],
                                 valid=v)

    # Outlier cloud (imageProjection.cpp:328-335): gathered straight from the
    # DENSE image (these cells are not part of the ring compaction).
    xyz_src = img.xyz if xyz_deskewed is None else xyz_deskewed
    outlier, out_drop = _compact_cloud(seg.outlier, cfg.max_outlier, xyz_src,
                                       ring_f, img.rel_time)

    overflow = jnp.stack([sharp_drop, ls_drop, flat_drop, lf_drop, out_drop]
                         ).astype(jnp.int32)
    return ScanFeatures(sharp=sharp, less_sharp=less_sharp, flat=flat,
                        less_flat=less_flat, outlier=outlier,
                        overflow=overflow)
