"""Ground removal + connected-component segmentation on the dense range image.

Reference behavior: ``src/imageProjection.cpp:260-460`` (``groundRemoval``,
``cloudSegmentation``, ``labelComponents``).

The reference's ``labelComponents`` is a queue-based BFS from every unlabeled cell
with hand-rolled array queues ("use std::queue ... will slow the program down
greatly", imageProjection.cpp:138-142).  BFS is inherently sequential; the
replacement is classic GPU connected-component labeling in plain XLA:

  1. Precompute the 4-neighbor connectivity ONCE from the angle predicate
     (imageProjection.cpp:411-423) — a handful of fused elementwise ops.
  2. Iterative min-label diffusion with pointer-jumping compression
     (label <- label[label]), which converges in O(log diameter) sweeps instead
     of the O(diameter) of plain diffusion.

Labels are root flat-indices into the (N_SCAN*H) grid, so compression is a pure
gather.  Cluster statistics (size, ring span) for the validity rule
(imageProjection.cpp:440-451) are two segment reductions over the final labels.

All outputs are DENSE masks (no compaction).  The reference's compacted
"segmentedCloud + segMsg" bookkeeping (start/end ring indices, per-point ground
flag / column / range, imageProjection.cpp:319-355) is reproduced at the feature
extraction boundary (``ops/features.py``) where the per-ring ordering matters.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SegmentationConfig, SensorConfig
from .projection import RangeImage

# Sentinel used by the reference for invalid clusters (imageProjection.cpp:456-458).
OUTLIER_LABEL = 999999


class Segmentation(NamedTuple):
    """Dense per-cell segmentation results, all (N_SCAN, H) unless noted."""

    ground: jax.Array        # bool: cell is ground (groundMat == 1)
    label: jax.Array         # int32 cluster root id; -1 ground/invalid; OUTLIER_LABEL
    segmented: jax.Array     # bool: cell enters the segmented cloud (features)
    outlier: jax.Array       # bool: cell enters the outlier cloud
    seg_ground_flag: jax.Array  # bool: segmented cell is ground (segMsg flag)
    n_clusters: jax.Array    # () int32: number of valid clusters (diagnostic)


def ground_removal(img: RangeImage, sensor: SensorConfig,
                   cfg: SegmentationConfig) -> jax.Array:
    """Reference ``groundRemoval`` (imageProjection.cpp:260-310), vectorized.

    For rings 0..ground_scan_ind-1, the angle of the vector between vertically
    adjacent returns is compared against the mount angle; both cells of a
    near-horizontal pair are marked ground.
    """
    g = sensor.ground_scan_ind
    lower = img.xyz[:g]          # (g, H, 3)
    upper = img.xyz[1 : g + 1]
    diff = upper - lower
    angle = jnp.degrees(
        jnp.arctan2(diff[..., 2], jnp.linalg.norm(diff[..., :2], axis=-1))
    )
    both = img.valid[:g] & img.valid[1 : g + 1]
    flat_pair = both & (
        jnp.abs(angle - sensor.mount_angle_deg) <= cfg.ground_angle_thresh_deg
    )
    ground = jnp.zeros(img.rng.shape, bool)
    ground = ground.at[:g].set(flat_pair)
    ground = ground.at[1 : g + 1].set(ground[1 : g + 1] | flat_pair)
    return ground & img.valid


def _connectivity(img: RangeImage, sensor: SensorConfig, cfg: SegmentationConfig):
    """4-neighbor angle-predicate connectivity with column wraparound.

    Edge criterion between ranges d1 >= d2 separated by angular resolution alpha:
    ``atan2(d2*sin(a), d1 - d2*cos(a)) > segmentTheta`` (imageProjection.cpp:411-423).

    Returns (conn_h, conn_v): conn_h[r, c] connects (r,c)<->(r,(c+1)%H);
    conn_v[r, c] connects (r,c)<->(r+1,c), shape (N-1, H).
    """
    theta = jnp.radians(jnp.float32(cfg.segment_theta_deg))

    def edge(a_rng, b_rng, alpha):
        d1 = jnp.maximum(a_rng, b_rng)
        d2 = jnp.minimum(a_rng, b_rng)
        ang = jnp.arctan2(d2 * jnp.sin(alpha), d1 - d2 * jnp.cos(alpha))
        return ang > theta

    r = jnp.where(img.valid, img.rng, jnp.inf)
    conn_h = edge(r, jnp.roll(r, -1, axis=1), jnp.float32(sensor.ang_res_x))
    conn_h &= img.valid & jnp.roll(img.valid, -1, axis=1)
    conn_v = edge(r[:-1], r[1:], jnp.float32(sensor.ang_res_y))
    conn_v &= img.valid[:-1] & img.valid[1:]
    return conn_h, conn_v


def _seg_min_scan(labels: jax.Array, boundary: jax.Array, axis: int,
                  reverse: bool) -> jax.Array:
    """Segmented running-min along ``axis``: within each run (boundary=True
    starts a new run), every element sees the min of all elements scanned so
    far in its run.  Associative combine: (v, g)·(v', g') =
    (g' ? v' : min(v, v'), g|g')."""

    def combine(a, b):
        av, ag = a
        bv, bg = b
        v = jnp.where(bg, bv, jnp.minimum(av, bv))
        return v, ag | bg

    v, _ = jax.lax.associative_scan(
        combine, (labels, boundary), axis=axis, reverse=reverse)
    return v


def _label_propagation(seed_mask: jax.Array, conn_h: jax.Array, conn_v: jax.Array,
                       max_iters: int) -> jax.Array:
    """Connected components by alternating SEGMENTED MIN-SCANS.

    Data-parallel replacement of the reference's queue BFS: a parallel-prefix
    (associative_scan) min over each horizontal run propagates a label across
    an ENTIRE row-run (wrap-around included, via array doubling) in one pass;
    alternating with vertical scans carries labels around corners.  ``sweeps``
    scans handle components whose min-label path bends up to ``sweeps`` times
    — range-image clusters (walls, vehicles, poles) are overwhelmingly convex
    enough that 6 sweeps + a pointer-jump compression converge; pathological
    snake-shaped components can fragment, which only affects the validity
    decision of small clusters (the size/ring-span rule is insensitive for
    large ones).

    Returns root flat-index labels (N, H); non-seed cells get n_cells.
    """
    n, h = seed_mask.shape
    n_cells = n * h
    big = jnp.int32(n_cells)
    labels = jnp.where(
        seed_mask,
        jnp.arange(n_cells, dtype=jnp.int32).reshape(n, h),
        big,
    )

    # Neighbors participate only if BOTH endpoints are segmentation seeds:
    # the reference BFS never crosses ground/invalid cells because those have
    # labelMat = -1 (imageProjection.cpp:295-301).
    conn_h = conn_h & seed_mask & jnp.roll(seed_mask, -1, axis=1)
    conn_v = conn_v & seed_mask[:-1] & seed_mask[1:]

    # Run-boundary flags per scan direction: an element starts a new run iff
    # it is not connected to the PREVIOUS element in scan order.  Circular
    # wrap is handled by doubling the row and reading the saturated half.
    rbf = ~jnp.roll(conn_h, 1, axis=1)             # fwd: not connected to c-1
    rbr = ~conn_h                                  # rev: not connected to c+1
    rbf2 = jnp.concatenate([rbf, rbf], axis=1)
    rbr2 = jnp.concatenate([rbr, rbr], axis=1)
    cbf = jnp.concatenate([jnp.ones((1, h), bool), ~conn_v], axis=0)
    cbr = jnp.concatenate([~conn_v, jnp.ones((1, h), bool)], axis=0)

    def sweep(labels):
        lab2 = jnp.concatenate([labels, labels], axis=1)
        fwd = _seg_min_scan(lab2, rbf2, axis=1, reverse=False)[:, h:]
        bwd = _seg_min_scan(lab2, rbr2, axis=1, reverse=True)[:, :h]
        labels = jnp.minimum(fwd, bwd)
        down = _seg_min_scan(labels, cbf, axis=0, reverse=False)
        up = _seg_min_scan(labels, cbr, axis=0, reverse=True)
        return jnp.minimum(down, up)

    # Sweep to FIXPOINT (bounded by max_iters): at the fixpoint every
    # connected pair carries the same label, so the partition equals the
    # reference BFS's connected components exactly (verified against the
    # NumPy oracle, tests/test_oracle_parity.py) instead of depending on a
    # sweep budget.  Realistic scans converge in <= 6 sweeps; the bound only
    # caps adversarial snake-shaped components.
    def cond(st):
        labels, i, changed = st
        return changed & (i < max_iters)

    def body(st):
        labels, i, _ = st
        new = sweep(labels)
        return new, i + 1, jnp.any(new != labels)

    labels, _, _ = jax.lax.while_loop(
        cond, body, (sweep(labels), jnp.int32(1), jnp.array(True)))

    # One pointer-jump compression canonicalizes any stragglers to their root.
    flat = jnp.concatenate([labels.reshape(-1), jnp.array([big])])
    flat = flat[flat[:n_cells]]
    flat = jnp.concatenate([flat, jnp.array([big])])[flat]
    return flat[:n_cells].reshape(n, h)


def segment(img: RangeImage, sensor: SensorConfig,
            cfg: SegmentationConfig) -> Segmentation:
    """Full reference ``cloudSegmentation`` (imageProjection.cpp:312-368)."""
    n, h = sensor.n_scan, sensor.horizon_scan
    n_cells = n * h
    ground = ground_removal(img, sensor, cfg)

    seeds = img.valid & ~ground
    conn_h, conn_v = _connectivity(img, sensor, cfg)
    labels = _label_propagation(seeds, conn_h, conn_v, cfg.ccl_max_iters)
    flat_labels = labels.reshape(-1)

    # Cluster validity (imageProjection.cpp:440-451): size >= 30, or size >=
    # valid_point_num spanning >= valid_line_num rings.  4-connectivity only
    # links vertically ADJACENT rings, so every connected component (and every
    # label class the propagation produces — each is a connected subset)
    # occupies a CONTIGUOUS ring interval; the reference's distinct-ring count
    # (lineCountFlag, imageProjection.cpp:436-446) therefore equals
    # max_ring - min_ring + 1 — two small segment reductions instead of a
    # (n_cells x n_scan) one-hot scatter — MINUS the reference's seed quirk:
    # lineCountFlag is set only for cells PUSHED by the BFS, and the seed
    # (the component's first cell in row-major order, hence in its minimum
    # ring) is never pushed, so its ring counts only if another component
    # cell shares it.  Reproduced exactly: subtract 1 when the minimum ring
    # holds a single cell (imageProjection.cpp:376-449).
    seeds_flat = seeds.reshape(-1)
    ones = seeds_flat.astype(jnp.int32)
    sizes = jax.ops.segment_sum(ones, flat_labels, num_segments=n_cells + 1)
    cell_size = sizes[flat_labels].reshape(n, h)
    ring_of = (jnp.arange(n_cells, dtype=jnp.int32) // h)
    rmin = jax.ops.segment_min(
        jnp.where(seeds_flat, ring_of, n), flat_labels,
        num_segments=n_cells + 1)
    rmax = jax.ops.segment_max(
        jnp.where(seeds_flat, ring_of, -1), flat_labels,
        num_segments=n_cells + 1)
    rmin_flat = rmin[flat_labels]
    cell_rspan = (rmax[flat_labels] - rmin_flat + 1).reshape(n, h)
    in_min_row = seeds_flat & (ring_of == rmin_flat)
    min_row_count = jax.ops.segment_sum(
        in_min_row.astype(jnp.int32), flat_labels, num_segments=n_cells + 1)
    cell_line_count = cell_rspan - (
        min_row_count[flat_labels].reshape(n, h) == 1)
    cell_valid_cluster = seeds & (
        (cell_size >= cfg.min_cluster_size)
        | ((cell_size >= cfg.valid_point_num)
           & (cell_line_count >= cfg.valid_line_num))
    )
    cell_invalid_cluster = seeds & ~cell_valid_cluster

    # Outlier thinning (imageProjection.cpp:328-335): invalid-cluster points in
    # rows > ground_scan_ind kept one-in-five columns.
    cols = jnp.arange(h)[None, :]
    rows = jnp.arange(n)[:, None]
    outlier = (
        cell_invalid_cluster
        & (rows > sensor.ground_scan_ind)
        & (cols % cfg.outlier_downsample == 0)
    )

    # Ground thinning (imageProjection.cpp:337-339): ground kept iff col%5==0 or
    # within 5 columns of either edge.
    ground_kept = ground & (
        (cols % cfg.ground_downsample == 0) | (cols <= 5) | (cols >= h - 5)
    )

    segmented = cell_valid_cluster | ground_kept
    seg_ground_flag = ground_kept

    # Count valid clusters (diagnostic; roots are cells whose label == own index).
    root_ids = jnp.arange(n_cells, dtype=jnp.int32)
    is_root = seeds.reshape(-1) & (flat_labels == root_ids)
    n_clusters = jnp.sum(is_root & cell_valid_cluster.reshape(-1))

    label_out = jnp.where(
        cell_valid_cluster, labels,
        jnp.where(cell_invalid_cluster, OUTLIER_LABEL, -1),
    )

    return Segmentation(
        ground=ground,
        label=label_out,
        segmented=segmented,
        outlier=outlier,
        seg_ground_flag=seg_ground_flag,
        n_clusters=n_clusters,
    )
