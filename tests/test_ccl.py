"""Connected-component labeling (segmentation._label_propagation) and the
cluster statistics of ``segment`` vs NumPy references: a union-find over the
same 4-neighbor connectivity, and per-cluster ring spans computed directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.ops import projection, segmentation
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic


def _canon(labels, seeds):
    """Per seed cell: the smallest flat index sharing its label (-1 off the
    seed mask) — a root-invariant partition representation."""
    lab = np.asarray(labels).reshape(-1)
    s = np.asarray(seeds).reshape(-1)
    rep = np.full(lab.shape, -1, np.int64)
    first = {}
    for i in np.nonzero(s)[0]:
        rep[i] = first.setdefault(lab[i], i)
    return rep


def _union_find(seeds, conn_h, conn_v):
    """NumPy union-find partition over seed cells joined by conn_h (column
    wrap included) and conn_v."""
    seeds, conn_h, conn_v = (np.asarray(x) for x in (seeds, conn_h, conn_v))
    n, h = seeds.shape
    parent = np.arange(n * h)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for r, c in zip(*np.nonzero(conn_h & seeds & np.roll(seeds, -1, 1))):
        union(r * h + c, r * h + (c + 1) % h)
    for r, c in zip(*np.nonzero(conn_v & seeds[:-1] & seeds[1:])):
        union(r * h + c, (r + 1) * h + c)
    return np.array([find(i) for i in range(n * h)]).reshape(n, h)


def _scan(idx):
    cfg = DEFAULT
    pose = Pose(jnp.eye(3), jnp.array([0.4 * idx, 0.1 * idx, 0.8]))
    pts, valid, ring = synthetic.raycast_scan(synthetic.default_scene(), pose,
                                              cfg.sensor)
    img = projection.project_scan(pts, valid, cfg.sensor, ring=ring)
    ground = segmentation.ground_removal(img, cfg.sensor, cfg.seg)
    seeds = img.valid & ~ground
    conn_h, conn_v = segmentation._connectivity(img, cfg.sensor, cfg.seg)
    return img, seeds, conn_h, conn_v


@pytest.mark.parametrize("scan_idx", [0, 1])
def test_label_propagation_matches_union_find(scan_idx):
    _, seeds, conn_h, conn_v = _scan(scan_idx)
    lab = segmentation._label_propagation(seeds, conn_h, conn_v,
                                          DEFAULT.seg.ccl_max_iters)
    assert (_canon(lab, seeds) == _canon(_union_find(seeds, conn_h, conn_v),
                                         seeds)).all()
    # Non-seed cells keep the sentinel.
    assert (np.asarray(lab)[~np.asarray(seeds)] == seeds.size).all()


def test_segment_ring_span_validity():
    """``segment``'s cluster validity (size >= 30, or size >= 5 spanning >= 3
    rings with the reference's seed-ring quirk, imageProjection.cpp:436-451)
    recomputed in NumPy from the union-find partition."""
    cfg = DEFAULT
    img, seeds, conn_h, conn_v = _scan(1)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    part = _union_find(seeds, conn_h, conn_v)
    s = np.asarray(seeds)
    rows = np.broadcast_to(np.arange(s.shape[0])[:, None], s.shape)
    want = np.zeros(s.shape, bool)
    n_multi_ring = 0
    for root in np.unique(part[s]):
        cells = s & (part == root)
        rr = rows[cells]
        size, lo = rr.size, rr.min()
        lines = rr.max() - lo + 1 - int((rr == lo).sum() == 1)
        n_multi_ring += lines >= cfg.seg.valid_line_num
        want[cells] = (size >= cfg.seg.min_cluster_size) or (
            size >= cfg.seg.valid_point_num
            and lines >= cfg.seg.valid_line_num)
    label = np.asarray(seg.label)
    got = s & (label >= 0) & (label != segmentation.OUTLIER_LABEL)
    assert n_multi_ring > 0
    assert (got == want).all()
    assert ((label == segmentation.OUTLIER_LABEL) == (s & ~want)).all()


def test_seam_crossing_cluster():
    """A wall crossing the column-wrap seam must become ONE cluster spanning
    its three rings."""
    cfg = DEFAULT
    n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    colmask = (jnp.arange(h) >= h - 5) | (jnp.arange(h) < 5)
    seeds = jnp.zeros((n, h), bool).at[8:11, :].set(colmask[None, :])
    conn_h = seeds & jnp.roll(seeds, -1, axis=1)
    conn_v = seeds[:-1] & seeds[1:]
    lab = np.asarray(segmentation._label_propagation(seeds, conn_h, conn_v, 6))
    labs = lab[np.asarray(seeds)]
    assert (labs == labs[0]).all(), "seam-crossing cluster fragmented"
    rows = np.nonzero(np.asarray(seeds))[0]
    assert rows.min() == 8 and rows.max() == 10
