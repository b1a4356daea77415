"""Feature extraction tests: picks must land where geometry says they should
(poles/corners -> edges, ground -> planar), with reference cap semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT, VLP16
from legoloam_tpu.ops import features, projection, segmentation
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic


@pytest.fixture(scope="module")
def feats_and_inputs():
    scene = synthetic.default_scene()
    pose = Pose(jnp.eye(3), jnp.array([0.0, 0.0, 0.8]))
    pts, valid, ring = synthetic.raycast_scan(scene, pose, VLP16)
    img = projection.project_scan(pts, valid, VLP16, ring=ring)
    seg = segmentation.segment(img, VLP16, DEFAULT.seg)
    f = features.extract_features(img, seg, VLP16, DEFAULT.feat)
    return f, img, seg


def test_feature_counts(feats_and_inputs):
    f, img, seg = feats_and_inputs
    n_sharp = int(f.sharp.count)
    n_less = int(f.less_sharp.count)
    n_flat = int(f.flat.count)
    n_lf = int(f.less_flat.count)
    # Caps from the reference: 2/section edges, 20 less-sharp, 4 planar
    # (featureAssociation.cpp:709-747).
    assert 0 < n_sharp <= 16 * 6 * 2
    assert n_sharp <= n_less <= 16 * 6 * 20
    assert 0 < n_flat <= 16 * 6 * 4
    assert n_lf > 500  # plenty of downsampled surface points
    # sharp ⊆ less_sharp by construction (labels 2 and >=1).
    assert n_less >= n_sharp


def test_flat_features_are_on_ground(feats_and_inputs):
    f, img, seg = feats_and_inputs
    xyz = np.asarray(f.flat.xyz)[np.asarray(f.flat.valid)]
    # Ground plane z=0, sensor at 0.8 -> flat points at z ~= -0.8.  A couple
    # of picks may sit on box-top edges where a wall point and a far ground
    # point form a near-horizontal vector — the reference's ground criterion
    # (imageProjection.cpp:280-289) has the identical artifact.
    on_plane = np.abs(xyz[:, 2] + 0.8) < 0.1
    assert on_plane.mean() > 0.9


def test_sharp_features_are_vertical_edges(feats_and_inputs):
    """Edges in this scene are pole surfaces and wall corners — all far from
    the ground plane and with high curvature."""
    f, img, seg = feats_and_inputs
    xyz = np.asarray(f.sharp.xyz)[np.asarray(f.sharp.valid)]
    assert xyz.shape[0] > 0
    # Not on the ground.
    assert np.all(xyz[:, 2] > -0.75)


def test_less_flat_includes_walls_and_ground(feats_and_inputs):
    f, _, _ = feats_and_inputs
    xyz = np.asarray(f.less_flat.xyz)[np.asarray(f.less_flat.valid)]
    z = xyz[:, 2]
    assert (np.abs(z + 0.8) < 0.1).sum() > 200   # ground points
    assert (z > -0.5).sum() > 100                # wall points


def test_feature_determinism(feats_and_inputs):
    f, img, seg = feats_and_inputs
    f2 = features.extract_features(img, seg, VLP16, DEFAULT.feat)
    np.testing.assert_array_equal(np.asarray(f.sharp.xyz), np.asarray(f2.sharp.xyz))
    np.testing.assert_array_equal(np.asarray(f.less_flat.valid),
                                  np.asarray(f2.less_flat.valid))


def test_empty_scan_has_no_features():
    img = projection.project_scan(
        jnp.zeros((100, 3)), jnp.zeros(100, bool), VLP16,
        ring=jnp.zeros(100, jnp.int32))
    seg = segmentation.segment(img, VLP16, DEFAULT.seg)
    f = features.extract_features(img, seg, VLP16, DEFAULT.feat)
    assert int(f.sharp.count) == 0
    assert int(f.less_sharp.count) == 0
    assert int(f.flat.count) == 0
    assert int(f.less_flat.count) == 0


def test_feature_cap_overflow_counted(feats_and_inputs):
    """Undersized FeatureConfig caps drop points — and COUNT them in
    ScanFeatures.overflow (no-silent-caps); generous default caps stay 0."""
    import dataclasses
    feats, img, seg = feats_and_inputs
    assert not np.asarray(feats.overflow).any()     # defaults never overflow
    tiny = dataclasses.replace(
        DEFAULT.feat, max_sharp=8, max_less_sharp=16, max_flat=8,
        max_less_flat=64, max_outlier=8)
    f2 = features.extract_features(img, seg, VLP16, tiny)
    over = np.asarray(f2.overflow)
    assert (over > 0).all(), over
    # Counted exactly: kept + dropped == the uncapped population.
    assert int(f2.sharp.valid.sum()) + int(over[0]) \
        == int(feats.sharp.valid.sum())
    assert int(f2.outlier.valid.sum()) + int(over[4]) \
        == int(feats.outlier.valid.sum())
