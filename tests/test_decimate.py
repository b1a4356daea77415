"""Keyframe-store saturation behavior: overflow counters + decimation.

The reference's keyframe store is unbounded (``cornerCloudKeyFrames`` etc.,
``src/mapOptmization.cpp:84-86``) and its validation runs exceed 20K scans
(``README.md:104-106``).  Here the store is a compile-time shape, so at the
cap the system must (a) COUNT what it drops (no-silent-caps) and (b) offer
graceful sparsification (``mapping.decimate_keyframes``) that drivers invoke
before overflow ever happens (``pipeline.maybe_decimate``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import mapping, pipeline, posegraph
from legoloam_tpu.models.posegraph import _between_residual
from legoloam_tpu.ops import se3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import synthetic

SMALL = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=16, scan_corner_cap=64, scan_surf_cap=128,
    submap_corner_cap=1024, submap_surf_cap=2048, decimate_keep_recent=4)


def fill_store(cfg, n, spacing=1.0):
    """Line trajectory with distinct tiny clouds; chain = true relatives."""
    st = mapping.init_state(cfg)
    kf = st.kf
    key = jax.random.PRNGKey(0)
    for k in range(n):
        key, sub = jax.random.split(key)
        t = jnp.array([k * spacing, 0.1 * k, 0.0])
        c = jax.random.uniform(sub, (cfg.scan_corner_cap, 3)) * 2.0
        s = jax.random.uniform(sub, (cfg.scan_surf_cap, 3)) * 2.0
        prev_t = kf.t[k - 1] if k else jnp.zeros(3)
        kf = kf._replace(
            R=kf.R.at[k].set(jnp.eye(3)),
            t=kf.t.at[k].set(t),
            time=kf.time.at[k].set(float(k)),
            chain_R=kf.chain_R.at[k].set(jnp.eye(3)),
            chain_t=kf.chain_t.at[k].set(t - prev_t),
            corner=kf.corner.at[k].set(c),
            corner_valid=kf.corner_valid.at[k].set(True),
            surf=kf.surf.at[k].set(s),
            surf_valid=kf.surf_valid.at[k].set(True),
            count=jnp.int32(k + 1))
    return kf


def test_overflow_counted_not_silent():
    """A keyframe warranted while the store is full increments the overflow
    counter and flags the diag — saturation is never silent."""
    cfg = SMALL
    kf = fill_store(cfg, 16)          # full
    st = mapping.init_state(cfg)._replace(
        kf=kf, initialized=jnp.array(True))
    corner = mapping.FeatureCloud(
        xyz=jnp.ones((256, 3)), ring=jnp.zeros(256),
        rel_time=jnp.zeros(256), valid=jnp.ones(256, bool)) \
        if hasattr(mapping, "FeatureCloud") else None
    from legoloam_tpu.ops.features import FeatureCloud

    def cloud(n):
        return FeatureCloud(xyz=jnp.ones((n, 3)) * 20.0, ring=jnp.zeros(n),
                            rel_time=jnp.zeros(n), valid=jnp.ones(n, bool))

    # Odometry pose far from the last keyframe -> moved=True, but full.
    far = Pose(jnp.eye(3), jnp.array([100.0, 0.0, 0.0]))
    st2, T, diag = mapping.mapping_step(
        st, cloud(256), cloud(1024), cloud(256), far, jnp.float32(99.0), cfg)
    assert int(st2.kf.count) == 16          # unchanged: no room
    assert bool(diag.kf_overflow)
    assert int(st2.kf.overflow) == 1


def test_decimate_halves_and_keeps_anchor_and_recent():
    cfg = SMALL
    kf = fill_store(cfg, 16)
    loops = posegraph.init_loop_factors(8)
    kf2, loops2 = mapping.decimate_keyframes(kf, loops, keep_recent=4)
    # keep: idx 12..15 (recent) + even of 0..11 -> 6 + 4 = 10
    assert int(kf2.count) == 10
    np.testing.assert_allclose(np.asarray(kf2.t[0]), np.asarray(kf.t[0]),
                               atol=0)       # anchor kept
    np.testing.assert_allclose(np.asarray(kf2.t[9]), np.asarray(kf.t[15]),
                               atol=0)       # most recent kept
    # times preserved for survivors (0,2,4,6,8,10,12,13,14,15)
    np.testing.assert_allclose(
        np.asarray(kf2.time[:10]),
        [0, 2, 4, 6, 8, 10, 12, 13, 14, 15], atol=0)
    # Cloud payloads ride along with their keyframe.
    np.testing.assert_allclose(np.asarray(kf2.corner[1]),
                               np.asarray(kf.corner[2]), atol=0)
    # Inert tail rows cleared.
    assert not bool(jnp.any(kf2.corner_valid[10:]))


def test_decimate_chain_reconstructs_poses():
    """Composing the re-derived chain measurements from the anchor must
    reproduce every surviving pose exactly (the sparsified chain absorbs the
    dropped nodes' constraints)."""
    cfg = SMALL
    kf = fill_store(cfg, 16)
    loops = posegraph.init_loop_factors(8)
    kf2, _ = mapping.decimate_keyframes(kf, loops, keep_recent=4)
    T = Pose(kf2.R[0], kf2.t[0])
    for s in range(1, int(kf2.count)):
        T = se3.compose(T, Pose(kf2.chain_R[s], kf2.chain_t[s]))
        np.testing.assert_allclose(np.asarray(T.t), np.asarray(kf2.t[s]),
                                   atol=1e-5)


def test_decimate_loop_factor_remap_preserves_constraint():
    """A loop factor between two DROPPED nodes remaps onto surviving anchors
    with a compensated measurement Z' = (T_ai⁻¹T_i)·Z·(T_j⁻¹T_aj).  The
    transported constraint is EQUIVALENT: estimates satisfying the original
    exactly satisfy the remapped one exactly (zero residual preserved), and
    a nonzero error E = Z⁻¹T_i⁻¹T_j maps to the conjugate O_j⁻¹ E O_j —
    same error, expressed in the anchor's frame."""
    cfg = SMALL
    kf = fill_store(cfg, 16)

    # --- zero-residual invariance: estimate-consistent measurement ---
    loops = posegraph.init_loop_factors(8)
    Z0 = se3.relative(Pose(kf.R[3], kf.t[3]), Pose(kf.R[9], kf.t[9]))
    loops = posegraph.add_loop_factor(loops, 3, 9, Z0, jnp.float32(0.01))
    kf2, loops2 = mapping.decimate_keyframes(kf, loops, keep_recent=4)
    ni, nj = int(loops2.i[0]), int(loops2.j[0])
    assert bool(loops2.valid[0])
    # nodes 3 -> anchor 2 (new slot 1); 9 -> anchor 8 (new slot 4)
    assert (ni, nj) == (1, 4)
    r_after = _between_residual(Pose(kf2.R[ni], kf2.t[ni]),
                                Pose(kf2.R[nj], kf2.t[nj]),
                                Pose(loops2.R[0], loops2.t[0]))
    np.testing.assert_allclose(np.asarray(r_after), np.zeros(6), atol=1e-5)

    # --- nonzero error transported by conjugation ---
    loops = posegraph.init_loop_factors(8)
    Z = Pose(se3.so3_exp(jnp.array([0.0, 0.0, 0.1])),
             jnp.array([5.9, 0.5, 0.1]))
    loops = posegraph.add_loop_factor(loops, 3, 9, Z, jnp.float32(0.01))
    kf2, loops2 = mapping.decimate_keyframes(kf, loops, keep_recent=4)
    ni, nj = int(loops2.i[0]), int(loops2.j[0])
    E_before = se3.compose(se3.inverse(Z),
                           se3.relative(Pose(kf.R[3], kf.t[3]),
                                        Pose(kf.R[9], kf.t[9])))
    O_j = se3.relative(Pose(kf.R[9], kf.t[9]), Pose(kf.R[8], kf.t[8]))
    E_expect = se3.compose(se3.inverse(O_j), se3.compose(E_before, O_j))
    E_after = se3.compose(
        se3.inverse(Pose(loops2.R[0], loops2.t[0])),
        se3.relative(Pose(kf2.R[ni], kf2.t[ni]),
                     Pose(kf2.R[nj], kf2.t[nj])))
    np.testing.assert_allclose(np.asarray(E_after.t),
                               np.asarray(E_expect.t), atol=1e-5)
    np.testing.assert_allclose(np.asarray(E_after.R),
                               np.asarray(E_expect.R), atol=1e-5)


def test_decimate_collapsed_factor_dropped_and_counted():
    cfg = SMALL
    kf = fill_store(cfg, 16)
    loops = posegraph.init_loop_factors(8)
    # 2 and 3 share anchor 2 -> collapses.
    loops = posegraph.add_loop_factor(loops, 2, 3, Pose.identity(),
                                      jnp.float32(0.01))
    kf2, loops2 = mapping.decimate_keyframes(kf, loops, keep_recent=4)
    assert not bool(loops2.valid[0])
    assert int(loops2.dropped) == 1


def test_loop_factor_cap_overflow_counted():
    loops = posegraph.init_loop_factors(2)
    for k in range(4):
        loops = posegraph.add_loop_factor(
            loops, k, k + 1, Pose.identity(), jnp.float32(0.1))
    assert int(loops.count) == 2
    assert int(loops.dropped) == 2


import pytest


@pytest.mark.slow
def test_slam_sequence_survives_saturation():
    """Full pipeline with a tiny keyframe cap: maybe_decimate keeps the run
    going — finite poses, zero overflow, count bounded below the cap."""
    cfg = DEFAULT.replace(mapping=dataclasses.replace(
        DEFAULT.mapping, max_keyframes=48, decimate_keep_recent=16))
    scene = synthetic.loop_scene()
    n = 144
    poses = synthetic.circle_trajectory(n + 1, radius=30.0,
                                        angular_rate=0.009)
    scans = []
    for k in range(n):
        scans.append(synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True))
    fused, state = pipeline.run_slam_sequence(scans, cfg)
    assert bool(jnp.all(jnp.isfinite(fused.t)))
    assert int(state.mapping.kf.overflow) == 0, \
        f"store overflowed {int(state.mapping.kf.overflow)} times"
    assert int(state.mapping.kf.count) < 48
    # Trajectory quality survives decimation: bounded error on the lap.
    gt = np.asarray(poses.t[:n]) - np.asarray(poses.t[0])
    err = np.linalg.norm(np.asarray(fused.t) - gt, axis=1)
    assert float(err.max()) < 2.0, float(err.max())
