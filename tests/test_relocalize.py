"""Kidnapped-robot relocalization (models/relocalize.py): a scan taken far
from the belief must be re-localized onto the restored keyframe map via the
ICP hypothesis sweep, and the re-anchored pipeline must continue on-map.

The full multi-session kidnap evaluation (checkpoint -> restart at a
perturbed pose -> ATE with vs without relocalization) is the slow-tier
test below + tools/eval_kidnap.py's committed table.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoloam_tpu.config import DEFAULT
from legoloam_tpu.models import pipeline, relocalize
from legoloam_tpu.ops import se3
from legoloam_tpu.ops.se3 import Pose
from legoloam_tpu.utils import metrics, synthetic

SMALL_MAP = dataclasses.replace(
    DEFAULT.mapping, max_keyframes=128, submap_corner_cap=8192,
    submap_surf_cap=16384, scan_corner_cap=1024, scan_surf_cap=4096)
SMALL_RELOC = dataclasses.replace(
    DEFAULT.reloc, n_candidates=8, yaw_hypotheses=4, window=6,
    cur_cap=2048, hist_cap=8192, coarse_iters=8, icp_max_iters=40)
CFG = DEFAULT.replace(mapping=SMALL_MAP, reloc=SMALL_RELOC)


def _scan_at(scene, poses, k, n):
    pk = Pose(poses.R[k], poses.t[k])
    nxt = Pose(poses.R[min(k + 1, n - 1)], poses.t[min(k + 1, n - 1)])
    return synthetic.raycast_scan(scene, pk, CFG.sensor, next_pose=nxt,
                                  motion=k + 1 < n)


@pytest.fixture(scope="module")
def mapped_session():
    """Session 1: 15 scans around the courtyard -> keyframe store."""
    scene = synthetic.default_scene()
    n = 15
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.035)
    state = pipeline.init_slam_state(CFG)
    for k in range(n):
        state, _ = pipeline.slam_scan_step(
            state, *_scan_at(scene, poses, k, n), CFG, k * 0.1,
            run_mapping=(k % CFG.mapping_every == 0), bootstrap=(k == 1))
    assert int(state.mapping.kf.count) >= 3
    return scene, poses, n, state


def test_relocalize_recovers_kidnapped_pose(mapped_session):
    """A scan from mid-course, presented with a belief anchored at the
    session end (many meters and a heading turn away), relocalizes to its
    true pose."""
    scene, poses, n, state = mapped_session
    k_true = 4                      # early-course, well away from the end pose
    # The session-2 robot boots STATIONARY (the physically standard resume):
    # its first scan is rigid.  A moving first scan cannot be de-skewed yet
    # (no twist estimate exists), which costs ~1 m of ICP bias at 0.7 m/scan
    # — scan-to-map then absorbs that over the next few steps instead.
    gt_world = Pose(poses.R[k_true], poses.t[k_true])
    scan = synthetic.raycast_scan(scene, gt_world, CFG.sensor)
    # The map frame is session 1's scan-0 sensor frame (SLAM starts at
    # identity); rebase the world-frame ground truth into it.
    gt = se3.relative(Pose(poses.R[0], poses.t[0]), gt_world)

    # Session 2, scan 0: fresh odometry, restored map (kidnap = the belief
    # t_aft still points at session 1's end).
    st2 = pipeline.init_slam_state(CFG)._replace(
        mapping=state.mapping, loops=state.loops)
    st2, _ = pipeline.slam_scan_step(st2, *scan, CFG, 100.0,
                                     run_mapping=False)
    prior = st2.mapping.t_aft
    prior_err = float(jnp.linalg.norm(prior.t - gt.t))
    assert prior_err > 3.0, f"kidnap offset too small to test: {prior_err}"

    st2, diag = relocalize.relocalize_slam_state(st2, CFG)
    assert bool(diag.accepted), float(diag.fitness)
    t_err = float(jnp.linalg.norm(st2.mapping.t_aft.t - gt.t))
    R_err = np.degrees(float(jnp.linalg.norm(
        se3.so3_log(se3.mat3_mul(st2.mapping.t_aft.R.T, gt.R)))))
    assert t_err < 0.5, (t_err, prior_err)
    assert R_err < 5.0, R_err
    # The rebase anchors t_bef at the current odometry pose, so the fused
    # output jumps to the relocalized pose immediately.
    fused = se3.project_through_correction(
        st2.odom.pose, st2.mapping.t_bef, st2.mapping.t_aft)
    np.testing.assert_allclose(np.asarray(fused.t),
                               np.asarray(st2.mapping.t_aft.t), atol=1e-5)


def test_relocalize_rejects_unmapped_place():
    """A scan from a scene that shares no geometry with the map must be
    rejected (fitness above threshold) and leave the state unchanged."""
    scene = synthetic.default_scene()
    n = 9
    poses = synthetic.circle_trajectory(n, radius=20.0, angular_rate=0.012)
    state = pipeline.init_slam_state(CFG)
    for k in range(n):
        state, _ = pipeline.slam_scan_step(
            state, *_scan_at(scene, poses, k, n), CFG, k * 0.1,
            run_mapping=(k % CFG.mapping_every == 0))

    # An unrelated scene (different wall/box layout).
    other = synthetic.loop_scene()
    scan = synthetic.raycast_scan(
        other, Pose(jnp.eye(3), jnp.array([0.0, 0.0, 0.8])), CFG.sensor)
    st2 = pipeline.init_slam_state(CFG)._replace(mapping=state.mapping)
    st2, _ = pipeline.slam_scan_step(st2, *scan, CFG, 100.0,
                                     run_mapping=False)
    before = jax.tree.map(np.asarray, (st2.mapping.t_bef, st2.mapping.t_aft))
    st2, diag = relocalize.relocalize_slam_state(st2, CFG)
    assert not bool(diag.accepted)
    after = (st2.mapping.t_bef, st2.mapping.t_aft)
    for b, a in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.slow
def test_kidnap_multisession_reloc_beats_no_reloc():
    """Multi-session acceptance: checkpoint -> restart at a perturbed pose on
    mapped territory -> the ICP relocalization path beats the no-reloc run by
    >= 2x fused ATE through the ordinary slam_scan_step driver (no
    hand-drifted stores).  CPU-scale version of tools/eval_kidnap.py (the
    committed full-scale table: 620x abs ATE, end drift 58.3 m -> 0.11 m)."""
    from legoloam_tpu.utils import metrics as _metrics

    reloc_cfg = dataclasses.replace(
        DEFAULT.reloc, n_candidates=16, yaw_hypotheses=4, window=6,
        cur_cap=2048, hist_cap=8192, coarse_iters=8, icp_max_iters=40,
        refine_top_k=3)
    loop_cfg = dataclasses.replace(DEFAULT.loop, enabled=True)
    cfg = DEFAULT.replace(mapping=SMALL_MAP, reloc=reloc_cfg, loop=loop_cfg)

    scene = synthetic.loop_scene()
    s1, s2 = 120, 45
    k0 = s1 // 2
    poses = synthetic.circle_trajectory(s1 + s2 + 1, radius=30.0,
                                        angular_rate=0.009)

    def scan_at(k, rigid=False):
        if rigid:
            return synthetic.raycast_scan(
                scene, Pose(poses.R[k], poses.t[k]), cfg.sensor)
        return synthetic.raycast_scan(
            scene, Pose(poses.R[k], poses.t[k]), cfg.sensor,
            next_pose=Pose(poses.R[k + 1], poses.t[k + 1]), motion=True)

    # Session 1: map the first half-lap + checkpoint round-trip.
    state = pipeline.init_slam_state(cfg)
    for k in range(s1):
        state, _ = pipeline.slam_scan_step(
            state, *scan_at(k), cfg, 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0), bootstrap=(k == 1))
    import tempfile, os
    from legoloam_tpu.utils import checkpoint as ckpt
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "s1.npz")
        ckpt.save_state(p, state)
        restored = ckpt.load_state(p, pipeline.init_slam_state(cfg))
    assert int(restored.mapping.kf.count) == int(state.mapping.kf.count)

    R0, t0w = np.asarray(poses.R[0]), np.asarray(poses.t[0])
    gt2 = (np.asarray(poses.t)[k0:k0 + s2] - t0w) @ R0
    offset = float(np.linalg.norm(
        np.asarray(restored.mapping.t_aft.t) - gt2[0]))
    assert offset > 2 * cfg.loop.search_radius, offset  # discontinuous jump

    def session2(use_reloc):
        st = pipeline.init_slam_state(cfg)._replace(
            mapping=jax.tree.map(jnp.array, restored.mapping),
            loops=jax.tree.map(jnp.array, restored.loops))
        fused = []
        t_off = s1 * 0.1 + 600.0
        for j in range(s2):
            k = k0 + j
            st, out = pipeline.slam_scan_step(
                st, *scan_at(k, rigid=(j == 0)), cfg, t_off + 0.1 * j,
                run_mapping=(j % cfg.mapping_every == 0) and j > 0,
                bootstrap=(j == 1))
            if j == 0 and use_reloc:
                st, diag = relocalize.relocalize_slam_state(st, cfg)
                assert bool(diag.accepted), float(diag.fitness)
                out = out._replace(fused_pose=st.mapping.t_aft)
            fused.append(np.asarray(out.fused_pose.t))
        fused = np.array(fused)
        return float(np.sqrt(np.mean(
            np.sum((fused[1:] - gt2[1:]) ** 2, axis=1))))

    ate_no = session2(False)
    ate_yes = session2(True)
    # The stale-belief run carries the kidnap offset forever; the
    # relocalized run continues on-map.
    assert ate_yes * 2 <= ate_no, (ate_yes, ate_no)
    assert ate_yes < 1.0, ate_yes
