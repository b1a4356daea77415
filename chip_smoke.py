#!/usr/bin/env python
"""GPU smoke test: the SLAM main path at DEFAULT widths, on one NVIDIA GPU.

    python chip_smoke.py            # all single-card phases
    python chip_smoke.py --mesh4    # only the 4-card distributed phase

Phases (one process; any failure raises and exits non-zero):
  0. float32 geometry precision on the card (70 m points vs float64 NumPy);
  1. every GPU kernel vs its plain reference at benchmark shapes (the Triton
     k-NN vs ``voxel.knn`` and a float64 brute force), with timings;
  2. frontend parity: projection / ground / segmentation / features on the
     GPU vs the same jitted functions on the CPU device, then the REFERENCE
     preset vs the NumPy oracle;
  3. main path: 512 distinct ring-world scans through
     ``pipeline.slam_scan_step`` (mapping every 3rd scan, loop closure every
     10th), accuracy vs ground truth, then a determinism check;
  4. the normal CLI (``legoloam_tpu.cli.main``) on 64 synthetic scans.
``--mesh4`` runs ``pipeline_dist`` on a 4-device mesh beside the
single-device pipeline on the same scans.

Exits non-zero, printing no result, when JAX finds no GPU.  The last line of
stdout is one JSON object: {"ok": true, "device": {...}}.  Outputs go to
``chip_out/`` (gitignored).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 20) -> float:
    """Median wall time of ``fn()`` over ``reps`` calls after one warm-up,
    each ending in ``block_until_ready``."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e3)


def card_info() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi in a child
    process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# --------------------------------------------------------------------------
# Phase 0: f32 geometry precision
# --------------------------------------------------------------------------

def phase_precision(seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from legoloam_tpu.ops import se3
    from legoloam_tpu.ops.se3 import Pose

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(65536, 3)).astype(np.float32)
    pts *= (70.0 / np.linalg.norm(pts, axis=1, keepdims=True)).astype(
        np.float32)
    xi = np.array([0.1, -0.2, 0.7], np.float32)
    R = np.asarray(se3.so3_exp(jnp.asarray(xi)))
    t = np.array([12.5, -3.25, 0.8], np.float32)
    want = pts.astype(np.float64) @ R.astype(np.float64).T + t
    got = np.asarray(jax.jit(se3.transform_points)(
        Pose(jnp.asarray(R), jnp.asarray(t)), jnp.asarray(pts)))
    dot = np.asarray(jax.jit(lambda p: p @ jnp.asarray(R).T + t)(
        jnp.asarray(pts)))
    err = float(np.abs(got - want).max())
    err_dot = float(np.abs(dot - want).max())
    log(f"[precision] transform_points max err at 70 m: {err:.3e} m; "
        f"jnp dot under the default precision: {err_dot:.3e} m")
    assert err < 1e-4, err
    assert err_dot < 1e-4, err_dot


# --------------------------------------------------------------------------
# Phase 1: kernels vs references
# --------------------------------------------------------------------------

def _knn_world(n_scans: int, cfg):
    """World-frame points of ``n_scans`` ring-world scans plus one query
    scan's points, seen from a slightly wrong pose (the mapping guess)."""
    import jax
    import jax.numpy as jnp

    from legoloam_tpu.ops import se3
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    scene = synthetic.loop_scene()
    poses = synthetic.circle_trajectory(3 * n_scans + 2, radius=30.0,
                                        angular_rate=0.009)
    ray = jax.jit(lambda R, t: synthetic.raycast_scan(
        scene, Pose(R, t), cfg.sensor))
    world, ok = [], []
    for k in range(0, 3 * n_scans, 3):
        p, v, _ = ray(poses.R[k], poses.t[k])
        world.append(se3.transform_points(Pose(poses.R[k], poses.t[k]), p))
        ok.append(v)
    k = 3 * n_scans // 2 + 1
    p, v, _ = ray(poses.R[k], poses.t[k])
    guess = Pose(se3.mat3_mul(se3.so3_exp(jnp.array([0.0, 0.0, 0.004])),
                              poses.R[k]),
                 poses.t[k] + jnp.array([0.05, -0.04, 0.02]))
    center = poses.t[k]
    return (jnp.concatenate(world), jnp.concatenate(ok), p, v, guess, center)


def _brute64(q, r, rv, k):
    """float64 NumPy brute force: (d (n, k+1), i (n, k+1)) ascending."""
    d = ((q[:, None, :].astype(np.float64) - r[None, :, :]) ** 2).sum(-1)
    d[:, ~rv] = np.inf
    i = np.argsort(d, axis=1, kind="stable")[:, :k + 1]
    return np.take_along_axis(d, i, 1), i


def _check_knn(name, q, qv, r, rv, k, gate, d_k, i_k, d_x, i_x, n_check,
               seed):
    """Kernel (d_k, i_k) vs plain (d_x, i_x) on all queries and vs float64
    on ``n_check`` sampled valid queries."""
    gate_sq = None if gate is None else gate * gate
    d_k, i_k, d_x, i_x = map(np.asarray, (d_k, i_k, d_x, i_x))
    q, qv, r, rv = map(np.asarray, (q, qv, r, rv))

    if gate_sq is not None:
        acc_k = d_k[:, k - 1] < gate_sq
        acc_x = d_x[:, k - 1] < gate_sq
        # The plain path selects in matmul form (cancellation noise ~1e-4
        # m^2 at submap extents); only a 5th distance that close to the gate
        # may be decided differently.
        near = np.abs(d_x[:, k - 1] - gate_sq) < 1e-3
        bad = (acc_k != acc_x) & qv & ~near
        log(f"[knn] {name}: gate decisions kernel vs voxel.knn: "
            f"{int(((acc_k != acc_x) & qv).sum())} differ, "
            f"{int(near.sum())} within 1e-3 m^2 of the gate")
        assert not bad.any(), np.nonzero(bad)[0][:10]
    rows = qv if gate_sq is None else qv & (d_x[:, k - 1] < gate_sq)
    same_i = (i_k == i_x).all(axis=1) & rows
    log(f"[knn] {name}: index rows equal to voxel.knn: "
        f"{int(same_i.sum())}/{int(rows.sum())} rows inside the gate")
    dd = np.abs(d_k - d_x)[same_i]
    assert dd.size == 0 or dd.max() < 1e-4, dd.max()

    rs = np.random.default_rng(seed)
    idx = rs.choice(np.nonzero(qv)[0], size=min(n_check, int(qv.sum())),
                    replace=False)
    D, I = _brute64(q[idx], r, rv, k)
    exact_rows = (np.ones(len(idx), bool) if gate_sq is None
                  else D[:, k - 1] < gate_sq)
    if gate_sq is not None:
        tie = np.abs(D[:, k - 1] - gate_sq) <= 1e-6 * gate_sq
        dec = (d_k[idx, k - 1] < gate_sq) != (D[:, k - 1] < gate_sq)
        assert not (dec & ~tie).any(), "gate decision differs from float64"
    n_tie = 0
    for row, ok in enumerate(exact_rows):
        if not ok:
            continue
        got, want = set(i_k[idx[row]].tolist()), set(I[row, :k].tolist())
        if got != want:
            gap = D[row, k] - D[row, k - 1]
            assert gap <= 1e-6 * max(D[row, k - 1], 1e-12), (
                name, row, sorted(got), sorted(want), D[row])
            n_tie += 1
    err = np.abs(d_k[idx][exact_rows] - D[exact_rows, :k]).max()
    log(f"[knn] {name}: vs float64 on {len(idx)} queries: max |d| err "
        f"{err:.3e} m^2, {n_tie} near-tie index sets")
    assert err < 1e-4, err


def phase_knn(cfg, n_scans: int = 24, shapes=None, n_check: int = 1024,
              reps: int = 20, interpret: bool = False) -> dict:
    """Triton k-NN vs ``voxel.knn`` and float64 at the mapping and ICP
    shapes.  Returns {name: (kernel ms, plain ms)}."""
    import functools

    import jax
    import jax.numpy as jnp

    from legoloam_tpu.ops import se3
    from legoloam_tpu.ops.knn_pallas import knn_pallas
    from legoloam_tpu.ops.voxel import (knn, voxel_downsample,
                                        voxel_representative)

    m = cfg.mapping
    gate = float(m.nn_max_dist) ** 0.5
    if shapes is None:
        shapes = [("surf 5-NN", m.scan_surf_cap, m.submap_surf_cap, 5, gate,
                   m.surf_leaf, "morton"),
                  ("corner 5-NN", m.scan_corner_cap, m.submap_corner_cap, 5,
                   gate, 1.0, "morton"),
                  ("ICP 1-NN", cfg.loop.cur_cap, cfg.loop.hist_cap, 1, None,
                   cfg.loop.submap_leaf, "hash")]
    world, wok, scan, sok, guess, center = _knn_world(n_scans, cfg)
    times = {}
    for name, nq, nr, k, g, leaf, order in shapes:
        if order == "morton":
            r, rv = voxel_downsample(world, wok, leaf, nr, origin=center)
        else:
            r, rv = voxel_representative(world, wok, leaf, nr)
        q, qv = voxel_downsample(scan, sok, leaf / 2, nq,
                                 origin=jnp.zeros(3))
        q = se3.transform_points(guess, q)
        log(f"[knn] {name}: Q={nq} ({int(qv.sum())} valid) R={nr} "
            f"({int(rv.sum())} valid) k={k} gate={g}")
        f_k = jax.jit(functools.partial(knn_pallas, k=k, gate=g,
                                        interpret=interpret))
        f_x = jax.jit(functools.partial(knn, k=k,
                                        q_tile=8192 if k > 1 else 512))
        d_k, i_k = f_k(q, qv, r, rv)
        d_x, i_x = f_x(q, qv, r, rv)
        _check_knn(name, q, qv, r, rv, k, g, d_k, i_k, d_x, i_x, n_check,
                   seed=nq + k)
        t_k = median_ms(lambda: f_k(q, qv, r, rv), reps)
        t_x = median_ms(lambda: f_x(q, qv, r, rv), reps)
        log(f"[knn] {name}: kernel {t_k:.4f} ms, voxel.knn {t_x:.4f} ms "
            f"(median of {reps})")
        times[name] = (t_k, t_x)
    return times


# --------------------------------------------------------------------------
# Phase 2: frontend parity (GPU vs CPU device, then the NumPy oracle)
# --------------------------------------------------------------------------

def _frontend_fns(cfg):
    import jax

    from legoloam_tpu.ops import features, projection, segmentation

    sensor = cfg.sensor

    @jax.jit
    def front(pts, valid, ring):
        img = projection.project_scan(pts, valid, sensor, ring=ring)
        seg = segmentation.segment(img, sensor, cfg.seg)
        feats, dbg = features.extract_features(img, seg, sensor, cfg.feat,
                                               return_debug=True)
        return img, seg, feats, dbg

    return front


def _partition(label, mask):
    """Per cell: the smallest flat index sharing its label (-1 off mask)."""
    lab = np.asarray(label).reshape(-1)
    m = np.asarray(mask).reshape(-1)
    rep = np.full(lab.shape, -1, np.int64)
    idx = np.nonzero(m)[0]
    _, first = np.unique(lab[idx], return_index=True)
    root = dict(zip(lab[idx][first].tolist(), idx[first].tolist()))
    rep[idx] = [root[v] for v in lab[idx].tolist()]
    return rep


def _pick_cells(dbg, h):
    lab = np.asarray(dbg.label)
    col = np.asarray(dbg.col)
    n = lab.shape[0]
    in_ring = np.arange(lab.shape[1])[None, :] < np.asarray(dbg.count)[:, None]
    cells = np.arange(n)[:, None] * h + col
    out = {}
    for name, m in (("sharp", lab == 2), ("less_sharp", lab >= 1),
                    ("flat", lab == -1)):
        out[name] = set(cells[m & in_ring].tolist())
    return out


def phase_frontend(cfg, n_scans: int = 2, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from legoloam_tpu.config import REFERENCE
    from legoloam_tpu.oracle import OracleFrontend
    from legoloam_tpu.ops import segmentation
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    cpu = jax.devices("cpu")[0]
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(n_scans + 1, radius=20.0,
                                        angular_rate=0.0075)
    n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
    front = _frontend_fns(cfg)
    for s in range(n_scans):
        scan = synthetic.raycast_scan(
            scene, Pose(poses.R[s], poses.t[s]), cfg.sensor,
            next_pose=Pose(poses.R[s + 1], poses.t[s + 1]), motion=True,
            noise_key=jax.random.PRNGKey(seed + s), noise_sigma=0.01)
        scan = [np.asarray(x) for x in scan]
        img_g, seg_g, _, dbg_g = jax.tree.map(
            np.asarray, front(*[jnp.asarray(x) for x in scan]))
        img_c, seg_c, _, dbg_c = jax.tree.map(
            np.asarray, front(*[jax.device_put(x, cpu) for x in scan]))
        occ = img_g.valid != img_c.valid
        both = img_g.valid & img_c.valid
        rng_err = float(np.abs(img_g.rng[both] - img_c.rng[both]).max())
        # Cells whose occupancy differs, widened by +-5 columns.
        near = occ.copy()
        for dc in range(1, 6):
            near |= np.roll(occ, dc, axis=1) | np.roll(occ, -dc, axis=1)
        near_flat = near.reshape(-1)
        ground_bad = (seg_g.ground != seg_c.ground) & ~near
        cl_g = (seg_g.label >= 0) & (seg_g.label != segmentation.OUTLIER_LABEL)
        cl_c = (seg_c.label >= 0) & (seg_c.label != segmentation.OUTLIER_LABEL)
        part_bad = ((_partition(seg_g.label, cl_g)
                     != _partition(seg_c.label, cl_c)) & ~near_flat)
        picks_g, picks_c = _pick_cells(dbg_g, h), _pick_cells(dbg_c, h)
        pick_bad = {k: {c for c in picks_g[k] ^ picks_c[k]
                        if not near_flat[c]} for k in picks_g}
        log(f"[frontend] scan {s}: occupancy differs in {int(occ.sum())} of "
            f"{n * h} cells, max range diff {rng_err:.3e} m, ground diffs "
            f"{int((seg_g.ground != seg_c.ground).sum())}, partition diffs "
            f"{int((_partition(seg_g.label, cl_g) != _partition(seg_c.label, cl_c)).sum())}, "
            f"pick diffs " + ", ".join(
                f"{k} {len(picks_g[k] ^ picks_c[k])}" for k in picks_g)
            + f"; outside the +-5-column neighbourhood: ground "
            f"{int(ground_bad.sum())}, partition {int(part_bad.sum())}, "
            f"picks {sum(len(v) for v in pick_bad.values())}")
        assert occ.sum() <= 0.001 * n * h, int(occ.sum())
        assert rng_err <= 1e-5, rng_err
        assert not ground_bad.any()
        assert not part_bad.any()
        assert not any(pick_bad.values()), pick_bad

    # REFERENCE preset vs the NumPy oracle (tests/test_oracle_parity.py).
    sensor = REFERENCE.sensor
    oracle = OracleFrontend(sensor, REFERENCE.seg, REFERENCE.feat)
    ref_front = _frontend_fns(REFERENCE)
    for s in range(n_scans):
        pts, valid, ring = synthetic.raycast_scan(
            scene, Pose(poses.R[s], poses.t[s]), sensor,
            noise_key=jax.random.PRNGKey(seed + 100 + s), noise_sigma=0.01)
        img, seg, _, dbg = jax.tree.map(np.asarray,
                                        ref_front(pts, valid, ring))
        orc = oracle.process(np.asarray(pts), np.asarray(valid),
                             np.asarray(ring))
        np.testing.assert_array_equal(img.valid, orc.full_idx >= 0)
        np.testing.assert_array_equal(seg.ground, orc.ground_mat == 1)
        cat = np.where(seg.label == -1, 0,
                       np.where(seg.label == segmentation.OUTLIER_LABEL, 2, 1))
        ocat = np.where(orc.label_mat == -1, 0,
                        np.where(orc.label_mat == 999999, 2, 1))
        np.testing.assert_array_equal(cat, ocat)
        m = ocat == 1
        pairs = np.unique(np.stack([orc.label_mat[m], seg.label[m]], 1),
                          axis=0)
        assert len(np.unique(pairs[:, 0])) == len(pairs) == len(
            np.unique(pairs[:, 1]))
        picks = _pick_cells(dbg, sensor.horizon_scan)
        jac = {}
        for k, o in (("sharp", orc.sharp_cells), ("less_sharp",
                                                  orc.less_sharp_cells),
                     ("flat", orc.flat_cells)):
            o = set(o.tolist())
            jac[k] = len(picks[k] & o) / max(len(picks[k] | o), 1)
            assert jac[k] >= 0.80, (k, jac[k])
        log(f"[frontend] REFERENCE vs oracle scan {s}: projection, ground, "
            f"partition exact ({len(pairs)} clusters); pick Jaccard "
            + ", ".join(f"{k} {v:.3f}" for k, v in jac.items()))


def time_stages(cfg, reps: int = 20) -> dict:
    """Standalone jitted ``segment`` and ``extract_features`` on one scan."""
    import jax

    from legoloam_tpu.ops import features, projection, segmentation
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    scene = synthetic.loop_scene()
    poses = synthetic.circle_trajectory(2, radius=30.0, angular_rate=0.009)
    pts, valid, ring = synthetic.raycast_scan(
        scene, Pose(poses.R[0], poses.t[0]), cfg.sensor)
    img = jax.jit(lambda p, v, r: projection.project_scan(
        p, v, cfg.sensor, ring=r))(pts, valid, ring)
    seg_f = jax.jit(lambda im: segmentation.segment(im, cfg.sensor, cfg.seg))
    seg = seg_f(img)
    feat_f = jax.jit(lambda im, sg: features.extract_features(
        im, sg, cfg.sensor, cfg.feat))
    t = {"segment": median_ms(lambda: seg_f(img), reps),
         "extract_features": median_ms(lambda: feat_f(img, seg), reps)}
    log(f"[stages] segment {t['segment']:.4f} ms, extract_features "
        f"{t['extract_features']:.4f} ms (median of {reps})")
    return t


# --------------------------------------------------------------------------
# Phase 3: the main path
# --------------------------------------------------------------------------

def _ring_scans(cfg, n: int):
    """bench.py's ring world: n distinct motion-distorted scans + gt."""
    import jax

    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    scene = synthetic.loop_scene()
    poses = synthetic.circle_trajectory(n + 1, radius=30.0,
                                        angular_rate=0.009)
    ray = jax.jit(lambda a, b, c, d: synthetic.raycast_scan(
        scene, Pose(a, b), cfg.sensor, next_pose=Pose(c, d), motion=True))
    scans = [ray(poses.R[k], poses.t[k], poses.R[k + 1], poses.t[k + 1])
             for k in range(n)]
    jax.block_until_ready(scans)
    gt = np.asarray(poses.t[:n]) - np.asarray(poses.t[0])
    return scans, gt


def _run(cfg, scans, state=None):
    from legoloam_tpu.models import pipeline

    state = pipeline.init_slam_state(cfg) if state is None else state
    fused = []
    for k, scan in enumerate(scans):
        state, out = pipeline.slam_scan_step(
            state, *scan, cfg, 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0),
            run_loop=cfg.loop.enabled and k % 10 == 0 and k > 0)
        fused.append(out.fused_pose.t)
    return state, fused


def phase_main(cfg, n: int = 512, det_n: int = 16) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))
    scans, gt = _ring_scans(cfg, n)
    # Compile every step variant (mapping, loop closure) outside the window.
    st, _ = _run(cfg, scans[:11])
    jax.block_until_ready(st)
    del st
    t0 = time.perf_counter()
    state, fused = _run(cfg, scans)
    jax.block_until_ready(state)
    dt = time.perf_counter() - t0
    est = np.asarray(jnp.stack(fused))
    err = np.linalg.norm(est - gt, axis=1)
    kf, overflow = int(state.mapping.kf.count), int(state.mapping.kf.overflow)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use",
                                                       0)
    res = {"scans_per_s": n / dt, "mean_err_m": float(err.mean()),
           "end_err_m": float(err[-1]), "keyframes": kf,
           "overflow": overflow, "loops": int(state.loops.count),
           "peak_bytes": int(peak)}
    log(f"[main] {n} scans: {res['scans_per_s']:.3f} scans/s, peak device "
        f"memory {peak / 2**30:.4f} GiB, keyframes {kf}, overflow "
        f"{overflow}, loops {res['loops']}, position error mean "
        f"{res['mean_err_m']:.5f} m end {res['end_err_m']:.5f} m")
    assert overflow == 0
    assert np.isfinite(est).all()
    assert res["mean_err_m"] < 0.25, res
    del state
    a = np.asarray(jnp.stack(_run(cfg, scans[:det_n])[1]))
    b = np.asarray(jnp.stack(_run(cfg, scans[:det_n])[1]))
    res["deterministic"] = bool((a == b).all())
    log(f"[main] {det_n}-scan rerun fused poses bit-identical: "
        f"{res['deterministic']} (max diff {np.abs(a - b).max():.3e} m)")
    return res


# --------------------------------------------------------------------------
# Phase 4: the CLI
# --------------------------------------------------------------------------

def phase_cli(out_dir: str, n: int = 64) -> None:
    from legoloam_tpu import cli
    from legoloam_tpu.utils import export

    d = os.path.join(out_dir, "cli")
    rc = cli.main(["--synthetic", str(n), "--loop-closure", "--out", d])
    assert rc == 0, rc
    for name in ("trajectory_fused.txt", "trajectory_mapped.txt"):
        tr = np.loadtxt(os.path.join(d, name), ndmin=2)
        assert tr.shape[0] > 0 and np.isfinite(tr).all(), name
    pts = export.read_pcd_xyz(os.path.join(d, "global_map.pcd"))
    assert pts.shape[0] > 0 and np.isfinite(pts).all()
    fused = np.loadtxt(os.path.join(d, "trajectory_fused.txt"), ndmin=2)
    log(f"[cli] {fused.shape[0]} fused poses, {pts.shape[0]} map points "
        f"-> {d}")
    assert fused.shape[0] == n


# --------------------------------------------------------------------------
# --mesh4: the distributed pipeline beside the single-device one
# --------------------------------------------------------------------------

def phase_mesh(cfg, n_dev: int = 4, n: int = 24) -> None:
    import jax

    from legoloam_tpu.models import pipeline
    from legoloam_tpu.parallel import mesh as mesh_mod, pipeline_dist

    assert len(jax.devices()) >= n_dev, jax.devices()
    mesh = mesh_mod.make_mesh(n_dev)
    scans, gt = _ring_scans(cfg, n)
    single, st1 = pipeline.run_slam_sequence(scans, cfg)
    dist, st2 = pipeline_dist.run_slam_sequence_dist(scans, cfg, mesh)
    jax.block_until_ready((single.t, dist.t))
    s, d = np.asarray(single.t), np.asarray(dist.t)
    assert np.isfinite(d).all()
    kf1, kf2 = int(st1.mapping.kf.count), int(st2.mapping.kf.count)
    err = np.abs(d - s).max(axis=1)
    log(f"[mesh] {n} scans on {n_dev} devices: keyframes {kf2} (single "
        f"{kf1}), max |dist - single| first 3 scans {err[:3].max():.3e} m, "
        f"all scans {err.max():.3e} m; position error vs gt mean "
        f"{np.linalg.norm(d - gt, axis=1).mean():.5f} m")
    for dev in jax.devices()[:n_dev]:
        st = dev.memory_stats() or {}
        log(f"[mesh] {dev}: bytes_in_use {st.get('bytes_in_use')} peak "
            f"{st.get('peak_bytes_in_use')}")
    shards = st2.mapping.kf.surf.addressable_shards
    log("[mesh] keyframe surf shards: " + ", ".join(
        f"{sh.device}: {sh.data.shape}" for sh in shards))
    assert len({sh.device for sh in shards}) == n_dev
    assert kf1 == kf2
    # Parity bounds of __graft_entry__.dryrun_multichip (tight while the map
    # holds one keyframe) and tests/test_pipeline_dist.py (whole run).
    assert err[:3].max() < 1e-4, err[:3]
    assert err.max() < 0.05, err.max()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the 4-device distributed phase")
    ap.add_argument("--out", default=os.path.join(HERE, "chip_out"))
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (default backend "
              f"{jax.default_backend()!r}); refusing to run on the CPU",
              file=sys.stderr)
        return 2

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.utils import compile_cache

    cache = compile_cache.enable()
    devs = jax.devices()
    log(f"[env] jax {jax.__version__}, devices {devs}, kind "
        f"{devs[0].device_kind}, count {len(devs)}")
    log(f"[env] card: {card_info()}")
    log(f"[env] default matmul precision: "
        f"{jax.config.jax_default_matmul_precision}; compile cache {cache}")
    os.makedirs(args.out, exist_ok=True)

    t0 = time.perf_counter()
    if args.mesh4:
        phase_mesh(DEFAULT)
        count = 4
    else:
        phase_precision()
        phase_knn(DEFAULT)
        time_stages(DEFAULT)
        phase_frontend(DEFAULT)
        phase_main(DEFAULT)
        phase_cli(args.out)
        count = len(devs)
    log(f"[env] total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
