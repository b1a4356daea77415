#!/usr/bin/env python
"""Ablation timing of the REAL state-threaded block program (bench.py's block
mode) — the trustworthy way to attribute time on device, since separately
jitted stages can be distorted by loop-invariant code motion.

Each variant runs the same lax.scan-over-B-scans structure with one piece
disabled; deltas vs 'full' attribute the cost.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def _sync(out):
    return jax.block_until_ready(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=12)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import odometry as odom
    from legoloam_tpu.models import pipeline
    from legoloam_tpu.ops import features as feat_ops
    from legoloam_tpu.ops import projection, segmentation
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    cfg = DEFAULT
    scene = synthetic.default_scene()
    poses = synthetic.circle_trajectory(args.block + 1, radius=20.0,
                                        angular_rate=0.0075)
    scans = []
    for k in range(args.block):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[k + 1], poses.t[k + 1])
        scans.append(synthetic.raycast_scan(scene, pk, cfg.sensor,
                                            next_pose=nxt, motion=True))
    batch = tuple(jnp.stack([scans[i][j] for i in range(args.block)])
                  for j in range(3))
    batch = jax.tree.map(jax.device_put, batch)
    state0 = odom.init_state(cfg.odom, cfg.feat)

    def run(prog, state):
        out = prog(state, *batch)
        _sync(out)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = prog(state, *batch)
        _sync(out)
        return (time.perf_counter() - t0) / (args.iters * args.block) * 1e3

    import functools

    # --- full step (reference point) ---
    full = functools.partial(pipeline.odometry_scan_block, cfg=cfg)
    state1, _ = full(state0, *batch)

    # --- frontend only: projection+segmentation+features, odometry skipped ---
    @jax.jit
    def frontend_only(state, points, valid, ring):
        def body(st, scan):
            pts, v, r = scan
            feats = pipeline.process_scan(pts, v, r, cfg)
            # tie a scalar into the carry so nothing is DCE'd or hoisted
            tick = st + jnp.sum(feats.sharp.xyz) + jnp.sum(feats.less_flat.xyz)
            return tick, feats.sharp.valid.sum()
        return jax.lax.scan(body, jnp.float32(0.0) * state.xi[0],
                            (points, valid, ring))

    # --- frontend without segmentation (projection+features on fake seg) ---
    @jax.jit
    def frontend_noseg(state, points, valid, ring):
        def body(st, scan):
            pts, v, r = scan
            img = projection.project_scan(pts, v, cfg.sensor, ring=r)
            n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
            cols = jnp.arange(h)[None, :]
            seg = segmentation.Segmentation(
                ground=img.valid & (jnp.arange(n)[:, None] < 7),
                label=jnp.where(img.valid, 1, -1).astype(jnp.int32),
                segmented=img.valid,
                outlier=img.valid & (cols % 5 == 0),
                seg_ground_flag=img.valid & (jnp.arange(n)[:, None] < 7)
                                & (cols % 5 == 0),
                n_clusters=jnp.int32(1),
            )
            feats = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat)
            tick = st + jnp.sum(feats.sharp.xyz) + jnp.sum(feats.less_flat.xyz)
            return tick, feats.sharp.valid.sum()
        return jax.lax.scan(body, jnp.float32(0.0) * state.xi[0],
                            (points, valid, ring))

    # --- frontend with label propagation but CONSTANT validity stats ---
    @jax.jit
    def frontend_novalid(state, points, valid, ring):
        def body(st, scan):
            pts, v, r = scan
            img = projection.project_scan(pts, v, cfg.sensor, ring=r)
            ground = segmentation.ground_removal(img, cfg.sensor, cfg.seg)
            seeds = img.valid & ~ground
            ch, cv = segmentation._connectivity(img, cfg.sensor, cfg.seg)
            labels = segmentation._label_propagation(seeds, ch, cv,
                                                     cfg.seg.ccl_max_iters)
            n, h = cfg.sensor.n_scan, cfg.sensor.horizon_scan
            cols = jnp.arange(h)[None, :]
            cell_ok = seeds & (labels < n * h)
            ground_kept = ground & ((cols % 5 == 0) | (cols <= 5)
                                    | (cols >= h - 5))
            seg = segmentation.Segmentation(
                ground=ground, label=labels, segmented=cell_ok | ground_kept,
                outlier=seeds & (cols % 5 == 0) & ~cell_ok,
                seg_ground_flag=ground_kept, n_clusters=jnp.int32(1))
            feats = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat)
            tick = st + jnp.sum(feats.sharp.xyz) + jnp.sum(feats.less_flat.xyz)
            return tick, feats.sharp.valid.sum()
        return jax.lax.scan(body, jnp.float32(0.0) * state.xi[0],
                            (points, valid, ring))

    # --- projection only ---
    @jax.jit
    def projection_only(state, points, valid, ring):
        def body(st, scan):
            pts, v, r = scan
            img = projection.project_scan(pts, v, cfg.sensor, ring=r)
            tick = st + jnp.sum(img.xyz) + jnp.sum(img.rel_time)
            return tick, img.valid.sum()
        return jax.lax.scan(body, jnp.float32(0.0) * state.xi[0],
                            (points, valid, ring))

    # --- frontend without the less-flat voxel downsample ---
    from legoloam_tpu.ops import features as fmod

    @jax.jit
    def frontend_novoxel(state, points, valid, ring):
        orig = fmod.voxel_downsample_with_payload

        def stub(pts, payload, valid_, leaf, cap):
            return (pts[:cap], payload[:cap], valid_[:cap])

        fmod.voxel_downsample_with_payload = stub
        try:
            def body(st, scan):
                pts, v, r = scan
                img = projection.project_scan(pts, v, cfg.sensor, ring=r)
                seg = segmentation.segment(img, cfg.sensor, cfg.seg)
                feats = fmod.extract_features.__wrapped__(
                    img, seg, cfg.sensor, cfg.feat)
                tick = st + jnp.sum(feats.sharp.xyz) + \
                    jnp.sum(feats.less_flat.xyz)
                return tick, feats.sharp.valid.sum()
            return jax.lax.scan(body, jnp.float32(0.0) * state.xi[0],
                                (points, valid, ring))
        finally:
            fmod.voxel_downsample_with_payload = orig

    # --- LM with 1 iteration (attributes the per-iteration solve+knn cost) ---
    cfg_lm1 = cfg.replace(odom=cfg.odom.__class__(
        **{**cfg.odom.__dict__, "max_iterations": 1}))
    lm1 = functools.partial(pipeline.odometry_scan_block, cfg=cfg_lm1)

    # --- LM with 2 iterations ---
    cfg_lm2 = cfg.replace(odom=cfg.odom.__class__(
        **{**cfg.odom.__dict__, "max_iterations": 2}))
    lm2 = functools.partial(pipeline.odometry_scan_block, cfg=cfg_lm2)

    # --- odometry internals: fresh scan bodies with pieces stubbed ---
    from legoloam_tpu.models import odometry as om
    from legoloam_tpu.ops import se3

    def odom_block(lm_loop_body=True, warp_end=True, corr=True):
        ocfg = cfg.odom

        @jax.jit
        def prog(state, points, valid, ring):
            def body(st, scan):
                pts, v, r = scan
                feats = pipeline.process_scan(pts, v, r, cfg)
                xi0 = st.xi
                if lm_loop_body:
                    if corr:
                        xi_a, it_a, n_s = om._lm_loop(
                            feats.flat, st.last_surf, xi0, ocfg,
                            om._find_surf_corr, om._SURF_DOF, is_line=False)
                        xi_b, it_b, n_c = om._lm_loop(
                            feats.sharp, st.last_corner, xi_a, ocfg,
                            om._find_corner_corr, om._CORNER_DOF, is_line=True)
                    else:
                        def fake_corr(p_warped, q_valid, last, c):
                            z = jnp.zeros_like(p_warped)
                            return om._Corr(
                                n=z.at[:, 2].set(1.0), off=jnp.zeros(
                                    p_warped.shape[0]),
                                t1=z, t2=z.at[:, 0].set(1.0), valid=q_valid)
                        xi_a, it_a, n_s = om._lm_loop(
                            feats.flat, st.last_surf, xi0, ocfg,
                            fake_corr, om._SURF_DOF, is_line=False)
                        xi_b, it_b, n_c = om._lm_loop(
                            feats.sharp, st.last_corner, xi_a, ocfg,
                            fake_corr, om._CORNER_DOF, is_line=True)
                    xi = xi_b
                else:
                    xi = xi0
                motion = se3.se3_exp(xi)
                new_pose = se3.compose(st.pose, motion)
                if warp_end:
                    lc = om._warp_to_end(xi, feats.less_sharp)
                    ls = om._warp_to_end(xi, feats.less_flat)
                    lo = om._warp_to_end(xi, feats.outlier)
                elif warp_end is None:     # carry passthrough (old clouds)
                    lc, ls, lo = st.last_corner, st.last_surf, \
                        st.last_outlier
                else:
                    lc, ls, lo = feats.less_sharp, feats.less_flat, \
                        feats.outlier
                st2 = om.OdometryState(
                    pose=new_pose, xi=xi, last_corner=lc, last_surf=ls,
                    last_outlier=lo, initialized=jnp.array(True))
                return st2, (new_pose.t, xi)
            return jax.lax.scan(body, state, (points, valid, ring))
        return prog

    rows = [
        ("full (5 LM iters)", run(full, state1)),
        ("odom: no corr search", run(odom_block(corr=False), state1)),
        ("odom: no lm loop", run(odom_block(lm_loop_body=False), state1)),
        ("odom: no lm, no warp", run(odom_block(lm_loop_body=False,
                                                warp_end=False), state1)),
        ("odom: no lm, carry pass", run(odom_block(lm_loop_body=False,
                                                   warp_end=None), state1)),
        ("odom: no warp_to_end", run(odom_block(warp_end=False), state1)),
        ("odom: rebuilt full", run(odom_block(), state1)),
        ("frontend only", run(frontend_only, state1)),
        ("frontend, no CCL", run(frontend_noseg, state1)),
        ("frontend, no validity", run(frontend_novalid, state1)),
        ("projection only", run(projection_only, state1)),
        ("frontend, no voxel", run(frontend_novoxel, state1)),
        ("full, 1 LM iter", run(lm1, state1)),
        ("full, 2 LM iters", run(lm2, state1)),
    ]
    print(f"{'variant':24s} {'ms/scan':>9s}")
    for name, ms in rows:
        print(f"{name:24s} {ms:9.3f}")


if __name__ == "__main__":
    main()
