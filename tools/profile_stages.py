#!/usr/bin/env python
"""Per-stage wall-clock breakdown of the fused odometry step on the real
device.  Each stage is jitted separately and timed with a block-scan wrapper
so the per-execution dispatch overhead is amortized identically to
bench.py's block mode — numbers are comparable to the headline scans/sec.

Usage: python tools/profile_stages.py [--block 12] [--iters 20]
"""

import argparse
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def timed_block(fn, args, block, iters, donate=False):
    """Run `fn(*args)` `block` times inside one jitted lax.scan program,
    execute `iters` times, return per-call ms."""

    sync = jax.block_until_ready

    @jax.jit
    def prog(args):
        # Chain a (numerically negligible) dependency through the scan so
        # XLA cannot hoist the loop-invariant body and compute it once.
        def body(c, _):
            nudged = jax.tree.map(
                lambda x: x + c.astype(x.dtype) if jnp.issubdtype(
                    x.dtype, jnp.floating) else x, tuple(args))
            out = fn(*nudged)
            floats = [x for x in jax.tree.leaves(out)
                      if jnp.issubdtype(x.dtype, jnp.floating)]
            leaf = floats[0] if floats else \
                jax.tree.leaves(out)[0].astype(jnp.float32)
            return leaf.ravel()[0] * 1e-30, out
        _, outs = jax.lax.scan(body, jnp.float32(0.0), None, length=block)
        return outs

    out = prog(args)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = prog(args)
    sync(out)
    dt = (time.perf_counter() - t0) / (iters * block)
    return dt * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import odometry as odom
    from legoloam_tpu.models.pipeline import odometry_scan_step
    from legoloam_tpu.ops import features as feat_ops
    from legoloam_tpu.ops import projection, segmentation
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    cfg = DEFAULT
    scene = synthetic.default_scene()
    pose = Pose(jnp.eye(3), jnp.array([0.0, 0.0, 0.8]))
    pts, valid, ring = synthetic.raycast_scan(scene, pose, cfg.sensor)
    pose2 = Pose(jnp.eye(3), jnp.array([0.12, 0.02, 0.8]))
    pts2, valid2, ring2 = synthetic.raycast_scan(scene, pose2, cfg.sensor)

    img = projection.project_scan(pts, valid, cfg.sensor, ring=ring)
    seg = segmentation.segment(img, cfg.sensor, cfg.seg)
    feats = feat_ops.extract_features(img, seg, cfg.sensor, cfg.feat)

    state0 = odom.init_state(cfg.odom, cfg.feat)
    state1, _ = odometry_scan_step(state0, pts, valid, ring, cfg)
    jax.block_until_ready(state1)

    B, I = args.block, args.iters
    rows = []
    rows.append(("projection", timed_block(
        lambda p, v, r: projection.project_scan(p, v, cfg.sensor, ring=r),
        (pts, valid, ring), B, I)))
    rows.append(("ground_removal", timed_block(
        lambda im: segmentation.ground_removal(im, cfg.sensor, cfg.seg),
        (img,), B, I)))
    rows.append(("segmentation(full)", timed_block(
        lambda im: segmentation.segment(im, cfg.sensor, cfg.seg),
        (img,), B, I)))
    rows.append(("features", timed_block(
        lambda im, sg: feat_ops.extract_features(im, sg, cfg.sensor, cfg.feat),
        (img, seg), B, I)))
    rows.append(("odometry_solve", timed_block(
        lambda st, f: odom.odometry_step(st, f, cfg.odom),
        (state1, feats), B, I)))
    rows.append(("TOTAL fused step", timed_block(
        lambda st, p, v, r: odometry_scan_step(st, p, v, r, cfg),
        (state1, pts2, valid2, ring2), B, I)))

    print(f"{'stage':24s} {'ms/scan':>9s}")
    for name, ms in rows:
        print(f"{name:24s} {ms:9.3f}")


if __name__ == "__main__":
    main()
