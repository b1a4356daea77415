#!/usr/bin/env python
"""Kidnapped-robot / multi-session evaluation: the end-to-end scenario where
the EXPLICIT ICP machinery earns its keep.

Single-session revisits are absorbed by radius-mode scan-to-map (continuous
implicit closure — PERF.md's loop-closure table), so the regime that needs
the explicit path is a DISCONTINUOUS pose error: map a course, checkpoint,
then restart the robot somewhere else on the mapped territory with the
belief still anchored at the session-1 end (re-entry offset up to the world
diameter — beyond the 50 m submap radius on the ring world).

Two session-2 runs through the ordinary ``slam_scan_step`` driver:
  A. no relocalization — the pipeline continues from the stale belief;
  B. ``relocalize_slam_state`` on the first scan (ICP hypothesis sweep over
     the restored keyframe map), then the identical driver.

Reports fused ATE / end drift for both (session-2 ground truth, map frame);
the acceptance criterion is B beating A by >= 2x.  The
checkpoint is round-tripped through utils/checkpoint save/load to prove the
resume path carries the map.

Usage:
  python tools/eval_kidnap.py                  # ring world, 800+200 scans
  python tools/eval_kidnap.py --s1 400 --s2 120 --kidnap-frac 0.45
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None)
    ap.add_argument("--s1", type=int, default=800,
                    help="session-1 scans (800 = one full ring lap)")
    ap.add_argument("--s2", type=int, default=200)
    ap.add_argument("--kidnap-frac", type=float, default=0.5,
                    help="session-2 start as a fraction of the session-1 "
                         "course (0.5 = opposite side of the ring, ~60 m "
                         "from the stale belief)")
    ap.add_argument("--radius", type=float, default=30.0)
    ap.add_argument("--angular-rate", type=float, default=0.009)
    ap.add_argument("--ckpt", default=None,
                    help="cache session 1 to this npz (reused when present "
                         "— skips the 800-scan mapping run on re-invocations)")
    ap.add_argument("--candidates", type=int, default=128,
                    help="relocalization candidate cells; the ring lap "
                         "occupies ~70 cells at the 5 m cell size, so 128 "
                         "makes the search global")
    args = ap.parse_args()
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    import dataclasses

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import pipeline, relocalize
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import checkpoint, metrics, synthetic

    cfg = DEFAULT.replace(
        loop=dataclasses.replace(DEFAULT.loop, enabled=True),
        reloc=dataclasses.replace(DEFAULT.reloc,
                                  n_candidates=args.candidates))

    scene = synthetic.loop_scene()
    total = args.s1 + 1
    poses = synthetic.circle_trajectory(total, radius=args.radius,
                                        angular_rate=args.angular_rate)
    ray = jax.jit(lambda a, b, c, d: synthetic.raycast_scan(
        scene, Pose(a, b), cfg.sensor, next_pose=Pose(c, d), motion=True))

    # ---- session 1: map one lap ----
    if args.ckpt and os.path.exists(args.ckpt):
        print(f"[session 1] loading cached checkpoint {args.ckpt}",
              flush=True)
        restored = checkpoint.load_state(args.ckpt,
                                         pipeline.init_slam_state(cfg))
        kf1 = int(restored.mapping.kf.count)
    else:
        print(f"[session 1] {args.s1} scans...", flush=True)
        state = pipeline.init_slam_state(cfg)
        sched = pipeline.LoopScheduler(cfg)
        t0 = time.perf_counter()
        for k in range(args.s1):
            pts, valid, ring = ray(poses.R[k], poses.t[k],
                                   poses.R[k + 1], poses.t[k + 1])
            state, out = pipeline.slam_scan_step(
                state, pts, valid, ring, cfg, 0.1 * k,
                run_mapping=(k % cfg.mapping_every == 0),
                run_loop=sched.due(0.1 * k), bootstrap=(k == 1))
            if (k + 1) % 200 == 0:
                np.asarray(out.fused_pose.t)
                print(f"  scan {k + 1}/{args.s1} "
                      f"({(k + 1) / (time.perf_counter() - t0):.1f} scans/s)",
                      flush=True)
        kf1 = int(state.mapping.kf.count)
        print(f"[session 1] done: {kf1} keyframes, "
              f"{int(state.loops.count)} closures", flush=True)

        # ---- checkpoint round-trip (the resume path carries the map) ----
        path = args.ckpt or os.path.join(tempfile.mkdtemp(), "session1.npz")
        checkpoint.save_state(path, state)
        restored = checkpoint.load_state(path, pipeline.init_slam_state(cfg))
        assert int(restored.mapping.kf.count) == kf1

    # ---- session 2 ground truth: restart mid-course ----
    k0 = int(args.s1 * args.kidnap_frac)
    R0, t0w = np.asarray(poses.R[0]), np.asarray(poses.t[0])
    # Session-2 needs poses beyond the stored lap when k0+s2 > s1: extend.
    poses2 = synthetic.circle_trajectory(
        k0 + args.s2 + 1, radius=args.radius, angular_rate=args.angular_rate)
    gt2 = (np.asarray(poses2.t)[k0:k0 + args.s2] - t0w) @ R0

    belief = np.asarray(restored.mapping.t_aft.t)
    offset = float(np.linalg.norm(belief - gt2[0]))
    print(f"[kidnap] restart at scan {k0}; belief-to-truth offset "
          f"{offset:.1f} m (submap radius {cfg.mapping.search_radius} m)",
          flush=True)

    def session2(use_reloc: bool):
        # mapping_step DONATES its state buffers — each run gets a fresh
        # deep copy of the restored map or run B would read run A's
        # invalidated buffers.
        st = pipeline.init_slam_state(cfg)._replace(
            mapping=jax.tree.map(jnp.array, restored.mapping),
            loops=jax.tree.map(jnp.array, restored.loops))
        sched2 = pipeline.LoopScheduler(cfg)
        fused = []
        t_off = args.s1 * 0.1 + 600.0      # resume later in data time
        for j in range(args.s2):
            k = k0 + j
            if j == 0:
                # Boot stationary: the first scan is rigid (no twist
                # estimate exists yet to de-skew a moving one).
                pts, valid, ring = synthetic.raycast_scan(
                    scene, Pose(poses2.R[k], poses2.t[k]), cfg.sensor)
            else:
                pts, valid, ring = ray(poses2.R[k], poses2.t[k],
                                       poses2.R[k + 1], poses2.t[k + 1])
            st, out = pipeline.slam_scan_step(
                st, pts, valid, ring, cfg, t_off + 0.1 * j,
                run_mapping=(j % cfg.mapping_every == 0) and j > 0,
                run_loop=sched2.due(t_off + 0.1 * j), bootstrap=(j == 1))
            if j == 0 and use_reloc:
                st, diag = relocalize.relocalize_slam_state(st, cfg)
                print(f"  reloc: accepted={bool(diag.accepted)} "
                      f"candidate={int(diag.candidate)} "
                      f"fitness={float(diag.fitness):.4f}", flush=True)
                out = out._replace(fused_pose=st.mapping.t_aft)
            fused.append(np.asarray(out.fused_pose.t))
        fused = np.array(fused)
        # Score scans after the first mapping cadence settles (both runs
        # identically); scan 0 itself is pre-reloc output in run A.
        # ate_rmse Umeyama-aligns (it would hide a constant kidnap offset);
        # localization in an EXISTING map is judged by the absolute map-frame
        # error, so that is the headline.
        ate_abs = float(np.sqrt(np.mean(
            np.sum((fused[1:] - gt2[1:]) ** 2, axis=1))))
        ate_umy = float(metrics.ate_rmse(jnp.asarray(fused[1:]),
                                         jnp.asarray(gt2[1:])))
        drift = float(np.linalg.norm(fused[-1] - gt2[-1]))
        return ate_abs, ate_umy, drift, \
            int(st.loops.count) - int(restored.loops.count)

    print("[session 2/A] no relocalization...", flush=True)
    ate_a, umy_a, drift_a, loops_a = session2(False)
    print(f"  abs ATE {ate_a:.3f} m  (umeyama {umy_a:.3f})  "
          f"end drift {drift_a:.3f} m  new closures {loops_a}", flush=True)
    print("[session 2/B] with relocalization...", flush=True)
    ate_b, umy_b, drift_b, loops_b = session2(True)
    print(f"  abs ATE {ate_b:.3f} m  (umeyama {umy_b:.3f})  "
          f"end drift {drift_b:.3f} m  new closures {loops_b}", flush=True)

    print("\n| run | abs ATE (map frame) | Umeyama ATE | end drift "
          "| new closures |")
    print("|---|---|---|---|---|")
    print(f"| A: stale belief, no reloc | {ate_a:.3f} m | {umy_a:.3f} m "
          f"| {drift_a:.3f} m | {loops_a} |")
    print(f"| B: ICP relocalization | {ate_b:.3f} m | {umy_b:.3f} m "
          f"| {drift_b:.3f} m | {loops_b} |")
    print(f"\nreloc advantage: {ate_a / max(ate_b, 1e-9):.1f}x abs ATE, "
          f"{umy_a / max(umy_b, 1e-9):.1f}x Umeyama "
          f"(acceptance bar: >= 2x)")


if __name__ == "__main__":
    main()
