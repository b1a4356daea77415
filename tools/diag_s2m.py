#!/usr/bin/env python
"""Isolated scan-to-map LM diagnostics.

Builds a submap from keyframes placed at GROUND-TRUTH poses (static raycast
scans, no odometry in the loop), perturbs the query pose by a known delta,
and measures how well ``scan_to_map`` recovers it.  Separates "the LM is
broken/biased" from "the map the LM sees is corrupted by upstream frames".

Usage: python tools/diag_s2m.py [--world loop] [--backend cpu] [--motion]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None)
    ap.add_argument("--world", default="loop", choices=["courtyard", "loop"])
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--angular-rate", type=float, default=0.009)
    ap.add_argument("--kf-every", type=int, default=2)
    ap.add_argument("--n-kf", type=int, default=12)
    ap.add_argument("--motion", action="store_true",
                    help="raycast with motion distortion (scan-end gt frame)")
    ap.add_argument("--refresh", type=int, default=None,
                    help="override corr_refresh_every")
    ap.add_argument("--iters", type=int, default=None,
                    help="override max_iterations")
    args = ap.parse_args()
    if args.radius is None:
        args.radius = 30.0 if args.world == "loop" else 26.0
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import mapping as mapping_mod
    from legoloam_tpu.models import pipeline
    from legoloam_tpu.ops import se3
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.ops.voxel import voxel_downsample
    from legoloam_tpu.utils import synthetic

    import dataclasses

    cfg = DEFAULT
    mcfg = cfg.mapping
    if args.refresh:
        mcfg = dataclasses.replace(mcfg, corr_refresh_every=args.refresh)
    if args.iters:
        mcfg = dataclasses.replace(mcfg, max_iterations=args.iters)
    scene = (synthetic.loop_scene() if args.world == "loop"
             else synthetic.default_scene())
    n_scans = args.n_kf * args.kf_every + 1
    poses = synthetic.circle_trajectory(n_scans + 1, radius=args.radius,
                                        angular_rate=args.angular_rate)

    def frontend_clouds(k):
        """Feature clouds of scan k, downsampled exactly like mapping_step."""
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[k + 1], poses.t[k + 1])
        pts, valid, ring = synthetic.raycast_scan(
            scene, pk, cfg.sensor,
            next_pose=nxt if args.motion else None, motion=args.motion)
        feats = pipeline.process_scan(pts, valid, ring, cfg)
        zero3 = jnp.zeros((3,))
        c, cv = voxel_downsample(
            feats.less_sharp.xyz, feats.less_sharp.valid, mcfg.corner_leaf,
            mcfg.scan_corner_cap, origin=zero3)
        s_all = jnp.concatenate([feats.less_flat.xyz, feats.outlier.xyz], 0)
        s_ok = jnp.concatenate([feats.less_flat.valid, feats.outlier.valid], 0)
        s, sv = voxel_downsample(s_all, s_ok, mcfg.surf_leaf,
                                 mcfg.scan_surf_cap, origin=zero3)
        return c, cv, s, sv

    # Keyframes at GT poses.
    state = mapping_mod.init_state(mcfg)
    kf = state.kf
    for j in range(args.n_kf):
        k = j * args.kf_every
        c, cv, s, sv = frontend_clouds(k)
        kf = kf._replace(
            R=kf.R.at[j].set(poses.R[k]), t=kf.t.at[j].set(poses.t[k]),
            corner=kf.corner.at[j].set(c), corner_valid=kf.corner_valid.at[j].set(cv),
            surf=kf.surf.at[j].set(s), surf_valid=kf.surf_valid.at[j].set(sv),
            count=jnp.int32(j + 1))

    # Query scan = the last scan (not a keyframe).
    kq = args.n_kf * args.kf_every
    qc, qcv, qs, qsv = frontend_clouds(kq)
    gt = Pose(poses.R[kq], poses.t[kq])

    (sub_c, sub_cv), (sub_s, sub_sv) = mapping_mod.extract_submap(
        kf, gt.t, mcfg)
    print(f"submap: {int(jnp.sum(sub_cv))} corner, {int(jnp.sum(sub_sv))} "
          f"surf voxels; query: {int(jnp.sum(qcv))} corner, "
          f"{int(jnp.sum(qsv))} surf pts; motion={args.motion}")

    rng = np.random.RandomState(0)
    print(f"{'perturb t(m)/r(deg)':>22} {'-> err t(m)':>12} {'err r(deg)':>11} "
          f"{'iters':>6} {'nC':>5} {'nS':>6}")
    for dt, rot_deg in [(0.0, 0.0), (0.05, 0.3), (0.1, 0.5), (0.2, 1.0),
                        (0.5, 2.0), (1.0, 4.0)]:
        for trial in range(3):
            dvec = rng.randn(3); dvec = dvec / np.linalg.norm(dvec) * dt
            axis = rng.randn(3); axis /= np.linalg.norm(axis)
            w = axis * np.radians(rot_deg)
            xi = jnp.asarray(np.concatenate([w, dvec]), jnp.float32)
            guess = se3.retract(gt, xi)
            T, iters, n_c, n_s = mapping_mod.scan_to_map(
                guess, qc, qcv, qs, qsv, sub_c, sub_cv, sub_s, sub_sv, mcfg)
            terr = float(jnp.linalg.norm(T.t - gt.t))
            tvec = np.asarray(T.t - gt.t)
            dR = np.asarray(T.R) @ np.asarray(gt.R).T   # world-frame error rot
            w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                          dR[1, 0] - dR[0, 1]]) * 0.5   # ~axis*sin(angle)
            tr = np.clip((np.trace(dR) - 1) / 2, -1, 1)
            rerr = float(np.degrees(np.arccos(tr)))
            print(f"{dt:13.2f}/{rot_deg:7.2f} {terr:12.4f} {rerr:11.4f} "
                  f"{int(iters):6d} {int(n_c):5d} {int(n_s):6d}"
                  f"   dt=({tvec[0]:+.3f},{tvec[1]:+.3f},{tvec[2]:+.3f})"
                  f" w_deg=({np.degrees(w[0]):+.2f},{np.degrees(w[1]):+.2f},"
                  f"{np.degrees(w[2]):+.2f})", flush=True)


if __name__ == "__main__":
    main()
