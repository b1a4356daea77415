#!/usr/bin/env python
"""Per-mapping-step diagnostics on a synthetic world.

Prints, for every mapping step: the initial-guess error vs ground truth, the
post-LM mapped-pose error, residual counts, LM iterations, submap occupancy,
and whether the submap cache rebuilt — to localize mapping divergence.

Usage: python tools/diag_map.py --world loop --scans 200 [--backend cpu]
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
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--world", default="loop", choices=["courtyard", "loop"])
    ap.add_argument("--radius", type=float, default=None)
    ap.add_argument("--angular-rate", type=float, default=0.009)
    ap.add_argument("--gt-odom", action="store_true",
                    help="feed mapping GROUND-TRUTH odometry poses (but the "
                         "real odometry-warped clouds): isolates cloud-frame "
                         "bugs from odometry-error feedback")
    ap.add_argument("--no-motion", action="store_true",
                    help="raycast WITHOUT motion distortion")
    ap.add_argument("--no-deskew", action="store_true",
                    help="disable all intra-scan warps (rel_time=0)")
    ap.add_argument("--traj", default="circle", choices=["circle", "figure8"])
    ap.add_argument("--refresh", type=int, default=None,
                    help="override mapping corr_refresh_every")
    ap.add_argument("--map-iters", type=int, default=None,
                    help="override mapping max_iterations")
    ap.add_argument("--rot-std", type=float, default=None,
                    help="override mapping prior_rot_std_deg")
    ap.add_argument("--trans-std", type=float, default=None,
                    help="override mapping prior_trans_std")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override any MappingConfig field, e.g. "
                         "--set surrounding_leaf=0.01 --set ground_anchor=0")
    args = ap.parse_args()
    if args.radius is None:
        args.radius = 30.0 if args.world == "loop" else 26.0
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import mapping as mapping_mod
    from legoloam_tpu.models import odometry as odom_mod
    from legoloam_tpu.models import pipeline
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.utils import synthetic

    import dataclasses

    cfg = DEFAULT
    if args.no_deskew:
        cfg = cfg.replace(deskew=False)
    m = cfg.mapping
    if args.refresh:
        m = dataclasses.replace(m, corr_refresh_every=args.refresh)
    if args.map_iters:
        m = dataclasses.replace(m, max_iterations=args.map_iters)
    if args.rot_std is not None:
        m = dataclasses.replace(m, prior_rot_std_deg=args.rot_std)
    if args.trans_std is not None:
        m = dataclasses.replace(m, prior_trans_std=args.trans_std)
    from legoloam_tpu.config import apply_overrides
    m = apply_overrides(m, args.set)
    cfg = cfg.replace(mapping=m)
    scene = (synthetic.loop_scene() if args.world == "loop"
             else synthetic.default_scene())
    n = args.scans
    if args.traj == "figure8":
        poses = synthetic.figure8_trajectory(n + 1, radius=8.0)
    else:
        poses = synthetic.circle_trajectory(n + 1, radius=args.radius,
                                            angular_rate=args.angular_rate)
    motion = not args.no_motion
    ray = jax.jit(lambda pk_R, pk_t, nx_R, nx_t: synthetic.raycast_scan(
        scene, Pose(pk_R, pk_t), cfg.sensor,
        next_pose=Pose(nx_R, nx_t) if motion else None, motion=motion))

    # Re-create slam_scan_step but capture the mapping diag + guess.
    from legoloam_tpu.models import fusion as fusion_mod
    from legoloam_tpu.ops import se3

    state = pipeline.init_slam_state(cfg)
    print(f"{'k':>4} {'|guess err|':>11} {'|mapped err|':>12} {'odom err':>9} "
          f"{'nC':>5} {'nS':>6} {'it':>3} {'subC':>6} {'subS':>6} "
          f"{'kf':>4} {'rebuilt':>7}")
    prev_map_k = None      # (scan index, odom pose) at the previous mapping
    prev_odom = None
    for k in range(n):
        pts, valid, ring = ray(poses.R[k], poses.t[k],
                               poses.R[k + 1], poses.t[k + 1])
        odom_state, out = pipeline.odometry_scan_step(
            state.odom, pts, valid, ring, cfg)
        if args.gt_odom:
            # GT pose expressed in the estimate frame (scan-0 sensor frame).
            gt_rel_t = poses.t[k] - poses.t[0]
            out = out._replace(pose=type(out.pose)(poses.R[k], gt_rel_t))
        map_state = state.mapping
        if k % cfg.mapping_every == 0:
            guess = se3.project_through_correction(
                out.pose, map_state.t_bef, map_state.t_aft)
            merged_before = int(map_state.cache.merged)
            origin_before = np.asarray(map_state.cache.origin)
            map_state, mapped_pose, mdiag = mapping_mod.mapping_step(
                map_state, odom_state.last_corner, odom_state.last_surf,
                odom_state.last_outlier, out.pose, jnp.asarray(0.1 * k),
                cfg.mapping, ground_cloud=odom_state.last_flat)
            gt_t = np.asarray(poses.t[k])
            g_err = float(np.linalg.norm(np.asarray(guess.t) - gt_t))
            m_err = float(np.linalg.norm(np.asarray(mapped_pose.t) - gt_t))
            o_err = float(np.linalg.norm(np.asarray(out.pose.t) - gt_t))

            def rot_err_deg_at(R_est, kk):
                dR = np.asarray(R_est) @ np.asarray(poses.R[kk]).T
                w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0],
                              dR[1, 0] - dR[0, 1]]) * 0.5
                return np.degrees(np.arcsin(np.clip(np.linalg.norm(w),
                                                    -1, 1)))

            def rot_err_deg(R_est):
                return rot_err_deg_at(R_est, k)
            g_r = rot_err_deg(guess.R)
            m_r = rot_err_deg(mapped_pose.R)
            o_r = rot_err_deg(out.pose.R)
            rebuilt = not np.allclose(np.asarray(map_state.cache.origin),
                                      origin_before)
            # Error vector in the GT heading frame (fwd/left/up), offset-free.
            gt_rel = np.asarray(poses.t[k]) - np.asarray(poses.t[0])
            d = np.asarray(mapped_pose.t) - gt_rel
            Rk = np.asarray(poses.R[k])
            e_fwd, e_left, e_up = float(d @ Rk[:, 0]), float(d @ Rk[:, 1]), \
                float(d[2])
            # Attribution: odometry-DELTA translation error over this mapping
            # window (the noise the guess inherits from odometry), plus the
            # GUESS-STEP error: how far the projected guess moved vs the true
            # world-frame motion since the previous mapped pose.
            d_odo_err = 0.0
            guess_step_err = 0.0
            step_ang = step_mag = aft_rot = odo_n = 0.0
            if prev_map_k is not None:
                pk = prev_map_k
                gt_d = np.asarray(poses.R[pk]).T @ (
                    np.asarray(poses.t[k]) - np.asarray(poses.t[pk]))
                oR = np.asarray(prev_odom.R)
                od_d = oR.T @ (np.asarray(out.pose.t)
                               - np.asarray(prev_odom.t))
                d_odo_err = float(np.linalg.norm(od_d - gt_d))
                gt_d_world = np.asarray(poses.t[k]) - np.asarray(poses.t[pk])
                guess_step = np.asarray(guess.t) - np.asarray(prev_mapped_t)
                guess_step_err = float(np.linalg.norm(guess_step
                                                      - gt_d_world))
                # Decompose: angle between the projected and true step, the
                # magnitude ratio, and the attitude error of the t_aft used.
                gs_n = np.linalg.norm(guess_step)
                gt_n = np.linalg.norm(gt_d_world)
                odo_n = float(np.linalg.norm(np.asarray(out.pose.t)
                                             - np.asarray(prev_odom.t)))
                cosang = np.clip(guess_step @ gt_d_world
                                 / max(gs_n * gt_n, 1e-12), -1, 1)
                step_ang = float(np.degrees(np.arccos(cosang)))
                step_mag = float(gs_n / max(gt_n, 1e-12))
                aft_rot = rot_err_deg_at(np.asarray(prev_aft_R), pk)
            prev_map_k, prev_odom = k, out.pose
            prev_mapped_t = np.asarray(mapped_pose.t)
            prev_aft_R = np.asarray(mapped_pose.R)
            print(f"{k:4d} {g_err:11.3f} {m_err:12.3f} {o_err:9.3f} "
                  f"{int(mdiag.n_corner_res):5d} {int(mdiag.n_surf_res):6d} "
                  f"{int(mdiag.iters):3d} {int(mdiag.n_submap_corner):6d} "
                  f"{int(mdiag.n_submap_surf):6d} "
                  f"{int(map_state.kf.count):4d} {str(rebuilt):>7}"
                  f"  rot(g/m/o)deg={g_r:5.2f}/{m_r:5.2f}/{o_r:5.2f}"
                  f"  e(f/l/u)=({e_fwd:+7.2f},{e_left:+7.2f},{e_up:+6.2f})"
                  f"  dOdo={d_odo_err:6.3f} gStep={guess_step_err:6.3f}"
                  f"  stepAng={step_ang:5.2f} stepMag={step_mag:5.3f}"
                  f"  aftRot={aft_rot:5.2f} odoN={odo_n:5.3f}",
                  flush=True)
        state = pipeline.SlamState(odom=odom_state, mapping=map_state,
                                   loops=state.loops)


if __name__ == "__main__":
    main()
