#!/usr/bin/env python
"""Per-piece timing of the scan-to-map LM body on the real device."""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as _np


def _sync(out):
    _np.asarray(jax.tree.leaves(out)[-1]).ravel()[:1]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    if args.backend:
        jax.config.update("jax_platforms", args.backend)

    from legoloam_tpu.config import DEFAULT
    from legoloam_tpu.models import mapping, pipeline
    from legoloam_tpu.ops import lm, se3
    from legoloam_tpu.ops.knn_pallas import search
    from legoloam_tpu.ops.se3 import Pose
    from legoloam_tpu.ops.voxel import voxel_downsample
    from legoloam_tpu.utils import synthetic

    cfg = DEFAULT
    scene = synthetic.default_scene()
    state = pipeline.init_slam_state(cfg)
    poses = synthetic.circle_trajectory(31, radius=20.0, angular_rate=0.0075)
    out = None
    for k in range(30):
        pk = Pose(poses.R[k], poses.t[k])
        nxt = Pose(poses.R[k + 1], poses.t[k + 1])
        pts, valid, ring = synthetic.raycast_scan(scene, pk, cfg.sensor,
                                                  next_pose=nxt, motion=True)
        state, out = pipeline.slam_scan_step(
            state, pts, valid, ring, cfg, 0.1 * k,
            run_mapping=(k % cfg.mapping_every == 0))
    _sync(state.mapping.kf.count)

    ms = state.mapping
    oc, os_, oo = state.odom.last_corner, state.odom.last_surf, \
        state.odom.last_outlier
    opose = out.odom_pose
    mc = cfg.mapping

    c_pts, c_ok = voxel_downsample(oc.xyz, oc.valid, mc.corner_leaf,
                                   mc.scan_corner_cap)
    surf_all = jnp.concatenate([os_.xyz, oo.xyz], axis=0)
    surf_all_ok = jnp.concatenate([os_.valid, oo.valid], axis=0)
    s_pts, s_ok = voxel_downsample(surf_all, surf_all_ok, mc.surf_leaf,
                                   mc.scan_surf_cap)
    sub = jax.jit(lambda kf, c: mapping.extract_submap(kf, c, mc))
    (sub_c, sub_cv), (sub_s, sub_sv) = sub(ms.kf, opose.t)
    _sync(sub_sv)

    def timed(name, fn, *a):
        r = fn(*a)
        _sync(r)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = fn(*a)
        _sync(r)
        print(f"{name:42s} {(time.perf_counter() - t0) / args.iters * 1e3:9.2f} ms")
        return r

    pc_w = se3.transform_points(opose, c_pts)
    ps_w = se3.transform_points(opose, s_pts)

    gate = float(mc.nn_max_dist) ** 0.5
    knnp = jax.jit(lambda q, qv, r, rv: search(q, qv, r, rv, k=5, gate=gate))
    timed("knn 5-NN surf", lambda: knnp(ps_w, s_ok, sub_s, sub_sv))
    timed("knn 5-NN corner", lambda: knnp(pc_w, c_ok, sub_c, sub_cv))

    cres = jax.jit(lambda p, v: mapping._corner_residuals(p, v, sub_c, sub_cv, mc))
    sres = jax.jit(lambda p, v: mapping._surf_residuals(p, v, sub_s, sub_sv, mc))
    timed("_corner_residuals (full)", lambda: cres(pc_w, c_ok))
    timed("_surf_residuals (full)", lambda: sres(ps_w, s_ok))

    d_s, i_s = knnp(ps_w, s_ok, sub_s, sub_sv)
    gath = jax.jit(lambda i: sub_s[i])
    timed("gather sub_s[i] (8192x5)", lambda: gath(i_s))
    nn = sub_s[i_s]
    timed("fit_plane_lstsq (8192x5)", jax.jit(lambda n: lm.fit_plane_lstsq(n)), nn)

    s2m = jax.jit(lambda g: mapping.scan_to_map(
        g, c_pts, c_ok, s_pts, s_ok, sub_c, sub_cv, sub_s, sub_sv, mc))
    r = timed("scan_to_map LM (full)", lambda: s2m(opose))
    print("LM iterations taken:", int(r[1]))

    # one full iteration body cost = residuals + J assembly + solve
    def one_iter(T):
        pc = se3.transform_points(T, c_pts)
        ps = se3.transform_points(T, s_pts)
        cdir, cr, c_okr = mapping._corner_residuals(pc, c_ok, sub_c, sub_cv, mc)
        sdir, sr, s_okr = mapping._surf_residuals(ps, s_ok, sub_s, sub_sv, mc)
        p_all = jnp.concatenate([pc, ps], axis=0)
        dir_all = jnp.concatenate([cdir, sdir], axis=0)
        res_all = jnp.concatenate([cr, sr], axis=0)
        ok_all = jnp.concatenate([c_okr, s_okr], axis=0)
        J = jnp.concatenate([jnp.cross(p_all, dir_all), dir_all], axis=1)
        delta, deg = lm.solve_normal_equations(
            J, res_all, ok_all, 1.0, lm.identity_degeneracy(6), True,
            mc.degeneracy_eig_thresh)
        return se3.retract(T, delta)

    timed("one LM iteration (jitted alone)", jax.jit(one_iter), opose)


if __name__ == "__main__":
    main()
