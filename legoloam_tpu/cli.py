"""Command-line runner — the reference's launch file + rosbag replay, as one
deterministic process.

Reference: ``roslaunch lego_loam run.launch`` + ``rosbag play`` + RViz
(``launch/run.launch``, README.md:90-106).  Here:

    python -m legoloam_tpu --scans /data/seq/*.lpk --out /tmp/run1
    python -m legoloam_tpu --synthetic 200 --out /tmp/run1  # no dataset needed

Outputs (the reference's /tmp PCD dumps + more, mapOptmization.cpp:730-755):
    out/trajectory_fused.txt   TUM-format fused trajectory (10 Hz equivalent)
    out/trajectory_mapped.txt  TUM-format mapped keyframe trajectory
    out/global_map.pcd         voxel-downsampled world map
    out/checkpoint.npz         full resumable SLAM state
    out/profile.txt            per-stage wall-clock summary
"""

from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="legoloam_tpu", description=__doc__)
    ap.add_argument("--scans", nargs="*", default=None,
                    help="scan files (.lpk/.bin/.pcd), in sequence order")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N ray-cast synthetic scans instead of files")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--sensor", default="vlp16",
                    choices=["vlp16", "hdl32e", "vls128", "os1_16", "os1_64"])
    ap.add_argument("--loop-closure", action="store_true")
    ap.add_argument("--imu", default=None, metavar="FILE.imu",
                    help="IMU1 sidecar (utils/io.py:write_imu) on the scan "
                         "clock; enables de-skew + the IMU-seeded initial "
                         "guess + the mapping attitude blend")
    ap.add_argument("--odometry-only", action="store_true",
                    help="skip mapping (BASELINE config 2 mode)")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--relocalize", action="store_true",
                    help="with --resume: relocalize the first scan in the "
                         "restored keyframe map (ICP hypothesis sweep, "
                         "models/relocalize.py) before continuing — for "
                         "multi-session runs where the robot does not "
                         "restart where the previous session ended")
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--map-every", type=int, default=2000, metavar="N",
                    help="export the downsampled global map every N scans "
                         "during the run (the reference publishes it at "
                         "0.2 Hz, mapOptmization.cpp:758-800); 0 = only at "
                         "the end")
    ap.add_argument("--backend", default=None, help="cpu to force CPU")
    ap.add_argument("--debug-dump", default=None, metavar="DIR",
                    help="write per-scan debug npz records (range image, "
                         "ground mask, cluster labels, pick sets, submap "
                         "occupancy, diag counters) every --debug-every "
                         "scans — the reference's subscriber-gated RViz "
                         "debug publishers (imageProjection.cpp:463-507), "
                         "offline; view with tools/view_debug.py")
    ap.add_argument("--debug-every", type=int, default=50)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the DISTRIBUTED pipeline over an N-device mesh "
                         "(keyframe clouds sharded, submap all_gather, psum'd "
                         "scan-to-map LM, sharded pose graph); 0 = "
                         "single-device")
    ap.add_argument("--preset", default="default", choices=["default", "small"],
                    help="'small' shrinks map capacities (CPU debugging)")
    args = ap.parse_args(argv)

    import jax
    if args.backend:
        jax.config.update("jax_platforms", args.backend)
    import dataclasses

    from .utils import compile_cache
    compile_cache.enable()

    import jax.numpy as jnp
    import numpy as np

    from .config import DEFAULT, SENSORS
    from .models import pipeline
    from .ops.se3 import Pose
    from .utils import checkpoint, export, io as lio, profiling, synthetic

    cfg = DEFAULT.replace(sensor=SENSORS[args.sensor])
    if args.preset == "small":
        cfg = cfg.replace(mapping=dataclasses.replace(
            cfg.mapping, max_keyframes=128, submap_corner_cap=4096,
            submap_surf_cap=8192, scan_corner_cap=1024, scan_surf_cap=4096))
    if args.loop_closure:
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, enabled=True))

    os.makedirs(args.out, exist_ok=True)
    timer = profiling.StageTimer()

    # --- scan source ---
    if args.synthetic:
        scene = synthetic.default_scene()
        n = args.synthetic
        poses = synthetic.circle_trajectory(n, radius=20.0,
                                            angular_rate=0.0075)

        def scan_iter():
            for k in range(n):
                pk = Pose(poses.R[k], poses.t[k])
                nxt = Pose(poses.R[min(k + 1, n - 1)],
                           poses.t[min(k + 1, n - 1)])
                with timer.stage("raycast"):
                    yield synthetic.raycast_scan(
                        scene, pk, cfg.sensor, next_pose=nxt,
                        motion=k + 1 < n)
    else:
        paths = []
        for p in (args.scans or []):
            paths.extend(sorted(glob.glob(p)) if any(c in p for c in "*?")
                         else [p])
        if not paths:
            ap.error("no scans given (use --scans or --synthetic N)")
        loader = lio.ScanLoader(
            paths, point_cap=cfg.sensor.n_points,
            n_scan=cfg.sensor.n_scan,
            ang_bottom_deg=cfg.sensor.ang_bottom_deg,
            ang_res_y_deg=cfg.sensor.ang_res_y_deg)

        def scan_iter():
            for xyz, valid, ring in loader:
                yield jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(ring)

    # --- run ---
    mesh = None
    if args.relocalize and not args.resume:
        ap.error("--relocalize requires --resume (a restored keyframe map)")
    if args.mesh:
        from .parallel import mesh as mesh_mod, pipeline_dist
        n_dev = len(jax.devices())
        if n_dev < args.mesh:
            ap.error(f"--mesh {args.mesh} but only {n_dev} devices visible")
        mesh = mesh_mod.make_mesh(args.mesh)
        if cfg.mapping.max_keyframes % args.mesh:
            rounded = cfg.mapping.max_keyframes // args.mesh * args.mesh
            print(f"warning: --mesh {args.mesh} does not divide "
                  f"max_keyframes={cfg.mapping.max_keyframes}; capacity "
                  f"rounded down to {rounded} (checkpoints saved at the "
                  f"original capacity will not resume under this mesh)",
                  file=sys.stderr)
            cfg = cfg.replace(mapping=dataclasses.replace(
                cfg.mapping, max_keyframes=rounded))
        state = pipeline_dist.init_dist_state(cfg, mesh)
    else:
        state = pipeline.init_slam_state(cfg)
    if args.resume:
        if mesh is not None:
            single = pipeline.init_slam_state(cfg)
            single = checkpoint.load_state(args.resume, single)
            state = state._replace(
                odom=single.odom, loops=single.loops,
                mapping=state.mapping._replace(
                    kf=pipeline_dist.from_keyframe_store(single.mapping.kf,
                                                         mesh),
                    t_bef=single.mapping.t_bef, t_aft=single.mapping.t_aft,
                    ground_ref=single.mapping.ground_ref,
                    ground_ref_ok=single.mapping.ground_ref_ok,
                    initialized=single.mapping.initialized))
        else:
            state = checkpoint.load_state(args.resume, state)
    def snapshot(st):
        """Canonical single-device state (checkpoints stay interchangeable
        between --mesh and single-device runs)."""
        if mesh is None:
            return st
        single = pipeline.init_slam_state(cfg)
        return pipeline.SlamState(
            odom=st.odom, loops=st.loops,
            mapping=single.mapping._replace(
                kf=pipeline_dist.to_keyframe_store(st.mapping.kf, mesh),
                t_bef=st.mapping.t_bef, t_aft=st.mapping.t_aft,
                ground_ref=st.mapping.ground_ref,
                ground_ref_ok=st.mapping.ground_ref_ok,
                initialized=st.mapping.initialized))

    imu_seq = None
    if args.imu:
        from .ops import deskew
        imu_seq = lio.ImuSequence.from_file(args.imu)

    from .utils.debugdump import DebugDumper
    dumper = DebugDumper(args.debug_dump, every=args.debug_every)

    sched = pipeline.LoopScheduler(cfg)
    fused_R, fused_t, times = [], [], []
    for k, scan in enumerate(scan_iter()):
        t = k * cfg.sensor.scan_period
        integ = None
        if imu_seq is not None:
            with timer.stage("imu"):
                integ = deskew.integrate_imu(
                    imu_seq.window_for(t, cfg.sensor.scan_period))
        with timer.stage("slam_step"):
            run_mapping = not args.odometry_only \
                and (k % cfg.mapping_every == 0)
            if mesh is not None:
                state, out = pipeline_dist.slam_scan_step_dist(
                    state, *scan, cfg, mesh, t,
                    run_mapping=run_mapping, run_loop=sched.due(t),
                    imu_integral=integ)
            else:
                state, out = pipeline.slam_scan_step(
                    state, *scan, cfg, t,
                    run_mapping=run_mapping,
                    run_loop=sched.due(t),
                    imu_integral=integ,
                    bootstrap=(k == 1 and not args.resume))
        if k == 0 and args.relocalize and args.resume:
            from .models import relocalize as reloc_mod
            if mesh is None:
                state, rdiag = reloc_mod.relocalize_slam_state(state, cfg)
            else:
                # Mesh path: relocalize against the canonical single-device
                # snapshot (one full-store gather at boot), then write the
                # REPLICATED correction back — t_bef/t_aft and the
                # initialized flag are replicated in DistMapState, and the
                # distributed submap is rebuilt per step anyway.
                single, rdiag = reloc_mod.relocalize_slam_state(
                    snapshot(state), cfg)
                state = state._replace(mapping=state.mapping._replace(
                    t_bef=single.mapping.t_bef,
                    t_aft=single.mapping.t_aft,
                    initialized=single.mapping.initialized))
            print(f"[reloc] accepted={bool(rdiag.accepted)} "
                  f"candidate={int(rdiag.candidate)} "
                  f"fitness={float(rdiag.fitness):.4f}")
            out = out._replace(fused_pose=state.mapping.t_aft)
        fused_R.append(out.fused_pose.R)
        fused_t.append(out.fused_pose.t)
        times.append(t)
        if dumper.due(k):
            with timer.stage("debug_dump"):
                dumper.maybe_dump(k, scan, cfg, state=state, diag=out.diag)
        if args.checkpoint_every and (k + 1) % args.checkpoint_every == 0:
            with timer.stage("checkpoint"):
                checkpoint.save_state(
                    os.path.join(args.out, "checkpoint.npz"), snapshot(state))
        if args.map_every and (k + 1) % args.map_every == 0:
            with timer.stage("map_export"):
                kf_now = snapshot(state).mapping.kf
                if int(kf_now.count):
                    pts, val = export.assemble_global_map(kf_now)
                    export.write_pcd(
                        os.path.join(args.out, "global_map.pcd"),
                        np.asarray(pts), np.asarray(val))
        if (k + 1) % 100 == 0:
            print(f"[legoloam_tpu] {k + 1} scans, "
                  f"{int(state.mapping.kf.count)} keyframes", file=sys.stderr)
            # No-silent-caps: warn the moment any fixed cap drops data, and
            # decimate the keyframe store before it saturates (the reference
            # grows RAM unboundedly instead, mapOptmization.cpp:84-86).
            fo = np.asarray(out.diag.feat_overflow)
            if fo.any():
                print(f"warning: feature caps overflowed this scan "
                      f"[sharp,less_sharp,flat,less_flat,outlier]={fo.tolist()}"
                      f" — raise FeatureConfig caps", file=sys.stderr)
            if int(state.loops.dropped):
                print(f"warning: {int(state.loops.dropped)} loop factors "
                      f"dropped (cap/decimation) — raise "
                      f"PoseGraphConfig.max_loop_factors", file=sys.stderr)
            if int(state.mapping.kf.overflow):
                print(f"warning: keyframe store overflowed "
                      f"{int(state.mapping.kf.overflow)} times — raise "
                      f"max_keyframes or decimate more aggressively",
                      file=sys.stderr)
            if mesh is None:
                if int(getattr(state.mapping.cache, "voxel_overflow", 0)):
                    print(f"warning: submap voxel caps dropped "
                          f"{int(state.mapping.cache.voxel_overflow)} voxels "
                          f"— raise submap_*_cap", file=sys.stderr)
                state, did = pipeline.maybe_decimate(state, cfg, margin=48)
                if did:
                    print(f"[legoloam_tpu] keyframe store decimated to "
                          f"{int(state.mapping.kf.count)} "
                          f"(cap {cfg.mapping.max_keyframes})",
                          file=sys.stderr)

    # --- outputs ---
    state = snapshot(state)
    fused = Pose(jnp.stack(fused_R), jnp.stack(fused_t))
    export.write_trajectory_tum(
        os.path.join(args.out, "trajectory_fused.txt"), times, fused)
    kf = state.mapping.kf
    n_kf = int(kf.count)
    if n_kf:
        export.write_trajectory_tum(
            os.path.join(args.out, "trajectory_mapped.txt"),
            np.asarray(kf.time[:n_kf]),
            Pose(kf.R[:n_kf], kf.t[:n_kf]))
        pts, val = export.assemble_global_map(kf)
        export.write_pcd(os.path.join(args.out, "global_map.pcd"),
                         np.asarray(pts), np.asarray(val))
    checkpoint.save_state(os.path.join(args.out, "checkpoint.npz"), state)
    with open(os.path.join(args.out, "profile.txt"), "w") as f:
        f.write(timer.summary() + "\n")
    n_scans = len(times)
    rate = timer.counts["slam_step"] / max(timer.totals["slam_step"], 1e-9)
    print(f"[legoloam_tpu] done: {n_scans} scans, {n_kf} keyframes, "
          f"{rate:.1f} scans/s -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
