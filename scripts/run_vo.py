#!/usr/bin/env python
"""VO driver CLI — the framework's replacement for the reference ROS nodes
(ros1/visual_odometry/node_{mono,stereo}_vo.cpp + launch files).

Examples:
  # KITTI stereo sequence with calib from the dataset
  python scripts/run_vo.py --dataset kitti --root /data/kitti_odom --seq 00 \\
      --mode stereo --out out/kitti00

  # Synthetic smoke run (no dataset needed)
  python scripts/run_vo.py --dataset synthetic --frames 30 --mode stereo --out out/syn

  # EuRoC mono with a reference-format YAML config
  python scripts/run_vo.py --dataset euroc --root /data/MH_01 --mode mono \\
      --config config/euroc_mono.yaml --out out/mh01

Outputs (reference trajectory-dump parity, mono_vo.cpp:64-127):
  <out>/frame_poses.txt     13-column KITTI-format all-frame trajectory
  <out>/keyframe_poses.txt  keyframe subset
  <out>/stats.jsonl         per-frame statistics records
  <out>/trajectory.png      top-down plot (with GT when available; --plot,
                            needs matplotlib)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["kitti", "euroc", "synthetic"], required=True)
    p.add_argument("--root", default=None, help="dataset root directory")
    p.add_argument("--seq", default="00", help="KITTI sequence id")
    p.add_argument("--mode", choices=["mono", "stereo"], default="stereo")
    p.add_argument("--config", default=None, help="reference-format YAML config")
    p.add_argument("--frames", type=int, default=None, help="limit frame count")
    p.add_argument("--out", default="out/run")
    p.add_argument("--platform", default=None, help="force jax platform (cpu/cuda)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="capture a jax.profiler device trace of the run (view in xprof/tensorboard)")
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="device-resident batching: scan B frames per device call "
                        "(the batched serving path; 0 = per-frame)")
    p.add_argument("--stage-timing", action="store_true",
                   help="per-stage device timing in stats.jsonl (statisticsStamped "
                        "time_track/1p/pose/new/ba fields; slower — per-stage sync)")
    p.add_argument("--debug-images", action="store_true",
                   help="write per-frame tracking overlays to <out>/debug/ "
                        "(showTracking analog, mono_vo.cpp:392-475)")
    p.add_argument("--plot", action="store_true",
                   help="write <out>/trajectory.png (needs matplotlib)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def build_dataset(args):
    from visual_odometry_ros_tpu.config import VOConfig, load_yaml

    if args.dataset == "kitti":
        from visual_odometry_ros_tpu.io.datasets import KittiOdometry

        ds = KittiOdometry(args.root, args.seq)
        cfg = load_yaml(args.config) if args.config else ds.config()
        gt = ds.gt_poses
        return ds, cfg, gt
    if args.dataset == "euroc":
        from visual_odometry_ros_tpu.io.datasets import EurocMav

        ds = EurocMav(args.root, stereo=(args.mode == "stereo"))
        if args.config is None:
            raise SystemExit("--config YAML is required for EuRoC (distorted cameras)")
        cfg = load_yaml(args.config)
        gt = None if ds.gt is None else ds.gt[1]
        return ds, cfg, gt
    # synthetic
    from visual_odometry_ros_tpu.io.synthetic import TwoPlaneSequence, forward_trajectory

    n = args.frames or 30
    # Keep the whole trajectory comfortably in front of the near plane: at
    # 0.25 m/frame the camera reaches the default z0_a=9 m plane by frame 36
    # and the chirality guard (correctly) aborts the render.
    step = 0.25
    z_needed = step * n + 4.0
    world = TwoPlaneSequence(z0_a=max(9.0, z_needed), z0_b=max(18.0, 2.0 * z_needed))
    poses = forward_trajectory(n, step=step, yaw_rate=0.002, lateral=0.1 if args.mode == "mono" else 0.0)

    def it():
        for i, T in enumerate(poses):
            l, r = world.stereo_pair(T.astype(np.float64))
            yield i * 0.1, l, r

    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = world.a.fx
    cfg.cam.cx, cfg.cam.cy = world.a.cx, world.a.cy
    cfg.cam.width, cfg.cam.height = world.width, world.height
    cfg.cam_right = cfg.cam
    cfg.T_lr = np.eye(4, dtype=np.float32)
    cfg.T_lr[0, 3] = world.a.baseline
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.score_min = 10.0
    cfg.extractor.thres_fastscore = 8.0
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.0
    if args.mode == "mono":
        cfg.map.thres_parallax = 0.4
        cfg.keyframe.thres_translation = 1e9
        cfg.keyframe.thres_overlap_ratio = 0.75
    return it(), cfg, poses


def main(argv=None):
    args = parse_args(argv)
    # Explicit SIGINT -> KeyboardInterrupt, even when the inherited
    # disposition is SIG_IGN (non-interactive shells start background jobs
    # that way, and Python then skips its default handler). Reference parity:
    # core/util/signal_handler_linux.cpp installs its own handler so the
    # destructor trajectory dump always runs.
    import signal

    def _sigint(_sig, _frm):
        raise KeyboardInterrupt

    try:
        signal.signal(signal.SIGINT, _sigint)
    except ValueError:
        pass  # not the main thread (embedded use) — rely on the caller
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from visual_odometry_ros_tpu.device import device_info, enable_compile_cache
    from visual_odometry_ros_tpu.io.statistics import ExecStats, FrameRecord, LandmarkStats, StatisticsLog
    from visual_odometry_ros_tpu.io.trajectory import ate_rmse, save_kitti_trajectory

    enable_compile_cache()

    ds, cfg, gt = build_dataset(args)

    if args.mode == "stereo":
        from visual_odometry_ros_tpu.models.stereo_vo import StereoVO

        vo = StereoVO(cfg)
    else:
        from visual_odometry_ros_tpu.models.mono_vo import MonoVO

        vo = MonoVO(cfg)

    os.makedirs(args.out, exist_ok=True)
    slog = StatisticsLog()
    n_done = 0
    tracer = None
    if args.trace:
        # Device-level tracing (the reference's tic/toc+gprof analog, SURVEY §5):
        # per-op device timelines viewable in xprof/tensorboard.
        import contextlib

        tracer = contextlib.ExitStack()
        tracer.enter_context(jax.profiler.trace(args.trace))
    t_start = time.perf_counter()

    def record(stats, ts, dt_ms):
        nonlocal n_done
        sm = stats.get("stage_ms") or {}
        # scale est/gt per frame (statisticsStamped scale_cur_frame / gt):
        # translation step length vs ground truth's.
        scale_est = scale_gt = 0.0
        fidx = stats.get("frame", n_done)
        if len(vo.trajectory) >= 2 and fidx >= 1:
            scale_est = float(np.linalg.norm(
                vo.trajectory[-1][:3, 3] - vo.trajectory[-2][:3, 3]
            ))
            if gt is not None and fidx < len(gt):
                scale_gt = float(np.linalg.norm(gt[fidx][:3, 3] - gt[fidx - 1][:3, 3]))
        slog.append(FrameRecord(
            frame=fidx,
            timestamp=ts,
            keyframe=bool(stats.get("keyframe")),
            steering_angle=float(stats.get("steering_angle", 0.0) or 0.0),
            scale_est=scale_est,
            scale_gt=scale_gt,
            exec=ExecStats(
                time_total=dt_ms,
                time_track=sm.get("time_track", 0.0),
                time_stereo=sm.get("time_stereo", 0.0),
                time_1p=sm.get("time_1p", 0.0),
                time_5p=sm.get("time_5p", 0.0),
                time_pose=sm.get("time_pose", 0.0),
                time_new=sm.get("time_new", 0.0),
                time_ba=sm.get("time_ba", 0.0),
            ),
            landmarks=LandmarkStats(
                n_initial=stats.get("n_initial", 0) or 0,
                n_pass_bidirection=stats.get("n_tracked", 0) or 0,
                n_pass_1p=stats.get("n_pass_1p", 0) or 0,
                n_pass_5p=stats.get("n_inliers", 0) or 0,
                n_new=stats.get("n_new", 0) or 0,
                n_final=(stats.get("n_inliers", 0) or 0) + (stats.get("n_new", 0) or 0),
                n_ok_parallax=stats.get("n_ok_parallax", 0) or 0,
                avg_parallax=float(stats.get("avg_parallax", 0.0) or 0.0),
                avg_age=float(stats.get("avg_age", 0.0) or 0.0),
            ),
        ))
        n_done += 1
        if not args.quiet and n_done % 25 == 0:
            print(f"[{n_done}] t={ts:.2f} tracks={stats.get('n_inliers')} {dt_ms:.1f}ms",
                  flush=True)

    pend_ts, pend_l, pend_r = [], [], []

    def flush_batch():
        if not pend_ts:
            return
        t0 = time.perf_counter()
        if args.mode == "stereo":
            out = vo.track_stereo_batch(np.stack(pend_l), np.stack(pend_r))
        else:
            out = vo.track_batch(np.stack(pend_l))
        dt_ms = (time.perf_counter() - t0) * 1e3 / max(len(out), 1)
        for s_, ts_ in zip(out, pend_ts):
            record(s_, ts_, dt_ms)
        pend_ts.clear(); pend_l.clear(); pend_r.clear()

    def dump_outputs():
        """Write every output artifact from whatever state exists — called on
        clean completion AND on interrupt (reference parity: the SIGINT
        handler converts the signal to an exception so the destructor still
        dumps trajectories, core/util/signal_handler_linux.cpp +
        mono_vo.cpp:64-127; an interrupted 4,000-frame run must not lose
        everything)."""
        if not vo.trajectory:
            return None
        traj = np.stack(vo.trajectory)
        save_kitti_trajectory(os.path.join(args.out, "frame_poses.txt"), traj)
        save_kitti_trajectory(
            os.path.join(args.out, "keyframe_poses.txt"),
            [T for _, T in vo.kf_trajectory],
            [i for i, _ in vo.kf_trajectory],
        )
        slog.save_jsonl(os.path.join(args.out, "stats.jsonl"))
        summary = slog.summary()
        summary["fps"] = n_done / max(time.perf_counter() - t_start, 1e-9)
        summary["device"] = device_info()
        has_gt = gt is not None and len(gt) >= len(traj)
        if has_gt:
            align = "se3" if args.mode == "stereo" else "sim3"
            summary["ate_rmse"] = ate_rmse(traj, gt[: len(traj)], align=align)
            if args.mode == "mono" and vo.kf_trajectory:
                # Mono holds identity until bootstrap; report the tracked
                # segment separately so init frames don't dominate the ATE.
                b = vo.kf_trajectory[0][0]
                if b + 2 < len(traj):
                    summary["ate_rmse_post_init"] = ate_rmse(traj[b:], gt[b : len(traj)], align=align)
        if args.plot:
            from visual_odometry_ros_tpu.io.visualize import plot_trajectory

            plot_trajectory(traj, gt[: len(traj)] if has_gt else None,
                            out_path=os.path.join(args.out, "trajectory.png"))
        return summary

    interrupted = False
    try:
        for ts, left, right in ds:
            if args.frames is not None and n_done + len(pend_ts) >= args.frames:
                break
            # Mono batching only valid once bootstrapped (phase 2).
            batch_ready = args.batch > 0 and (args.mode == "stereo" or getattr(vo, "phase", 2) == 2)
            if batch_ready:
                pend_ts.append(ts); pend_l.append(left); pend_r.append(right)
                if len(pend_ts) >= args.batch:
                    flush_batch()
                continue
            t0 = time.perf_counter()
            if args.mode == "stereo":
                T, stats = vo.track_stereo_images(left, right, ts, timed=args.stage_timing)
            else:
                T, stats = vo.track_image(left, ts, timed=args.stage_timing)
            record(stats, ts, (time.perf_counter() - t0) * 1e3)
            if args.debug_images and vo.state is not None:
                from visual_odometry_ros_tpu.io.visualize import save_image

                dbg_dir = os.path.join(args.out, "debug")
                os.makedirs(dbg_dir, exist_ok=True)
                save_image(
                    os.path.join(dbg_dir, f"{n_done - 1:06d}.png"), vo.debug_overlay(left)
                )
        flush_batch()
    except KeyboardInterrupt:
        interrupted = True
        print(f"\ninterrupted — dumping {n_done} processed frames to {args.out}",
              file=sys.stderr, flush=True)
    except BaseException:
        # Dump whatever state exists, but never let a dump failure (e.g.
        # plotting a diverged trajectory) mask the original error, and never
        # turn a crash into the misleading "no frames processed" exit
        # (r4 ADVICE low).
        if tracer is not None:
            tracer.close()
            tracer = None
        try:
            dump_outputs()
        except Exception as dump_exc:  # noqa: BLE001 — diagnostic only
            print(f"warning: output dump failed after error: {dump_exc!r}",
                  file=sys.stderr, flush=True)
        raise
    finally:
        if tracer is not None:
            tracer.close()

    summary = dump_outputs()
    if summary is None:
        raise SystemExit(
            f"no frames processed — check --root/--seq (dataset yielded 0 frames) "
            f"or --frames ({args.frames})"
        )
    print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in summary.items()})
    if interrupted:
        raise SystemExit(130)
    return summary


if __name__ == "__main__":
    main()
