#!/usr/bin/env python
"""Accuracy procedure (BASELINE.md): run mono + stereo VO on long adversarial
synthetic sequences, record ATE RMSE / RPE, and hold the GPU run to <= the
CPU run's ATE (same jnp program, two backends).

No KITTI/EuRoC data exists in this environment, so the sequences are made
hard instead (BASELINE.md procedure as amended by round-1 VERDICT #4):
200+ frames, exposure drift, a moving occluder, repeated texture, varying
speed with S-curves (io/synthetic.py HardSequence / varied_trajectory).

The CPU run is the reimplementation of the reference algorithms with
reference thresholds that BASELINE.md designates as the accuracy baseline.
The GPU run executes the same program on the card. Both must land under the
drift bounds, and GPU ATE must not exceed CPU ATE materially.

Usage:
  python scripts/eval_accuracy.py --platform cpu            # baseline leg
  python scripts/eval_accuracy.py --platform cuda           # GPU leg
  python scripts/eval_accuracy.py --render-only             # just write md

Each leg is keyed by its platform (cpu, gpu) in ACCURACY.json; ACCURACY.md is
regenerated after each run. Rendered frames are cached under out/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JSON_PATH = os.path.join(ROOT, "ACCURACY.json")
MD_PATH = os.path.join(ROOT, "ACCURACY.md")


def build_stereo():
    from visual_odometry_ros_tpu.config import VOConfig
    from visual_odometry_ros_tpu.models.stereo_vo import StereoVO

    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.cam_right = cfg.cam
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = 0.5
    cfg.T_lr = T_lr
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.2
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    return StereoVO(cfg)


def build_mono():
    from visual_odometry_ros_tpu.config import VOConfig
    from visual_odometry_ros_tpu.models.mono_vo import MonoVO

    cfg = VOConfig()
    cfg.cam.fx = cfg.cam.fy = 500.0
    cfg.cam.cx, cfg.cam.cy = 320.0, 240.0
    cfg.cam.width, cfg.cam.height = 640, 480
    cfg.flagDoUndistortion = False
    cfg.extractor.n_features = 512
    cfg.extractor.n_bins_u = 16
    cfg.extractor.n_bins_v = 10
    cfg.map.landmark_capacity = 4096
    cfg.keyframe.n_max_keyframes_in_window = 7
    cfg.keyframe.thres_translation = 1.2
    cfg.tracker.max_level = 3
    cfg.tracker.max_iter = 15
    return MonoVO(cfg)


CHUNK = 25  # frames per device-resident scan batch


def run_stereo(frames):
    """Chunked batch-scan stereo run (r2 weak #4: the per-frame path paid a
    jit dispatch per frame — 194 s for 200 frames; the scan path is one
    device call per CHUNK frames)."""
    vo = build_stereo()
    il = np.stack([l for l, _ in frames])
    ir = np.stack([r for _, r in frames])
    t0 = time.perf_counter()
    for s in range(0, len(frames), CHUNK):
        vo.track_stereo_batch(il[s : s + CHUNK], ir[s : s + CHUNK])
    wall = time.perf_counter() - t0
    return np.stack(vo.trajectory), wall, vo.stats_log


def run_mono(imgs):
    """Per-frame until bootstrapped (phase 2), then chunked batch scan."""
    vo = build_mono()
    t0 = time.perf_counter()
    first_steady = None
    i = 0
    while i < len(imgs) and vo.phase != 2:
        _, stats = vo.track_image(imgs[i])
        if first_steady is None and stats.get("phase") in ("bootstrapped", "steady"):
            first_steady = i
        i += 1
    while i < len(imgs):
        vo.track_batch(np.stack(imgs[i : i + CHUNK]))
        i += CHUNK
    wall = time.perf_counter() - t0
    return np.stack(vo.trajectory), wall, first_steady or 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--platform", default=None)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--render-only", action="store_true")
    args = p.parse_args(argv)
    if args.render_only:
        render_md()
        return

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from visual_odometry_ros_tpu.device import device_info, enable_compile_cache

    enable_compile_cache()
    device = device_info()
    plat = device["platform"]

    from visual_odometry_ros_tpu.io.synthetic import HardSequence, varied_trajectory
    from visual_odometry_ros_tpu.io.trajectory import ate_rmse, rpe

    poses_gt = varied_trajectory(args.frames, step=0.3)
    dist = float(
        np.sum(np.linalg.norm(np.diff(poses_gt[:, :3, 3], axis=0), axis=-1))
    )

    # Corridor sized around the trajectory: the world is valid for every pose
    # (render raises ChiralityError otherwise — VERDICT r2 missing #1a).
    world = HardSequence(poses_T_wc=poses_gt, baseline=0.5)
    # Rendering takes many minutes of host CPU per run; the sequence is a
    # pure function of --frames, so cache it across legs (cpu/gpu consume
    # identical pixels — that identity is what makes the A/B valid).
    os.makedirs(os.path.join(ROOT, "out"), exist_ok=True)
    cache = os.path.join(ROOT, "out", f"vo_eval_frames_{args.frames}.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        frames = list(zip(z["il"], z["ir"]))
        print(f"[{plat}] loaded {args.frames} cached frames from {cache}", flush=True)
    else:
        print(f"[{plat}] rendering {args.frames} adversarial stereo frames ...", flush=True)
        frames = [world.stereo_pair(T.astype(np.float64), frame=i) for i, T in enumerate(poses_gt)]
        np.savez_compressed(cache, il=np.stack([l for l, _ in frames]),
                            ir=np.stack([r for _, r in frames]))

    print(f"[{plat}] stereo run ...", flush=True)
    traj_s, wall_s, slog = run_stereo(frames)
    n_fail = sum(1 for s in slog if s.get("pose_ok") is False)
    n_rec = sum(1 for s in slog if s.get("recovered", 0) > 0)
    ate_s = float(ate_rmse(traj_s, poses_gt, align="none"))
    t_rmse_s, r_rmse_s = rpe(traj_s, poses_gt)

    print(f"[{plat}] mono run ...", flush=True)
    imgs_l = [l for l, _ in frames]
    traj_m, wall_m, _ = run_mono(imgs_l)
    # Mono is up-to-scale: Umeyama sim3 alignment.
    ate_m = float(ate_rmse(traj_m, poses_gt, align="sim3"))

    rec = {
        "device": device,
        "frames": args.frames,
        "distance_m": round(dist, 2),
        "stereo": {
            "ate_rmse_m": round(ate_s, 4),
            "ate_pct_of_dist": round(100.0 * ate_s / dist, 3),
            "rpe_trans_m": round(float(t_rmse_s), 4),
            "rpe_rot_deg": round(float(r_rmse_s), 4),
            "n_pose_fail": n_fail,
            "n_recoveries": n_rec,
            "wall_s": round(wall_s, 1),
        },
        "mono": {
            "ate_rmse_sim3_m": round(ate_m, 4),
            "ate_pct_of_dist": round(100.0 * ate_m / dist, 3),
            "wall_s": round(wall_m, 1),
        },
    }

    def _de_nan(obj):
        """NaN/Inf -> None so failed metrics are explicit nulls, never NaN
        literals that break strict JSON (r2 ADVICE high)."""
        if isinstance(obj, dict):
            return {k: _de_nan(v) for k, v in obj.items()}
        if isinstance(obj, float) and not np.isfinite(obj):
            return None
        return obj

    rec = _de_nan(rec)
    print(json.dumps(rec, indent=1, allow_nan=False))

    records = {}
    if os.path.exists(JSON_PATH):
        with open(JSON_PATH) as f:
            records = json.load(f)
    records[plat] = rec
    with open(JSON_PATH, "w") as f:
        json.dump(records, f, indent=1, allow_nan=False)
    render_md()


def render_md():
    if not os.path.exists(JSON_PATH):
        print("no ACCURACY.json yet")
        return
    with open(JSON_PATH) as f:
        records = json.load(f)
    lines = [
        "# ACCURACY — synthetic adversarial sequences (BASELINE.md procedure)",
        "",
        "No KITTI/EuRoC data exists in this environment (zero egress); per the",
        "BASELINE.md amendment in round-1 VERDICT #4 the sequences are made hard",
        "instead: 200 frames, exposure drift (±15% gain, ±8 bias), a moving",
        "occluder (12% of width, independent motion), repeated texture (256-px",
        "tile), varying speed with S-curves. Generator:",
        "`visual_odometry_ros_tpu/io/synthetic.py` (`HardSequence`,",
        "`varied_trajectory`); harness: `scripts/eval_accuracy.py`.",
        "",
        "The **cpu** row is the faithful reference-algorithm reimplementation",
        "(reference thresholds) — the accuracy baseline the GPU run is held to.",
        "The **gpu** row runs the same program on the card named in its row.",
        "",
        "| platform | device | frames | dist (m) | stereo ATE (m) | stereo ATE %dist | stereo RPE t (m) | stereo RPE r (deg) | mono ATE sim3 (m) | mono ATE %dist |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    def fmt(v, pct=False):
        # Absent/diverged metrics render as n/a, never literal "None"
        # (r3 ADVICE low).
        if v is None:
            return "n/a"
        return f"{v}%" if pct else f"{v}"

    for plat, rec in sorted(records.items()):
        s, m = rec["stereo"], rec["mono"]
        lines.append(
            f"| {plat} | {rec['device']['kind']} | {rec['frames']} "
            f"| {rec['distance_m']} | {fmt(s['ate_rmse_m'])} | {fmt(s['ate_pct_of_dist'], True)} "
            f"| {fmt(s['rpe_trans_m'])} | {fmt(s['rpe_rot_deg'])} | {fmt(m['ate_rmse_sim3_m'])} | {fmt(m['ate_pct_of_dist'], True)} |"
        )
    if "cpu" in records and "gpu" in records:
        t = records["gpu"]["stereo"]["ate_rmse_m"]
        c = records["cpu"]["stereo"]["ate_rmse_m"]
        if t is None or c is None:
            verdict = "FAIL (a leg diverged: ATE is null)"
        elif t <= c * 1.2 + 0.01:
            verdict = "PASS (<= CPU x1.2 + 1cm)"
        else:
            verdict = "FAIL"
        lines += [
            "",
            f"**GPU-vs-CPU ATE check:** stereo GPU {t} m vs CPU {c} m -> {verdict}",
        ]
    lines.append("")
    with open(MD_PATH, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {MD_PATH}")


if __name__ == "__main__":
    main()
