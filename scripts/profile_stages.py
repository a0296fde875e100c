#!/usr/bin/env python
"""Per-stage device timing + FLOP accounting for the stereo pipeline (GPU only).

The structured successor of the reference's tic/toc instrumentation around
pipeline stages (stereo_vo.cpp:531-560 under VERBOSE_STEREO_VO), fixed per
r4 VERDICT #2/#10:

- The steady step is timed from a REAL evolved state (after a warm scan
  batch), not a frame-0 state whose track table and priors are atypical.
- The replenishment cascade (detect / coarse disparity volume / birth
  stereo match / full-res ZNCC verify / descriptors) is attributed
  separately — in r4 it was the unmeasured ~80% of the steady step.
- `scan_per_frame` is the headline: the production serving path
  (device-resident lax.scan, keyframe BA inlined) amortized per frame.
- Each compiled program's XLA cost_analysis flops are recorded, with the
  achieved FLOP/s of the scan path. The pipeline runs no model, so no
  model-FLOP utilization is reported.
- Every timing is the median of several trials, and the run names the
  device; it refuses the CPU backend.

  python scripts/profile_stages.py [--out out/profile_stages.json]
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


def timeit(fn, args, n=20, warmup=2, name="", trials=5):
    """Median over `trials` of the mean time of `n` back-to-back calls."""
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / n * 1e3)
    ms = float(np.median(ts))
    if name:
        print(f"{name:24s} {ms:9.3f} ms", flush=True)
    return ms


def flops_of(jitted, *args):
    """XLA cost_analysis flop estimate of a compiled program (None if the
    backend doesn't expose it)."""
    try:
        ca = jitted.lower(*args).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        return float(ca.get("flops", 0.0)) or None
    except Exception:
        return None


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "out", "profile_stages.json"))
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from bench import build_vo, make_frames, BATCH
    from visual_odometry_ros_tpu.device import NoGPUError, enable_compile_cache, require_gpu

    try:
        device = require_gpu()
    except NoGPUError as e:
        raise SystemExit(str(e))
    enable_compile_cache()

    vo = build_vo()
    n_total = 1 + BATCH * 2
    il, ir = make_frames(n_total)

    # Warm scan batch: compiles the production path AND evolves the state to
    # a representative steady point (full track table, non-identity dT).
    vo.track_stereo_batch(il[: 1 + BATCH], ir[: 1 + BATCH])
    jax.block_until_ready(vo.state.T_wc)
    state = vo.state
    W, H = vo.cfg.cam.width, vo.cfg.cam.height

    staged = jax.device_put((il[1 + BATCH :], ir[1 + BATCH :]))
    jax.block_until_ready(staged)

    results = {}

    # ---- headline: production scan path, per frame ----
    scan = vo._scan_steps

    def run_scan(s, a, b):
        return scan(s, a, b)

    ms_batch = timeit(run_scan, (state, staged[0], staged[1]), n=3, trials=4,
                      name="scan_batch(24f)")
    results["scan_per_frame"] = ms_batch / BATCH
    print(f"{'scan_per_frame':24s} {results['scan_per_frame']:9.3f} ms", flush=True)

    # ---- fused steady step from the evolved state ----
    im_l = staged[0][0].astype(jnp.float32)
    im_r = staged[1][0].astype(jnp.float32)
    results["steady_step_full"] = timeit(
        vo._steady_step, (state, im_l, im_r), n=10, name="steady_step_full"
    )

    # ---- stage decomposition on the same real state ----
    jt = jax.jit(vo._track_stage_impl)
    out_t = jt(state, im_l, im_r)
    pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth, scale_prior = out_t
    results["track_stage"] = timeit(jt, (state, im_l, im_r), name="track_stage")

    js = jax.jit(vo._stereo_stage_impl)
    out_s = js(pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth)
    pts_r1, ok_stereo, _ = out_s
    results["stereo_stage"] = timeit(
        js, (pyr_l, pyr_r, pts1, ok_track, has_3d, prior_depth), name="stereo_stage"
    )

    jp = jax.jit(vo._pose_stage_impl)
    out_p = jp(state, pts1, pts_r1, ok_track, ok_stereo, has_3d)
    results["pose_stage"] = timeit(
        jp, (state, pts1, pts_r1, ok_track, ok_stereo, has_3d), name="pose_stage"
    )

    ju = jax.jit(vo._update_stage_impl)
    upd_args = (state, pyr_l, pyr_r, pts1, pts_r1, ok_track, ok_stereo, scale_prior) + out_p
    results["update_stage"] = timeit(ju, upd_args, name="update_stage")

    # ---- replenishment cascade (runs on deficit/keyframe frames only) ----
    jrep = jax.jit(
        lambda pl, pr, t, a, T: vo._replenish(pl, pr, t, a, T)
    )
    rep_args = (pyr_l, pyr_r, state.tracks, state.arena, state.T_wc)
    out_r = jrep(*rep_args)
    results["replenish_total"] = timeit(jrep, rep_args, name="replenish_total")

    from visual_odometry_ros_tpu.ops import features as F
    from visual_odometry_ros_tpu.ops import stereo_disparity as SD

    cfg = vo.cfg
    jdet = jax.jit(
        lambda im, p, v: F.detect_features(
            im, p, v, gh=cfg.extractor.n_bins_v, gw=cfg.extractor.n_bins_u,
            n_max=vo.N // 2, fast_thresh=cfg.extractor.thres_fastscore,
            score_min=cfg.extractor.score_min,
        )
    )
    det_args = (pyr_l[0][0], state.tracks.pts, state.tracks.valid)
    new_pts, new_ok = jdet(*det_args)
    results["rep_detect"] = timeit(jdet, det_args, name="rep_detect")

    jcd = jax.jit(lambda pl, pr, pts: vo._coarse_disparity_prior(pl, pr, pts))
    disp_prior, prior_ok, _amb = jcd(pyr_l, pyr_r, new_pts)
    results["rep_coarse_disp"] = timeit(jcd, (pyr_l, pyr_r, new_pts), name="rep_coarse_disp")

    jsm = jax.jit(
        lambda pl, pr, pts, v, dp: vo._stereo_match(pl, pr, pts, v, disp_prior=dp)
    )
    sm_args = (pyr_l, pyr_r, new_pts, new_ok, disp_prior)
    pts_rn, ok_rn, disp_n = jsm(*sm_args)
    results["rep_stereo_match"] = timeit(jsm, sm_args, name="rep_stereo_match")

    jver = jax.jit(
        lambda a, b, p, d, v: SD.verify_disparity_zncc(a, b, p, d, v)
    )
    ver_args = (pyr_l[0][0], pyr_r[0][0], new_pts, disp_n, new_ok & ok_rn)
    out_v = jver(*ver_args)
    results["rep_zncc_verify"] = timeit(jver, ver_args, name="rep_zncc_verify")

    jdesc = jax.jit(lambda im, p: F.orb_descriptors(im, p))
    out_d = jdesc(pyr_l[0][0], new_pts)
    results["rep_descriptors"] = timeit(jdesc, (pyr_l[0][0], new_pts), name="rep_descriptors")

    # ---- keyframe + BA path ----
    state2, _ = vo._steady_step(state, im_l, im_r)
    results["keyframe_ba"] = timeit(
        lambda s: vo._keyframe_step(s), (state2,), n=5, name="keyframe_ba"
    )

    # ---- FLOPs ----
    scan_flops = flops_of(scan, state, staged[0], staged[1])
    steady_flops = flops_of(vo._steady_step, state, im_l, im_r)
    flops_per_frame = scan_flops / BATCH if scan_flops else None
    achieved = (
        flops_per_frame / (results["scan_per_frame"] * 1e-3) if flops_per_frame else None
    )

    artifact = {
        "device": device,
        "width": W,
        "height": H,
        "features": vo.N,
        "stages_ms": {k: round(v, 4) for k, v in results.items()},
        "implied_scan_fps": round(1000.0 / results["scan_per_frame"], 2),
        "flops": {
            "scan_batch": scan_flops,
            "steady_step": steady_flops,
            "per_frame": round(flops_per_frame) if flops_per_frame else None,
            "achieved_flops_per_s": round(achieved) if achieved else None,
            "note": "XLA cost_analysis estimates; VO is gather-heavy, so "
                    "its bound is memory traffic and kernel latency, not "
                    "matmul peak.",
        },
    }
    out_path = args.out
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(artifact, f, indent=1)
    print(json.dumps(artifact["stages_ms"], indent=1))
    print(f"wrote {os.path.abspath(out_path)}")
    return results


if __name__ == "__main__":
    main()
