#!/usr/bin/env python
"""End-to-end smoke test of the VO pipelines on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: precision, stereo, mono, parity
    python chip_smoke.py --four   # four GPUs: landmark-sharded BA only

One process drives the card; every phase runs and any failure ends the run
with a non-zero exit. Phases (one GPU):

  precision  an f32 [1024, 1024] matmul on the GPU matches float64 numpy to
             1e-5 relative error, i.e. the package's float32 precision pin
             reaches the card (TF32 would give ~1e-3);
  stereo     the KITTI 00 stereo configuration (config/stereo/
             kitti_00_stereo.yaml: 1241x376, 1024 features, 4 levels, 21x21
             window, 9-keyframe window, 4096-slot arena) on a synthetic
             corridor: frame 0, two 24-frame scan batches through
             StereoVO.track_stereo_batch, three frames through
             track_stereo_images; SE3-aligned ATE <= 0.5% of the path;
  mono       the KITTI 00 mono configuration on the left images of the same
             sequence (it has lateral motion): bootstrap through
             MonoVO.track_image, one 24-frame batch through track_batch;
             Sim3-aligned post-init ATE under MONO_ATE_BOUND_M;
  parity     KLT (track_with_prior_pyr, N=1024, r=10, 4 levels) and window
             BA (ba_solve_impl, 4096 landmarks, 9 keyframes) on the GPU
             against the same jnp code on the CPU backend, same inputs.

`--four` runs the landmark-sharded BA (parallel/dist_ba.py) on a 1-D mesh of
four GPUs at 4x4096 landmarks and compares it with the one-card solve.

The last line of stdout is {"ok": true, "device": {...}} as JAX reports the
device. Without a GPU the script exits non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STEREO_CFG = os.path.join(ROOT, "config", "stereo", "kitti_00_stereo.yaml")
MONO_CFG = os.path.join(ROOT, "config", "mono", "kitti_00.yaml")
BATCH = 24
N_BATCHES = 2
N_PERFRAME = 3
LANDMARKS = 4096
WINDOW = 9

# Synthetic sequence: bench.py's corridor world, made to track at full KITTI
# width (assumed settings, not the reference's): 0.2 m/frame forward with a
# lateral drift for the mono bootstrap's parallax (at 0.8 m/frame the first,
# prior-free frame's flow in the narrow corridor exceeds the KLT pyramid's
# reach), sharper texture (smooth=1) and 2x contrast about mid-grey (the raw
# render's std is ~12 grey levels, far below a real camera's).
STEP_M = 0.2
YAW_RATE = 0.0015
LATERAL_M = 0.03
CONTRAST = 2.0

# Bounds. Stereo: 0.5% of the path (metric, SE3-aligned). Mono: Sim3-aligned
# post-init ATE over the ~5 m post-init path; the CPU backend's run of this
# same sequence at full size gave 2.8 mm (H100: 1.9 mm), so 5 cm flags a real
# regression while leaving room for f32 reduction-order drift.
STEREO_ATE_FRAC = 0.005
MONO_ATE_BOUND_M = 0.05
PRECISION_RTOL = 1e-5
KLT_TOL_PX = 0.01
KLT_AGREE_FRAC = 0.99
BA_POSE_TOL = 1e-4
BA_ERR_TOL_PX = 1e-3


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, or why it is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def last_line(device: dict) -> str:
    """The final stdout line of a passing run."""
    return json.dumps(
        {"ok": True, "device": {"platform": device["platform"], "kind": device["kind"],
                                "count": device["count"]}}
    )


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Synthetic frames: rendered in CPU worker processes that never touch the GPU.
# ---------------------------------------------------------------------------

_WORLD = None  # per-worker corridor, built once by the pool initializer


def _init_render_worker(poses, world_kw):
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, ROOT)
    from visual_odometry_ros_tpu.io.synthetic import CorridorSequence

    global _WORLD
    _WORLD = CorridorSequence.fit(poses, **world_kw)


def _render_pair(T_wc):
    pair = _WORLD.stereo_pair(np.asarray(T_wc, np.float64))
    return tuple(np.clip((im - 128.0) * CONTRAST + 128.0, 0, 255).astype(np.uint8) for im in pair)


def render_sequence(cfg, n_frames: int, workers: int | None = None):
    """(poses_T_wc [n,4,4], left uint8 [n,H,W], right uint8 [n,H,W])."""
    from visual_odometry_ros_tpu.io.synthetic import forward_trajectory

    poses = forward_trajectory(n_frames, step=STEP_M, yaw_rate=YAW_RATE, lateral=LATERAL_M)
    c = cfg.cam
    world_kw = dict(
        width=c.width, height=c.height, fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy,
        baseline=float(np.linalg.norm(cfg.T_lr[:3, 3])),
        wall_tex_size=256, wall_tex_scale=40.0, smooth=1,
    )
    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 2))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers, initializer=_init_render_worker, initargs=(poses, world_kw)) as pool:
        pairs = pool.map(_render_pair, list(poses), chunksize=1)
    return poses, np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def precision_phase():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (1024, 1024)).astype(np.float32)
    b = rng.uniform(-1, 1, (1024, 1024)).astype(np.float32)
    gpu = jax.devices()[0]
    c = np.asarray(jax.jit(jnp.matmul)(jax.device_put(a, gpu), jax.device_put(b, gpu)))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.linalg.norm(c - ref) / np.linalg.norm(ref))
    log(f"precision: f32 1024^3 matmul on {gpu.device_kind}, rel err vs float64 = {rel:.3e} "
        f"(bound {PRECISION_RTOL:g}; default matmul precision "
        f"{jax.config.jax_default_matmul_precision!r})")
    assert rel <= PRECISION_RTOL, f"f32 matmul rel err {rel:.3e} > {PRECISION_RTOL:g}: TF32 in use?"


def _build(job):
    name, fn, args = job
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return name, time.perf_counter() - t0, compiled


def precompile(pool, jobs):
    """Start compiling every (name, jitted fn, args) job on `pool`, one
    thread each: XLA releases the GIL while it compiles, so independent
    programs build in parallel. The pipelines' own later calls with the same
    shapes find them in the compile cache. Each returned future gives
    (name, seconds, compiled)."""
    return [pool.submit(_build, job) for job in jobs]


def pipeline_jobs(vo_s, vo_m, ba_problem):
    """Every program the one-card phases compile, with abstract arguments."""
    import functools

    import jax
    import jax.numpy as jnp

    from visual_odometry_ros_tpu.ops import klt as KLT
    from visual_odometry_ros_tpu.ops.pyramid import build_pyramid_with_gradients

    H, W = vo_s.cfg.cam.height, vo_s.cfg.cam.width
    img = jax.ShapeDtypeStruct((H, W), jnp.float32)
    batch = jax.ShapeDtypeStruct((BATCH, H, W), jnp.uint8)
    st = jax.eval_shape(vo_s._first_frame_impl, img, img)
    sm = jax.eval_shape(vo_m._first_frame_impl, img)
    pyr = jax.eval_shape(functools.partial(build_pyramid_with_gradients, levels=vo_s.klt_params.levels), img)
    pts = jax.ShapeDtypeStruct((vo_s.N, 2), jnp.float32)
    valid = jax.ShapeDtypeStruct((vo_s.N,), jnp.bool_)
    problem, fx, fy, cx, cy, T_rl = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype) if isinstance(x, np.ndarray) else x, ba_problem
    )
    return [
        ("stereo first frame", vo_s._first_frame, (img, img)),
        ("stereo scan", vo_s._scan_steps, (st, batch, batch)),
        ("stereo steady step", vo_s._steady_step, (st, img, img)),
        ("stereo keyframe step", vo_s._keyframe_step, (st,)),
        ("mono first frame", vo_m._first_frame, (img,)),
        ("mono init track", vo_m._init_track, (sm, img)),
        ("mono bootstrap", vo_m._init_bootstrap, (sm, vo_m._key)),
        ("mono scan", vo_m._scan_steps, (sm, vo_m._key, batch)),
        ("KLT track_with_prior_pyr", KLT.track_with_prior_pyr, (pyr, pyr, pts, pts, valid, vo_s.klt_params)),
        ("BA ba_solve_impl", ba_jit(), (problem, fx, fy, cx, cy, T_rl, vo_s.ba_params)),
    ]


def stereo_phase(vo, poses, il, ir, device_name: str):
    """Run the stereo pipeline. Returns klt_case: the last per-frame step's
    real KLT problem — previous and current left image, the tracks entering
    the step, and where the pipeline put them, offset by (+1.0, -0.6) px as
    a prior one GN climb away from the answer."""
    import jax

    from visual_odometry_ros_tpu.io.trajectory import ate_rmse

    t0 = time.perf_counter()
    vo.track_stereo_images(il[0], ir[0])
    jax.block_until_ready(vo.state.T_wc)
    log(f"stereo: frame 0 {time.perf_counter() - t0:.2f} s")

    batch_s = []
    for b in range(N_BATCHES):
        s = 1 + b * BATCH
        cur = jax.device_put((il[s : s + BATCH], ir[s : s + BATCH]))
        jax.block_until_ready(cur)
        t0 = time.perf_counter()
        vo.track_stereo_batch(*cur)
        jax.block_until_ready(vo.state.T_wc)
        batch_s.append(time.perf_counter() - t0)
        log(f"stereo: scan batch {b} ({BATCH} frames) {batch_s[-1]:.3f} s")
    log(f"stereo: steady scan {batch_s[-1] / BATCH * 1e3:.3f} ms/frame on {device_name} "
        f"(information only; one batch, uploads staged)")

    s = 1 + N_BATCHES * BATCH
    for i in range(s, s + N_PERFRAME):
        before = jax.device_get(vo.state.tracks)
        t0 = time.perf_counter()
        vo.track_stereo_images(il[i], ir[i])
        log(f"stereo: per-frame track_stereo_images frame {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    after = jax.device_get(vo.state.tracks)
    same = before.valid & after.valid & (before.lm_idx == after.lm_idx)
    klt_case = (il[i - 1].astype(np.float32), il[i].astype(np.float32), before.pts,
                np.where(same[:, None], after.pts + np.float32([1.0, -0.6]), before.pts), same)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"stereo: peak_bytes_in_use = {stats.get('peak_bytes_in_use')}")

    traj = np.stack(vo.trajectory)
    gt = poses[: len(traj)]
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    ate = float(ate_rmse(traj, gt, align="se3"))
    n_kf = len(vo.kf_trajectory)
    n_ba_ok = sum(1 for st in vo.stats_log if st.get("ba_err") is not None and not st.get("ba_rejected"))
    n_fail = sum(1 for st in vo.stats_log if st.get("pose_ok") is False)
    log(f"stereo: {len(traj)} frames, path {path:.2f} m, ATE(se3) {ate:.4f} m = "
        f"{100 * ate / path:.3f}% of path (bound {100 * STEREO_ATE_FRAC:.2f}%), "
        f"keyframes {n_kf}, accepted BAs {n_ba_ok}, pose failures {n_fail}")
    assert np.isfinite(traj).all(), "stereo: non-finite pose"
    assert n_kf >= 2, f"stereo: only {n_kf} keyframes"
    assert n_ba_ok >= 1, "stereo: no accepted BA"
    assert ate <= STEREO_ATE_FRAC * path, f"stereo: ATE {ate:.4f} m > {STEREO_ATE_FRAC:.3%} of {path:.2f} m"
    return klt_case


def mono_phase(vo, poses, imgs, max_bootstrap: int = 16):
    """Bootstrap MonoVO per frame, then one scan batch; returns post-init ATE."""
    import jax

    from visual_odometry_ros_tpu.io.trajectory import ate_rmse

    i = 0
    t0 = time.perf_counter()
    while vo.phase != 2:
        assert i < max_bootstrap, f"mono: not bootstrapped after {max_bootstrap} frames"
        vo.track_image(imgs[i])
        i += 1
    log(f"mono: bootstrapped after {i} frames ({time.perf_counter() - t0:.2f} s)")
    assert i + BATCH <= len(imgs), "mono: sequence too short for one batch"
    t0 = time.perf_counter()
    vo.track_batch(imgs[i : i + BATCH])
    jax.block_until_ready(vo.state.T_wc)
    log(f"mono: scan batch ({BATCH} frames) {time.perf_counter() - t0:.3f} s")

    traj = np.stack(vo.trajectory)
    b = vo.kf_trajectory[0][0]
    gt = poses[b : len(traj)]
    path = float(np.sum(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=-1)))
    ate = float(ate_rmse(traj[b:], gt, align="sim3"))
    n_fail = sum(1 for st in vo.stats_log if st.get("pose_ok") is False)
    log(f"mono: {len(traj)} frames, post-init path {path:.2f} m, ATE(sim3) {ate:.4f} m "
        f"(bound {MONO_ATE_BOUND_M} m), keyframes {len(vo.kf_trajectory)}, pose failures {n_fail}")
    assert np.isfinite(traj).all(), "mono: non-finite pose"
    assert ate < MONO_ATE_BOUND_M, f"mono: ATE {ate:.4f} m >= {MONO_ATE_BOUND_M} m"
    return ate


def klt_parity(klt_params, img0, img1, pts, prior, valid):
    """Fraction of both-side-live features whose GPU and CPU tracks agree."""
    import jax

    from visual_odometry_ros_tpu.ops import klt as KLT
    from visual_odometry_ros_tpu.ops.pyramid import build_pyramid_with_gradients

    cpu = jax.devices("cpu")[0]
    build = jax.jit(build_pyramid_with_gradients, static_argnums=1)
    pyr0 = jax.device_get(build(jax.device_put(img0, cpu), klt_params.levels))
    pyr1 = jax.device_get(build(jax.device_put(img1, cpu), klt_params.levels))
    args = (pyr0, pyr1, pts, prior, valid)
    out = {}
    for name, dev in (("gpu", jax.devices()[0]), ("cpu", cpu)):
        p1, ok = KLT.track_with_prior_pyr(*jax.device_put(args, dev), klt_params)
        out[name] = jax.device_get((p1, ok))
    (pg, okg), (pc, okc) = out["gpu"], out["cpu"]
    both = okg & okc
    d = np.linalg.norm(pg - pc, axis=-1)[both]
    frac = float(np.mean(d <= KLT_TOL_PX)) if both.any() else 0.0
    log(f"parity KLT: N={len(pts)} r={klt_params.window_radius} levels={klt_params.levels}: "
        f"live gpu {int(okg.sum())} cpu {int(okc.sum())} both {int(both.sum())}; "
        f"{100 * frac:.2f}% within {KLT_TOL_PX} px (bound {100 * KLT_AGREE_FRAC:.0f}%), "
        f"max |d| {float(d.max()) if d.size else float('nan'):.2e} px")
    assert both.sum() >= 0.5 * valid.sum(), "KLT parity: fewer than half the features live"
    assert frac >= KLT_AGREE_FRAC, f"KLT parity: {frac:.4f} < {KLT_AGREE_FRAC}"


def ba_jit():
    import jax

    from visual_odometry_ros_tpu.ops import ba as BA

    return jax.jit(BA.ba_solve_impl, static_argnums=6)


def ba_reference(problem, intr, T_rl, params, device):
    """One-card ba_solve_impl on `device` (the plain single-device solver)."""
    import jax

    args = jax.device_put((problem, *intr, T_rl), device)
    return jax.device_get(ba_jit()(*args, params))


def compare_ba(tag, res, ref):
    dpose = float(np.max(np.abs(np.asarray(res.T_cw) - np.asarray(ref.T_cw))))
    derr = abs(float(res.mean_err_px) - float(ref.mean_err_px))
    log(f"parity BA {tag}: max |dT_cw| {dpose:.2e} (bound {BA_POSE_TOL:g}), "
        f"|d mean_err| {derr:.2e} px (bound {BA_ERR_TOL_PX:g}); mean_err "
        f"{float(res.mean_err_px):.4f} px vs {float(ref.mean_err_px):.4f} px, n_obs {int(res.n_obs)}")
    assert np.isfinite(np.asarray(res.T_cw)).all(), f"BA {tag}: non-finite poses"
    assert dpose <= BA_POSE_TOL, f"BA {tag}: poses differ by {dpose:.2e}"
    assert derr <= BA_ERR_TOL_PX, f"BA {tag}: mean_err differs by {derr:.2e} px"


def ba_parity(params, ba_problem):
    import jax

    problem, fx, fy, cx, cy, T_rl = ba_problem
    intr = (fx, fy, cx, cy)
    res = ba_reference(problem, intr, T_rl, params, jax.devices()[0])
    ref = ba_reference(problem, intr, T_rl, params, jax.devices("cpu")[0])
    compare_ba(f"gpu vs cpu (M={LANDMARKS}, K={WINDOW})", res, ref)


def four_card_phase(params):
    import jax
    from jax.sharding import Mesh

    from __graft_entry__ import make_ba_problem
    from visual_odometry_ros_tpu.parallel import dist_ba

    gpus = jax.devices()
    assert len(gpus) == 4, f"--four needs 4 GPUs, JAX sees {len(gpus)}"
    M = 4 * LANDMARKS
    problem, fx, fy, cx, cy, T_rl = make_ba_problem(M, WINDOW)
    intr = (fx, fy, cx, cy)
    mesh = Mesh(np.asarray(gpus), ("lm",))  # all-to-all NVLink: a plain list
    solve = dist_ba.make_distributed_ba(mesh, params)
    t0 = time.perf_counter()
    res = jax.device_get(solve(problem, *intr, T_rl))
    log(f"four: sharded BA over {len(gpus)} x {gpus[0].device_kind} compiled + ran in "
        f"{time.perf_counter() - t0:.2f} s")
    ref = ba_reference(problem, intr, T_rl, params, gpus[0])
    compare_ba(f"4-card sharded vs 1-card (M={M}, K={WINDOW})", res, ref)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the landmark-sharded BA on four GPUs against one card")
    args = ap.parse_args(argv)

    log(f"card: {card_line()}")
    import jax

    jax.config.update("jax_platforms", "cuda,cpu")
    sys.path.insert(0, ROOT)
    from visual_odometry_ros_tpu.device import NoGPUError, enable_compile_cache, require_gpu
    from visual_odometry_ros_tpu.ops import ba as BA

    try:
        device = require_gpu()
    except NoGPUError as e:
        raise SystemExit(str(e))
    log(f"jax {jax.__version__}: {device['count']} x {device['kind']} ({device['platform']}); "
        f"compile cache {enable_compile_cache()}")
    t_start = time.perf_counter()

    if args.four:
        four_card_phase(BA.BAParams())
    else:
        from __graft_entry__ import make_ba_problem
        from visual_odometry_ros_tpu.config import load_yaml
        from visual_odometry_ros_tpu.models.mono_vo import MonoVO
        from visual_odometry_ros_tpu.models.stereo_vo import StereoVO

        precision_phase()
        cfg_s = load_yaml(STEREO_CFG, stereo=True)
        cfg_s.map.landmark_capacity = LANDMARKS
        cfg_m = load_yaml(MONO_CFG, stereo=False)
        cfg_m.map.landmark_capacity = LANDMARKS
        vo_s, vo_m = StereoVO(cfg_s), MonoVO(cfg_m)
        ba_problem = make_ba_problem(LANDMARKS, WINDOW)

        jobs = pipeline_jobs(vo_s, vo_m, ba_problem)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            builds = precompile(pool, jobs)
            n_frames = 1 + N_BATCHES * BATCH + N_PERFRAME
            poses, il, ir = render_sequence(cfg_s, n_frames)
            log(f"rendered {n_frames} stereo pairs {il.shape[1:]} in {time.perf_counter() - t0:.1f} s")
            for build in builds:
                name, seconds, compiled = build.result()
                log(f"compiled {name} in {seconds:.1f} s")
                if name == "stereo scan":
                    log(f"stereo: scan step memory_analysis: {compiled.memory_analysis()}")
        log(f"all programs compiled {time.perf_counter() - t0:.1f} s after the start of rendering")

        klt_case = stereo_phase(vo_s, poses, il, ir, device["kind"])
        mono_phase(vo_m, poses, il)
        klt_parity(vo_s.klt_params, *klt_case)
        ba_parity(vo_s.ba_params, ba_problem)

    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(last_line(device), flush=True)


if __name__ == "__main__":
    main()
