#!/usr/bin/env python
"""Multi-device BA scaling benchmark: BA iterations/s at 1..N devices.

The BASELINE north star asks for frames/s and BA iters/s at 1 chip / 1 host /
N hosts with >=70% scaling efficiency. This harness measures the
landmark-sharded distributed Schur BA (parallel/dist_ba.py) at a sweep of
mesh sizes and prints one JSON line per mesh plus a final efficiency line.

It runs on whatever devices JAX finds: GPUs, or virtual CPU devices (the
mesh/collective code path is the same; absolute numbers mean something only
on real cards). Weak scaling by default: landmarks per device held constant.

  python scripts/bench_scaling.py [--devices 1 2 4 8] [--lm-per-dev 4096]
  python scripts/bench_scaling.py --strong --landmarks 32768

Multi-process mode is a multi-host stand-in on virtual CPU devices only:
N processes x D virtual devices each, one global mesh through
jax.distributed over gRPC loopback. Several processes per card would fail
for device memory, so it refuses any other platform:

  python scripts/bench_scaling.py --multiprocess 2 --local-devices 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_problem_np(M: int, K: int, seed: int = 0):
    """Deterministic synthetic BA problem as host numpy (no device placement).

    Every process of a multi-host job rebuilds the identical problem from the
    seed; placement then only donates local shards (parallel/multihost.py)."""
    import jax.numpy as jnp

    from visual_odometry_ros_tpu.ops import ba as BA
    from visual_odometry_ros_tpu.utils import geometry as geo

    rng = np.random.default_rng(seed)
    FX = FY = 718.0
    CX, CY = 607.0, 185.0
    T_cw = []
    for k in range(K):
        xi = np.array([0.01 * k, 0.0, -0.8 * k, 0.0, 0.002 * k, 0.0], np.float32)
        T_cw.append(np.asarray(geo.se3_inverse(geo.se3_exp(jnp.asarray(xi)))))
    T_cw = np.stack(T_cw)
    Xw = np.stack(
        [rng.uniform(-15, 15, M), rng.uniform(-3, 3, M), rng.uniform(5, 60, M)], -1
    ).astype(np.float32)
    pts = np.zeros((M, K, 2), np.float32)
    mask = np.zeros((M, K), bool)
    for k in range(K):
        Xc = Xw @ T_cw[k, :3, :3].T + T_cw[k, :3, 3]
        z = np.maximum(Xc[:, 2], 1e-3)
        uv = np.stack([Xc[:, 0] / z * FX + CX, Xc[:, 1] / z * FY + CY], -1)
        pts[:, k] = uv + rng.normal(0, 0.3, (M, 2))
        mask[:, k] = (Xc[:, 2] > 1.0) & (np.abs(uv[:, 0] - CX) < 700) & (np.abs(uv[:, 1] - CY) < 250)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.537
    problem = BA.BAProblem(
        T_cw=jnp.asarray(T_cw),
        Xw=jnp.asarray(Xw),
        pts=jnp.asarray(pts),
        mask=jnp.asarray(mask),
        pts_r=jnp.asarray(pts),
        mask_r=jnp.asarray(mask),
        kf_valid=jnp.ones((K,), bool),
        lm_valid=jnp.ones((M,), bool),
    )
    return problem, FX, FY, CX, CY, jnp.asarray(T_rl)


def run_worker(args):
    """One process of a --multiprocess job (also spawned by
    tests/test_multihost.py). Initializes jax.distributed, joins the global
    mesh, and runs the landmark-sharded BA on its shard of the problem."""
    from visual_odometry_ros_tpu.parallel import multihost as MH

    jax = MH.init_worker(
        args.coordinator, args.num_procs, args.worker_id, args.local_devices
    )
    from visual_odometry_ros_tpu.ops import ba as BA
    from visual_odometry_ros_tpu.parallel import dist_ba

    n_dev = len(jax.devices())
    M_total = args.landmarks or args.lm_per_dev * n_dev
    M_total = (M_total + n_dev - 1) // n_dev * n_dev
    problem, FX, FY, CX, CY, T_rl = build_problem_np(M_total, args.window)
    mesh = MH.global_mesh()
    prob_spec, _, _ = dist_ba._sharded_specs()
    gproblem = MH.host_tree(problem, mesh, prob_spec)
    solve = dist_ba.make_distributed_ba(mesh, BA.BAParams(iters=args.iters))
    res = solve(gproblem, FX, FY, CX, CY, T_rl)  # compile + warm
    jax.block_until_ready(res.T_cw)
    t0 = time.perf_counter()
    for _ in range(args.reps):
        res = solve(gproblem, FX, FY, CX, CY, T_rl)
    jax.block_until_ready(res.T_cw)
    dt = time.perf_counter() - t0
    if args.worker_id == 0:
        rec = {
            "metric": "ba_iters_per_s_multiprocess",
            "processes": args.num_procs,
            "devices": n_dev,
            "landmarks": M_total,
            "window": args.window,
            "value": round(args.reps * args.iters / dt, 2),
            "unit": "GN iters/s",
            "ms_per_solve": round(dt / args.reps * 1e3, 2),
            "mean_err_px": round(float(res.mean_err_px), 4),
        }
        print(json.dumps(rec), flush=True)
        if args.out:
            # T_cw / mean_err are replicated -> addressable on every process.
            np.savez(
                args.out,
                T_cw=np.asarray(res.T_cw),
                mean_err_px=np.asarray(res.mean_err_px),
                landmarks=M_total,
                window=args.window,
                iters=args.iters,
            )


def spawn_multiprocess(args):
    """Driver: launch N worker processes over gRPC loopback and wait."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    procs = []
    for wid in range(args.multiprocess):
        cmd = [
            sys.executable,
            os.path.abspath(__file__),
            "--worker-id", str(wid),
            "--num-procs", str(args.multiprocess),
            "--coordinator", f"localhost:{port}",
            "--local-devices", str(args.local_devices),
            "--lm-per-dev", str(args.lm_per_dev),
            "--window", str(args.window),
            "--iters", str(args.iters),
            "--reps", str(args.reps),
        ]
        if args.landmarks:
            cmd += ["--landmarks", str(args.landmarks)]
        if args.out and wid == 0:
            cmd += ["--out", args.out]
        procs.append(
            subprocess.Popen(
                cmd, env=env, stdout=None if wid == 0 else subprocess.DEVNULL
            )
        )
    rcs = [p.wait(timeout=900) for p in procs]
    if any(rcs):
        raise SystemExit(f"multiprocess workers failed: rcs={rcs}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--lm-per-dev", type=int, default=4096)
    p.add_argument("--landmarks", type=int, default=None, help="total landmarks (strong scaling)")
    p.add_argument("--strong", action="store_true")
    p.add_argument("--window", type=int, default=9)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--platform", default=None)
    p.add_argument("--multiprocess", type=int, default=None, metavar="N",
                   help="spawn N processes over a jax.distributed global mesh")
    p.add_argument("--local-devices", type=int, default=4,
                   help="virtual devices per process in --multiprocess mode")
    p.add_argument("--out", default=None, help="npz dump of the proc-0 result")
    p.add_argument("--json-out", default=None, help="append result records to this JSON file")
    p.add_argument("--worker-id", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--num-procs", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    if args.worker_id is not None:
        run_worker(args)
        return
    if args.multiprocess:
        if (args.platform or os.environ.get("JAX_PLATFORMS") or "cpu") != "cpu":
            raise SystemExit(
                "--multiprocess runs virtual CPU devices only (one JAX process "
                "per card is the limit on a GPU); unset --platform/JAX_PLATFORMS"
            )
        spawn_multiprocess(args)
        return

    max_dev = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max_dev}"
        ).strip()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from jax.sharding import Mesh

    from visual_odometry_ros_tpu.device import enable_compile_cache

    enable_compile_cache()

    from visual_odometry_ros_tpu.ops import ba as BA
    from visual_odometry_ros_tpu.parallel import dist_ba

    have = len(jax.devices())
    sizes = [d for d in args.devices if d <= have]
    if sizes != args.devices:
        print(f"# only {have} devices available; running {sizes}", file=sys.stderr)

    # Per-iteration interconnect payload of the landmark-sharded solver
    # (r4 VERDICT #9): exactly one psum of the reduced camera system per GN
    # iteration — S [6K, 6K] f32 + s [6K] f32 — plus three scalar guards and
    # the two mean-err reductions per solve. Everything else stays
    # shard-local (assembly, Cinv, back-substitution).
    K6 = 6 * args.window
    payload_iter = K6 * K6 * 4 + K6 * 4 + 3 * 4
    payload_solve = args.iters * payload_iter + 2 * 8

    results = []
    for nd in sizes:
        if args.strong:
            M_total = args.landmarks or (args.lm_per_dev * max(sizes))
        else:
            M_total = args.lm_per_dev * nd
        M_total = (M_total + nd - 1) // nd * nd
        problem, FX, FY, CX, CY, T_rl = build_problem_np(M_total, args.window)
        mesh = Mesh(np.asarray(jax.devices()[:nd]), ("lm",))
        solve = dist_ba.make_distributed_ba(mesh, BA.BAParams(iters=args.iters))
        res = solve(problem, FX, FY, CX, CY, T_rl)  # compile + warm
        jax.block_until_ready(res)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            res = solve(problem, FX, FY, CX, CY, T_rl)
        jax.block_until_ready(res)
        dt = time.perf_counter() - t0
        iters_per_s = args.reps * args.iters / dt

        # Assembly/solve split (r4 VERDICT #9): time the shard-local half
        # (observation terms + normal blocks + Schur elimination — no
        # collective) in isolation; the remainder of a full iteration is the
        # psum + replicated 6Kx6K solve + back-substitution.
        from visual_odometry_ros_tpu.ops import ba as _ba

        def _assembly_only(prob, fx, fy, cx, cy, trl):
            T_cr = prob.T_cw  # window-anchored enough for cost purposes
            w, r, Q, Rj = _ba.build_observation_terms(
                T_cr, prob.Xw, prob.pts, prob.mask, prob.pts_r, prob.mask_r,
                fx, fy, cx, cy, trl, 1.0,
            )
            A, a, C, b, B = _ba.assemble_normal_blocks(w, r, Q, Rj)
            S_loc, s_loc, Cinv, _ = _ba.schur_reduce(A, a, C, b, B, 1e-4)
            return S_loc, s_loc, Cinv
        asm = jax.jit(_assembly_only)
        out = asm(problem, FX, FY, CX, CY, T_rl)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = asm(problem, FX, FY, CX, CY, T_rl)
        jax.block_until_ready(out)
        asm_ms = (time.perf_counter() - t0) / args.reps * 1e3
        iter_ms = dt / args.reps / args.iters * 1e3

        rec = {
            "metric": "ba_iters_per_s",
            "devices": nd,
            "landmarks": M_total,
            "window": args.window,
            "value": round(iters_per_s, 2),
            "unit": "GN iters/s",
            "ms_per_solve": round(dt / args.reps * 1e3, 2),
            "assembly_ms_per_iter": round(asm_ms, 3),
            "collective_and_solve_ms_per_iter": round(max(iter_ms - asm_ms, 0.0), 3),
            "psum_payload_bytes_per_iter": payload_iter,
            "psum_payload_bytes_per_solve": payload_solve,
            "mean_err_px": round(float(res.mean_err_px), 4),
        }
        results.append(rec)
        print(json.dumps(rec))

    if len(results) >= 2:
        base = results[0]
        last = results[-1]
        # On forced-host virtual devices the N "devices" time-share the same
        # physical cores, so the ideal is NOT N-fold: total compute is fixed.
        # There, strong scaling has a FLAT ideal (iters/s constant as the same
        # problem is sharded over more virtual devices) and the ratio directly
        # measures collective + partition overhead — the only thing a virtual
        # mesh *can* measure. On real chips each device adds compute and the
        # usual ideals apply.
        host_limited = (
            jax.devices()[0].platform == "cpu"
            and "xla_force_host_platform_device_count"
            in os.environ.get("XLA_FLAGS", "")
        )
        dev_ratio = last["devices"] / base["devices"]
        raw_ratio = last["value"] / base["value"]
        if args.strong:
            eff = raw_ratio if host_limited else raw_ratio / dev_ratio
        else:
            # weak: per-device load constant. Real chips: ideal iters/s flat.
            # Host-limited: total work grows xN on fixed cores, ideal 1/N.
            eff = raw_ratio * (dev_ratio if host_limited else 1.0)
        # The host-limited "ideal" assumes the base run saturates the cores;
        # if it doesn't, extra virtual devices add real parallelism and the
        # rescaled figure flatters. Cap at 1.0 and always report the raw
        # iters/s ratio alongside (r2 ADVICE medium).
        eff_rec = {
            "metric": "scaling_efficiency",
            "mode": "strong" if args.strong else "weak",
            "host_limited_ideal": host_limited,
            "devices": last["devices"],
            "value": round(min(eff, 1.0), 3),
            "raw_iters_ratio": round(raw_ratio, 3),
            "unit": "fraction",
        }
        results.append(eff_rec)
        print(json.dumps(eff_rec))
    if args.json_out:
        existing = []
        if os.path.exists(args.json_out):
            with open(args.json_out) as f:
                existing = json.load(f)
        with open(args.json_out, "w") as f:
            json.dump(existing + results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
