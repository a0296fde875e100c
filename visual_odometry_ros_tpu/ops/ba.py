"""Sliding-window sparse bundle adjustment — Schur complement, batched.

Capability parity with the reference BA stack
(core/visual_odometry/ba_solver/):
  - `SparseBAParameters` (sparse_ba_parameters.h): window landmark collection,
    re-anchoring of all poses to the first window keyframe + pose/point scaling
    for numerical stability (:204-262), fixed vs optimizable pose split.
  - `SparseBundleAdjustmentSolver` (sparse_bundle_adjustment.{h,cpp}): per-
    observation residual/Huber/point-Jacobian Rij (2x3)/pose-Jacobian Qij (2x6)
    accumulation (:197-427), multiplicative lambda damping (:430-453), reduced
    camera system (A - B Cinv Bt) x = a - B Cinv b solved densely (:455-536),
    landmark back-substitution y = Cinv (b - Bt x) (:538-558), pose update via
    log/add-front/exp (:583-596), landmark kill at ||X|| > 3000 (:708-717),
    divergence guard on large translation updates (:652-654).
  - right-image observation rows via R_rl (:206-320) for the stereo solver.

Batched design: observations live in a dense [M, K] incidence (pixels +
mask) instead of per-landmark vectors; all per-(landmark, keyframe)
accumulations are fused einsums; the reduced 6K x 6K system is assembled once
per iteration and solved by Cholesky. Landmark back-substitution is one
batched 3x3 solve. The landmark axis shards cleanly (parallel/dist_ba.py
psums A, a, S, sb across hosts — SURVEY.md §7).

Precision: assembly in f32 with the reference's anchor-at-first-KF
re-parameterization; the reduced system gets Jacobi equilibration before the
f32 Cholesky (replaces the reference's f64, define_ba_type.h:9).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from ..utils.robust import huber_weight

_HI = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Dense-incidence BA problem over a keyframe window.

    K = window capacity (static), M = landmark capacity (static).
    """

    T_cw: jax.Array  # [K, 4, 4] world->camera poses
    Xw: jax.Array  # [M, 3] world points
    pts: jax.Array  # [M, K, 2] observed pixels (left cam)
    mask: jax.Array  # [M, K] bool
    pts_r: jax.Array  # [M, K, 2] right-cam pixels (zeros if mono)
    mask_r: jax.Array  # [M, K] bool (all False if mono)
    kf_valid: jax.Array  # [K] bool — which window slots hold real keyframes
    lm_valid: jax.Array  # [M] bool — which landmark slots are live


class BAParams(NamedTuple):
    iters: int = 10  # reference hardcodes 10 LM iterations
    n_fix: int = 2  # oldest keyframes held fixed
    huber_delta: float = 1.0  # px (reference setHuberThreshold, driver uses 0.5-1.0)
    lam: float = 1e-5  # multiplicative diagonal damping
    max_trans_update: float = 50.0  # divergence guard (reference :652-654)
    kill_dist: float = 3000.0  # landmark kill radius (reference :708-717)
    min_obs: int = 2  # landmarks need >=2 window observations


class BAResult(NamedTuple):
    T_cw: jax.Array  # [K, 4, 4] updated poses
    Xw: jax.Array  # [M, 3] updated points
    killed: jax.Array  # [M] landmarks beyond the kill radius (caller prunes)
    mean_err_px: jax.Array  # masked mean reprojection error after solve
    n_obs: jax.Array
    mean_err0_px: jax.Array  # same error BEFORE the solve (acceptance guard)


def _proj_jac(Xc, fx, fy):
    """[..., 3] -> residual-space Jacobian [..., 2, 3] of pi at Xc."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
        ],
        axis=-2,
    )


def _inv3x3(C):
    """Batched closed-form 3x3 inverse via adjugate. C: [..., 3, 3]."""
    a00, a01, a02 = C[..., 0, 0], C[..., 0, 1], C[..., 0, 2]
    a10, a11, a12 = C[..., 1, 0], C[..., 1, 1], C[..., 1, 2]
    a20, a21, a22 = C[..., 2, 0], C[..., 2, 1], C[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, jnp.where(det < 0, -1e-12, 1e-12), det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], -1),
            jnp.stack([c10, c11, c12], -1),
            jnp.stack([c20, c21, c22], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def build_observation_terms(T_cr, Xr, pts, mask, pts_r, mask_r, fx, fy, cx, cy, T_rl, huber_delta):
    """Residuals + Jacobian blocks for every (landmark m, keyframe k) pair.

    All inputs in the *anchored* frame (poses T_cr map ref->cam). Returns
    (w [M,K,rows], r [M,K,rows], Q [M,K,rows,6], Rj [M,K,rows,3]) with
    rows = 2 (mono) stacked to 4 when right observations exist.

    The per-observation Jacobians are closed-form elementwise expressions —
    tiny per-(m,k) matmuls (2x3 @ 3x6) would lower to millions of micro-
    dots; the expanded forms evaluate in one fused elementwise pass.
    """
    R = T_cr[:, :3, :3]  # [K, 3, 3]
    t = T_cr[:, :3, 3]  # [K, 3]
    Xc = jnp.einsum("kij,mj->mki", R, Xr, precision=_HI) + t[None]  # [M, K, 3]
    z_ok = Xc[..., 2] > 0.05

    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / jnp.where(jnp.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    xiz, yiz = x * iz, y * iz
    u = xiz * fx + cx
    v = yiz * fy + cy
    r_l = jnp.stack([u, v], axis=-1) - pts  # [M, K, 2]

    # Q_l rows: d(u,v)/d[v, w] with left perturbation (dXc = v + w x Xc).
    one = jnp.ones_like(iz)
    zero = jnp.zeros_like(iz)
    qu = jnp.stack(
        [fx * iz, zero, -fx * xiz * iz, -fx * xiz * yiz, fx * (one + xiz * xiz), -fx * yiz],
        axis=-1,
    )
    qv = jnp.stack(
        [zero, fy * iz, -fy * yiz * iz, -fy * (one + yiz * yiz), fy * xiz * yiz, fy * xiz],
        axis=-1,
    )
    Q_l = jnp.stack([qu, qv], axis=-2)  # [M, K, 2, 6]
    # Rj_l rows: dpi @ R = f*iz*(R[row] - (x or y)*iz * R[2]).
    Rj_l = jnp.stack(
        [
            fx * iz[..., None] * (R[None, :, 0, :] - xiz[..., None] * R[None, :, 2, :]),
            fy * iz[..., None] * (R[None, :, 1, :] - yiz[..., None] * R[None, :, 2, :]),
        ],
        axis=-2,
    )  # [M, K, 2, 3]

    m_l = (mask & z_ok).astype(jnp.float32)

    # Right-camera rows through the rectified extrinsic (reference :206-320).
    R_rl = T_rl[:3, :3]
    t_rl = T_rl[:3, 3]
    Xrc = jnp.einsum("ij,mkj->mki", R_rl, Xc, precision=_HI) + t_rl
    zr_ok = Xrc[..., 2] > 0.05
    xr, yr = Xrc[..., 0], Xrc[..., 1]
    izr = 1.0 / jnp.where(jnp.abs(Xrc[..., 2]) < 1e-6, 1e-6, Xrc[..., 2])
    ur = xr * izr * fx + cx
    vr = yr * izr * fy + cy
    r_r = jnp.stack([ur, vr], axis=-1) - pts_r
    # dpiR = dpir @ R_rl, rows f*izr*(R_rl[row] - (xr|yr)*izr*R_rl[2]).
    dpiR = jnp.stack(
        [
            fx * izr[..., None] * (R_rl[None, None, 0, :] - (xr * izr)[..., None] * R_rl[None, None, 2, :]),
            fy * izr[..., None] * (R_rl[None, None, 1, :] - (yr * izr)[..., None] * R_rl[None, None, 2, :]),
        ],
        axis=-2,
    )  # [M, K, 2, 3]
    # Q_r = dpiR @ [I | -skew(Xc)]; the rotation block rows are Xc x dpiR_row.
    Q_r = jnp.concatenate([dpiR, jnp.cross(Xc[..., None, :], dpiR)], axis=-1)  # [M, K, 2, 6]
    # Rj_r = dpiR @ R (contract 3; an elementwise mul-sum).
    Rj_r = jnp.sum(dpiR[..., :, :, None] * R[None, :, None, :, :], axis=-2)
    m_r = (mask_r & zr_ok).astype(jnp.float32)

    r = jnp.concatenate([r_l, r_r], axis=-1)  # [M, K, 4]
    Q = jnp.concatenate([Q_l, Q_r], axis=-2)  # [M, K, 4, 6]
    Rj = jnp.concatenate([Rj_l, Rj_r], axis=-2)  # [M, K, 4, 3]

    # Huber IRLS weight per observation (on the 2-row residual norms).
    rn_l = jnp.sqrt(jnp.sum(r_l * r_l, axis=-1) + 1e-12)
    rn_r = jnp.sqrt(jnp.sum(r_r * r_r, axis=-1) + 1e-12)
    w_l = huber_weight(rn_l, huber_delta) * m_l
    w_r = huber_weight(rn_r, huber_delta) * m_r
    w = jnp.concatenate(
        [jnp.repeat(w_l[..., None], 2, -1), jnp.repeat(w_r[..., None], 2, -1)], axis=-1
    )  # [M, K, 4]
    return w, r, Q, Rj


def assemble_normal_blocks(w, r, Q, Rj):
    """Hessian blocks from observation terms.

    Returns A [K,6,6], a [K,6], C [M,3,3], b [M,3], B [M,K,6,3].

    Contractions over the tiny residual-row axis (r<=4) are expanded
    mul-sums; only the landmark-axis reductions are dots.
    """
    wQ = Q * w[..., None]
    # A: contract (m, r) — inner dim M*rows is large, a real matmul per k.
    A = jnp.einsum("mkra,mkrb->kab", wQ, Q, precision=_HI)
    a = -jnp.einsum("mkra,mkr->ka", wQ, r, precision=_HI)
    wR = Rj * w[..., None]
    # C/b/B: batch (m[,k]) with tiny contraction — elementwise mul-sums.
    C = jnp.sum(wR[..., :, :, None] * Rj[..., :, None, :], axis=(-4, -3))  # [M,3,3]
    b = -jnp.sum(wR * r[..., None], axis=(-3, -2))  # [M, 3]
    B = jnp.sum(wQ[..., :, :, None] * Rj[..., :, None, :], axis=-3)  # [M,K,6,3]
    return A, a, C, b, B


def schur_reduce(A, a, C, b, B, lam):
    """Damp + eliminate the landmark block.

    Returns (S [K,K,6,6], s [K,6], Cinv [M,3,3]).
    """
    K = A.shape[0]
    M = C.shape[0]
    # Diagonal ops as mask arithmetic (fuses; no multi-index scatter).
    eye6 = jnp.eye(6, dtype=A.dtype)
    eye3 = jnp.eye(3, dtype=C.dtype)
    A = A + lam * A * eye6
    C = C + lam * C * eye3
    # Regularize unobserved landmark blocks so Cinv stays finite.
    C = C + 1e-6 * eye3
    Cinv = _inv3x3(C)
    # BCinv: batched [6,3]@[3,3] per (m,k) — elementwise mul-sum.
    BCinv = jnp.sum(B[..., :, :, None] * Cinv[:, None, None, :, :], axis=-2)  # [M,K,6,3]
    # S_off contracts (m, c): reshape into ONE [6K, 3M] @ [3M, 6K] matmul.
    X1 = BCinv.transpose(1, 2, 0, 3).reshape(K * 6, M * 3)
    X2 = B.transpose(0, 3, 1, 2).reshape(M * 3, K * 6)
    # HIGHEST precision: a reduced-precision (TF32) product would inject
    # noise into the reduced camera system.
    S_off = jnp.matmul(X1, X2, precision=_HI).reshape(K, 6, K, 6).transpose(0, 2, 1, 3)
    eyeK = jnp.eye(K, dtype=A.dtype)
    S = -S_off + eyeK[:, :, None, None] * A[:, None, :, :]
    sb = jnp.matmul(X1, b.reshape(M * 3), precision=_HI)  # [6K]
    s = a - sb.reshape(K, 6)
    return S, s, Cinv, BCinv


def solve_reduced(S, s, opt_mask):
    """Solve the reduced camera system for the optimizable keyframes.

    S: [K, K, 6, 6]; s: [K, 6]; opt_mask: [K] bool (False = fixed or empty).
    Fixed/empty slots are replaced by identity rows so the dense solve stays
    well-posed; their dx comes out 0. Jacobi equilibration keeps the f32
    Cholesky healthy (replaces the reference's f64 solve).
    """
    K = S.shape[0]
    n = 6 * K
    om = opt_mask.astype(S.dtype)
    # Zero cross-blocks touching non-opt frames; unit diagonal there.
    gate = om[:, None] * om[None, :]
    S = S * gate[:, :, None, None]
    H = S.transpose(0, 2, 1, 3).reshape(n, n)
    rhs = (s * om[:, None]).reshape(n)
    keep = jnp.repeat(om, 6)
    H = H * keep[:, None] * keep[None, :] + jnp.diag(1.0 - keep)
    d = jnp.sqrt(jnp.clip(jnp.diag(H), 1e-12, None))
    dinv = 1.0 / d
    Hn = H * dinv[:, None] * dinv[None, :]
    Hn = Hn + 1e-7 * jnp.eye(n, dtype=H.dtype)
    L = jnp.linalg.cholesky(Hn)
    y = jax.scipy.linalg.solve_triangular(L, rhs * dinv, lower=True)
    x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False) * dinv
    return x.reshape(K, 6) * om[:, None]


def back_substitute(Cinv, b, B, dx):
    """dy_i = Cinv_i (b_i - sum_j B_ij^T dx_j)  — [M, 3] (elementwise mul-sums)."""
    Btx = jnp.sum(B * dx[None, :, :, None], axis=(1, 2))  # [M, 3]
    rhs = b - Btx
    return jnp.sum(Cinv * rhs[:, None, :], axis=-1)


def ba_accept(mean_err_px, mean_err0_px, reproj_thresh: float):
    """Window-BA acceptance rule, shared by both pipelines and pinned by
    tests/test_ba.py::test_ba_accept_gate.

    A solve is written back iff it is finite AND either
      (a) materially improved (<= 0.98x the pre-BA error) and below a hard
          absolute ceiling — "improved" from 305 px to 298 px is still a
          garbage window (r4 f69 detonation), or
      (b) roughly flat (<= 1.05x + 0.1 px) and already below a tight ceiling.
    Clause (a) prevents the freeze-livelock: a bad-but-improving window is
    accepted so successive solves can walk it down instead of being
    re-rejected forever; clause (b) lets converged windows breathe.
    Ceilings derive from the pose-GN reprojection threshold (config), not
    bespoke literals (r4 VERDICT #8): hard = 6.5x, tight = 2.5x — at the
    default 3 px threshold these reproduce the r4-tuned 19.5/7.5 px gates.
    """
    hard_ceil = 6.5 * reproj_thresh
    tight_ceil = 2.5 * reproj_thresh
    improved = mean_err_px <= mean_err0_px * 0.98
    flat = mean_err_px <= mean_err0_px * 1.05 + 0.1
    return jnp.isfinite(mean_err_px) & (
        (improved & (mean_err_px < hard_ceil))
        | (flat & (mean_err_px < tight_ceil))
    )


def ba_solve_impl(
    problem: BAProblem,
    fx,
    fy,
    cx,
    cy,
    T_rl: jax.Array,
    params: BAParams = BAParams(),
    axis_name: str | None = None,
) -> BAResult:
    """Run `params.iters` damped GN iterations of sliding-window BA.

    Mono: pass mask_r all-False and any T_rl (identity).

    Distribution (SURVEY.md §7 / BASELINE.json config #5): when `axis_name`
    is set, the landmark axis M is assumed sharded across that mesh axis
    (poses/kf_valid replicated). Hessian assembly and the Schur terms are
    computed shard-locally; only the tiny reduced camera system (A, a,
    B Cinv B^T, B Cinv b — 6K x 6K) crosses the interconnect via psum. The
    replicated solve is deterministic, so every device applies identical pose
    updates; landmark back-substitution stays shard-local with zero
    communication.
    """

    def _psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x
    K = problem.T_cw.shape[0]
    M = problem.Xw.shape[0]

    # Only landmarks with >= min_obs observations in live keyframes participate
    # (reference collects landmarks seen in >=2 window KFs,
    # sparse_ba_parameters.h:362-402).
    obs_mask = problem.mask & problem.kf_valid[None, :]
    obs_mask_r = problem.mask_r & problem.kf_valid[None, :]
    n_obs_per_lm = jnp.sum(obs_mask, axis=1)
    lm_active = problem.lm_valid & (n_obs_per_lm >= params.min_obs)
    mask = obs_mask & lm_active[:, None]
    mask_r = obs_mask_r & lm_active[:, None]

    # Anchor at the first window keyframe (sparse_ba_parameters.h:204-226):
    # poses become T_cr = T_cw @ T_wr where r = KF slot 0; points X_r = T_rw X_w.
    T_rw = problem.T_cw[0]
    T_wr = geo.se3_inverse(T_rw)
    T_cr = problem.T_cw @ T_wr  # [K, 4, 4]
    Xr = geo.transform_points(T_rw, problem.Xw)  # [M, 3]

    # Optimizable = live keyframes beyond the first n_fix.
    opt_mask = problem.kf_valid & (jnp.arange(K) >= params.n_fix)

    def masked_mean_err(T_cr_e, Xr_e):
        """Masked mean left-row reprojection error (px) at a given state."""
        w_, r_, _, _ = build_observation_terms(
            T_cr_e, Xr_e, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl, 1e9
        )
        rn_ = jnp.sqrt(jnp.sum(r_[..., :2] ** 2, axis=-1))
        return _psum(jnp.sum(rn_ * mask)) / jnp.maximum(_psum(jnp.sum(mask)), 1)

    # Pre-solve error: keyframe steps use it as an acceptance guard — a solve
    # that ends WORSE than it started (poisoned window: dynamic-object
    # landmarks, bad poses) must not be written back.
    mean_err0 = masked_mean_err(T_cr, Xr)

    def iteration(state):
        it, T_cr, Xr, _ = state
        w, r, Q, Rj = build_observation_terms(
            T_cr, Xr, problem.pts, mask, problem.pts_r, mask_r, fx, fy, cx, cy, T_rl, params.huber_delta
        )
        A, a, C, b, B = assemble_normal_blocks(w, r, Q, Rj)
        # Local damping/elimination, then one psum of the reduced system.
        S_loc, s_loc, Cinv, _ = schur_reduce(A, a, C, b, B, params.lam)
        S, s = _psum(S_loc), _psum(s_loc)
        dx = solve_reduced(S, s, opt_mask)
        dy = back_substitute(Cinv, b, B, dx)
        dy = jnp.where(lm_active[:, None], dy, 0.0)

        # Divergence guards: NaN or huge translation update -> skip this step
        # (reference throws; we mask — fail-soft keeps the jit graph pure).
        dy_bad = _psum((~jnp.all(jnp.isfinite(dy))).astype(jnp.int32)) > 0
        bad = (
            ~jnp.all(jnp.isfinite(dx))
            | dy_bad
            | (jnp.max(jnp.linalg.norm(dx[:, :3], axis=-1)) > params.max_trans_update)
        )
        dx = jnp.where(bad, 0.0, dx)
        dy = jnp.where(bad, 0.0, dy)

        T_new = jax.vmap(geo.add_front_se3)(T_cr, dx)
        T_cr = jnp.where(opt_mask[:, None, None], T_new, T_cr)
        Xr = Xr + dy
        # Early exit on pose-step convergence. dx is identical on every shard
        # (it comes out of the psum-reduced solve), so the flag — and hence
        # the psum count — stays consistent across devices; dy is shard-local
        # and must NOT feed this.
        done = jnp.max(jnp.abs(dx)) < 1e-5
        return it + 1, T_cr, Xr, done

    def iter_cond(state):
        it, _, _, done = state
        return (it < params.iters) & ~done

    _, T_cr, Xr, _ = jax.lax.while_loop(
        iter_cond, iteration, (jnp.int32(0), T_cr, Xr, jnp.array(False))
    )

    # Write back to world frame (reference :630-718). Two erosion guards
    # (the r4 det-0.915 collapse — see geo.so3_project docstring):
    #   - OPTIMIZED poses are re-orthonormalized after the anchor round-trip;
    #   - FIXED/invalid poses return BIT-IDENTICAL — previously they too
    #     passed through T_cw @ T_wr @ T_rw and silently picked up the
    #     round-trip epsilon at every single BA.
    T_cw_new = jnp.where(
        opt_mask[:, None, None], geo.se3_project(T_cr @ T_rw), problem.T_cw
    )
    Xw_new = geo.transform_points(T_wr, Xr)
    Xw_new = jnp.where(lm_active[:, None], Xw_new, problem.Xw)

    # Kill runaway landmarks (reference ||X|| > 3000 rule).
    dist = jnp.linalg.norm(Xr, axis=-1)
    killed = lm_active & (dist > params.kill_dist)

    # Final masked mean reprojection error (left rows).
    mean_err = masked_mean_err(T_cr, Xr)
    msum = _psum(jnp.sum(mask))
    return BAResult(
        T_cw_new, Xw_new, killed, mean_err, msum + _psum(jnp.sum(mask_r)), mean_err0
    )


ba_solve = partial(jax.jit, static_argnames=("params",))(ba_solve_impl)
