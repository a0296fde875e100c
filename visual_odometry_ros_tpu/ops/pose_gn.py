"""Pose-only Gauss-Newton / Levenberg-Marquardt refinement — mono and stereo.

Capability parity with the reference `MotionEstimator` pose-only BA
(core/visual_odometry/motion_estimator.cpp):
  - mono `poseOnlyBundleAdjustment` (:665-861): 6-DoF GN/LM on T_10 with
    analytic 2x6 Jacobians, Huber weighting (delta = 0.5 px), fixed
    multiplicative lambda damping (1e-5), <=100 iterations, convergence on
    ||dxi|| or |dcost|, inlier mask by reprojection threshold, NaN bail-out.
  - stereo `poseOnlyBundleAdjustment_Stereo` (:863-1088): same with 4 residual
    rows per landmark (left x,y + right x,y) through the rectified extrinsic
    T_rl.
  - the exploit-sparsity JtWJ accumulations (:1342-1576) become one fused
    einsum over all points.

Batched design: the per-point scalar loop is a single [N]-batched residual/Jacobian
evaluation; the 6x6 normal system is accumulated with full-f32 contractions
and solved closed-form via Cholesky each iteration inside `lax.while_loop`.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from ..utils.robust import huber_weight

_HI = jax.lax.Precision.HIGHEST


class PoseGNParams(NamedTuple):
    max_iters: int = 100
    huber_delta: float = 0.5
    lam: float = 1e-5  # multiplicative LM damping on the Hessian diagonal
    # Without per-step accept/reject, plain GN dithers at the noise floor
    # near the optimum: step_tol below it never fires and every solve runs
    # max_iters. 1e-4 (0.1 mm / 0.1 mrad) is far below VO noise, and local
    # BA refines keyframe poses afterwards anyway.
    step_tol: float = 1e-4
    cost_tol: float = 1e-5  # relative |dcost| / cost
    reproj_thresh: float = 1.5  # px, inlier gate for the output mask
    # The reference's pose-only BA fails only on NaN (motion_estimator.cpp:
    # 857,1084); its mono caller additionally requires >=10 points
    # (mono_vo.cpp:864-866). We gate on an ABSOLUTE inlier floor (a pose fit
    # by 60 points is valid even when 200 occluder tracks are outliers —
    # r2 frame-16 false-failure mode) plus a low ratio floor against
    # fitting pure noise; the model-level motion-sanity gate rejects
    # wrong-but-consistent solves.
    min_inlier_ratio: float = 0.25
    min_inliers: int = 10


def _project_jacobian(Xc: jax.Array, fx, fy):
    """d(pixel)/d(Xc): [N, 2, 3] for camera-frame points [N, 3]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz2 = iz * iz
    zero = jnp.zeros_like(x)
    row_u = jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1)
    row_v = jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def _se3_point_jacobian(Xc: jax.Array):
    """d(Xc)/d(xi) with xi=[v,w] (left perturbation): [N, 3, 6] = [I | -[Xc]x]."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=Xc.dtype), Xc.shape[:-1] + (3, 3))
    return jnp.concatenate([eye, -geo.skew(Xc)], axis=-1)


def _solve6(H: jax.Array, g: jax.Array) -> jax.Array:
    L = jnp.linalg.cholesky(H)
    y = jax.scipy.linalg.solve_triangular(L, g, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


class PoseGNResult(NamedTuple):
    T10: jax.Array  # refined pose [4, 4]
    inliers: jax.Array  # [N] bool
    mean_err: jax.Array  # mean reproj error over valid points (px)
    ok: jax.Array  # scalar bool: converged to a sane solution
    n_iter: jax.Array


def _pose_gn_core(residual_fn, T_init, valid, params: PoseGNParams, n_rows: int):
    """Shared GN/LM loop. residual_fn(T) -> (r [N, n_rows], J [N, n_rows, 6])."""
    w_valid = valid.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(w_valid), 1.0)

    def step(state):
        # ONE residual/Jacobian evaluation per iteration, update always
        # applied — the reference's damped-GN shape (motion_estimator.cpp:
        # 713-810: fixed multiplicative lambda, break on small dxi or small
        # cost change, NaN bail-out). The cost of the new pose is simply
        # next iteration's cost, halving the per-iteration latency chain.
        T, prev_cost, it, done = state
        r, J = residual_fn(T)
        rn = jnp.sqrt(jnp.sum(r * r, axis=-1) + 1e-12)
        w = huber_weight(rn, params.huber_delta) * w_valid  # [N]
        cost = jnp.sum(w * rn * rn) / n_valid
        # H = sum w * J^T J ; g = -sum w * J^T r  (full f32 contraction)
        Jw = J * w[:, None, None]
        H = jnp.einsum("nri,nrj->ij", Jw, J, precision=_HI)
        g = -jnp.einsum("nri,nr->i", Jw, r, precision=_HI)
        H = H + params.lam * jnp.diag(jnp.diag(H)) + 1e-9 * jnp.eye(6, dtype=H.dtype)
        dxi = _solve6(H, g)
        bad = ~jnp.all(jnp.isfinite(dxi))
        T_new = jnp.where(bad, T, geo.add_front_se3(T, dxi))
        converged = (jnp.linalg.norm(dxi) < params.step_tol) | (
            jnp.abs(prev_cost - cost) < params.cost_tol * (cost + 1e-9)
        )
        return T_new, cost, it + 1, done | converged | bad

    def cond(state):
        _, _, it, done = state
        return (it < params.max_iters) & ~done

    state0 = (T_init, jnp.asarray(jnp.inf, jnp.float32), jnp.int32(0), jnp.array(False))
    T, cost, it, _ = jax.lax.while_loop(cond, step, state0)

    r, _ = residual_fn(T)
    err = jnp.sqrt(jnp.sum(r * r, axis=-1) / (n_rows // 2))
    inliers = valid & (err < params.reproj_thresh)
    mean_err = jnp.sum(err * w_valid) / n_valid
    n_inl = jnp.sum(inliers)
    inlier_ratio = n_inl / n_valid
    ok = (
        jnp.all(jnp.isfinite(T))
        & (inlier_ratio >= params.min_inlier_ratio)
        & (n_inl >= params.min_inliers)
        & jnp.isfinite(mean_err)
    )
    return PoseGNResult(T, inliers, mean_err, ok, it)


@partial(jax.jit, static_argnames=("params",))
def pose_only_gn_mono(
    X0: jax.Array,
    pts1: jax.Array,
    valid: jax.Array,
    fx,
    fy,
    cx,
    cy,
    T_10_init: jax.Array,
    params: PoseGNParams = PoseGNParams(),
) -> PoseGNResult:
    """Refine T_10 s.t. pi(T_10 * X0) matches pts1.

    X0: [N, 3] points in frame-0 camera coords; pts1: [N, 2] pixels in frame 1.
    """

    def residual_fn(T):
        Xc = geo.transform_points(T, X0)
        z = Xc[..., 2]
        iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        u = Xc[..., 0] * iz * fx + cx
        v = Xc[..., 1] * iz * fy + cy
        r = jnp.stack([u, v], axis=-1) - pts1
        J = jnp.einsum("nij,njk->nik", _project_jacobian(Xc, fx, fy), _se3_point_jacobian(Xc), precision=_HI)
        # Behind-camera points contribute nothing.
        front = (z > 0.01)[:, None]
        return jnp.where(front, r, 0.0), jnp.where(front[:, :, None], J, 0.0)

    return _pose_gn_core(residual_fn, T_10_init, valid, params, n_rows=2)


@partial(jax.jit, static_argnames=("params",))
def pose_only_gn_stereo(
    X0: jax.Array,
    pts_l1: jax.Array,
    pts_r1: jax.Array,
    valid_l: jax.Array,
    valid_r: jax.Array,
    fx,
    fy,
    cx,
    cy,
    T_rl: jax.Array,
    T_10_init: jax.Array,
    params: PoseGNParams = PoseGNParams(),
) -> PoseGNResult:
    """Stereo pose refinement with 4 residual rows (reference :863-1088).

    X0: [N, 3] points in previous *left* camera frame. pts_l1/pts_r1: current
    left/right pixel observations (rectified, shared intrinsics). T_rl maps
    left-cam coords to right-cam coords. Right rows are masked by valid_r so
    mono-only tracks still constrain the left rows.
    """
    R_rl = T_rl[:3, :3]

    def residual_fn(T):
        Xl = geo.transform_points(T, X0)
        Xr = geo.transform_points(T_rl, Xl)

        def proj_rows(Xc, pts):
            z = Xc[..., 2]
            iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
            u = Xc[..., 0] * iz * fx + cx
            v = Xc[..., 1] * iz * fy + cy
            return jnp.stack([u, v], axis=-1) - pts

        r_l = proj_rows(Xl, pts_l1)
        r_r = proj_rows(Xr, pts_r1)
        Jp = _se3_point_jacobian(Xl)  # [N, 3, 6] d(Xl)/dxi
        J_l = jnp.einsum("nij,njk->nik", _project_jacobian(Xl, fx, fy), Jp, precision=_HI)
        # Right rows: d(pix_r)/dXr * R_rl * d(Xl)/dxi (reference :206-320 shape)
        J_r = jnp.einsum("nij,jm,nmk->nik", _project_jacobian(Xr, fx, fy), R_rl, Jp, precision=_HI)

        front = (Xl[..., 2] > 0.01) & (Xr[..., 2] > 0.01)
        m_l = (front & valid_l)[:, None]
        m_r = (front & valid_r)[:, None]
        r = jnp.concatenate([jnp.where(m_l, r_l, 0.0), jnp.where(m_r, r_r, 0.0)], axis=-1)
        J = jnp.concatenate(
            [jnp.where(m_l[:, :, None], J_l, 0.0), jnp.where(m_r[:, :, None], J_r, 0.0)], axis=-2
        )
        return r, J

    return _pose_gn_core(residual_fn, T_10_init, valid_l, params, n_rows=4)


def _reproj_err_px(T, X0, pts1, fx, fy, cx, cy):
    """Per-point left-view reprojection error (px) of pi(T X0) vs pts1."""
    Xc = geo.transform_points(T, X0)
    z = Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = Xc[..., 0] * iz * fx + cx
    v = Xc[..., 1] * iz * fy + cy
    err = jnp.sqrt((u - pts1[..., 0]) ** 2 + (v - pts1[..., 1]) ** 2)
    # Behind-camera points are outliers by definition.
    return jnp.where(z > 0.01, err, 1e6)


@partial(jax.jit, static_argnames=("params", "gate_scale"))
def pose_only_gn_stereo_robust(
    X0: jax.Array,
    pts_l1: jax.Array,
    pts_r1: jax.Array,
    valid_l: jax.Array,
    valid_r: jax.Array,
    fx,
    fy,
    cx,
    cy,
    T_rl: jax.Array,
    T_10_init: jax.Array,
    params: PoseGNParams = PoseGNParams(),
    gate_scale: float = 2.0,
):
    """Two-pass gated pose GN: solve, hard-gate at gate_scale x reproj_thresh
    under the better of {pass-1 pose, prior}, re-solve on survivors.

    Coherent outlier groups (dynamic objects: stereo-consistent landmarks
    that move with an occluder, not the world) bias the single Huber solve
    enough to fail the inlier-ratio check; the hard gate under the prior
    strips them so the second solve converges on the static set. Returns
    (PoseGNResult of the chosen pass, err_px [N] under the chosen pose) —
    the error lets callers fail-soft gate survivors even when ok=False
    (keeping ALL tracks on failure feeds dynamic outliers into the map).
    """
    res1 = pose_only_gn_stereo(
        X0, pts_l1, pts_r1, valid_l, valid_r, fx, fy, cx, cy, T_rl, T_10_init, params
    )
    T1 = jnp.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts_l1, fx, fy, cx, cy)
    keep = valid_l & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_stereo(
        X0, pts_l1, pts_r1, keep, valid_r & keep, fx, fy, cx, cy, T_rl, T1, params
    )
    # Pass selection on the COMMON point set (all of `valid_l`): res2's
    # mean_err averages only over the gated subset, so comparing means is
    # biased toward pass 2 — compare inlier counts under each candidate
    # pose over the same set instead.
    err2_all = _reproj_err_px(res2.T10, X0, pts_l1, fx, fy, cx, cy)
    n1 = jnp.sum(valid_l & (err1 < params.reproj_thresh))
    n2 = jnp.sum(valid_l & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = jnp.where(use2, res2.T10, jnp.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts_l1, fx, fy, cx, cy)
    inliers = valid_l & (err < params.reproj_thresh)
    # Re-gate ok on the FINAL inlier set over the full valid population:
    # pass-2's internal ok is computed over its gated subset, so a pose
    # supported by a handful of mutually-consistent aliases could otherwise
    # report ok=True (r2 frame-16/26 false-accepts on repeated texture).
    n_fin = jnp.sum(inliers)
    n_all = jnp.maximum(jnp.sum(valid_l), 1)
    # Prior-competition arbitration: GN descends cost from T_10_init, so a
    # healthy solve explains at least as many points as the prior does. A
    # solution explaining FEWER points has latched onto a coherent outlier
    # cluster (a dynamic object whose residuals dominate the Huber cost) —
    # reject it and let the caller fail-soft on the prior (the r4 hard-
    # sequence collapse: three successively worse poses accepted at
    # 0.73/0.64/0.27 inlier ratio while the prior explained more points).
    err_prior = _reproj_err_px(T_10_init, X0, pts_l1, fx, fy, cx, cy)
    n_prior = jnp.sum(valid_l & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        # Small slack (r4 ADVICE low): a converged solve that explains one or
        # two threshold-straddling points fewer than the prior is a near-tie
        # under noise, not a dynamic-object latch; rejecting it flips to the
        # prior and bumps fail_count, so a run of near-ties could spuriously
        # trigger recovery. Only decisively worse solves are rejected.
        & (n_fin + 2 >= n_prior)
    )
    mean_err = jnp.where(use2, res2.mean_err, res1.mean_err)
    n_iter = res1.n_iter + res2.n_iter
    return PoseGNResult(T, inliers, mean_err, ok, n_iter), err


@partial(jax.jit, static_argnames=("params", "gate_scale"))
def pose_only_gn_mono_robust(
    X0: jax.Array,
    pts1: jax.Array,
    valid: jax.Array,
    fx,
    fy,
    cx,
    cy,
    T_10_init: jax.Array,
    params: PoseGNParams = PoseGNParams(),
    gate_scale: float = 2.0,
):
    """Mono twin of pose_only_gn_stereo_robust."""
    res1 = pose_only_gn_mono(X0, pts1, valid, fx, fy, cx, cy, T_10_init, params)
    T1 = jnp.where(res1.ok, res1.T10, T_10_init)
    err1 = _reproj_err_px(T1, X0, pts1, fx, fy, cx, cy)
    keep = valid & (err1 < gate_scale * params.reproj_thresh)
    res2 = pose_only_gn_mono(X0, pts1, keep, fx, fy, cx, cy, T1, params)
    # Common-set pass selection (see stereo twin).
    err2_all = _reproj_err_px(res2.T10, X0, pts1, fx, fy, cx, cy)
    n1 = jnp.sum(valid & (err1 < params.reproj_thresh))
    n2 = jnp.sum(valid & (err2_all < params.reproj_thresh))
    use2 = res2.ok & (~res1.ok | (n2 >= n1))
    T = jnp.where(use2, res2.T10, jnp.where(res1.ok, res1.T10, T_10_init))
    err = _reproj_err_px(T, X0, pts1, fx, fy, cx, cy)
    inliers = valid & (err < params.reproj_thresh)
    # Re-gate ok on the final inlier set + prior-competition arbitration
    # (see stereo twin).
    n_fin = jnp.sum(inliers)
    n_all = jnp.maximum(jnp.sum(valid), 1)
    err_prior = _reproj_err_px(T_10_init, X0, pts1, fx, fy, cx, cy)
    n_prior = jnp.sum(valid & (err_prior < params.reproj_thresh))
    ok = (
        (res1.ok | res2.ok)
        & (n_fin >= params.min_inliers)
        & (n_fin / n_all >= params.min_inlier_ratio)
        # Small slack (r4 ADVICE low): a converged solve that explains one or
        # two threshold-straddling points fewer than the prior is a near-tie
        # under noise, not a dynamic-object latch; rejecting it flips to the
        # prior and bumps fail_count, so a run of near-ties could spuriously
        # trigger recovery. Only decisively worse solves are rejected.
        & (n_fin + 2 >= n_prior)
    )
    mean_err = jnp.where(use2, res2.mean_err, res1.mean_err)
    return PoseGNResult(T, inliers, mean_err, ok, res1.n_iter + res2.n_iter), err
