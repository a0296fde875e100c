"""Batched PnP RANSAC: 3D->2D pose estimation with fixed-size hypothesis sets.

Capability parity with the reference `MotionEstimator::calcPoseByPnP`
(core/visual_odometry/motion_estimator.cpp:135-203): cv::solvePnPRansac
(EPNP) with a retry at 2x the reprojection threshold and a 60% inlier-count
acceptance vote, followed by refinement.

Batched design: K minimal 6-point DLT hypotheses solved as one batched 12x12
eigenproblem, nearest-rotation projection per hypothesis, reprojection
scoring as one [K, N] fused evaluation, and a pose-only GN polish on the
winning inlier set (reusing ops/pose_gn). The reference's retry-at-2x rule is
evaluated arithmetically instead of as a second RANSAC run.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from . import pose_gn as PG

_HI = jax.lax.Precision.HIGHEST


class PnPResult(NamedTuple):
    T_cw: jax.Array  # [4, 4] world->camera
    inliers: jax.Array  # [N]
    ok: jax.Array
    n_inliers: jax.Array


def _dlt_pnp(Xw: jax.Array, xn: jax.Array):
    """Linear PnP from >=6 points: [..., n, 3] world, [..., n, 2] normalized.

    Returns T_cw candidates [..., 4, 4] (rotation projected to SO(3), sign
    fixed by cheirality on the centroid).
    """
    n = Xw.shape[-2]
    X, Y, Z = Xw[..., 0], Xw[..., 1], Xw[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    # Rows for u: [X Y Z 1 0 0 0 0 -uX -uY -uZ -u]
    r1 = jnp.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], axis=-1)
    r2 = jnp.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], axis=-1)
    A = jnp.concatenate([r1, r2], axis=-2)  # [..., 2n, 12]
    M = jnp.einsum("...ki,...kj->...ij", A, A, precision=_HI)
    _, vecs = jnp.linalg.eigh(M)
    p = vecs[..., :, 0]  # [..., 12]
    P = p.reshape(p.shape[:-1] + (3, 4))
    Rraw = P[..., :3]
    t_raw = P[..., 3]
    # Nearest rotation + scale recovery: R_raw = s * R.
    U, S, Vt = jnp.linalg.svd(Rraw)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt))
    D = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), det], axis=-1)
    R = jnp.einsum("...ij,...j,...jk->...ik", U, D, Vt, precision=_HI)
    scale = jnp.sum(S[..., :2], axis=-1) / 2.0  # mean of the two reliable svs
    t = t_raw / jnp.maximum(scale, 1e-9)[..., None]
    # Cheirality: centroid must land in front; otherwise negate (P and -P
    # are equivalent null vectors).
    cen = jnp.mean(Xw, axis=-2)
    z_cen = jnp.einsum("...ij,...j->...i", R, cen)[..., 2] + t[..., 2]
    flip = (z_cen < 0)[..., None]
    # Negating p flips both R_raw and t; nearest rotation of -R_raw is
    # R @ diag(-1,-1,-1)-ish — recompute cheaply by negating R odd? Proper:
    # negate t and rotate R by 180deg is wrong; instead recompute with -P.
    U2, S2, Vt2 = jnp.linalg.svd(-Rraw)
    det2 = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U2, Vt2))
    D2 = jnp.stack([jnp.ones_like(det2), jnp.ones_like(det2), det2], axis=-1)
    R2 = jnp.einsum("...ij,...j,...jk->...ik", U2, D2, Vt2, precision=_HI)
    t2 = -t_raw / jnp.maximum(scale, 1e-9)[..., None]
    R = jnp.where(flip[..., None], R2, R)
    t = jnp.where(flip, t2, t)
    return geo.rt_to_se3(R, t)


@partial(jax.jit, static_argnames=("n_hypotheses", "gn_params"))
def pnp_ransac(
    Xw: jax.Array,
    pts: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    fx,
    fy,
    cx,
    cy,
    thresh_px: float = 3.0,
    n_hypotheses: int = 64,
    min_inlier_ratio: float = 0.6,
    gn_params: PG.PoseGNParams = PG.PoseGNParams(max_iters=30),
    T_init: jax.Array | None = None,
) -> PnPResult:
    """RANSAC linear-PnP + GN polish. Xw: [N, 3] world; pts: [N, 2] pixels.

    T_init (optional [4, 4] T_cw prior): added as one more scored hypothesis.
    The 12-parameter linear DLT is DEGENERATE for coplanar points (homography
    ambiguity) — on planar scenes every sampled hypothesis can be garbage
    while a GN descent from a decent prior converges cleanly; the reference's
    cv::EPNP handles planarity inside its control-point formulation, the
    prior hypothesis is our equivalent escape hatch (relocalization always
    has the dead-reckoned pose available).
    """
    N = Xw.shape[0]
    K = n_hypotheses
    xn = jnp.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], axis=-1)

    # Minimal sets WITHOUT replacement: with few valid candidates, sampling
    # with replacement yields duplicate rows (<6 distinct points) for most
    # sets, starving the hypothesis pool.
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    keys = jax.random.split(key, K)
    idx = jax.vmap(
        lambda k: jax.random.choice(k, N, shape=(6,), replace=False, p=p)
    )(keys)
    T_h = _dlt_pnp(Xw[idx], xn[idx])  # [K, 4, 4]
    if T_init is not None:
        T_h = jnp.concatenate([T_h, T_init[None]], axis=0)

    # Score: reprojection error of all points under each hypothesis.
    Xc = jnp.einsum("kij,nj->kni", T_h[:, :3, :3], Xw, precision=_HI) + T_h[:, None, :3, 3]
    z = Xc[..., 2]
    iz = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    u = Xc[..., 0] * iz * fx + cx
    v = Xc[..., 1] * iz * fy + cy
    err = jnp.sqrt((u - pts[None, :, 0]) ** 2 + (v - pts[None, :, 1]) ** 2)
    inl = (err < thresh_px) & (z > 0.01) & valid[None, :]
    # Reference retry rule: accept the 2x-threshold count when the base
    # threshold fails the ratio vote (motion_estimator.cpp:174-201).
    inl2 = (err < 2.0 * thresh_px) & (z > 0.01) & valid[None, :]
    scores = jnp.sum(inl, axis=1)
    best = jnp.argmax(scores)

    # GN polish on the winner's (2x) inlier set.
    res = PG.pose_only_gn_mono(
        Xw,
        pts,
        inl2[best],
        fx,
        fy,
        cx,
        cy,
        T_h[best],
        gn_params,
    )
    T_final = jnp.where(res.ok, res.T10, T_h[best])
    if T_init is not None:
        # Polish the prior over ALL valid points too (its 2x gate may be
        # empty if the prior has drifted, but the basin often still holds on
        # planar scenes where every sampled hypothesis is degenerate), then
        # keep whichever final pose explains more points.
        res_p = PG.pose_only_gn_mono(
            Xw, pts, valid, fx, fy, cx, cy, T_init, gn_params
        )
        T_prior = jnp.where(jnp.all(jnp.isfinite(res_p.T10)), res_p.T10, T_init)

        def count_inl(T):
            Xc_ = geo.transform_points(T, Xw)
            z_ = Xc_[..., 2]
            iz_ = 1.0 / jnp.where(jnp.abs(z_) < 1e-6, 1e-6, z_)
            e_ = jnp.sqrt(
                (Xc_[..., 0] * iz_ * fx + cx - pts[:, 0]) ** 2
                + (Xc_[..., 1] * iz_ * fy + cy - pts[:, 1]) ** 2
            )
            return jnp.sum((e_ < thresh_px) & (z_ > 0.01) & valid)

        T_final = jnp.where(count_inl(T_prior) > count_inl(T_final), T_prior, T_final)

    # Final inlier mask at the base threshold.
    Xcf = geo.transform_points(T_final, Xw)
    zf = Xcf[..., 2]
    izf = 1.0 / jnp.where(jnp.abs(zf) < 1e-6, 1e-6, zf)
    uf = Xcf[..., 0] * izf * fx + cx
    vf = Xcf[..., 1] * izf * fy + cy
    errf = jnp.sqrt((uf - pts[:, 0]) ** 2 + (vf - pts[:, 1]) ** 2)
    inliers = (errf < thresh_px) & (zf > 0.01) & valid
    n_in = jnp.sum(inliers)
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    ok = (n_in >= min_inlier_ratio * n_valid) & jnp.all(jnp.isfinite(T_final))
    return PnPResult(T_final, inliers, ok, n_in)
