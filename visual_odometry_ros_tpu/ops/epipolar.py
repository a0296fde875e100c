"""Epipolar geometry: essential-matrix estimation (batched RANSAC + 8-point),
decomposition with chirality vote, Sampson/symmetric distances, 1-point
histogram motion (planar).

Capability parity with the reference `MotionEstimator`'s geometry stack
(core/visual_odometry/motion_estimator.cpp):
  - `calcPose5PointsAlgorithm` (:21-123) — cv::findEssentialMat RANSAC + SVD +
    chirality vote via triangulation (`findCorrectRT`, :205-263). Here: batched
    fixed-hypothesis-count 8-point RANSAC (the reference itself ships an
    8-point least-squares refiner, :265-469, which we use as the minimal and
    the refinement solver — Nister's 5-point polynomial is hostile to SPMD).
  - essential refinement via IRLS with Sampson weights (:300-469)
  - Sampson / symmetric epipolar distances (:539-653)
  - `calcPoseOnePointHistogram` steering-angle vote (:471-537)

Batched design: hypotheses are a fixed [K]-batch; each 8-point solve is the
smallest eigenvector of a 9x9 normal matrix (batched eigh); scoring is one
[K, N] fused Sampson evaluation; selection is an argmax. No data-dependent
shapes anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import geometry as geo
from .triangulate import triangulate

_HI = jax.lax.Precision.HIGHEST


def _to_homog(xn: jax.Array) -> jax.Array:
    return jnp.concatenate([xn, jnp.ones_like(xn[..., :1])], axis=-1)


def sampson_distance(E: jax.Array, xn0: jax.Array, xn1: jax.Array) -> jax.Array:
    """Squared Sampson distance in normalized coords. E: [..., 3, 3];
    xn0/xn1: [N, 2]. Broadcasts E batch dims against N."""
    x0 = _to_homog(xn0)
    x1 = _to_homog(xn1)
    Ex0 = jnp.einsum("...ij,nj->...ni", E, x0, precision=_HI)
    Etx1 = jnp.einsum("...ji,nj->...ni", E, x1, precision=_HI)
    x1Ex0 = jnp.einsum("ni,...ni->...n", x1, Ex0, precision=_HI)
    denom = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return (x1Ex0**2) / jnp.maximum(denom, 1e-12)


def symmetric_epipolar_distance(E: jax.Array, xn0: jax.Array, xn1: jax.Array) -> jax.Array:
    """Squared symmetric epipolar distance (reference :591-653)."""
    x0 = _to_homog(xn0)
    x1 = _to_homog(xn1)
    Ex0 = jnp.einsum("...ij,nj->...ni", E, x0, precision=_HI)
    Etx1 = jnp.einsum("...ji,nj->...ni", E, x1, precision=_HI)
    x1Ex0 = jnp.einsum("ni,...ni->...n", x1, Ex0, precision=_HI)
    d0 = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2
    d1 = Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return x1Ex0**2 * (1.0 / jnp.maximum(d0, 1e-12) + 1.0 / jnp.maximum(d1, 1e-12))


def _eight_point_normal(xn0: jax.Array, xn1: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted 8-point solve: smallest eigenvector of A^T W A (9x9).

    xn0/xn1: [..., N, 2]; w: [..., N]. Returns E [..., 3, 3] (unprojected).
    """
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    ones = jnp.ones_like(x0)
    A = jnp.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )  # [..., N, 9]
    Aw = A * w[..., None]
    M = jnp.einsum("...ni,...nj->...ij", Aw, A, precision=_HI)  # [..., 9, 9]
    _, vecs = jnp.linalg.eigh(M)
    e = vecs[..., :, 0]  # smallest eigenvalue's eigenvector
    return e.reshape(e.shape[:-1] + (3, 3))


def _project_to_essential(E: jax.Array) -> jax.Array:
    """Nearest essential matrix: SVD, singular values -> (1, 1, 0)."""
    U, _, Vt = jnp.linalg.svd(E)
    d = jnp.asarray([1.0, 1.0, 0.0], E.dtype)
    return jnp.einsum("...ij,j,...jk->...ik", U, d, Vt, precision=_HI)


def decompose_essential(E: jax.Array):
    """E -> (R_a, R_b, t): the four (R, t+-) candidates (Hartley-Zisserman)."""
    U, _, Vt = jnp.linalg.svd(E)
    # Enforce proper rotations.
    detU = jnp.linalg.det(U)
    detVt = jnp.linalg.det(Vt)
    U = U * jnp.where(detU < 0, -1.0, 1.0)
    Vt = Vt * jnp.where(detVt < 0, -1.0, 1.0)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., :, 2]
    return Ra, Rb, t


def chirality_vote(Ra, Rb, t, xn0, xn1, valid):
    """Pick the (R, t) with the most points in front of both cameras
    (reference findCorrectRT, motion_estimator.cpp:205-263). Returns (R, t, votes)."""
    cands_R = jnp.stack([Ra, Ra, Rb, Rb])
    cands_t = jnp.stack([t, -t, t, -t])

    def count(Rt):
        R, tt = Rt
        T10 = geo.rt_to_se3(R, tt)
        X0, X1 = triangulate(xn0, xn1, T10)
        ok = (X0[..., 2] > 0) & (X1[..., 2] > 0) & valid
        return jnp.sum(ok)

    votes = jax.vmap(count)((cands_R, cands_t))
    best = jnp.argmax(votes)
    return cands_R[best], cands_t[best], votes[best]


class EssentialResult(NamedTuple):
    E: jax.Array  # [3, 3]
    R_10: jax.Array  # [3, 3] rotation of frame0 in frame1
    t_10: jax.Array  # [3] unit translation
    inliers: jax.Array  # [N] bool
    ok: jax.Array  # scalar bool
    n_inliers: jax.Array


@partial(jax.jit, static_argnames=("n_hypotheses", "refine_iters"))
def estimate_essential_ransac(
    xn0: jax.Array,
    xn1: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    thresh_px: float = 1.0,
    focal: float = 700.0,
    n_hypotheses: int = 256,
    refine_iters: int = 5,
    min_inliers: int = 30,
) -> EssentialResult:
    """Fixed-size batched RANSAC: K 8-point hypotheses -> Sampson score ->
    best -> IRLS refinement on inliers -> decomposition + chirality.

    thresh_px is converted to normalized-coordinate units via `focal` (the
    reference passes pixel thresholds to cv::findEssentialMat the same way).
    """
    N = xn0.shape[0]
    K = n_hypotheses
    thresh = (thresh_px / focal) ** 2  # squared, normalized units

    # Sample 8 valid indices per hypothesis: weight valid lanes.
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(key, logits[None, :], shape=(K, 8))  # [K, 8]
    s0 = xn0[idx]  # [K, 8, 2]
    s1 = xn1[idx]
    w8 = jnp.ones((K, 8), jnp.float32)

    E_raw = _eight_point_normal(s0, s1, w8)  # [K, 3, 3]
    E_h = _project_to_essential(E_raw)
    d = sampson_distance(E_h, xn0, xn1)  # [K, N]
    inlier_mat = (d < thresh) & valid[None, :]
    scores = jnp.sum(inlier_mat, axis=1)

    # LO-RANSAC-style multi-start refinement: a single best hypothesis can be
    # a biased local minimum whose gated refit never escapes — iterated hard-
    # inlier least squares (tightening gate 4x -> 2x -> 1x) from the top-k
    # seeds in parallel, then pick the best refined model globally.
    TOPK = 8
    _, top_idx = jax.lax.top_k(scores, TOPK)
    E_seeds = E_h[top_idx]  # [TOPK, 3, 3]

    def refine(i, E):  # E: [TOPK, 3, 3]
        c = jnp.maximum(4.0 / (2.0 ** i.astype(jnp.float32)), 1.0)
        dd = sampson_distance(E, xn0, xn1)  # [TOPK, N]
        w = ((dd < c * thresh) & valid[None, :]).astype(jnp.float32)
        E_new = _project_to_essential(_eight_point_normal(xn0[None], xn1[None], w))
        # Per-seed: keep the refit only if it does not lose inliers.
        n_old = jnp.sum((dd < thresh) & valid[None, :], axis=1)
        d_new = sampson_distance(E_new, xn0, xn1)
        n_new = jnp.sum((d_new < thresh) & valid[None, :], axis=1)
        return jnp.where((n_new >= n_old)[:, None, None], E_new, E)

    E_ref_all = jax.lax.fori_loop(0, refine_iters + 2, refine, E_seeds)
    d_all = sampson_distance(E_ref_all, xn0, xn1)
    n_all = jnp.sum((d_all < thresh) & valid[None, :], axis=1)
    best = jnp.argmax(n_all)
    E_ref = E_ref_all[best]
    inliers = (d_all[best] < thresh) & valid
    n_in = n_all[best]

    Ra, Rb, t = decompose_essential(E_ref)
    R, tt, votes = chirality_vote(Ra, Rb, t, xn0, xn1, inliers)
    ok = (n_in >= min_inliers) & (votes > 0.6 * jnp.maximum(n_in, 1))
    return EssentialResult(E_ref, R, tt, inliers, ok, n_in)


@partial(jax.jit, static_argnames=("bins",))
def steering_angle_histogram(xn0: jax.Array, xn1: jax.Array, valid: jax.Array, bins: int = 400):
    """1-point steering-angle vote for planar motion (reference
    calcPoseOnePointHistogram, :471-537): per-pair angle
    -2*atan((x0*y1 - y0*x1) / (y0 + y1)), histogram median."""
    from ..utils.robust import masked_median_histogram

    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]
    denom = y0 + y1
    # Plain atan of the ratio (reference :500-502) — NOT atan2: the denominator's
    # sign must fold into the ratio, else pairs with y0+y1<0 vote near +/-pi.
    psi = -2.0 * jnp.arctan((x0 * y1 - y0 * x1) / jnp.where(jnp.abs(denom) < 1e-9, 1e-9, denom))
    med = masked_median_histogram(psi, valid, -0.5, 0.5, bins)
    return med, psi


def essential_from_rt(R_10: jax.Array, t_10: jax.Array) -> jax.Array:
    """E = [t]x R for inlier gating after a known motion."""
    return geo.skew(t_10) @ R_10


def symmetric_epipolar_distance_px(
    F: jax.Array, pts0: jax.Array, pts1: jax.Array
) -> jax.Array:
    """Un-squared symmetric epipolar distance in PIXEL units, the reference's
    calcSymmetricEpipolarDistance (motion_estimator.cpp:621-653):
    |p1^T F p0| * (1/||(Fp0)_xy|| + 1/||(F^T p1)_xy||). F: [3,3] fundamental;
    pts0/pts1: [N, 2] pixels."""
    p0 = _to_homog(pts0)
    p1 = _to_homog(pts1)
    Fp0 = jnp.einsum("ij,nj->ni", F, p0, precision=_HI)
    Ftp1 = jnp.einsum("ji,nj->ni", F, p1, precision=_HI)
    num = jnp.abs(jnp.einsum("ni,ni->n", p1, Fp0, precision=_HI))
    n0 = jnp.sqrt(jnp.maximum(Fp0[:, 0] ** 2 + Fp0[:, 1] ** 2, 1e-24))
    n1 = jnp.sqrt(jnp.maximum(Ftp1[:, 0] ** 2 + Ftp1[:, 1] ** 2, 1e-24))
    return num * (1.0 / n0 + 1.0 / n1)


class OnePointResult(NamedTuple):
    theta: jax.Array  # [] median steering angle (rad)
    R_10: jax.Array  # [3, 3] yaw-about-y rotation
    t_10: jax.Array  # [3] unit translation on the circular arc
    inliers: jax.Array  # [N] bool
    n_inliers: jax.Array  # [] int32


@partial(jax.jit, static_argnames=("bins",))
def one_point_pose(
    pts0: jax.Array,
    pts1: jax.Array,
    valid: jax.Array,
    fx,
    fy,
    cx,
    cy,
    thres_px: float = 15.0,
    bins: int = 400,
):
    """Full 1-point planar-motion estimate + inlier gate, parity with the
    reference findInliers1PointHistogram (motion_estimator.cpp:471-537):
    per-pair steering angle -2*atan((x0 y1 - y0 x1)/(y0 + y1)) in normalized
    coords, 400-bin histogram median theta, circular-arc motion model
    R = R_y(theta), t = [sin(theta/2), 0, cos(theta/2)], then un-squared
    symmetric epipolar distance in pixels gated at thres_px^2 (the reference
    squares its threshold, :527).

    pts0/pts1: [N, 2] pixels. Everything fixed-shape; the histogram vote is a
    one-hot [N, bins] contraction (scatter-free)."""
    xn0 = jnp.stack([(pts0[:, 0] - cx) / fx, (pts0[:, 1] - cy) / fy], -1)
    xn1 = jnp.stack([(pts1[:, 0] - cx) / fx, (pts1[:, 1] - cy) / fy], -1)
    theta, _ = steering_angle_histogram(xn0, xn1, valid, bins=bins)

    c, s = jnp.cos(theta), jnp.sin(theta)
    R_10 = jnp.array(
        [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=pts0.dtype
    )
    t_10 = jnp.array(
        [jnp.sin(theta * 0.5), 0.0, jnp.cos(theta * 0.5)], dtype=pts0.dtype
    )
    E = essential_from_rt(R_10, t_10)
    Kinv = jnp.array(
        [[1.0 / fx, 0.0, -cx / fx], [0.0, 1.0 / fy, -cy / fy], [0.0, 0.0, 1.0]],
        dtype=pts0.dtype,
    )
    F = Kinv.T @ E @ Kinv
    d = symmetric_epipolar_distance_px(F, pts0, pts1)
    inliers = valid & (d <= thres_px * thres_px)
    return OnePointResult(theta, R_10, t_10, inliers, jnp.sum(inliers.astype(jnp.int32)))
