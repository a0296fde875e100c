"""Pyramidal Lucas-Kanade feature tracking — batched over all features at once.

Capability parity with the reference `FeatureTracker`
(core/visual_odometry/feature_tracker.{h,cpp}):
  - `track` / `trackWithPrior` (forward pyramidal KLT, prior-seeded;
    feature_tracker.cpp:13-37, :171-206)
  - `trackBidirection[WithPrior]` (forward+backward with fb-distance gate,
    :39-169)
  - `trackWithScale` (inverse-compositional KLT on a checkerboard-subsampled
    patch scaled by predicted depth ratio; :236-504)
  - `calcPrior` (project landmarks through a pose prior; :208-234)

Design notes (batched, not a port):
  - The per-feature scalar loops become one [N, P] tensor program: P patch
    samples for all N features gathered at once, 2x2 normal equations solved
    closed-form, iterations as `lax.fori_loop` with masked (converged) lanes.
  - Template gradients (from I0) give a constant per-feature 2x2 Hessian —
    the inverse-compositional trick the reference derives at
    feature_tracker.cpp:240-281 — so the loop body is one gather + fused
    elementwise reductions.
  - Everything is static-shape: dead features ride along masked.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.interp import bilinear_sample
from .pyramid import build_pyramid_with_gradients


class KLTParams(NamedTuple):
    window_radius: int = 10  # 21x21 window (OpenCV default for VO)
    levels: int = 4
    iters: int = 12
    eps: float = 0.03  # convergence |delta| in px
    min_eig: float = 1e-4  # min-eigenvalue gate (per-pixel normalized)
    max_err: float = 30.0  # mean abs intensity error gate (reference err gate 30)
    fb_thresh: float = 1.0  # bidirectional consistency gate, px
    border: float = 3.0
    # Iteration budget for non-finest levels (0 = same as `iters`). Prior-
    # seeded tracks start within ~1-2 px at level 0, i.e. fractions of a
    # pixel at coarse levels, where GN converges in a handful of steps —
    # full budgets there buy nothing but wall time (kernel cost is linear
    # in the trip count; converged lanes are masked, not retired).
    iters_coarse: int = 0


def _patch_offsets(radius: int, checkerboard: bool = False) -> jax.Array:
    # Built in NumPy so the shape is static regardless of trace context.
    import numpy as np

    r = np.arange(-radius, radius + 1, dtype=np.float32)
    ou, ov = np.meshgrid(r, r)
    off = np.stack([ou.reshape(-1), ov.reshape(-1)], axis=-1)  # [P, 2]
    if checkerboard:
        off = off[::2]
    return jnp.asarray(off)


def _track_one_level(img0, gx0, gy0, img1, p0, p1_init, valid, offsets, iters, eps, min_eig,
                     epi1d=False):
    """One pyramid level of batched IC-KLT.

    img0/gx0/gy0/img1: [H, W]; p0, p1_init: [N, 2]; offsets: [P, 2].
    epi1d=True constrains the GN update to the x axis (rectified-stereo
    epipolar search: dy is structurally zero, so solve the 1-D normal
    equation du = b_x / g_xx — repeated texture can no longer drag the
    match off-row). Returns (p1 [N, 2], valid [N], err [N]).
    """
    pts0 = p0[:, None, :] + offsets[None, :, :]  # [N, P, 2]
    T, m0 = bilinear_sample(img0, pts0)
    gx, _ = bilinear_sample(gx0, pts0)
    gy, _ = bilinear_sample(gy0, pts0)
    w0 = m0.astype(jnp.float32)

    gxx = jnp.sum(gx * gx * w0, axis=1)
    gxy = jnp.sum(gx * gy * w0, axis=1)
    gyy = jnp.sum(gy * gy * w0, axis=1)
    npix = jnp.maximum(jnp.sum(w0, axis=1), 1.0)

    if epi1d:
        # 1-D conditioning: only the x-gradient energy matters.
        eig_ok = gxx / npix > min_eig
        inv_gxx = 1.0 / jnp.where(gxx < 1e-12, 1e-12, gxx)
    else:
        # min eigenvalue of [[gxx, gxy], [gxy, gyy]] / npix
        tr = gxx + gyy
        dd = jnp.sqrt(jnp.maximum((gxx - gyy) ** 2 + 4.0 * gxy * gxy, 0.0))
        lam_min = 0.5 * (tr - dd) / npix
        eig_ok = lam_min > min_eig

    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    live = valid & eig_ok

    def body(_, carry):
        p1, conv = carry
        pts1 = p1[:, None, :] + offsets[None, :, :]
        I1p, m1 = bilinear_sample(img1, pts1)
        w = w0 * m1.astype(jnp.float32)
        e = (T - I1p) * w
        bx = jnp.sum(gx * e, axis=1)
        by = jnp.sum(gy * e, axis=1)
        if epi1d:
            du = bx * inv_gxx
            dv = jnp.zeros_like(du)
        else:
            du = (gyy * bx - gxy * by) * inv_det
            dv = (gxx * by - gxy * bx) * inv_det
        step = jnp.stack([du, dv], axis=-1)
        active = (live & ~conv)[:, None]
        p1 = p1 + jnp.where(active, step, 0.0)
        conv = conv | (jnp.sum(step * step, axis=-1) < eps * eps)
        return p1, conv

    p1, _ = jax.lax.fori_loop(0, iters, body, (p1_init, jnp.zeros(p0.shape[0], bool)))

    # Final residual for the error gate.
    I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offsets[None, :, :])
    w = w0 * m1.astype(jnp.float32)
    err = jnp.sum(jnp.abs(T - I1p) * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    return p1, live, err


def _pyr_track(pyr0, pyr1, p0, p1_init, valid, params: KLTParams, track_levels: int | None = None,
               epi1d: bool = False):
    """Coarse-to-fine track: p0 (level 0 coords) -> p1 estimate.

    track_levels limits the climb to the finest `track_levels` levels —
    prior-seeded passes (projected landmarks, stereo disparity, backward
    consistency checks) start within a pixel or two of the answer and don't
    need the coarse levels at all."""
    offsets = _patch_offsets(params.window_radius)
    L = min(params.levels, track_levels) if track_levels else params.levels
    scale = 2.0 ** (L - 1)
    p1 = p1_init / scale
    live = valid
    err = jnp.zeros(p0.shape[0], jnp.float32)
    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        img0, gx0, gy0 = pyr0[lvl]
        img1 = pyr1[lvl][0]
        lvl_iters = params.iters if lvl == 0 else (params.iters_coarse or params.iters)
        p1, live, err = _track_one_level(
            img0,
            gx0,
            gy0,
            img1,
            p0 / s,
            p1,
            live,
            offsets,
            lvl_iters,
            params.eps,
            params.min_eig,
            epi1d=epi1d,
        )
        if lvl > 0:
            p1 = p1 * 2.0
    return p1, live, err


def _in_border(p, shape, border):
    H, W = shape
    return (p[..., 0] >= border) & (p[..., 1] >= border) & (p[..., 0] < W - border) & (p[..., 1] < H - border)


@partial(jax.jit, static_argnames=("params",))
def track(img0: jax.Array, img1: jax.Array, p0: jax.Array, valid: jax.Array, params: KLTParams = KLTParams()):
    """Forward pyramidal KLT (reference `track`, feature_tracker.cpp:13-37).

    Returns (p1 [N, 2], mask [N]).
    """
    return track_with_prior(img0, img1, p0, p0, valid, params)


@partial(jax.jit, static_argnames=("params",))
def track_with_prior(
    img0: jax.Array,
    img1: jax.Array,
    p0: jax.Array,
    p1_prior: jax.Array,
    valid: jax.Array,
    params: KLTParams = KLTParams(),
):
    """Prior-seeded forward KLT (reference `trackWithPrior`,
    feature_tracker.cpp:171-206; OPTFLOW_USE_INITIAL_FLOW semantics)."""
    pyr0 = build_pyramid_with_gradients(img0, params.levels)
    pyr1 = build_pyramid_with_gradients(img1, params.levels)
    return track_with_prior_pyr(pyr0, pyr1, p0, p1_prior, valid, params)


@partial(jax.jit, static_argnames=("params", "track_levels", "epi1d"))
def track_with_prior_pyr(
    pyr0,
    pyr1,
    p0: jax.Array,
    p1_prior: jax.Array,
    valid: jax.Array,
    params: KLTParams = KLTParams(),
    track_levels: int | None = None,
    epi1d: bool = False,
):
    """track_with_prior over prebuilt gradient pyramids (one pyramid build per
    image per frame; the pipelines cache the previous frame's pyramid).
    epi1d=True: rectified-stereo mode — the search is constrained to the
    epipolar row (x only)."""
    shape = pyr1[0][0].shape
    p1, live, err = _pyr_track(pyr0, pyr1, p0, p1_prior, valid, params, track_levels, epi1d=epi1d)
    ok = live & (err < params.max_err) & _in_border(p1, shape, params.border)
    return p1, ok


@partial(jax.jit, static_argnames=("params", "fb_scale"))
def track_bidirectional(
    img0: jax.Array,
    img1: jax.Array,
    p0: jax.Array,
    p1_prior: jax.Array,
    valid: jax.Array,
    params: KLTParams = KLTParams(),
    fb_scale: float = 1.0,
):
    """Forward + backward track with consistency gate (reference
    `trackBidirection[WithPrior]`, feature_tracker.cpp:39-169; the prior-seeded
    variant relaxes the fb gate 5x — pass fb_scale=5.0 for that behavior).

    Returns (p1 [N, 2], mask [N]).
    """
    pyr0 = build_pyramid_with_gradients(img0, params.levels)
    pyr1 = build_pyramid_with_gradients(img1, params.levels)
    return track_bidirectional_pyr(pyr0, pyr1, p0, p1_prior, valid, params, fb_scale)


@partial(jax.jit, static_argnames=("params", "fb_scale", "back_levels", "epi1d"))
def track_bidirectional_pyr(
    pyr0,
    pyr1,
    p0: jax.Array,
    p1_prior: jax.Array,
    valid: jax.Array,
    params: KLTParams = KLTParams(),
    fb_scale: float = 1.0,
    back_levels: int | None = None,
    epi1d: bool = False,
):
    """track_bidirectional over prebuilt gradient pyramids. back_levels
    restricts the backward consistency pass to the finest levels — it is
    seeded at the true answer (p0), so coarse levels add cost, not accuracy.
    epi1d=True constrains both passes to the epipolar row (rectified stereo)."""
    shape = pyr1[0][0].shape
    p1, live1, err1 = _pyr_track(pyr0, pyr1, p0, p1_prior, valid, params, epi1d=epi1d)
    p0b, live0, _ = _pyr_track(pyr1, pyr0, p1, p0, live1, params, back_levels, epi1d=epi1d)
    fb2 = jnp.sum((p0b - p0) ** 2, axis=-1)
    thr = (params.fb_thresh * fb_scale) ** 2
    ok = (
        live1
        & live0
        & (err1 < params.max_err)
        & (fb2 < thr)
        & _in_border(p1, shape, params.border)
    )
    return p1, ok


@partial(jax.jit, static_argnames=("radius", "iters"))
def track_with_scale(
    img0: jax.Array,
    du0: jax.Array,
    dv0: jax.Array,
    img1: jax.Array,
    p0: jax.Array,
    p1_init: jax.Array,
    scale_change: jax.Array,
    valid: jax.Array,
    radius: int = 11,
    iters: int = 30,
    max_err: float = 30.0,
):
    """Scale-compensated single-level IC-KLT refinement (reference
    `trackWithScale`, feature_tracker.cpp:236-504): a checkerboard-subsampled
    (2r+1)^2 template scaled per-feature by the predicted depth ratio, template
    Hessian precomputed from I0 gradients, <=`iters` damped GN steps, error
    gate 30 intensity levels.

    scale_change: [N] patch scale ratio (d_prev/d_curr per the reference prior).
    Returns (p1 [N, 2], mask [N]).
    """
    base_off = _patch_offsets(radius, checkerboard=True)  # [P, 2]
    offs = base_off[None, :, :] * scale_change[:, None, None]  # [N, P, 2]

    pts0 = p0[:, None, :] + offs
    T, m0 = bilinear_sample(img0, pts0)
    gx, _ = bilinear_sample(du0, pts0)
    gy, _ = bilinear_sample(dv0, pts0)
    w0 = m0.astype(jnp.float32)

    gxx = jnp.sum(gx * gx * w0, axis=1)
    gxy = jnp.sum(gx * gy * w0, axis=1)
    gyy = jnp.sum(gy * gy * w0, axis=1)
    det = gxx * gyy - gxy * gxy
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)

    def body(_, carry):
        p1, conv = carry
        I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offs)
        w = w0 * m1.astype(jnp.float32)
        e = (T - I1p) * w
        bx = jnp.sum(gx * e, axis=1)
        by = jnp.sum(gy * e, axis=1)
        du = (gyy * bx - gxy * by) * inv_det
        dv = (gxx * by - gxy * bx) * inv_det
        step = jnp.stack([du, dv], axis=-1)
        active = (valid & ~conv)[:, None]
        p1 = p1 + jnp.where(active, step, 0.0)
        conv = conv | (jnp.sum(step * step, axis=-1) < 1e-4)
        return p1, conv

    p1, _ = jax.lax.fori_loop(0, iters, body, (p1_init, jnp.zeros(p0.shape[0], bool)))

    I1p, m1 = bilinear_sample(img1, p1[:, None, :] + offs)
    w = w0 * m1.astype(jnp.float32)
    err = jnp.sum(jnp.abs(T - I1p) * w, axis=1) / jnp.maximum(jnp.sum(w, axis=1), 1.0)
    ok = valid & (err < max_err) & _in_border(p1, img1.shape, 3.0)
    return p1, ok


def calc_prior(Xw: jax.Array, T_cw_prior: jax.Array, fx, fy, cx, cy):
    """Project world landmarks through a pose prior to seed the tracker
    (reference `calcPrior`, feature_tracker.cpp:208-234)."""
    R = T_cw_prior[:3, :3]
    t = T_cw_prior[:3, 3]
    Xc = Xw @ R.T + t
    z = jnp.where(jnp.abs(Xc[..., 2]) < 1e-6, 1e-6, Xc[..., 2])
    u = Xc[..., 0] / z * fx + cx
    v = Xc[..., 1] / z * fy + cy
    return jnp.stack([u, v], axis=-1), Xc[..., 2]
