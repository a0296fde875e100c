"""Dense rectified-stereo ZNCC disparity with subpixel refinement + uncertainty.

Capability parity with the reference's legacy MATLAB prototypes
(legacy/matlab/stereoDisparityStatic.m / stereoDisparityTemporal.m): ZNCC
patch matching along the epipolar row, multi-peak rejection, parabolic
subpixel refinement, and inverse-depth standard deviation output — the
companion measurement model of the depth filter (SURVEY.md §2 'DepthFilter').

Batched design: the cost volume is D shifted whole-image ZNCC evaluations built
from box-filtered moment images (each disparity = a few fused elementwise
maps + separable box filters) — no per-pixel loops anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .pyramid import box_filter


class DisparityResult(NamedTuple):
    disparity: jax.Array  # [H, W] float32 subpixel disparity (px)
    valid: jax.Array  # [H, W] bool
    zncc: jax.Array  # [H, W] best-peak ZNCC score
    inv_depth_std: jax.Array  # [H, W] sigma of inverse depth (needs fx*b)
    ambiguous: jax.Array  # [H, W] bool — strong but NON-distinct peak
    # (repeated texture: the match is confidently multi-modal; distinct from
    # plain invalid = low texture / weak correlation, where the volume simply
    # has no opinion).


@partial(jax.jit, static_argnames=("max_disp", "radius"))
def zncc_disparity(
    left: jax.Array,
    right: jax.Array,
    max_disp: int = 64,
    radius: int = 4,
    min_zncc: float = 0.8,
    peak_margin: float = 0.05,
    fxb: float = 386.0,  # fx * baseline, for the inverse-depth sigma output
    px_noise: float = 0.5,
):
    """Dense disparity left->right. Returns DisparityResult.

    Multi-peak rejection: the best ZNCC must beat every score at least 2 px
    away by `peak_margin` (the MATLAB prototype's distinct-peak rule).
    """
    H, W = left.shape
    D = max_disp

    mu_l = box_filter(left, radius)
    var_l = box_filter(left * left, radius) - mu_l * mu_l

    mu_r = box_filter(right, radius)
    var_r = box_filter(right * right, radius) - mu_r * mu_r

    def score_at(d):
        right_s = jnp.roll(right, d, axis=1)  # right pixel (u - d) under left u
        mu_rs = jnp.roll(mu_r, d, axis=1)
        var_rs = jnp.roll(var_r, d, axis=1)
        cross = box_filter(left * right_s, radius) - mu_l * mu_rs
        denom = jnp.sqrt(jnp.maximum(var_l * var_rs, 1e-6))
        s = cross / denom
        # Columns that wrapped around are invalid.
        uu = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        return jnp.where(uu >= d, s, -1.0)

    scores = jnp.stack([score_at(d) for d in range(D)], axis=0)  # [D, H, W]

    best = jnp.argmax(scores, axis=0)  # [H, W]
    best_s = jnp.max(scores, axis=0)

    # Multi-peak rejection: suppress a +-2 disparity band around the winner,
    # then require the remaining maximum to be lower by peak_margin.
    dd = jax.lax.broadcasted_iota(jnp.int32, (D, H, W), 0)
    near = jnp.abs(dd - best[None]) <= 2
    second_s = jnp.max(jnp.where(near, -1.0, scores), axis=0)
    distinct = best_s > second_s + peak_margin

    # Parabolic subpixel refinement around the integer winner.
    def gather_d(offset):
        idx = jnp.clip(best + offset, 0, D - 1)
        return jnp.take_along_axis(scores, idx[None], axis=0)[0]

    s_m = gather_d(-1)
    s_0 = best_s
    s_p = gather_d(1)
    denom = jnp.maximum(s_m - 2.0 * s_0 + s_p, 1e-9)
    delta = jnp.clip(0.5 * (s_m - s_p) / -denom, -0.5, 0.5)
    disp = best.astype(jnp.float32) + jnp.where((best > 0) & (best < D - 1), delta, 0.0)

    textured = (best_s > min_zncc) & (var_l > 25.0)
    valid = distinct & textured & (best > 0) & (best < D - 1)
    # Ambiguous = the volume matched STRONGLY in more than one place (repeated
    # texture). This is positive evidence that any point match here aliases —
    # the consumer should veto landmark births. Low-texture / weak-correlation
    # pixels are merely invalid, not ambiguous: there the volume has no
    # opinion and point trackers may still succeed.
    ambiguous = textured & ~distinct
    disp = jnp.where(valid, disp, 0.0)

    # Inverse-depth sigma: rho = d / (fx b); sigma_rho = px_noise / (fx b).
    sigma_rho = jnp.full((H, W), px_noise / fxb, jnp.float32)
    return DisparityResult(
        disp, valid, best_s, jnp.where(valid, sigma_rho, jnp.inf), ambiguous
    )


def disparity_to_depth(res: DisparityResult, fxb: float):
    z = fxb / jnp.maximum(res.disparity, 1e-3)
    return jnp.where(res.valid, z, 0.0)


@partial(jax.jit, static_argnames=("radius", "span", "step"))
def verify_disparity_zncc(
    left: jax.Array,
    right: jax.Array,
    pts_l: jax.Array,
    disp: jax.Array,
    valid: jax.Array,
    radius: int = 4,
    span: int = 32,
    step: int = 1,
    min_zncc: float = 0.5,
    peak_margin: float = 0.03,
    agree_px: float = 1.5,
):
    """Full-resolution per-feature verification of a stereo KLT match.

    For each feature, ZNCC-scan the epipolar row in the right image over
    disparities `disp ± span` and test three things:
      1. the KLT match correlates (score at delta=0 > min_zncc);
      2. the in-window global best sits AT the KLT match (|delta*| <= agree_px);
      3. the profile is unimodal: no RIVAL LOCAL MAXIMUM more than 2 px from
         the best within peak_margin of its score.
    Smooth texture has a broad unimodal autocorrelation -> passes; repeated /
    self-similar texture (tiled facades, a corridor's vanishing region — the
    r4 birth-alias cluster at the horizon row, 18-46 px disparity errors) has
    multiple local maxima -> vetoed. This is the level-0 companion of the
    coarse cost volume's multi-peak rule (legacy/matlab/stereoDisparityStatic.m
    parity): the coarse map goes blind exactly where level-2 smoothing erases
    the texture; FAST features always have level-0 contrast, so a full-res
    hard gate cannot starve births the way the r3 coarse-level one did.

    Returns (ok [N] bool, best_score [N]).
    """
    del step  # the strip layout scans every integer delta in [-span, span]
    deltas = jnp.arange(-span, span + 1, dtype=jnp.float32)  # [D]

    from ..utils import interp

    # Slab loads, not point gathers: the naive per-(feature, delta) patch
    # gather is 1.4M scalar gathers, and the per-feature strip of pointwise
    # bilinear samples is still ~350k. Instead: pad once, pull ONE
    # contiguous (R+1) x (W_s+1) slab per feature via vmapped dynamic_slice,
    # and do the shared-fraction bilinear blend with four shifted slices —
    # whole-row memory traffic + pure vector math.
    H, W = right.shape
    R = 2 * radius + 1
    W_s = 2 * (span + radius) + 1
    pad_y, pad_x = radius + 2, span + radius + 2
    rightp = jnp.pad(right, ((pad_y, pad_y), (pad_x, pad_x)))
    leftp = jnp.pad(left, ((pad_y, pad_y), (pad_x, pad_x)))

    def slabs(imgp, y0f, x0f, rows_out, cols_out):
        """Bilinear [N, rows_out, cols_out] blocks anchored at float (y0f, x0f)
        in UNPADDED coords; shared per-feature fraction."""
        ay = jnp.floor(y0f)
        ax = jnp.floor(x0f)
        fy = (y0f - ay)[:, None, None]
        fx = (x0f - ax)[:, None, None]
        iy = jnp.clip(ay.astype(jnp.int32) + pad_y, 0, imgp.shape[0] - rows_out - 1)
        ix = jnp.clip(ax.astype(jnp.int32) + pad_x, 0, imgp.shape[1] - cols_out - 1)
        S = jax.vmap(
            lambda y, x: jax.lax.dynamic_slice(imgp, (y, x), (rows_out + 1, cols_out + 1))
        )(iy, ix)
        return (
            (1 - fy) * (1 - fx) * S[:, :-1, :-1]
            + (1 - fy) * fx * S[:, :-1, 1:]
            + fy * (1 - fx) * S[:, 1:, :-1]
            + fy * fx * S[:, 1:, 1:]
        )

    patch_l = slabs(
        leftp, pts_l[:, 1] - radius, pts_l[:, 0] - radius, R, R
    ).reshape(pts_l.shape[0], -1)  # [N, R*R]
    mask_l = (
        (pts_l[:, 0] >= radius + 1)
        & (pts_l[:, 0] <= W - radius - 2)
        & (pts_l[:, 1] >= radius + 1)
        & (pts_l[:, 1] <= H - radius - 2)
    )[:, None]
    strip = slabs(
        rightp,
        pts_l[:, 1] - radius,
        pts_l[:, 0] - disp - (span + radius),
        R,
        W_s,
    )  # [N, R, W_s]
    # Coordinate-based validity per strip column (zero-padded samples must
    # not enter the ZNCC): column j sits at u = pts_l - disp - span - radius + j.
    u_col = (
        pts_l[:, None, 0] - disp[:, None] - (span + radius)
        + jnp.arange(W_s, dtype=jnp.float32)[None, :]
    )
    col_ok = (u_col >= 0.0) & (u_col <= W - 1.0)  # [N, W_s]
    row_ok = (pts_l[:, 1] - radius >= 0.0) & (pts_l[:, 1] + radius <= H - 1.0)

    def score_of(delta):
        j0 = span - delta
        win = jax.lax.slice_in_dim(strip, j0, j0 + R, axis=2)
        m = jnp.all(jax.lax.slice_in_dim(col_ok, j0, j0 + R, axis=1), axis=-1)
        s = interp.zncc(patch_l, win.reshape(win.shape[0], -1), axis=-1)
        return jnp.where(m & row_ok, s, -1.0)

    scores = jnp.stack([score_of(d) for d in range(-span, span + 1)], axis=-1)  # [N, D]

    i0 = span  # index of delta = 0 (the KLT match)
    s_at = scores[:, i0]
    best_i = jnp.argmax(scores, axis=-1)
    best_d = deltas[best_i]
    best_s = jnp.max(scores, axis=-1)

    # Rival local maxima: strictly above left neighbour, >= right neighbour,
    # farther than 2 px from the best, within peak_margin of the best score.
    left_n = jnp.concatenate([jnp.full_like(scores[:, :1], -2.0), scores[:, :-1]], axis=1)
    right_n = jnp.concatenate([scores[:, 1:], jnp.full_like(scores[:, :1], -2.0)], axis=1)
    is_peak = (scores > left_n) & (scores >= right_n)
    far = jnp.abs(deltas[None, :] - best_d[:, None]) > 2.0
    rival = jnp.any(is_peak & far & (scores > best_s[:, None] - peak_margin), axis=-1)

    ok = (
        valid
        & jnp.all(mask_l, axis=-1)
        & (s_at > min_zncc)
        & (jnp.abs(best_d) <= agree_px)
        & ~rival
        # Clamp guard (r4 ADVICE): if the right-image anchor is far enough
        # off-image left that the dynamic_slice clamp shifted the strip,
        # col_ok's coordinate bookkeeping no longer matches the slab content
        # — such candidates must never pass regardless of upstream gates.
        & (pts_l[:, 0] - disp >= 0.0)
    )
    return ok, s_at
