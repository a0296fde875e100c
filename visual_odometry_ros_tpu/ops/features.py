"""Feature detection, bucketed selection, ORB descriptors, Hamming matching.

Capability parity with the reference `FeatureExtractor`
(core/visual_odometry/feature_extractor.{h,cpp}):
  - ORB keypoint detection w/ Harris scoring (params feature_extractor.cpp:49-57)
  - `WeightBin` spatial bucketing: u x v grid, bins containing live features
    suppressed, one winner per empty bin (feature_extractor.h:58-142,
    extractORBwithBinning_fast feature_extractor.cpp:211-318)
  - `extractAndComputeORB` descriptors (:321-332)
  - `descriptorDistance` 256-bit Hamming popcount (:338-357)

Batched design: FAST-9/16 is evaluated for every pixel at once with 16
rolled images and a bit-trick contiguous-arc test; corners are re-scored with
a Harris response (ORB's HARRIS_SCORE mode); the per-bin argmax is one
reshape + max-reduce (the reference's per-bin scalar scan at
feature_extractor.cpp:244-281 becomes a segment max). Descriptors are rotated
BRIEF-256 over a shared pattern — batched gathers + bit packing; distances are
XOR + population_count.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .pyramid import box_filter, scharr_gradients
from ..utils.interp import bilinear_sample

# ----------------------------------------------------------------------------
# FAST-9/16 corner mask (whole image, vectorized)
# ----------------------------------------------------------------------------

# Bresenham circle of radius 3 (the FAST-16 ring), clockwise.
_FAST_RING = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def fast_corner_mask(img: jax.Array, thresh: float = 20.0) -> jax.Array:
    """Boolean FAST-9/16 corner mask, same shape as img.

    For every pixel: >=9 contiguous ring pixels all brighter than I+t or all
    darker than I-t. The contiguity test runs in bit-parallel: pack the 16
    ring comparisons into a uint32, duplicate to 32 bits, AND of shifted
    copies detects a 9-run.
    """
    shifted = []
    for du, dv in _FAST_RING:
        shifted.append(jnp.roll(img, shift=(-int(dv), -int(du)), axis=(0, 1)))
    ring = jnp.stack(shifted)  # [16, H, W]

    hi = img + thresh
    lo = img - thresh

    def arc9(mask16: jax.Array) -> jax.Array:
        bits = jnp.zeros(img.shape, jnp.uint32)
        for i in range(16):
            bits = bits | (mask16[i].astype(jnp.uint32) << i)
        m = bits | (bits << 16)
        a = m & (m >> 1)
        b = a & (a >> 2)
        c = b & (b >> 4)
        d = c & (m >> 8)  # 9 consecutive
        return (d & jnp.uint32(0xFFFF)) != 0

    bright = arc9(ring > hi[None])
    dark = arc9(ring < lo[None])
    return bright | dark


# ----------------------------------------------------------------------------
# Harris / Shi-Tomasi response
# ----------------------------------------------------------------------------


def harris_response(img: jax.Array, radius: int = 2, k: float = 0.04) -> jax.Array:
    gx, gy = scharr_gradients(img)
    sxx = box_filter(gx * gx, radius)
    sxy = box_filter(gx * gy, radius)
    syy = box_filter(gy * gy, radius)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def shi_tomasi_response(img: jax.Array, radius: int = 2) -> jax.Array:
    gx, gy = scharr_gradients(img)
    sxx = box_filter(gx * gx, radius)
    sxy = box_filter(gx * gy, radius)
    syy = box_filter(gy * gy, radius)
    tr = sxx + syy
    dd = jnp.sqrt(jnp.maximum((sxx - syy) ** 2 + 4.0 * sxy * sxy, 0.0))
    return 0.5 * (tr - dd)


# ----------------------------------------------------------------------------
# Bucketed selection (WeightBin analog)
# ----------------------------------------------------------------------------


def occupancy_grid(pts: jax.Array, valid: jax.Array, H: int, W: int, gh: int, gw: int) -> jax.Array:
    """[gh, gw] count of live features per bin (WeightBin update,
    feature_extractor.h:96-141). One-hot contraction instead of scatter-add
    (fuses cleanly; bins are few)."""
    bu = jnp.clip((pts[:, 0] / (W / gw)).astype(jnp.int32), 0, gw - 1)
    bv = jnp.clip((pts[:, 1] / (H / gh)).astype(jnp.int32), 0, gh - 1)
    flat = bv * gw + bu
    oh = flat[:, None] == jnp.arange(gh * gw, dtype=jnp.int32)[None, :]  # [N, B]
    counts = jnp.sum(oh & valid[:, None], axis=0, dtype=jnp.int32)
    return counts.reshape(gh, gw)


@partial(jax.jit, static_argnames=("gh", "gw", "n_max", "border"))
def select_grid_features(
    score: jax.Array,
    occupied: jax.Array,
    gh: int,
    gw: int,
    n_max: int,
    score_min: float = 1.0,
    border: int = 8,
):
    """Pick at most one best-scoring corner per empty bin; return the global
    top-n_max as fixed-size arrays.

    score: [H, W] corner response, already masked (non-corners = -inf/0).
    occupied: [gh, gw] bool — bins with live features are skipped
    (reference weight=0 rule).
    Returns (pts [n_max, 2] float32, valid [n_max] bool).
    """
    H, W = score.shape
    # Pad to bin multiples.
    bh = -(-H // gh)
    bw = -(-W // gw)
    pad_h = bh * gh - H
    pad_w = bw * gw - W
    s = jnp.pad(score, ((0, pad_h), (0, pad_w)), constant_values=-jnp.inf)
    # Kill borders.
    uu = jax.lax.broadcasted_iota(jnp.int32, s.shape, 1)
    vv = jax.lax.broadcasted_iota(jnp.int32, s.shape, 0)
    s = jnp.where((uu < border) | (vv < border) | (uu >= W - border) | (vv >= H - border), -jnp.inf, s)

    blocks = s.reshape(gh, bh, gw, bw).transpose(0, 2, 1, 3).reshape(gh * gw, bh * bw)
    best = jnp.max(blocks, axis=1)
    arg = jnp.argmax(blocks, axis=1)
    bin_v = arg // bw
    bin_u = arg % bw
    gi = jnp.arange(gh * gw, dtype=jnp.int32)
    u = (gi % gw) * bw + bin_u
    v = (gi // gw) * bh + bin_v

    ok = (best > score_min) & (~occupied.reshape(-1))
    key = jnp.where(ok, best, -jnp.inf)
    if key.shape[0] < n_max:  # fewer bins than slots: pad with -inf lanes
        pad = n_max - key.shape[0]
        key = jnp.pad(key, (0, pad), constant_values=-jnp.inf)
        u = jnp.pad(u, (0, pad))
        v = jnp.pad(v, (0, pad))
    top_val, top_idx = jax.lax.top_k(key, n_max)
    pts = jnp.stack([u[top_idx].astype(jnp.float32), v[top_idx].astype(jnp.float32)], axis=-1)
    return pts, top_val > -jnp.inf


@partial(jax.jit, static_argnames=("gh", "gw", "n_max", "border"))
def detect_features(
    img: jax.Array,
    prev_pts: jax.Array,
    prev_valid: jax.Array,
    gh: int = 8,
    gw: int = 16,
    n_max: int = 256,
    fast_thresh: float = 15.0,
    score_min: float = 100.0,
    border: int = 8,
):
    """FAST detection + Harris re-scoring + bucketing, suppressing bins that
    already hold live tracks (extractORBwithBinning_fast analog)."""
    corners = fast_corner_mask(img, fast_thresh)
    resp = harris_response(img)
    score = jnp.where(corners, resp, -jnp.inf)
    occ = occupancy_grid(prev_pts, prev_valid, img.shape[0], img.shape[1], gh, gw) > 0
    return select_grid_features(score, occ, gh, gw, n_max, score_min, border)


# ----------------------------------------------------------------------------
# ORB descriptors (rotated BRIEF-256) + Hamming matching
# ----------------------------------------------------------------------------

_rng = np.random.default_rng(12345)
# 256 point-pairs drawn from N(0, (patch/5)^2) clipped to the 31x31 patch —
# the classic BRIEF sampling law (descriptor is self-consistent within this
# framework; cross-library bit compatibility is not a goal).
_BRIEF_PAIRS = np.clip(_rng.normal(0.0, 6.2, size=(256, 2, 2)), -15, 15).astype(np.float32)

# Circular mask offsets for the intensity-centroid orientation (radius 15).
_yy, _xx = np.mgrid[-15:16, -15:16]
_circ = (_xx**2 + _yy**2) <= 15**2
_CENT_OFF = np.stack([_xx[_circ], _yy[_circ]], axis=-1).astype(np.float32)  # [P, 2]


@jax.jit
def orb_orientation(img: jax.Array, pts: jax.Array) -> jax.Array:
    """Intensity-centroid orientation per keypoint (rad)."""
    off = jnp.asarray(_CENT_OFF)
    samples, mask = bilinear_sample(img, pts[:, None, :] + off[None, :, :])
    w = samples * mask.astype(jnp.float32)
    m10 = jnp.sum(w * off[None, :, 0], axis=1)
    m01 = jnp.sum(w * off[None, :, 1], axis=1)
    return jnp.arctan2(m01, m10)


# Discretized rotated BRIEF patterns (real ORB does exactly this: the pattern
# is pre-rotated at 2pi/30 steps and looked up by quantized angle —
# ORB_impl pattern tables). 16 bins keeps the worst-case angular error
# (11.25 deg) well inside BRIEF's tolerance while making the slab pick
# indices COMPILE-TIME constants.
_N_ROT = 16
_SLAB_R = 22  # slab half-size: 15*sqrt(2) rotated pattern + round-off
_SLAB_S = 2 * _SLAB_R + 1


def _rotated_pair_indices():
    idx = np.zeros((_N_ROT, 2, 256, 2), np.int32)  # [bin, a/b, pair, (y, x)]
    for b in range(_N_ROT):
        th = 2.0 * np.pi * b / _N_ROT
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, -s], [s, c]], np.float32)
        for k in range(2):
            r = _BRIEF_PAIRS[:, k, :] @ R.T  # [256, 2] (x, y)
            xi = np.clip(np.round(r[:, 0]).astype(np.int32) + _SLAB_R, 0, _SLAB_S - 1)
            yi = np.clip(np.round(r[:, 1]).astype(np.int32) + _SLAB_R, 0, _SLAB_S - 1)
            idx[b, k, :, 0] = yi
            idx[b, k, :, 1] = xi
    return idx


_ROT_IDX = _rotated_pair_indices()
_CENT_W = np.zeros((_SLAB_S, _SLAB_S, 2), np.float32)  # centroid moment weights
_CENT_W[_SLAB_R - 15 : _SLAB_R + 16, _SLAB_R - 15 : _SLAB_R + 16, 0] = np.where(_circ, _xx, 0)
_CENT_W[_SLAB_R - 15 : _SLAB_R + 16, _SLAB_R - 15 : _SLAB_R + 16, 1] = np.where(_circ, _yy, 0)


@jax.jit
def orb_descriptors(img: jax.Array, pts: jax.Array):
    """[N, 8] uint32 packed 256-bit rotated-BRIEF descriptors + validity.

    Layout: ONE contiguous slab per feature via vmapped
    dynamic_slice; the intensity-centroid orientation is a masked reduction
    over the slab, and the rotation is a quantized-angle LOOKUP into
    pre-rotated integer pattern tables (exactly how reference ORB rotates
    its pattern) — so every pick is a compile-time-constant index. Slab
    loads versus plain gathers on the GPU is an open measurement."""
    H, W = img.shape
    imgp = jnp.pad(img, ((_SLAB_R, _SLAB_R + 1), (_SLAB_R, _SLAB_R + 1)))
    ai = jnp.round(pts).astype(jnp.int32)  # integer center (subpixel irrelevant)
    ay = jnp.clip(ai[:, 1], 0, H - 1)  # + _SLAB_R pad - _SLAB_R offset
    ax = jnp.clip(ai[:, 0], 0, W - 1)
    slab = jax.vmap(
        lambda y, x: jax.lax.dynamic_slice(imgp, (y, x), (_SLAB_S, _SLAB_S))
    )(ay, ax)  # [N, S, S] centered at the feature

    # Orientation: moments as one reduction against constant weight maps.
    cw = jnp.asarray(_CENT_W)
    m10 = jnp.einsum("nyx,yx->n", slab, cw[..., 0])
    m01 = jnp.einsum("nyx,yx->n", slab, cw[..., 1])
    theta = jnp.arctan2(m01, m10)
    bin_f = jnp.round(theta / (2.0 * jnp.pi) * _N_ROT).astype(jnp.int32) % _N_ROT

    # All rotation variants from constant indices, then per-feature select.
    flat = slab.reshape(slab.shape[0], -1)  # [N, S*S]
    ridx = _ROT_IDX[..., 0] * _SLAB_S + _ROT_IDX[..., 1]  # [B, 2, 256]
    Ia = flat[:, jnp.asarray(ridx[:, 0].reshape(-1))].reshape(-1, _N_ROT, 256)
    Ib = flat[:, jnp.asarray(ridx[:, 1].reshape(-1))].reshape(-1, _N_ROT, 256)
    bits_all = Ia < Ib  # [N, B, 256]
    sel = bin_f[:, None] == jnp.arange(_N_ROT, dtype=jnp.int32)[None, :]
    bits = jnp.any(bits_all & sel[:, :, None], axis=1).astype(jnp.uint32)  # [N, 256]

    words = bits.reshape(pts.shape[0], 8, 32)
    packed = jnp.sum(
        words << jnp.arange(32, dtype=jnp.uint32)[None, None, :], axis=-1, dtype=jnp.uint32
    )
    # Valid = full pattern support inside the image (zero-padded slabs would
    # bias bits near the border).
    valid = (
        (pts[:, 0] >= _SLAB_R)
        & (pts[:, 0] < W - _SLAB_R)
        & (pts[:, 1] >= _SLAB_R)
        & (pts[:, 1] < H - _SLAB_R)
    )
    return packed, valid


def desc_to_u8(packed: jax.Array) -> jax.Array:
    """[N, 8] uint32 packed descriptors -> [N, 32] int32 bytes.

    Byte layout is little-endian per word; Hamming distance is invariant to
    the repack. uint8 storage exists so the arena's one-hot-einsum scatter
    (float32 contraction) stays exact — uint32 words would be rounded."""
    shifts = jnp.arange(4, dtype=jnp.uint32) * 8
    b = (packed[..., None] >> shifts[None, None, :]) & jnp.uint32(0xFF)
    return b.reshape(packed.shape[0], 32).astype(jnp.int32)


@jax.jit
def hamming_distance_matrix(da: jax.Array, db: jax.Array) -> jax.Array:
    """[N, 8] x [M, 8] uint32 -> [N, M] int32 Hamming distances
    (descriptorDistance analog, elementwise popcount)."""
    x = da[:, None, :] ^ db[None, :, :]
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


@jax.jit
def match_descriptors(
    da: jax.Array,
    va: jax.Array,
    db: jax.Array,
    vb: jax.Array,
    max_dist: int = 64,
    ratio: float = 0.9,
):
    """Mutual nearest-neighbor Hamming matching with Lowe ratio test.

    Returns (idx_b [N] int32 — match in b for each a, or -1; mask [N]).
    """
    d = hamming_distance_matrix(da, db)
    big = jnp.int32(10_000)
    d = jnp.where(va[:, None] & vb[None, :], d, big)
    best = jnp.argmin(d, axis=1)
    best_d = jnp.min(d, axis=1)
    # second best for ratio test (mask arithmetic, no multi-index scatter)
    is_best = jnp.arange(d.shape[1])[None, :] == best[:, None]
    second_d = jnp.min(jnp.where(is_best, big, d), axis=1)
    # mutual check
    best_rev = jnp.argmin(d, axis=0)
    mutual = best_rev[best] == jnp.arange(d.shape[0])
    ok = (best_d <= max_dist) & (best_d.astype(jnp.float32) < ratio * second_d.astype(jnp.float32)) & mutual & va
    return jnp.where(ok, best, -1), ok
