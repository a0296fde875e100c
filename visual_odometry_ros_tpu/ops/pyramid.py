"""Image pyramid + gradient kernels (jnp convs; XLA fuses these well).

Parity targets: OpenCV's buildOpticalFlowPyramid semantics used by the
reference FeatureTracker (core/visual_odometry/feature_tracker.cpp:13-37) and
the cv::Sobel du/dv feeding trackWithScale (stereo_vo.cpp:546-556). All shapes
static; levels is a Python int so each level is its own traced array.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# 5-tap binomial (Gaussian approx) used for pyramid antialiasing.
_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
# Scharr 3-tap pair: smoothing [3, 10, 3]/16 and central difference [-1, 0, 1]/2.
_SCHARR_S = np.array([3.0, 10.0, 3.0], np.float32) / 16.0
_SCHARR_D = np.array([-1.0, 0.0, 1.0], np.float32) * 0.5


def _sep_conv(img: jax.Array, kh, kw) -> jax.Array:
    """Separable 2D convolution with edge replication. img: [H, W].

    Implemented as shift-and-FMA over statically sliced views, which XLA
    fuses into about one elementwise pass over the image. Taps are Python
    floats so zero taps drop at trace time.
    """
    H, W = img.shape
    kh = np.asarray(kh).tolist()
    kw = np.asarray(kw).tolist()
    ph = len(kh) // 2
    pw = len(kw) // 2
    x = jnp.pad(img, ((ph, ph), (0, 0)), mode="edge")
    acc = None
    for i, w in enumerate(kh):
        if w == 0.0:
            continue
        t = x[i : i + H, :] * w
        acc = t if acc is None else acc + t
    x = jnp.pad(acc, ((0, 0), (pw, pw)), mode="edge")
    acc = None
    for j, w in enumerate(kw):
        if w == 0.0:
            continue
        t = x[:, j : j + W] * w
        acc = t if acc is None else acc + t
    return acc


def gaussian_blur5(img: jax.Array) -> jax.Array:
    return _sep_conv(img, _K5, _K5)


def _decim_blur_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Band matrix fusing the 5-tap binomial blur with stride-2 decimation
    (edge-replicated): out[i] = sum_k K5[k] * in[clip(2i + k - 2)]."""
    A = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    for k, w in enumerate(_K5):
        idx = np.clip(2 * rows + k - 2, 0, n_in - 1)
        np.add.at(A, (rows, idx), w)
    return A


_DECIM_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _decim(n_out: int, n_in: int) -> np.ndarray:
    key = (n_out, n_in)
    if key not in _DECIM_CACHE:
        _DECIM_CACHE[key] = _decim_blur_matrix(n_out, n_in)
    return _DECIM_CACHE[key]


def downsample2(img: jax.Array) -> jax.Array:
    """Blur + stride-2 decimation (one pyramid step).

    Expressed as two band-matrix matmuls (A_r @ img @ A_c^T). Equal to
    blur-then-[::2, ::2] up to f32 summation order (HIGHEST precision keeps
    the products in full f32, not TF32). Whether strided slices are faster
    on the GPU is an open measurement."""
    H, W = img.shape
    Ho, Wo = (H + 1) // 2, (W + 1) // 2
    Ar = jnp.asarray(_decim(Ho, H))
    Ac = jnp.asarray(_decim(Wo, W))
    t = jnp.matmul(Ar, img, precision=jax.lax.Precision.HIGHEST)
    return jnp.matmul(t, Ac.T, precision=jax.lax.Precision.HIGHEST)


def build_pyramid(img: jax.Array, levels: int) -> tuple[jax.Array, ...]:
    """Returns `levels` images, level 0 = full resolution."""
    out = [img.astype(jnp.float32)]
    for _ in range(levels - 1):
        out.append(downsample2(out[-1]))
    return tuple(out)


def scharr_gradients(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(d/du, d/dv) image gradients in intensity/pixel units."""
    gx = _sep_conv(img, _SCHARR_S, _SCHARR_D)
    gy = _sep_conv(img, _SCHARR_D, _SCHARR_S)
    return gx, gy


def build_pyramid_with_gradients(img: jax.Array, levels: int):
    """Pyramid plus per-level Scharr gradients: ((img, gx, gy), ...)."""
    pyr = build_pyramid(img, levels)
    return tuple((p, *scharr_gradients(p)) for p in pyr)


def box_filter(img: jax.Array, radius: int) -> jax.Array:
    k = np.ones((2 * radius + 1,), np.float32) / (2 * radius + 1)
    return _sep_conv(img, k, k)


def global_shift_zncc(prev: jax.Array, curr: jax.Array, radius: int = 8):
    """Dominant whole-image translation prev->curr by dense ZNCC over integer
    2-D shifts (run it on the COARSEST pyramid level and scale up).

    Purpose (r4): the frame-to-frame KLT fallback seed when no trusted
    velocity prior exists (pose blackout, post-re-bootstrap) used to be
    zero flow; on self-similar texture a seed a few px off locks every
    track onto a local alias and the pose never re-converges (the 137-
    frame fail run in the 200-frame hard sequence). Rotation — the
    dominant blackout drift — projects to a near-uniform image shift,
    exactly what this measures. Pure shifts + reductions.

    Returns (shift [2] float32 = (du, dv) in this level's pixels, score).
    """
    H, W = prev.shape
    # Central crop of prev compared against shifted crops of curr.
    cy, cx = radius, radius
    a = jax.lax.slice(prev, (cy, cx), (H - radius, W - radius))
    a = a - jnp.mean(a)
    ha, wa = a.shape
    an = jnp.sqrt(jnp.sum(a * a) + 1e-6)

    def score(dy, dx):
        b = jax.lax.slice(curr, (cy + dy, cx + dx), (cy + dy + ha, cx + dx + wa))
        b = b - jnp.mean(b)
        return jnp.sum(a * b) / (an * jnp.sqrt(jnp.sum(b * b) + 1e-6))

    shifts = [(dy, dx) for dy in range(-radius, radius + 1)
              for dx in range(-radius, radius + 1)]
    scores = jnp.stack([score(dy, dx) for dy, dx in shifts])
    best = jnp.argmax(scores)
    offs = jnp.asarray(shifts, jnp.float32)  # [(dy, dx)]
    return offs[best][::-1], scores[best]  # (du, dv)
