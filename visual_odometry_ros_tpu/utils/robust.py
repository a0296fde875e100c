"""Robust-estimation utilities: Huber weights, masked histograms/medians.

Parity targets: the reference's Huber-on-Manhattan weighting inside pose-only BA
(core/visual_odometry/motion_estimator.cpp:738-758) and the templated histogram/
median used by 1-point RANSAC (core/util/histogram.h:11-38, histogram.cpp).
Here everything is masked and fixed-shape so it lives inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def huber_weight(r_abs: jax.Array, delta: float) -> jax.Array:
    """w = 1 if |r| <= delta else delta/|r| (IRLS weight for Huber loss)."""
    return jnp.where(r_abs <= delta, 1.0, delta / jnp.maximum(r_abs, 1e-12))


def masked_histogram(values: jax.Array, mask: jax.Array, lo: float, hi: float, bins: int):
    """Fixed-bin histogram of masked values ([N] -> [bins]), jit-safe.
    One-hot sum instead of scatter-add (fuses cleanly; bins are few)."""
    idx = jnp.clip(((values - lo) / (hi - lo) * bins).astype(jnp.int32), 0, bins - 1)
    oh = idx[:, None] == jnp.arange(bins, dtype=jnp.int32)[None, :]
    return jnp.sum(oh & mask[:, None], axis=0).astype(jnp.float32)


def masked_median_histogram(values: jax.Array, mask: jax.Array, lo: float, hi: float, bins: int):
    """Approximate median via histogram CDF (medianHistogram analog).

    Returns the bin-center whose cumulative count first reaches half the total.
    Matches the reference 1-point RANSAC's 400-bin median steering-angle vote
    (motion_estimator.cpp:491-506).
    """
    hist = masked_histogram(values, mask, lo, hi, bins)
    total = jnp.sum(hist)
    cdf = jnp.cumsum(hist)
    med_bin = jnp.argmax(cdf >= 0.5 * total)
    width = (hi - lo) / bins
    return lo + (med_bin.astype(jnp.float32) + 0.5) * width


def masked_mean(values: jax.Array, mask: jax.Array, axis=None):
    m = mask.astype(values.dtype)
    return jnp.sum(values * m, axis=axis) / jnp.maximum(jnp.sum(m, axis=axis), 1.0)
