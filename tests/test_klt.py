"""KLT tracking tests on synthetic textured images with known motion."""

import numpy as np
import jax.numpy as jnp

from visual_odometry_ros_tpu.ops import klt
from visual_odometry_ros_tpu.ops.pyramid import build_pyramid, scharr_gradients


def _textured_image(rng, H=240, W=320, smooth=3):
    """Smooth random texture with enough gradient everywhere."""
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(smooth) / smooth
    for _ in range(3):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
        img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img.astype(np.float32)


def _shift_image(img, dx, dy):
    """Bilinear shift: out(x) = img(x - d) so features move by +d."""
    H, W = img.shape
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    us, vs = uu - dx, vv - dy
    u0 = np.clip(np.floor(us).astype(int), 0, W - 2)
    v0 = np.clip(np.floor(vs).astype(int), 0, H - 2)
    fu, fv = us - u0, vs - v0
    out = (
        img[v0, u0] * (1 - fu) * (1 - fv)
        + img[v0, u0 + 1] * fu * (1 - fv)
        + img[v0 + 1, u0] * (1 - fu) * fv
        + img[v0 + 1, u0 + 1] * fu * fv
    )
    return out.astype(np.float32)


def _grid_points(H, W, margin=30, step=40):
    us = np.arange(margin, W - margin, step, dtype=np.float32)
    vs = np.arange(margin, H - margin, step, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs)
    return np.stack([uu.reshape(-1), vv.reshape(-1)], -1)


def test_track_small_shift(rng):
    img0 = _textured_image(rng)
    dx, dy = 3.3, -2.1
    img1 = _shift_image(img0, dx, dy)
    p0 = _grid_points(*img0.shape)
    valid = np.ones(len(p0), bool)
    params = klt.KLTParams(levels=3, iters=15)
    p1, ok = klt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(valid), params)
    p1, ok = np.asarray(p1), np.asarray(ok)
    assert ok.mean() > 0.8
    err = np.linalg.norm(p1[ok] - (p0[ok] + [dx, dy]), axis=-1)
    assert np.median(err) < 0.2


def test_track_large_shift_needs_pyramid(rng):
    img0 = _textured_image(rng, smooth=7)
    dx, dy = 14.0, 9.0
    img1 = _shift_image(img0, dx, dy)
    p0 = _grid_points(*img0.shape)
    valid = np.ones(len(p0), bool)
    params = klt.KLTParams(levels=4, iters=20)
    p1, ok = klt.track(jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(valid), params)
    p1, ok = np.asarray(p1), np.asarray(ok)
    assert ok.mean() > 0.6
    err = np.linalg.norm(p1[ok] - (p0[ok] + [dx, dy]), axis=-1)
    assert np.median(err) < 0.5


def test_track_with_prior_converges_fast(rng):
    img0 = _textured_image(rng)
    dx, dy = 22.0, -17.0
    img1 = _shift_image(img0, dx, dy)
    p0 = _grid_points(*img0.shape)
    prior = p0 + np.array([dx - 1.0, dy + 0.8], np.float32)
    valid = np.ones(len(p0), bool)
    params = klt.KLTParams(levels=2, iters=10)
    p1, ok = klt.track_with_prior(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(prior), jnp.asarray(valid), params
    )
    p1, ok = np.asarray(p1), np.asarray(ok)
    assert ok.mean() > 0.8
    err = np.linalg.norm(p1[ok] - (p0[ok] + [dx, dy]), axis=-1)
    assert np.median(err) < 0.2


def test_bidirectional_rejects_occluded(rng):
    img0 = _textured_image(rng)
    img1 = _shift_image(img0, 4.0, 1.0)
    # Corrupt a region of img1: tracks landing there should fail the fb check.
    img1[100:160, 100:180] = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    p0 = _grid_points(*img0.shape)
    valid = np.ones(len(p0), bool)
    p1, ok = klt.track_bidirectional(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p0), jnp.asarray(valid)
    )
    p1, ok = np.asarray(p1), np.asarray(ok)
    in_corrupt = (
        (p0[:, 0] + 4 > 100) & (p0[:, 0] + 4 < 180) & (p0[:, 1] + 1 > 100) & (p0[:, 1] + 1 < 160)
    )
    # Good tracks survive, corrupted-region tracks mostly rejected.
    assert ok[~in_corrupt].mean() > 0.7
    good = ok & ~in_corrupt
    err = np.linalg.norm(p1[good] - (p0[good] + [4.0, 1.0]), axis=-1)
    assert np.median(err) < 0.2


def test_track_with_scale(rng):
    img0 = _textured_image(rng)
    dx, dy = 2.5, -1.5
    img1 = _shift_image(img0, dx, dy)
    p0 = _grid_points(*img0.shape)
    valid = np.ones(len(p0), bool)
    gx, gy = scharr_gradients(jnp.asarray(img0))
    scale = np.ones(len(p0), np.float32)
    p1, ok = klt.track_with_scale(
        jnp.asarray(img0),
        gx,
        gy,
        jnp.asarray(img1),
        jnp.asarray(p0),
        jnp.asarray(p0),
        jnp.asarray(scale),
        jnp.asarray(valid),
    )
    p1, ok = np.asarray(p1), np.asarray(ok)
    assert ok.mean() > 0.8
    err = np.linalg.norm(p1[ok] - (p0[ok] + [dx, dy]), axis=-1)
    assert np.median(err) < 0.3


def test_pyramid_shapes(rng):
    img = jnp.asarray(_textured_image(rng, 128, 256))
    pyr = build_pyramid(img, 4)
    assert [p.shape for p in pyr] == [(128, 256), (64, 128), (32, 64), (16, 32)]


def _smooth_noise(H, W, seed=0, smooth=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    k = np.ones(2 * smooth + 1, np.float32) / (2 * smooth + 1)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, img)
    return img


def _grid_features(H, W, margin=20, n=6):
    us = np.linspace(margin, W - margin, n)
    vs = np.linspace(margin, H - margin, n)
    uu, vv = np.meshgrid(us, vs)
    return np.stack([uu.ravel(), vv.ravel()], -1).astype(np.float32)


def test_track_one_level_epi1d_locks_row():
    """Rectified-stereo mode: a pure x shift is recovered and v never moves."""
    img0 = _smooth_noise(120, 160, seed=5)
    img1 = _shift_image(img0, 3.1, 0.0)
    p0 = _grid_features(120, 160)
    valid = jnp.ones(p0.shape[0], bool)
    gx, gy = scharr_gradients(jnp.asarray(img0))
    p1, live, _ = klt._track_one_level(
        jnp.asarray(img0), gx, gy, jnp.asarray(img1), jnp.asarray(p0), jnp.asarray(p0),
        valid, klt._patch_offsets(7), 20, 0.03, 1e-4, epi1d=True,
    )
    p1, live = np.asarray(p1), np.asarray(live)
    assert live.sum() >= 30
    np.testing.assert_allclose(p1[live, 0] - p0[live, 0], 3.1, atol=0.08)
    np.testing.assert_allclose(p1[live, 1], p0[live, 1], atol=1e-5)


def test_track_with_scale_handles_scaled_patch():
    """img0 is a 1.25x zoom-out of the base texture; scale_change=1.25 maps
    template offsets back onto it (reference trackWithScale semantics), so
    the track lands on the geometric answer p0 / 1.25 from a 1 px-off seed."""
    from visual_odometry_ros_tpu.utils.interp import bilinear_sample

    H, W, sc = 120, 160, 1.25
    base = jnp.asarray(_smooth_noise(2 * H + 32, 2 * W + 32, seed=11))
    uu, vv = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    # img1 = f(x + 16); img0 = f(x/sc + 16): a patch at p with offsets sc*o in
    # img0 equals f(p/sc + o + 16) = the img1 patch at p1 = p/sc with offsets o.
    img1, _ = bilinear_sample(base, jnp.stack([jnp.asarray(uu + 16.0), jnp.asarray(vv + 16.0)], -1))
    img0, _ = bilinear_sample(base, jnp.stack([jnp.asarray(uu / sc + 16.0), jnp.asarray(vv / sc + 16.0)], -1))
    p0 = _grid_features(H, W, margin=30, n=5)
    p1_true = p0 / sc
    n = p0.shape[0]
    gx, gy = scharr_gradients(img0)
    p1, ok = klt.track_with_scale(
        img0, gx, gy, img1, jnp.asarray(p0), jnp.asarray(p1_true + 1.0),
        jnp.full((n,), sc, jnp.float32), jnp.ones(n, bool), radius=11, iters=25,
    )
    p1, ok = np.asarray(p1), np.asarray(ok)
    assert ok.sum() >= 20
    # The construction carries a ~1 px gradient-scale bias (template
    # gradients are taken in img0's zoomed pixels).
    np.testing.assert_allclose(p1[ok], p1_true[ok], atol=1.5)
