"""Pinhole + radial-tangential camera model and stereo rectification, batched.

Capability parity with the reference `Camera`/`StereoCamera`
(core/visual_odometry/camera.{h,cpp}):
  - intrinsics + 5-param radtan distortion (camera.h:20-137)
  - image undistort maps: forward distortion eval per pixel (camera.cpp:56-87)
  - pixel undistort maps: iterative Gauss-Newton inversion (camera.cpp:89-161)
  - projectToPixel / reprojectToNormalizedPoint (camera.cpp:208-218)
  - inImage with 3-px border (camera.cpp:220-229)
  - custom stereo rectification: mid-rotation frame with x-axis = baseline,
    rectified K with f = (fx_l+fx_r)/2 and principal point at image center,
    remap grids through inverse rotation + distortion model, rectified
    extrinsics with identity rotation (camera.cpp:364-546)

Design: per-pixel C++ loops become single vectorized jnp evaluations over the
whole pixel grid (run once at init, jitted). Cameras are registered-dataclass
pytrees so they flow through jit/vmap/shard_map as arguments.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .utils.interp import bilinear_sample
from .utils import geometry as geo


@partial(jax.tree_util.register_dataclass, data_fields=["fx", "fy", "cx", "cy", "dist"], meta_fields=["width", "height"])
@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera. dist = [k1, k2, p1, p2, k3] (OpenCV order)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    dist: jax.Array
    width: int
    height: int

    @property
    def K(self) -> jax.Array:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx]),
                jnp.stack([z, self.fy, self.cy]),
                jnp.stack([z, z, o]),
            ]
        )

    @property
    def has_distortion(self) -> bool:
        return True  # decided numerically at trace time by callers if needed


def make_camera(fx, fy, cx, cy, dist=None, width=0, height=0) -> Camera:
    dist = jnp.zeros(5, jnp.float32) if dist is None else jnp.asarray(dist, jnp.float32)
    return Camera(
        fx=jnp.asarray(fx, jnp.float32),
        fy=jnp.asarray(fy, jnp.float32),
        cx=jnp.asarray(cx, jnp.float32),
        cy=jnp.asarray(cy, jnp.float32),
        dist=dist,
        width=int(width),
        height=int(height),
    )


# ----------------------------------------------------------------------------
# Distortion model
# ----------------------------------------------------------------------------


def distort_normalized(cam: Camera, xn: jax.Array) -> jax.Array:
    """Apply radtan distortion to normalized coords [..., 2] (camera.cpp:56-87)."""
    k1, k2, p1, p2, k3 = (cam.dist[i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    xx, yy = x * x, y * y
    xy2 = 2.0 * x * y
    r2 = xx + yy
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * xx)
    yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * yy)
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(cam: Camera, xd: jax.Array, iters: int = 20) -> jax.Array:
    """Invert the distortion by fixed-point/GN iteration.

    The reference runs per-pixel Gauss-Newton with MAX_ITER=500
    (camera.cpp:89-161); a fixed-count fixed-point iteration over the whole
    batch converges in <20 steps for realistic distortion and stays jit-static.
    """

    def body(_, xn):
        d = distort_normalized(cam, xn) - xn
        return xd - d

    return jax.lax.fori_loop(0, iters, body, xd)


# ----------------------------------------------------------------------------
# Projection
# ----------------------------------------------------------------------------


def project_to_pixel(cam: Camera, X: jax.Array) -> jax.Array:
    """3D cam-frame points [..., 3] -> pixels [..., 2] (no distortion;
    matches reference projectToPixel, camera.cpp:208-213, used on rectified
    streams)."""
    z = X[..., 2]
    inv_z = 1.0 / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = X[..., 0] * inv_z * cam.fx + cam.cx
    v = X[..., 1] * inv_z * cam.fy + cam.cy
    return jnp.stack([u, v], axis=-1)


def pixel_to_normalized(cam: Camera, p: jax.Array) -> jax.Array:
    """Pixels [..., 2] -> normalized coords (reprojectToNormalizedPoint)."""
    x = (p[..., 0] - cam.cx) / cam.fx
    y = (p[..., 1] - cam.cy) / cam.fy
    return jnp.stack([x, y], axis=-1)


def in_image(cam: Camera, p: jax.Array, border: float = 3.0) -> jax.Array:
    """Validity mask with border (reference inImage, camera.cpp:220-229)."""
    u, v = p[..., 0], p[..., 1]
    return (u >= border) & (v >= border) & (u < cam.width - border) & (v < cam.height - border)


def undistort_pixels(cam: Camera, p: jax.Array, iters: int = 20) -> jax.Array:
    """Distorted pixel coords -> undistorted pixel coords (same K)."""
    xn = undistort_normalized(cam, pixel_to_normalized(cam, p), iters)
    return jnp.stack([xn[..., 0] * cam.fx + cam.cx, xn[..., 1] * cam.fy + cam.cy], axis=-1)


# ----------------------------------------------------------------------------
# Undistortion / rectification maps (computed once, vectorized)
# ----------------------------------------------------------------------------


def _pixel_grid(width: int, height: int) -> jax.Array:
    u = jnp.arange(width, dtype=jnp.float32)
    v = jnp.arange(height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)  # [H, W]
    return jnp.stack([uu, vv], axis=-1)  # [H, W, 2]


def image_undistort_maps(cam: Camera) -> jax.Array:
    """For each undistorted output pixel, the distorted source coords [H, W, 2]
    (analog of generateImageUndistortMaps, camera.cpp:56-87)."""
    grid = _pixel_grid(cam.width, cam.height)
    xn = pixel_to_normalized(cam, grid)
    xd = distort_normalized(cam, xn)
    return jnp.stack([xd[..., 0] * cam.fx + cam.cx, xd[..., 1] * cam.fy + cam.cy], axis=-1)


def remap(img: jax.Array, map_uv: jax.Array) -> jax.Array:
    """Bilinear remap (cv::remap analog): img [H, W], map_uv [H, W, 2]."""
    vals, mask = bilinear_sample(img, map_uv)
    return jnp.where(mask, vals, 0.0)


@partial(jax.tree_util.register_dataclass, data_fields=["left", "right", "T_lr", "rect", "T_lr_rect", "map_left", "map_right"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Stereo pair + rectification products.

    rect: the rectified pinhole camera shared by both views.
    T_lr_rect: rectified extrinsics (identity rotation, baseline translation).
    map_left/map_right: [H, W, 2] remap grids (rectified pixel -> raw source).
    """

    left: Camera
    right: Camera
    T_lr: jax.Array
    rect: Camera
    T_lr_rect: jax.Array
    map_left: jax.Array
    map_right: jax.Array

    @property
    def baseline(self) -> jax.Array:
        return jnp.linalg.norm(self.T_lr_rect[:3, 3])


def make_stereo_camera(left: Camera, right: Camera, T_lr: jax.Array) -> StereoCamera:
    """Build rectification maps (analog of camera.cpp:364-546, vectorized).

    The rectified frame: x-axis along the baseline, z-axis = mean optical axis
    re-orthogonalized; rectified K uses f = (fx_l + fx_r)/2 and principal point
    at the image center; remap grids push rectified rays through each raw
    camera's rotation + distortion model.
    """
    T_lr = jnp.asarray(T_lr, jnp.float32)
    R_0r = T_lr[:3, :3]
    t_0r = T_lr[:3, 3]

    k_l = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    k_r = R_0r[:, 2]
    k_n = (k_l + k_r) * 0.5
    k_n = k_n / jnp.linalg.norm(k_n)
    i_n = t_0r / jnp.linalg.norm(t_0r)
    j_n = jnp.cross(k_n, i_n)
    j_n = j_n / jnp.linalg.norm(j_n)
    k_n = jnp.cross(i_n, j_n)
    k_n = k_n / jnp.linalg.norm(k_n)
    R_0n = jnp.stack([i_n, j_n, k_n], axis=1)  # left(=world0) -> rectified

    f_n = (left.fx + right.fx) * 0.5
    cx_n = left.width * 0.5
    cy_n = left.height * 0.5
    rect = Camera(
        fx=f_n,
        fy=f_n,
        cx=jnp.asarray(cx_n, jnp.float32),
        cy=jnp.asarray(cy_n, jnp.float32),
        dist=jnp.zeros(5, jnp.float32),
        width=left.width,
        height=left.height,
    )

    grid = _pixel_grid(left.width, left.height)
    xn_rect = pixel_to_normalized(rect, grid)  # [H, W, 2]
    rays = jnp.concatenate([xn_rect, jnp.ones_like(xn_rect[..., :1])], axis=-1)  # [H, W, 3]
    P0 = rays @ R_0n.T  # rectified ray expressed in left frame

    def raw_map(cam: Camera, R_c0: jax.Array) -> jax.Array:
        xc = P0 @ R_c0.T
        xn = xc[..., :2] / xc[..., 2:3]
        xd = distort_normalized(cam, xn)
        return jnp.stack([xd[..., 0] * cam.fx + cam.cx, xd[..., 1] * cam.fy + cam.cy], axis=-1)

    map_left = raw_map(left, jnp.eye(3, dtype=jnp.float32))
    map_right = raw_map(right, R_0r.T)

    # Rectified extrinsics: identity rotation, baseline expressed in rect frame
    # (reference camera.cpp:531-536: t_rect = R_ln^T t = R_0n^T t since R_0l=I).
    t_rect = R_0n.T @ t_0r
    T_lr_rect = geo.rt_to_se3(jnp.eye(3, dtype=jnp.float32), t_rect)

    return StereoCamera(
        left=left,
        right=right,
        T_lr=T_lr,
        rect=rect,
        T_lr_rect=T_lr_rect,
        map_left=map_left,
        map_right=map_right,
    )


@jax.jit
def rectify_stereo_images(stereo: StereoCamera, img_left: jax.Array, img_right: jax.Array):
    """Remap both raw images into the rectified frame (camera.cpp:300-336)."""
    return remap(img_left, stereo.map_left), remap(img_right, stereo.map_right)
