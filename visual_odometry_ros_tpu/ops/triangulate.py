"""Batched two-view triangulation — closed-form, SVD-free.

Capability parity with `mapping::triangulateDLT` (core/util/triangulate_3d.cpp:5-130),
which builds a 4x4 DLT matrix per point and runs JacobiSVD in a scalar loop.
Per-point SVD batches poorly, so we solve the *inhomogeneous* DLT
least-squares system instead: 4 linear constraints in the 3 unknowns of X,
solved in closed form via the adjugate of the 3x3 normal matrix — one fused
batch of elementwise ops + tiny matmuls over all N points at once.

For the rectified-stereo special case depth = fx * baseline / disparity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import geometry as geo


def _solve3x3(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 solve via adjugate. A: [..., 3, 3], b: [..., 3]."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    x = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    y = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    z = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return jnp.stack([x, y, z], axis=-1)


def triangulate(xn0: jax.Array, xn1: jax.Array, T_10: jax.Array):
    """Triangulate N points from two views.

    xn0, xn1: [N, 2] normalized coords in frame 0 / frame 1.
    T_10: [4, 4] pose of frame 0 in frame 1 (X1 = R_10 X0 + t_10).
    Returns (X0 [N, 3], X1 [N, 3]) — matching the reference's dual output
    (triangulate_3d.cpp:91-130).
    """
    R = T_10[:3, :3]
    t = T_10[:3, 3]
    x0, y0 = xn0[..., 0], xn0[..., 1]
    x1, y1 = xn1[..., 0], xn1[..., 1]

    # Frame 0 (identity pose): rows [1,0,-x0], [0,1,-y0]; rhs 0.
    z3 = jnp.zeros_like(x0)
    o3 = jnp.ones_like(x0)
    r0a = jnp.stack([o3, z3, -x0], axis=-1)
    r0b = jnp.stack([z3, o3, -y0], axis=-1)
    b0a = z3
    b0b = z3

    # Frame 1: rows (x1*R[2] - R[0]), (y1*R[2] - R[1]); rhs t0 - x1*t2 etc.
    r1a = x1[..., None] * R[2] - R[0]
    r1b = y1[..., None] * R[2] - R[1]
    b1a = t[0] - x1 * t[2]
    b1b = t[1] - y1 * t[2]

    A = jnp.stack([r0a, r0b, r1a, r1b], axis=-2)  # [N, 4, 3]
    b = jnp.stack([b0a, b0b, b1a, b1b], axis=-1)  # [N, 4]

    # Tiny contraction (k=4): an explicit broadcast-sum keeps full f32 in
    # every backend's default matmul precision (the normal equations are
    # conditioning-sensitive at small parallax).
    AtA = jnp.sum(A[..., :, :, None] * A[..., :, None, :], axis=-3)
    Atb = jnp.sum(A * b[..., None], axis=-2)
    X0 = _solve3x3(AtA, Atb)
    X1 = X0 @ R.T + t
    return X0, X1


def triangulate_pixels(p0, p1, cam0, cam1, T_10):
    """Pixel-space convenience wrapper (undistorted pixels)."""
    from ..camera import pixel_to_normalized

    return triangulate(pixel_to_normalized(cam0, p0), pixel_to_normalized(cam1, p1), T_10)


def stereo_depth_from_disparity(fx: jax.Array, baseline: jax.Array, disparity: jax.Array):
    """Rectified-stereo closed form: z = fx * b / d, with validity mask."""
    valid = disparity > 1e-3
    z = fx * baseline / jnp.where(valid, disparity, 1.0)
    return jnp.where(valid, z, 0.0), valid


def parallax_angle(ray0: jax.Array, ray1: jax.Array, R_01: jax.Array | None = None):
    """Angle between viewing rays, optionally rotation-compensated.

    Mirrors the reference's per-observation parallax statistic
    (landmark.cpp:107-134): rays are normalized camera-frame directions and
    the second is rotated into the first frame before the angle.
    """
    r0 = ray0 / jnp.linalg.norm(ray0, axis=-1, keepdims=True)
    r1 = ray1 if R_01 is None else ray1 @ R_01.T
    r1 = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
    cos_t = jnp.clip(jnp.sum(r0 * r1, axis=-1), -1.0, 1.0)
    return jnp.arccos(cos_t)
