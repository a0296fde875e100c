"""SO(3)/SE(3) geometry core — batched, jit-friendly.

Covers the capability surface of the reference `geometry::` namespace
(reference: core/util/geometry_library.{h,cpp} — se3Exp at geometry_library.cpp:386-440,
SE3Log at :442-535, addFrontse3 at :537-552, inverseSE3 at :554-567, quaternion ops
at :10-240) — redesigned as pure functions over batched jnp arrays rather than
per-matrix Eigen calls. All functions broadcast over arbitrary leading batch dims.

Conventions:
  - Rotations: 3x3 matrices R, quaternions [w, x, y, z], rotation vectors (axis*angle).
  - SE(3): 4x4 homogeneous matrices T = [[R, t], [0, 1]].
  - Tangent vectors xi = [v (3), w (3)]  (translation first, like the reference's
    [rho, phi] ordering in se3Exp).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-7


def skew(w: jax.Array) -> jax.Array:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula with small-angle guard. [..., 3] -> [..., 3, 3]."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # Guarded series: sin(t)/t and (1-cos t)/t^2 are smooth; the eps-shifted theta
    # keeps gradients finite at w=0 while the series limit is recovered via where.
    small = theta2 < 1e-12
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    W = skew(w)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * WW


def so3_log(R: jax.Array) -> jax.Array:
    """Inverse Rodrigues. [..., 3, 3] -> [..., 3]. Safe for angles in [0, pi)."""
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos_t = jnp.clip((tr - 1.0) * 0.5, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = jnp.arccos(cos_t)
    # vee of (R - R^T)/2
    v = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    ) * 0.5
    sin_t = jnp.sin(theta)
    scale = jnp.where(theta < 1e-6, 1.0 + theta * theta / 6.0, theta / jnp.maximum(sin_t, _EPS))
    return v * scale[..., None]


def _so3_left_jacobian(w: jax.Array) -> jax.Array:
    """V such that t = V @ rho in se3 exp (reference geometry_library.cpp:410-425)."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS * _EPS))
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta + _EPS * _EPS * _EPS),
    )
    W = skew(w)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + b[..., None, None] * W + c[..., None, None] * WW


def _so3_left_jacobian_inv(w: jax.Array) -> jax.Array:
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-12
    half = theta * 0.5
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS)) / (theta2 + _EPS * _EPS),
    )
    W = skew(w)
    WW = W @ W
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye - 0.5 * W + cot[..., None, None] * WW


def se3_exp(xi: jax.Array) -> jax.Array:
    """xi = [v, w] ([..., 6]) -> T ([..., 4, 4])."""
    v, w = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return rt_to_se3(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """T ([..., 4, 4]) -> xi = [v, w] ([..., 6])."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    v = (_so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def rt_to_se3(R: jax.Array, t: jax.Array) -> jax.Array:
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(t)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_inverse(T: jax.Array) -> jax.Array:
    """Closed-form inverse (reference inverseSE3, geometry_library.cpp:554-567)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return rt_to_se3(Rt, -(Rt @ t[..., None])[..., 0])


def so3_project(R: jax.Array) -> jax.Array:
    """Re-orthonormalize a near-rotation (Newton iteration of the polar
    decomposition: R <- R (3I - R^T R) / 2, quadratic convergence).

    Why this exists (r4 hard-sequence collapse root cause): long pose chains
    composed in f32 — especially the BA anchor/re-anchor round-trip
    T_cw @ inv(T_rw) ... @ T_rw, where inv() uses R^T and so assumes
    orthonormality — amplify rotation non-orthonormality GEOMETRICALLY
    (measured: det(R) 0.9996 -> 0.9154 in five keyframes, x3 error per BA).
    Once R leaves SO(3), se3_inverse is no longer the inverse and the whole
    map/pose state turns self-inconsistent (78 px reprojection error on
    freshly triangulated landmarks). The reference avoids this by keeping
    quaternion-synchronized rotations (core/util/pose3d.h); projecting at
    the pose write points is the matrix-native equivalent.
    """
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    for _ in range(2):
        RtR = jnp.swapaxes(R, -1, -2) @ R
        R = R @ (1.5 * eye - 0.5 * RtR)
    return R


def se3_project(T: jax.Array) -> jax.Array:
    """`so3_project` on the rotation block; translation untouched."""
    return rt_to_se3(so3_project(T[..., :3, :3]), T[..., :3, 3])


def add_front_se3(T: jax.Array, xi: jax.Array) -> jax.Array:
    """Left-compose a tangent update: exp(xi) @ T.

    Reference addFrontse3 (geometry_library.cpp:537-552) — tangent-space
    left-composition used by both pose-only GN and the BA solver.
    """
    return se3_exp(xi) @ T


def transform_points(T: jax.Array, X: jax.Array) -> jax.Array:
    """Apply SE3 to points: [..., 4, 4] x [..., N, 3] -> [..., N, 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return X @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


# ----------------------------------------------------------------------------
# Quaternions ([w, x, y, z])
# ----------------------------------------------------------------------------


def quat_multiply(q1: jax.Array, q2: jax.Array) -> jax.Array:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rotation(q: jax.Array) -> jax.Array:
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )
    return R


def rotation_to_quat(R: jax.Array) -> jax.Array:
    """Shepperd's method, branch-free via jnp.where (jit/batch safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # Four candidate constructions; pick the numerically largest pivot.
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = jnp.where(
        cond0[..., None],
        q0,
        jnp.where(cond1[..., None], q1, jnp.where(cond2[..., None], q2, q3)),
    )
    # Canonical sign (w >= 0).
    return quat_normalize(q * jnp.where(q[..., :1] < 0, -1.0, 1.0))


def rotvec_to_quat(w: jax.Array) -> jax.Array:
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)
    half = theta * 0.5
    small = theta < 1e-6
    k = jnp.where(small, 0.5 - theta * theta / 48.0, jnp.sin(half) / jnp.maximum(theta, _EPS))
    return jnp.concatenate([jnp.cos(half), w * k], axis=-1)


def quat_to_rotvec(q: jax.Array) -> jax.Array:
    return so3_log(quat_to_rotation(q))
