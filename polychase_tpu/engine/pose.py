"""SE(3) poses as quaternion+translation, with analytic Jacobians.

Rebuild of the reference's pose math (cpp/pose.h:9-160 and
cpp/pnp/quaternion.h:11-20).  All functions are pure jnp, float32, and
vmap-friendly (they operate on single items; batch with jax.vmap).

Conventions
-----------
- Quaternions are stored ``(w, x, y, z)`` (scalar first), matching the
  Blender-facing ordering of the reference pybind surface
  (cpp/polychase_pybind.cc:217-233).
- Rotation Jacobians are with respect to a *right-multiplicative* so(3)
  perturbation: ``R(q · exp(δω)) ≈ R(q) · (I + skew(δω))``, matching the
  reference's ``QuatStepPost`` retraction (cpp/pnp/quaternion.h:11-20),
  giving e.g. ``d(R p)/dω = R · skew(-p)`` (cpp/pose.h:69-87).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Every float32 device product asks for HIGHEST: at default precision a
# GPU may run a float32 dot in TF32 (~3 decimal digits), about a pixel of
# reprojection error for a point 4 m away at f = 1800 px.
HIGHEST = jax.lax.Precision.HIGHEST
matmul = partial(jnp.matmul, precision=HIGHEST)
_einsum = partial(jnp.einsum, precision=HIGHEST)


class Pose(NamedTuple):
    """Rigid transform ``x ↦ R(q) x + t`` (cpp/pose.h:9)."""

    q: jax.Array  # (..., 4) quaternion, (w, x, y, z)
    t: jax.Array  # (..., 3) translation

    @staticmethod
    def identity(batch_shape=()) -> "Pose":
        q = jnp.broadcast_to(
            jnp.array([1.0, 0.0, 0.0, 0.0], jnp.float32), (*batch_shape, 4)
        )
        t = jnp.zeros((*batch_shape, 3), jnp.float32)
        return Pose(q, t)


# ---------------------------------------------------------------------------
# Quaternion primitives
# ---------------------------------------------------------------------------


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], q.dtype)


def quat_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product, (w, x, y, z) ordering."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vector(s) ``v`` by quaternion ``q`` without forming R.

    Uses the standard ``v + 2 w (u × v) + 2 u × (u × v)`` identity.
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_to_mat(q: jax.Array) -> jax.Array:
    """Quaternion → 3×3 rotation matrix (cpp/pose.h:20)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def mat_to_quat(m: jax.Array) -> jax.Array:
    """3×3 rotation matrix → quaternion (w, x, y, z), branch-free.

    Shepperd's method evaluated on all four branches and selected with
    ``where`` so it is jit/vmap safe.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22

    # Four candidate quaternions (unnormalized), one per dominant component.
    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    qw = jnp.stack(
        [safe_sqrt(1 + tr), m21 - m12, m02 - m20, m10 - m01], axis=-1
    )
    qx = jnp.stack(
        [m21 - m12, safe_sqrt(1 + m00 - m11 - m22), m01 + m10, m02 + m20],
        axis=-1,
    )
    qy = jnp.stack(
        [m02 - m20, m01 + m10, safe_sqrt(1 - m00 + m11 - m22), m12 + m21],
        axis=-1,
    )
    qz = jnp.stack(
        [m10 - m01, m02 + m20, m12 + m21, safe_sqrt(1 - m00 - m11 + m22)],
        axis=-1,
    )

    # Scale each candidate: dominant term is s = sqrt(...)*2; q_dom = s/4.
    def finish(qc, dom_idx):
        s = qc[..., dom_idx]
        out = qc / (2.0 * s[..., None])
        return out.at[..., dom_idx].set(s / 2.0)

    cand = jnp.stack(
        [finish(qw, 0), finish(qx, 1), finish(qy, 2), finish(qz, 3)], axis=-2
    )  # (..., 4 candidates, 4)

    scores = jnp.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], axis=-1
    )
    best = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cand, best[..., None, None].repeat(4, -1), axis=-2)[
        ..., 0, :
    ]
    # Canonicalize sign (w >= 0) and normalize.
    q = jnp.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def quat_exp(w_delta: jax.Array) -> jax.Array:
    """so(3) vector → unit quaternion exp map, safe (and differentiable) at 0.

    Near zero the closed form ``(cos θ/2, sin(θ/2)/θ · ω)`` is replaced by its
    Taylor expansion so autodiff through the retraction stays NaN-free.
    """
    sq = jnp.sum(w_delta * w_delta, axis=-1, keepdims=True)
    small = sq < 1e-12
    # where() on the *input* so gradients only flow through the taken branch
    angle = jnp.sqrt(jnp.where(small, 1.0, sq))
    half = 0.5 * angle
    cos_half = jnp.where(small, 1.0 - sq / 8.0, jnp.cos(half))
    k = jnp.where(small, 0.5 - sq / 48.0, jnp.sin(half) / angle)
    return jnp.concatenate([cos_half, k * w_delta], axis=-1)


def quat_step_post(q: jax.Array, w_delta: jax.Array) -> jax.Array:
    """Right-multiplicative SO(3) retraction ``q · exp(δω)``.

    Matches the reference's LM step retraction (cpp/pnp/quaternion.h:11-20).
    """
    return quat_mul(q, quat_exp(w_delta))


def skew(v: jax.Array) -> jax.Array:
    """Cross-product matrix (cpp/pose.h:151-159)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    m = jnp.stack(
        [zero, -z, y, z, zero, -x, -y, x, zero], axis=-1
    )
    return m.reshape(*v.shape[:-1], 3, 3)


# ---------------------------------------------------------------------------
# Pose operations
# ---------------------------------------------------------------------------


def pose_apply(pose: Pose, p: jax.Array) -> jax.Array:
    """``R p + t`` (cpp/pose.h:43-45)."""
    return quat_rotate(pose.q, p) + pose.t


def pose_rotate(pose: Pose, p: jax.Array) -> jax.Array:
    return quat_rotate(pose.q, p)


def pose_derotate(pose: Pose, p: jax.Array) -> jax.Array:
    """``Rᵀ p`` (cpp/pose.h:40-42)."""
    return quat_rotate(quat_conj(pose.q), p)


def pose_center(pose: Pose) -> jax.Array:
    """Camera center ``-Rᵀ t`` (cpp/pose.h:47)."""
    return -pose_derotate(pose, pose.t)


def pose_inverse(pose: Pose) -> Pose:
    return Pose(quat_conj(pose.q), -pose_derotate(pose, pose.t))


def pose_rt4x4(pose: Pose) -> jax.Array:
    """4×4 homogeneous ``[R t; 0 1]`` (cpp/pose.h:27-36)."""
    R = quat_to_mat(pose.q)
    top = jnp.concatenate([R, pose.t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], R.dtype), (*top.shape[:-2], 1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def pose_from_rt(mat: jax.Array) -> Pose:
    """4×4 (or 3×4) rigid matrix → Pose (cpp/pose.h:133-136)."""
    return Pose(mat_to_quat(mat[..., :3, :3]), mat[..., :3, 3])


def pose_from_srt(mat: jax.Array) -> Pose:
    """Like :func:`pose_from_rt` but normalizes scaled columns
    (cpp/pose.h:138-144)."""
    R = mat[..., :3, :3]
    R = R / jnp.linalg.norm(R, axis=-2, keepdims=True)
    return Pose(mat_to_quat(R), mat[..., :3, 3])


# ---------------------------------------------------------------------------
# Operations with analytic Jacobians (all w.r.t. right-mult. so(3) + t)
# ---------------------------------------------------------------------------


def apply_with_jac(R: jax.Array, t: jax.Array, p: jax.Array):
    """``y = R p + t`` and Jacobians (cpp/pose.h:69-87).

    Returns ``(y, jac_p, jac_R, jac_t)`` with ``jac_R = R · skew(-p)``,
    ``jac_p = R``, ``jac_t = I``.
    """
    y = _einsum("...ij,...j->...i", R, p) + t
    jac_p = R
    jac_R = _einsum("...ij,...jk->...ik", R, skew(-p))
    jac_t = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    return y, jac_p, jac_R, jac_t


def derotate_with_jac(R: jax.Array, p: jax.Array):
    """``y = Rᵀ p`` and Jacobians (cpp/pose.h:102-114).

    Returns ``(y, jac_p, jac_R)`` with ``jac_p = Rᵀ``, ``jac_R = skew(y)``.
    """
    Rt = jnp.swapaxes(R, -1, -2)
    y = _einsum("...ij,...j->...i", Rt, p)
    return y, Rt, skew(y)


def center_with_jac(R: jax.Array, t: jax.Array):
    """``c = -Rᵀ t`` and Jacobians (cpp/pose.h:116-129).

    Returns ``(c, jac_R, jac_t)`` with ``jac_R = skew(c)``, ``jac_t = -Rᵀ``.
    """
    Rt = jnp.swapaxes(R, -1, -2)
    c = -_einsum("...ij,...j->...i", Rt, t)
    return c, skew(c), -Rt


# ---------------------------------------------------------------------------
# Host (numpy) variants — orchestration code runs per UI event / per frame
# and an eager device op costs a host round trip.
# ---------------------------------------------------------------------------


def quat_to_mat_np(q) -> np.ndarray:
    """Host copy of :func:`quat_to_mat` (WXYZ, cpp/pose.h:20)."""
    w, x, y, z = (float(v) for v in np.asarray(q).reshape(4))
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def mat_to_quat_np(m) -> np.ndarray:
    """Host rotation-matrix -> WXYZ quaternion (Shepperd)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        q = np.array([
            w,
            (m[2, 1] - m[1, 2]) / (4 * w),
            (m[0, 2] - m[2, 0]) / (4 * w),
            (m[1, 0] - m[0, 1]) / (4 * w),
        ])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        sdiag = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k]) * 2
        q = np.empty(4)
        q[i + 1] = sdiag / 4
        q[0] = (m[k, j] - m[j, k]) / sdiag
        q[j + 1] = (m[j, i] + m[i, j]) / sdiag
        q[k + 1] = (m[k, i] + m[i, k]) / sdiag
    return q / np.linalg.norm(q)


def pose_rt4x4_np(pose: "Pose") -> np.ndarray:
    """Host [R t; 0 1] (cpp/pose.h:27-36)."""
    m = np.eye(4)
    m[:3, :3] = quat_to_mat_np(np.asarray(pose.q))
    m[:3, 3] = np.asarray(pose.t, np.float64).reshape(3)
    return m
