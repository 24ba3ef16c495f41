"""Pinhole camera model with analytic Jacobians, OpenGL/OpenCV conventions.

Rebuild of the reference camera model (cpp/pnp/types.h:13-198).
``CameraIntrinsics`` is a jit-compatible pytree; the convention is carried as
a float sign ``s`` (+1 for OpenCV looking down +Z, -1 for OpenGL looking down
-Z), replacing the reference's enum branch (cpp/pnp/types.h:95-132).

The focal parameterization follows the reference exactly: ``fy`` is the free
focal parameter and ``fx = aspect_ratio · fy`` (cpp/pnp/types.h:75-93), so
intrinsics Jacobians are 2×3 / 3×3 over ``(fy, cx, cy)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Convention markers (matches CameraConvention in cpp/pnp/types.h:13-16)
OPENGL = 0  # looking at -Z
OPENCV = 1  # looking at +Z


class Intrinsics(NamedTuple):
    """Pinhole intrinsics pytree (cpp/pnp/types.h:18-29)."""

    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    aspect_ratio: jax.Array
    width: jax.Array
    height: jax.Array
    # +1.0 for OpenCV (+Z forward), -1.0 for OpenGL (-Z forward).
    sign: jax.Array

    @staticmethod
    def create(fx, fy, cx, cy, aspect_ratio, width, height, convention=OPENGL):
        # Host numpy scalars: creating device scalars here would cost one
        # host->device transfer per field on every construction (intrinsics
        # are built on the host per frame / per UI event).
        sign = 1.0 if convention == OPENCV else -1.0
        f = np.float32
        return Intrinsics(
            f(fx), f(fy), f(cx), f(cy), f(aspect_ratio), f(width), f(height),
            f(sign),
        )

    @property
    def convention(self):
        return OPENCV if self.sign > 0 else OPENGL


class Bounds(NamedTuple):
    """FOV-derived clamping bounds for (fy, cx, cy) optimization
    (cpp/pnp/types.h:147-192)."""

    f_low: jax.Array
    f_high: jax.Array
    cx_low: jax.Array
    cx_high: jax.Array
    cy_low: jax.Array
    cy_high: jax.Array


def intrinsics_bounds(
    intr: Intrinsics, min_fov_deg: float = 15.0, max_fov_deg: float = 160.0
) -> Bounds:
    """Focal/principal-point bounds from an FOV range
    (cpp/pnp/types.h:156-192).

    For OpenGL convention focals are negative, so the bounds flip sign.
    """
    min_tan = jnp.tan(jnp.deg2rad(jnp.float32(min_fov_deg)) / 2)
    max_tan = jnp.tan(jnp.deg2rad(jnp.float32(max_fov_deg)) / 2)
    half_w = intr.width / 2.0

    # OpenCV: f in [half_w/max_tan, half_w/min_tan]; OpenGL: negated+swapped.
    f_low_cv = half_w / max_tan
    f_high_cv = half_w / min_tan
    is_gl = intr.sign < 0
    f_low = jnp.where(is_gl, -f_high_cv, f_low_cv)
    f_high = jnp.where(is_gl, -f_low_cv, f_high_cv)

    zero = jnp.float32(0.0)
    return Bounds(f_low, f_high, zero, intr.width, zero, intr.height)


def project(intr: Intrinsics, x: jax.Array) -> jax.Array:
    """Perspective projection of 3D camera-space point(s)
    (cpp/pnp/types.h:65-67).  ``x`` is (..., 3); returns (..., 2)."""
    z = x[..., 2]
    return jnp.stack(
        [intr.fx * x[..., 0] / z + intr.cx, intr.fy * x[..., 1] / z + intr.cy],
        axis=-1,
    )


def project_with_jac(intr: Intrinsics, x: jax.Array):
    """Projection + Jacobians (cpp/pnp/types.h:69-93).

    Returns ``(p, jac_x, jac_intrin)``: jac_x is (..., 2, 3) w.r.t. the 3D
    point; jac_intrin is (..., 2, 3) w.r.t. ``(fy, cx, cy)`` with
    ``fx = aspect_ratio · fy`` folded in.
    """
    X, Y, Z = x[..., 0], x[..., 1], x[..., 2]
    inv_z = 1.0 / Z
    p = jnp.stack(
        [intr.fx * X * inv_z + intr.cx, intr.fy * Y * inv_z + intr.cy], axis=-1
    )

    zero = jnp.zeros_like(X)
    jac_x = jnp.stack(
        [
            intr.fx * inv_z, zero, -intr.fx * X * inv_z * inv_z,
            zero, intr.fy * inv_z, -intr.fy * Y * inv_z * inv_z,
        ],
        axis=-1,
    ).reshape(*X.shape, 2, 3)

    one = jnp.ones_like(X)
    jac_intrin = jnp.stack(
        [
            intr.aspect_ratio * X * inv_z, one, zero,
            Y * inv_z, zero, one,
        ],
        axis=-1,
    ).reshape(*X.shape, 2, 3)

    return p, jac_x, jac_intrin


def unproject(intr: Intrinsics, p: jax.Array) -> jax.Array:
    """Pixel → camera-space ray direction (cpp/pnp/types.h:95-98).

    Returns ``s · ((px-cx)/fx, (py-cy)/fy, 1)`` with s the convention sign.
    """
    s = intr.sign
    return jnp.stack(
        [
            s * (p[..., 0] - intr.cx) / intr.fx,
            s * (p[..., 1] - intr.cy) / intr.fy,
            jnp.broadcast_to(s, p[..., 0].shape),
        ],
        axis=-1,
    )


def unproject_with_jac(intr: Intrinsics, p: jax.Array):
    """Unprojection + Jacobians (cpp/pnp/types.h:100-125).

    Returns ``(d, jac_p, jac_intrin)``: jac_p is (..., 3, 2)-like padded to
    (..., 3, 3) to mirror the reference layout (third column zero);
    jac_intrin is (..., 3, 3) w.r.t. ``(fy, cx, cy)``.
    """
    s = intr.sign
    px, py = p[..., 0], p[..., 1]
    d = jnp.stack(
        [
            s * (px - intr.cx) / intr.fx,
            s * (py - intr.cy) / intr.fy,
            jnp.broadcast_to(s, px.shape),
        ],
        axis=-1,
    )

    zero = jnp.zeros_like(px)
    jac_p = jnp.stack(
        [
            s / intr.fx + zero, zero, zero,
            zero, s / intr.fy + zero, zero,
            zero, zero, zero,
        ],
        axis=-1,
    ).reshape(*px.shape, 3, 3)

    jac_intrin = jnp.stack(
        [
            s * (intr.cx - px) / (intr.fy * intr.fy * intr.aspect_ratio),
            -s / intr.fx + zero,
            zero,
            s * (intr.cy - py) / (intr.fy * intr.fy),
            zero,
            -s / intr.fy + zero,
            zero, zero, zero,
        ],
        axis=-1,
    ).reshape(*px.shape, 3, 3)

    return d, jac_p, jac_intrin


def is_behind(intr: Intrinsics, x: jax.Array) -> jax.Array:
    """Cheirality test (cpp/pnp/types.h:129-132): behind iff ``s · z < 0``."""
    return intr.sign * x[..., 2] < 0.0


def proj_matrix_3x3(intr: Intrinsics) -> jax.Array:
    """K matrix (cpp/pnp/types.h:51-59)."""
    z = jnp.zeros_like(intr.fx)
    o = jnp.ones_like(intr.fx)
    return jnp.stack(
        [intr.fx, z, intr.cx, z, intr.fy, intr.cy, z, z, o], axis=-1
    ).reshape(*jnp.shape(intr.fx), 3, 3)


# The reference's fixed bogus near/far plane (cpp/pnp/types.h:31-49);
# only rows 0, 1, 3 of the resulting matrix are meaningful.
_BOGUS_FAR, _BOGUS_NEAR = 100.0, 10.0


def proj_matrix_4x4(intr: Intrinsics) -> jax.Array:
    """4×4 projection with the reference's fixed bogus near/far plane
    (cpp/pnp/types.h:31-49): only row 0,1,3 are meaningful."""
    f, n = _BOGUS_FAR, _BOGUS_NEAR
    p22 = -(f + n) / (f - n)
    p23 = -2.0 * f * n / (f - n)
    z = jnp.zeros_like(intr.fx)
    o = jnp.ones_like(intr.fx)
    return jnp.stack(
        [
            intr.fx, z, intr.cx, z,
            z, intr.fy, intr.cy, z,
            z, z, p22 + z, p23 + z,
            z, z, o, z,
        ],
        axis=-1,
    ).reshape(*jnp.shape(intr.fx), 4, 4)


def rescale(intr: Intrinsics, scale) -> Intrinsics:
    """Scale fx/fy/cx/cy (cpp/pnp/types.h:134-145)."""
    return intr._replace(
        fx=intr.fx * scale, fy=intr.fy * scale,
        cx=intr.cx * scale, cy=intr.cy * scale,
    )


class CameraState(NamedTuple):
    """Intrinsics + pose (cpp/pnp/types.h:195-198)."""

    intrinsics: Intrinsics
    pose: "Pose"  # noqa: F821  (polychase_tpu.engine.pose.Pose)


def proj_matrix_4x4_np(intr: Intrinsics) -> "np.ndarray":
    """Host copy of :func:`proj_matrix_4x4` for orchestration code."""
    i = jax.device_get(intr)
    f, n = _BOGUS_FAR, _BOGUS_NEAR
    return np.array(
        [
            [float(i.fx), 0, float(i.cx), 0],
            [0, float(i.fy), float(i.cy), 0],
            [0, 0, -(f + n) / (f - n), -2.0 * f * n / (f - n)],
            [0, 0, 1.0, 0],
        ],
        np.float64,
    )
