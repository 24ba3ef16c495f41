"""Iterative PnP: camera pose (+ optional intrinsics) from 2D↔3D matches.

Rebuild of the reference PnP stack (cpp/pnp/pnp_problem.h:13-142,
cpp/pnp/solvers.cc:11-78).  The 9-parameter problem — 3 so(3) rotation,
3 translation, 3 intrinsics (fy, cx, cy) — is evaluated for **all**
correspondences at once with batched closed-form Jacobians, reduced to 9×9
normal equations, and iterated inside one jitted LM loop
(`engine.levmarq`).  Points are padded to fixed bucket sizes so interactive
re-solves never re-trace (SURVEY.md §7 "interactive latency").

Reference semantics preserved:

- residual = project(pose · X) − x; points behind the camera get infinite
  cost so such steps are rejected (cpp/pnp/pnp_problem.h:52-61);
- intrinsics optimization silently disabled for ≤ 3 points
  (cpp/pnp/pnp_problem.h:34-35);
- step: right-multiplicative quaternion retraction; fy stepped then clamped
  to FOV bounds with fx = aspect·fy; cx/cy clamped to the image
  (cpp/pnp/pnp_problem.h:101-131);
- inlier ratio computed against ``max_inlier_error`` px
  (cpp/pnp/solvers.cc:30-47).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import camera as C
from . import pose as P
from .levmarq import BundleOptions, BundleStats, LMProblem, lm_solve


class PnPResult(NamedTuple):
    """Solve result (cpp/pnp/solvers.h:9-13)."""

    camera: C.CameraState
    stats: BundleStats
    inlier_ratio: jax.Array


class PnPOptions(NamedTuple):
    """PnP options (cpp/pnp/solvers.h:15-20)."""

    bundle_opts: BundleOptions = BundleOptions()
    max_inlier_error: float = 12.0
    optimize_focal_length: bool = False
    optimize_principal_point: bool = False


# Behind-camera points get this residual so any step that pushes a point
# behind the camera is rejected by cost (the reference uses FLT_MAX,
# cpp/pnp/pnp_problem.h:52-61).  Kept finite to avoid inf·0 NaNs on padding.
_BEHIND_RESIDUAL = 1e18


def _residuals(cam: C.CameraState, X, x, mask):
    """Batched reprojection residuals.  X (N,3) world, x (N,2) pixels.

    Returns ``(res, valid, behind)``; ``valid`` marks real (non-padding)
    points — behind-camera points stay valid but carry a huge residual.
    """
    Z = P.pose_apply(
        P.Pose(cam.pose.q[None, :], cam.pose.t[None, :]), X
    )
    behind = C.is_behind(cam.intrinsics, Z)
    z = C.project(cam.intrinsics, Z)
    res = jnp.where(behind[:, None], _BEHIND_RESIDUAL, z - x)
    return jnp.where(mask[:, None], res, 0.0), mask, behind


def _residuals_jac(cam: C.CameraState, X, x, mask, opt_f, opt_pp):
    """Residuals + (N, 2, 9) Jacobians via batched chain rule
    (cpp/pnp/pnp_problem.h:63-99)."""
    R = P.quat_to_mat(cam.pose.q)
    Rb = jnp.broadcast_to(R, (X.shape[0], 3, 3))
    tb = jnp.broadcast_to(cam.pose.t, X.shape)
    Z, _, dZ_dR, _ = P.apply_with_jac(Rb, tb, X)
    z, dz_dZ, dz_dintr = C.project_with_jac(cam.intrinsics, Z)
    res = z - x

    hi = jax.lax.Precision.HIGHEST
    J_rot = jnp.einsum("nij,njk->nik", dz_dZ, dZ_dR, precision=hi)
    J_t = dz_dZ
    if not opt_f:
        dz_dintr = dz_dintr.at[:, :, 0].set(0.0)
    if not opt_pp:
        dz_dintr = dz_dintr.at[:, :, 1:].set(0.0)
    J = jnp.concatenate([J_rot, J_t, dz_dintr], axis=-1)  # (N, 2, 9)
    return jnp.where(mask[:, None], res, 0.0), jnp.where(
        mask[:, None, None], J, 0.0
    ), mask


def _step(cam: C.CameraState, dp, bounds: C.Bounds, opt_f, opt_pp):
    """Apply an LM step (cpp/pnp/pnp_problem.h:101-131)."""
    q = P.quat_step_post(cam.pose.q, dp[0:3])
    t = cam.pose.t + dp[3:6]
    intr = cam.intrinsics
    if opt_f:
        fy = jnp.clip(intr.fy + dp[6], bounds.f_low, bounds.f_high)
        fx = jnp.clip(fy * intr.aspect_ratio, bounds.f_low, bounds.f_high)
        intr = intr._replace(fx=fx, fy=fy)
    if opt_pp:
        intr = intr._replace(
            cx=jnp.clip(intr.cx + dp[7], bounds.cx_low, bounds.cx_high),
            cy=jnp.clip(intr.cy + dp[8], bounds.cy_low, bounds.cy_high),
        )
    return C.CameraState(intr, P.Pose(q, t))


def solve_arrays(
    X, x, weights, mask, params,
    *, opt_f: bool, opt_pp: bool, opts: BundleOptions,
):
    """Traced PnP core over already-device arrays.

    ``params`` is the 16-float vector [q(4) t(3) fx fy cx cy aspect w h
    sign max_inlier_error].  Returns the 19-float result vector (pose,
    intrinsics, stats, inlier ratio).  Shared by the packed host entry
    below and fused device programs (e.g. the tracker's
    raycast-and-solve)."""
    intr = C.Intrinsics(
        fx=params[7], fy=params[8], cx=params[9], cy=params[10],
        aspect_ratio=params[11], width=params[12], height=params[13],
        sign=params[14],
    )
    cam0 = C.CameraState(intr, P.Pose(params[0:4], params[4:7]))
    bounds = C.intrinsics_bounds(intr)
    max_inlier_error = params[15]

    def residuals(cam):
        res, valid, behind = _residuals(cam, X, x, mask)
        return res, valid, weights

    # Intrinsics optimization requires > 3 valid points
    # (cpp/pnp/pnp_problem.h:34-35); the count is dynamic in fused
    # programs (it comes out of a ray cast), so gate the intrinsic
    # Jacobian columns instead of a static flag.
    int_gate = jnp.where(jnp.sum(mask) > 3, 1.0, 0.0)

    def residuals_jac(cam):
        res, J, valid = _residuals_jac(cam, X, x, mask, opt_f, opt_pp)
        if opt_f or opt_pp:
            J = J.at[:, :, 6:].multiply(int_gate)
        return res, J, valid, weights

    def step(cam, dp):
        new = _step(cam, dp, bounds, opt_f, opt_pp)
        if opt_f or opt_pp:
            # With <=3 points the reference disables intrinsics entirely;
            # _step's clamping must not silently rewrite fx/fy/cx/cy.
            intr = jax.tree.map(
                lambda a, b: jnp.where(int_gate > 0.0, a, b),
                new.intrinsics, cam.intrinsics,
            )
            new = C.CameraState(intr, new.pose)
        return new

    problem = LMProblem(
        residuals=residuals,
        residuals_jac=residuals_jac,
        step=step,
        num_params=9,
        normalize=False,
        invalid_is_inf=False,
    )

    cam_out, stats = lm_solve(problem, cam0, opts)

    # Inlier ratio (cpp/pnp/solvers.cc:30-47)
    res, _, behind = _residuals(cam_out, X, x, mask)
    err2 = jnp.sum(res * res, axis=-1)
    err2 = jnp.where(mask & ~behind, err2, jnp.inf)
    num_points = jnp.maximum(jnp.sum(mask), 1)
    inliers = jnp.sum((err2 < max_inlier_error**2) & mask)
    ratio = jnp.where(
        max_inlier_error > 0.0,
        inliers.astype(jnp.float32) / num_points.astype(jnp.float32),
        0.0,
    )
    io = cam_out.intrinsics
    return jnp.stack(
        [
            cam_out.pose.q[0], cam_out.pose.q[1], cam_out.pose.q[2],
            cam_out.pose.q[3],
            cam_out.pose.t[0], cam_out.pose.t[1], cam_out.pose.t[2],
            io.fx, io.fy, io.cx, io.cy,
            stats.iterations.astype(jnp.float32),
            stats.initial_cost, stats.cost, stats.lambda_,
            stats.invalid_steps.astype(jnp.float32),
            stats.step_norm, stats.grad_norm,
            ratio,
        ]
    )


@partial(jax.jit, static_argnames=("opt_f", "opt_pp", "opts"))
def _solve_padded(
    packed,      # (m, 8) f32: X(3) | x(2) | weight | mask | unused
    params,      # (16,) f32: q(4) t(3) fx fy cx cy aspect w h sign err
    *, opt_f: bool, opt_pp: bool, opts: BundleOptions,
):
    """One-dispatch PnP solve.

    Every dynamic input rides in two packed arrays and the result is one
    flat vector: interactive solves (pin drags fire per mouse-move,
    cpp/pin_mode.cc:219-246) must not pay a host round trip per scalar.
    ``opts`` is static: solver tolerances change at most per session.
    """
    return solve_arrays(
        packed[:, 0:3], packed[:, 3:5], packed[:, 5],
        packed[:, 6] > 0.0, params,
        opt_f=opt_f, opt_pp=opt_pp, opts=opts,
    )


_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_size(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 8192) * 8192)


def pack_camera_params(cam_host, max_inlier_error: float) -> np.ndarray:
    """16-float camera/params vector shared by every one-dispatch solver:
    [q(4) t(3) fx fy cx cy aspect w h sign max_inlier_error]."""
    ci = cam_host.intrinsics
    return np.array(
        [
            *np.asarray(cam_host.pose.q, np.float32).reshape(4),
            *np.asarray(cam_host.pose.t, np.float32).reshape(3),
            float(ci.fx), float(ci.fy), float(ci.cx), float(ci.cy),
            float(ci.aspect_ratio), float(ci.width), float(ci.height),
            float(ci.sign), float(max_inlier_error),
        ],
        np.float32,
    )


def normalize_bundle_opts(b: BundleOptions) -> BundleOptions:
    """Coerce fields to hashable python scalars (static jit arg)."""
    return BundleOptions(
        max_iterations=int(b.max_iterations),
        loss_type=int(b.loss_type),
        loss_scale=float(b.loss_scale),
        gradient_tol=float(b.gradient_tol),
        step_tol=float(b.step_tol),
        initial_lambda=float(b.initial_lambda),
        min_lambda=float(b.min_lambda),
        max_lambda=float(b.max_lambda),
        function_tol=float(getattr(b, "function_tol", 0.0)),
    )


def solve_pnp(
    object_points,
    image_points,
    cam0: C.CameraState,
    opts: PnPOptions = PnPOptions(),
    weights=None,
) -> PnPResult:
    """Host-facing PnP entry (cpp/pnp/solvers.cc:50-78).

    Pads to fixed bucket sizes so repeated interactive solves reuse the same
    compiled executable.
    """
    X = np.ascontiguousarray(object_points, np.float32).reshape(-1, 3)
    x = np.ascontiguousarray(image_points, np.float32).reshape(-1, 2)
    n = X.shape[0]
    if n != x.shape[0]:
        raise ValueError("object/image point count mismatch")
    if n < 3:
        raise ValueError("PnP needs at least 3 points")

    m = bucket_size(n)
    packed = np.zeros((m, 8), np.float32)
    packed[:n, 0:3] = X
    packed[:n, 3:5] = x
    packed[:n, 6] = 1.0
    # Padded image targets at the projection of a dummy point would produce
    # garbage residuals; they are masked out everywhere.
    if weights is None:
        packed[:n, 5] = 1.0
    else:
        packed[:n, 5] = np.ascontiguousarray(
            weights, np.float32
        ).reshape(-1)

    # Intrinsics optimization requires > 3 points (cpp/pnp/pnp_problem.h:34)
    opt_f = bool(opts.optimize_focal_length) and n > 3
    opt_pp = bool(opts.optimize_principal_point) and n > 3

    # One host-side gather of the warm-start camera (it may hold device
    # scalars from a previous solve), one packed upload, one download.
    c = jax.device_get(cam0)
    ci = c.intrinsics
    params = pack_camera_params(c, opts.max_inlier_error)
    static_opts = normalize_bundle_opts(opts.bundle_opts)
    out = np.asarray(
        _solve_padded(
            packed, params, opt_f=opt_f, opt_pp=opt_pp, opts=static_opts
        )
    )
    intr_out = C.Intrinsics(
        fx=np.float32(out[7]), fy=np.float32(out[8]),
        cx=np.float32(out[9]), cy=np.float32(out[10]),
        aspect_ratio=ci.aspect_ratio, width=ci.width, height=ci.height,
        sign=ci.sign,
    )
    camera = C.CameraState(intr_out, P.Pose(out[0:4], out[4:7]))
    stats = BundleStats(
        iterations=np.int32(out[11]),
        initial_cost=np.float32(out[12]),
        cost=np.float32(out[13]),
        lambda_=np.float32(out[14]),
        invalid_steps=np.int32(out[15]),
        step_norm=np.float32(out[16]),
        grad_norm=np.float32(out[17]),
    )
    return PnPResult(camera=camera, stats=stats, inlier_ratio=out[18])
