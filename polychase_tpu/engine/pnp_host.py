"""Host (numpy) iterative PnP — the interactive fast path.

A pin drag fires one solve per mouse-move (cpp/pin_mode.cc:219-246 via
blender_addon/operators/pin_mode/pin_mode.py:452-467).  An 8-pin
9-parameter LM is microseconds of numpy, less than the launch and transfer
latency of any device dispatch.  This module mirrors ``engine.pnp.solve_arrays`` in float64 numpy:
same residual/Jacobian math (cpp/pnp/pnp_problem.h:52-131), same Nielsen λ
schedule (cpp/pnp/lev_marq.h:179-214), same FOV bounds clamping and the
<4-points intrinsics gate.  ``engine.pinmode`` routes tiny solves here and
keeps the device path for large point counts; tests/test_pinmode.py asserts
parity between the two.
"""

from __future__ import annotations

import numpy as np

from . import camera as C
from . import pose as P
from .levmarq import BundleStats, CAUCHY, HUBER, TRIVIAL
from .pnp import PnPOptions, PnPResult

_BEHIND_RESIDUAL = 1e18  # matches engine.pnp._BEHIND_RESIDUAL


# ---------------------------------------------------------------------------
# Host quaternion / camera helpers (float64 twins of engine.pose / camera)
# ---------------------------------------------------------------------------


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def _quat_exp(w_delta):
    sq = float(np.dot(w_delta, w_delta))
    if sq < 1e-12:
        return np.concatenate([[1.0 - sq / 8.0], (0.5 - sq / 48.0) * w_delta])
    angle = np.sqrt(sq)
    half = 0.5 * angle
    return np.concatenate(
        [[np.cos(half)], (np.sin(half) / angle) * w_delta]
    )


def _quat_step_post(q, w_delta):
    """Right-multiplicative retraction q · exp(δω) (cpp/pnp/quaternion.h)."""
    return _quat_mul(q, _quat_exp(w_delta))


def _bounds(width, height, sign):
    """FOV bounds for (fy, cx, cy) — numpy twin of
    engine.camera.intrinsics_bounds (keep in sync with
    engine/camera.py:68; cpp/pnp/types.h:156-192)."""
    min_tan = np.tan(np.deg2rad(15.0) / 2)
    max_tan = np.tan(np.deg2rad(160.0) / 2)
    half_w = width / 2.0
    f_low_cv, f_high_cv = half_w / max_tan, half_w / min_tan
    if sign < 0:
        f_low, f_high = -f_high_cv, -f_low_cv
    else:
        f_low, f_high = f_low_cv, f_high_cv
    return f_low, f_high, 0.0, width, 0.0, height


def _loss_value(loss_type, scale, r2):
    if loss_type == TRIVIAL:
        return r2
    if loss_type == HUBER:
        thr2 = scale * scale
        r = np.sqrt(np.maximum(r2, 0))
        return np.where(r2 <= thr2, r2, scale * (2.0 * r - scale))
    if loss_type == CAUCHY:
        thr2 = scale * scale
        return thr2 * np.log1p(r2 / thr2)
    raise ValueError(f"unknown loss type {loss_type}")


def _loss_weight(loss_type, scale, r2):
    if loss_type == TRIVIAL:
        return np.ones_like(r2)
    if loss_type == HUBER:
        thr2 = scale * scale
        r = np.sqrt(np.maximum(r2, 1e-30))
        return np.where(r2 <= thr2, 1.0, scale / r)
    if loss_type == CAUCHY:
        inv_thr2 = 1.0 / (scale * scale)
        return np.maximum(1.18e-38, 1.0 / (1.0 + r2 * inv_thr2))
    raise ValueError(f"unknown loss type {loss_type}")


class _Cam:
    """Mutable host camera state: q(4) t(3) fx fy cx cy (+ aspect/sign).

    ``fx`` is stored separately because the device step clamps fx and fy
    INDEPENDENTLY (fy stepped then clamped; fx = clip(aspect*fy)), so
    near the FOV bounds with aspect != 1 they decouple."""

    __slots__ = (
        "q", "t", "fx", "fy", "cx", "cy", "aspect", "sign", "w", "h",
    )

    def __init__(self, q, t, fx, fy, cx, cy, aspect, sign, w, h):
        self.q, self.t = q, t
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.aspect, self.sign, self.w, self.h = aspect, sign, w, h

    def copy(self):
        return _Cam(
            self.q.copy(), self.t.copy(), self.fx, self.fy, self.cx,
            self.cy, self.aspect, self.sign, self.w, self.h,
        )


def _rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _residuals(cam: _Cam, X, x):
    """(N,2) residuals, behind mask (cpp/pnp/pnp_problem.h:52-61)."""
    Z = X @ _rotmat(cam.q).T + cam.t
    behind = cam.sign * Z[:, 2] < 0.0
    z = np.stack(
        [cam.fx * Z[:, 0] / Z[:, 2] + cam.cx,
         cam.fy * Z[:, 1] / Z[:, 2] + cam.cy],
        axis=-1,
    )
    res = z - x
    res[behind] = _BEHIND_RESIDUAL
    return res, behind


def _residuals_jac(cam: _Cam, X, x, opt_f, opt_pp):
    """Residuals + (N,2,9) Jacobians (cpp/pnp/pnp_problem.h:63-99)."""
    R = _rotmat(cam.q)
    Z = X @ R.T + cam.t
    Xc, Yc, Zc = Z[:, 0], Z[:, 1], Z[:, 2]
    inv_z = 1.0 / Zc
    z = np.stack(
        [cam.fx * Xc * inv_z + cam.cx, cam.fy * Yc * inv_z + cam.cy], axis=-1
    )
    res = z - x

    n = X.shape[0]
    zero = np.zeros(n)
    # dz/dZ (N,2,3)
    dz_dZ = np.stack(
        [
            cam.fx * inv_z, zero, -cam.fx * Xc * inv_z * inv_z,
            zero, cam.fy * inv_z, -cam.fy * Yc * inv_z * inv_z,
        ],
        axis=-1,
    ).reshape(n, 2, 3)
    # dZ/dω = R · skew(-p) for right-mult so(3) (cpp/pose.h:69-87)
    px, py, pz = X[:, 0], X[:, 1], X[:, 2]
    skew_neg = np.stack(
        [zero, pz, -py, -pz, zero, px, py, -px, zero], axis=-1
    ).reshape(n, 3, 3)
    dZ_dR = np.einsum("ij,njk->nik", R, skew_neg)

    J_rot = np.einsum("nij,njk->nik", dz_dZ, dZ_dR)
    J_t = dz_dZ
    # d z / d (fy, cx, cy) with fx = aspect·fy (cpp/pnp/types.h:69-93)
    one = np.ones(n)
    dz_dintr = np.stack(
        [cam.aspect * Xc * inv_z, one, zero, Yc * inv_z, zero, one], axis=-1
    ).reshape(n, 2, 3)
    if not opt_f:
        dz_dintr[:, :, 0] = 0.0
    if not opt_pp:
        dz_dintr[:, :, 1:] = 0.0
    return res, np.concatenate([J_rot, J_t, dz_dintr], axis=-1)


def _total_cost(cam, X, x, weights, loss_type, loss_scale):
    res, _ = _residuals(cam, X, x)
    r2 = np.sum(res * res, axis=-1)
    return float(np.sum(weights * _loss_value(loss_type, loss_scale, r2)))


def _normal_equations(cam, X, x, weights, loss_type, loss_scale, opt_f, opt_pp):
    res, J = _residuals_jac(cam, X, x, opt_f, opt_pp)
    r2 = np.sum(res * res, axis=-1)
    w = weights * _loss_weight(loss_type, loss_scale, r2)
    JtJ = np.einsum("nlp,nlq,n->pq", J, J, w)
    Jtr = np.einsum("nlp,nl,n->p", J, res, w)
    return JtJ, Jtr


def _damped_solve(JtJ, Jtr, lam):
    """Damped equilibrated Cholesky (engine.levmarq.damped_cholesky_solve)."""
    diag = np.clip(np.diagonal(JtJ), 1e-6, 1e32)
    damped = diag * (1.0 + lam)
    A = JtJ.copy()
    np.fill_diagonal(A, damped)
    d = 1.0 / np.sqrt(damped)
    As = A * d[:, None] * d[None, :]
    try:
        L = np.linalg.cholesky(As)
    except np.linalg.LinAlgError:
        return np.zeros_like(Jtr), False
    y = np.linalg.solve(L, Jtr * d)
    s = np.linalg.solve(L.T, y)
    step = -(s * d)
    ok = bool(np.all(np.isfinite(step)))
    return (step if ok else np.zeros_like(step)), ok


def _apply_step(cam: _Cam, dp, bounds, opt_f, opt_pp):
    """LM step with bounds clamping (cpp/pnp/pnp_problem.h:101-131)."""
    new = cam.copy()
    new.q = _quat_step_post(cam.q, dp[0:3])
    new.t = cam.t + dp[3:6]
    f_low, f_high, cx_low, cx_high, cy_low, cy_high = bounds
    if opt_f:
        # fy stepped then clamped; fx clamped independently — exactly
        # the device step (engine/pnp.py _step).
        new.fy = float(np.clip(cam.fy + dp[6], f_low, f_high))
        new.fx = float(np.clip(new.aspect * new.fy, f_low, f_high))
    if opt_pp:
        new.cx = float(np.clip(cam.cx + dp[7], cx_low, cx_high))
        new.cy = float(np.clip(cam.cy + dp[8], cy_low, cy_high))
    return new


def solve_pnp_host(
    object_points,
    image_points,
    cam0: C.CameraState,
    opts: PnPOptions = PnPOptions(),
    weights=None,
) -> PnPResult:
    """Drop-in host twin of :func:`engine.pnp.solve_pnp`.

    Identical semantics (residuals, λ schedule, clamping, inlier ratio) in
    float64 numpy — zero device traffic.  Intended for interactive solves
    with small N where dispatch latency dominates.
    """
    X = np.asarray(object_points, np.float64).reshape(-1, 3)
    x = np.asarray(image_points, np.float64).reshape(-1, 2)
    n = X.shape[0]
    if n != x.shape[0]:
        raise ValueError("object/image point count mismatch")
    if n < 3:
        raise ValueError("PnP needs at least 3 points")
    w_arr = (
        np.ones(n) if weights is None
        else np.asarray(weights, np.float64).reshape(-1)
    )

    import jax

    c = jax.device_get(cam0)
    ci = c.intrinsics
    cam = _Cam(
        q=np.asarray(c.pose.q, np.float64).reshape(4).copy(),
        t=np.asarray(c.pose.t, np.float64).reshape(3).copy(),
        fx=float(ci.fx), fy=float(ci.fy), cx=float(ci.cx),
        cy=float(ci.cy),
        aspect=float(ci.aspect_ratio), sign=float(ci.sign),
        w=float(ci.width), h=float(ci.height),
    )
    bounds = _bounds(cam.w, cam.h, cam.sign)

    b = opts.bundle_opts
    loss_type, loss_scale = int(b.loss_type), float(b.loss_scale)
    # Intrinsics optimization requires > 3 points (cpp/pnp/pnp_problem.h:34)
    opt_f = bool(opts.optimize_focal_length) and n > 3
    opt_pp = bool(opts.optimize_principal_point) and n > 3

    cost = _total_cost(cam, X, x, w_arr, loss_type, loss_scale)
    initial_cost = cost
    JtJ, Jtr = _normal_equations(
        cam, X, x, w_arr, loss_type, loss_scale, opt_f, opt_pp
    )
    grad_norm = float(np.linalg.norm(Jtr))
    lam, v = float(b.initial_lambda), 2.0
    iterations, invalid_steps, step_norm = 0, 0, -1.0
    done = grad_norm < b.gradient_tol

    while not done and iterations < b.max_iterations:
        step, solve_ok = _damped_solve(JtJ, Jtr, lam)
        step_norm = float(np.linalg.norm(step))
        cam_new = _apply_step(cam, step, bounds, opt_f, opt_pp)
        cost_new = _total_cost(cam_new, X, x, w_arr, loss_type, loss_scale)

        improved = solve_ok and cost_new < cost
        tiny_step = solve_ok and step_norm < b.step_tol

        actual = cost_new - cost
        expected = float(np.dot(step, 2.0 * Jtr + JtJ @ step))
        rho = actual / expected if expected != 0.0 else 0.0
        lam_saturated = lam >= b.max_lambda

        accept = improved and not tiny_step
        if accept:
            cam = cam_new
            cost = cost_new
            if rho > 0:
                factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam = float(np.clip(lam * factor, b.min_lambda, b.max_lambda))
            v = 2.0
            JtJ, Jtr = _normal_equations(
                cam, X, x, w_arr, loss_type, loss_scale, opt_f, opt_pp
            )
            grad_norm = float(np.linalg.norm(Jtr))
        else:
            lam = min(b.max_lambda, lam * v)
            v = 2.0 * v
        if not (improved or tiny_step):
            invalid_steps += 1

        done = (
            tiny_step
            or (accept and grad_norm < b.gradient_tol)
            or (not improved and not tiny_step and lam_saturated)
        )
        iterations += 1

    # Inlier ratio (cpp/pnp/solvers.cc:30-47)
    res, behind = _residuals(cam, X, x)
    err2 = np.sum(res * res, axis=-1)
    err2[behind] = np.inf
    max_err = float(opts.max_inlier_error)
    ratio = (
        float(np.sum(err2 < max_err * max_err)) / max(n, 1)
        if max_err > 0.0 else 0.0
    )

    f32 = np.float32
    intr_out = C.Intrinsics(
        fx=f32(cam.fx), fy=f32(cam.fy), cx=f32(cam.cx), cy=f32(cam.cy),
        aspect_ratio=f32(cam.aspect), width=f32(cam.w), height=f32(cam.h),
        sign=f32(cam.sign),
    )
    camera = C.CameraState(
        intr_out,
        P.Pose(cam.q.astype(np.float32), cam.t.astype(np.float32)),
    )
    stats = BundleStats(
        iterations=np.int32(iterations),
        initial_cost=f32(initial_cost),
        cost=f32(cost),
        lambda_=f32(lam),
        invalid_steps=np.int32(invalid_steps),
        step_norm=f32(step_norm),
        grad_norm=f32(grad_norm),
    )
    return PnPResult(camera=camera, stats=stats, inlier_ratio=f32(ratio))
