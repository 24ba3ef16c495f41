"""The tracking chain's PnP solve (engine/pnp.solve_arrays, an XLA
``lax.while_loop`` LM) against the float64 host solver
(engine/pnp_host) on tracking-shaped problems: hundreds of points,
masked padding rows, points behind the camera, every loss, and the
9-parameter pose + intrinsics solve."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from polychase_tpu.engine import camera as C
from polychase_tpu.engine import pose as P
from polychase_tpu.engine.levmarq import BundleOptions
from polychase_tpu.engine.pnp import (
    PnPOptions, pack_camera_params, solve_arrays,
)
from polychase_tpu.engine.pnp_host import solve_pnp_host

MAX_INLIER_ERROR = 12.0


def _scene(n=300, n_masked=50, seed=0, behind=0, convention=C.OPENGL,
           f_err=1.0, pp_err=(0.0, 0.0)):
    """Points in front of the camera, projected with 0.4 px noise; the
    last ``n_masked`` rows are padding (mask off)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    gl = convention == C.OPENGL
    X[:, 2] += -6.0 if gl else 6.0
    if behind:
        X[:behind, 2] += 14.0 if gl else -14.0
    intr = C.Intrinsics.create(1800.0, 1800.0, 960.0, 540.0, 1.0, 1920,
                               1080, convention)
    q_gt = np.array([0.99, 0.05, -0.08, 0.03], np.float32)
    q_gt /= np.linalg.norm(q_gt)
    t_gt = np.array([0.1, -0.2, 0.3], np.float32)
    x = np.asarray(C.project(intr, P.pose_apply(
        P.Pose(jnp.asarray(q_gt), jnp.asarray(t_gt)), jnp.asarray(X))))
    x = (x + rng.normal(scale=0.4, size=(n, 2))).astype(np.float32)
    mask = np.ones(n, bool)
    if n_masked:
        mask[-n_masked:] = False
    intr0 = C.Intrinsics.create(
        1800.0 * f_err, 1800.0 * f_err, 960.0 + pp_err[0],
        540.0 + pp_err[1], 1.0, 1920, 1080, convention,
    )
    q0 = q_gt + np.array([0.01, -0.02, 0.015, 0.01], np.float32)
    cam0 = C.CameraState(intr0, P.Pose(
        jnp.asarray(q0 / np.linalg.norm(q0)),
        jnp.asarray([0.15, -0.1, 0.2], jnp.float32)))
    return X, x, mask, cam0, q_gt, t_gt


def _solve_both(X, x, mask, cam0, opts, opt_f=False, opt_pp=False):
    params = pack_camera_params(jax.device_get(cam0), MAX_INLIER_ERROR)
    dev = np.asarray(solve_arrays(
        jnp.asarray(X), jnp.asarray(x),
        jnp.asarray(mask.astype(np.float32)), jnp.asarray(mask),
        jnp.asarray(params), opt_f=opt_f, opt_pp=opt_pp, opts=opts,
    ))
    host = solve_pnp_host(
        X[mask], x[mask], cam0,
        PnPOptions(bundle_opts=opts, max_inlier_error=MAX_INLIER_ERROR,
                   optimize_focal_length=opt_f,
                   optimize_principal_point=opt_pp),
    )
    return dev, host


def _assert_same_pose(dev, host, t_atol=2e-3):
    q_h = np.asarray(host.camera.pose.q)
    assert abs(float(np.dot(q_h, dev[:4]))) > 1.0 - 1e-6
    np.testing.assert_allclose(dev[4:7], np.asarray(host.camera.pose.t),
                               atol=t_atol)
    assert dev[18] == pytest.approx(float(host.inlier_ratio), abs=1e-3)


@pytest.mark.parametrize("loss_type", [0, 1, 2])
@pytest.mark.parametrize("ftol", [0.0, 1e-5])
def test_matches_host_every_loss(loss_type, ftol):
    X, x, mask, cam0, q_gt, t_gt = _scene()
    dev, host = _solve_both(
        X, x, mask, cam0,
        BundleOptions(max_iterations=30, loss_type=loss_type,
                      function_tol=ftol),
    )
    _assert_same_pose(dev, host)
    assert np.abs(dev[4:7] - t_gt).max() < 2e-2
    assert min(np.linalg.norm(dev[:4] - q_gt),
               np.linalg.norm(dev[:4] + q_gt)) < 2e-3


def test_behind_camera_points():
    X, x, mask, cam0, _, _ = _scene(behind=40)
    dev, host = _solve_both(
        X, x, mask, cam0,
        BundleOptions(max_iterations=30, loss_type=2),
    )
    _assert_same_pose(dev, host)


def test_all_rows_masked_stays_finite():
    X, x, mask, cam0, _, _ = _scene()
    mask[:] = False
    params = pack_camera_params(jax.device_get(cam0), MAX_INLIER_ERROR)
    dev = np.asarray(solve_arrays(
        jnp.asarray(X), jnp.asarray(x), jnp.zeros(len(X)),
        jnp.asarray(mask), jnp.asarray(params), opt_f=False, opt_pp=False,
        opts=BundleOptions(max_iterations=10, loss_type=1),
    ))
    assert np.all(np.isfinite(dev[:11]))
    np.testing.assert_allclose(dev[:7], params[:7], atol=1e-6)
    assert dev[18] == 0.0


def test_padding_rows_do_not_change_the_solve():
    """A 333-point solve equals the same points padded to 512 with
    masked rows (the scan chain pads every frame to a bucket)."""
    X, x, mask, cam0, _, _ = _scene(n=333, n_masked=0, seed=4)
    opts = BundleOptions(max_iterations=30, loss_type=1)
    params = jnp.asarray(
        pack_camera_params(jax.device_get(cam0), MAX_INLIER_ERROR))

    def solve(X, x, m):
        return np.asarray(solve_arrays(
            jnp.asarray(X), jnp.asarray(x),
            jnp.asarray(m.astype(np.float32)), jnp.asarray(m), params,
            opt_f=False, opt_pp=False, opts=opts))

    pad = 512 - 333
    a = solve(X, x, mask)
    b = solve(np.concatenate([X, np.zeros((pad, 3), np.float32)]),
              np.concatenate([x, np.zeros((pad, 2), np.float32)]),
              np.concatenate([mask, np.zeros(pad, bool)]))
    np.testing.assert_allclose(b[:7], a[:7], atol=1e-5)
    assert b[18] == pytest.approx(a[18])


@pytest.mark.parametrize(
    "opt_f,opt_pp", [(True, False), (False, True), (True, True)]
)
def test_variable_intrinsics_match_host(opt_f, opt_pp):
    """9-param solves from a -12.5% focal / 8 px principal-point error."""
    X, x, mask, cam0, _, _ = _scene(
        seed=3, convention=C.OPENCV, n_masked=0,
        f_err=0.875 if opt_f else 1.0,
        pp_err=(8.0, -6.0) if opt_pp else (0.0, 0.0),
    )
    dev, host = _solve_both(
        X, x, mask, cam0,
        BundleOptions(max_iterations=50, loss_type=1),
        opt_f=opt_f, opt_pp=opt_pp,
    )
    _assert_same_pose(dev, host, t_atol=5e-3)
    hi = host.camera.intrinsics
    np.testing.assert_allclose(
        dev[7:11], [float(hi.fx), float(hi.fy), float(hi.cx), float(hi.cy)],
        rtol=2e-3, atol=1.0)
    if opt_f:
        assert abs(dev[8] - 1800.0) < 25.0
    if opt_pp:
        assert abs(dev[9] - 960.0) < 4.0 and abs(dev[10] - 540.0) < 4.0


def test_intrinsics_gate_three_points():
    """<=3 valid points: intrinsics stay frozen
    (cpp/pnp/pnp_problem.h:34-35)."""
    X, x, mask, cam0, _, _ = _scene(seed=3, convention=C.OPENCV,
                                    n_masked=0, f_err=0.9)
    mask[3:] = False
    params = pack_camera_params(jax.device_get(cam0), MAX_INLIER_ERROR)
    dev = np.asarray(solve_arrays(
        jnp.asarray(X), jnp.asarray(x), jnp.asarray(mask.astype(np.float32)),
        jnp.asarray(mask), jnp.asarray(params), opt_f=True, opt_pp=True,
        opts=BundleOptions(max_iterations=20, loss_type=0),
    ))
    np.testing.assert_allclose(dev[7:11], params[7:11], atol=0.0)
