"""Host-numpy PnP fast path: parity with the device solver.

The interactive pin path (engine/pinmode.py) routes small solves through
engine/pnp_host.py to dodge per-mouse-move dispatch latency; these tests
pin the host solver to the device solver's results.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from polychase_tpu.engine import camera as C
from polychase_tpu.engine import pose as P
from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY, HUBER, TRIVIAL
from polychase_tpu.engine.pnp import PnPOptions, solve_pnp
from polychase_tpu.engine.pnp_host import solve_pnp_host

from synthetic import make_intrinsics


def _problem(seed, n=8, noise=0.5):
    rng = np.random.default_rng(seed)
    intr = make_intrinsics()
    X = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    q_true = P.quat_normalize(
        jnp.asarray([1.0, 0.05, -0.03, 0.02], jnp.float32)
    )
    t_true = jnp.asarray([0.05, -0.02, 3.0], jnp.float32)
    cam_true = C.CameraState(intr, P.Pose(q_true, t_true))
    x = np.asarray(
        C.project(intr, P.pose_apply(P.Pose(q_true, t_true), jnp.asarray(X)))
    )
    x = (x + rng.normal(0, noise, x.shape)).astype(np.float32)
    cam0 = C.CameraState(
        intr, P.Pose(jnp.asarray([1.0, 0, 0, 0]), jnp.asarray([0.0, 0, 2.8]))
    )
    return X, x, cam0


def _rmse(cam, X, x):
    c = np.asarray
    Xj = jnp.asarray(X)
    proj = np.asarray(C.project(cam.intrinsics, P.pose_apply(
        P.Pose(jnp.asarray(c(cam.pose.q)), jnp.asarray(c(cam.pose.t))), Xj)))
    return float(np.sqrt(np.mean(np.sum((proj - x) ** 2, axis=-1))))


@pytest.mark.parametrize("loss", [TRIVIAL, HUBER, CAUCHY])
def test_host_matches_device(loss):
    X, x, cam0 = _problem(0)
    opts = PnPOptions(bundle_opts=BundleOptions(loss_type=loss))
    dev = solve_pnp(X, x, cam0, opts)
    host = solve_pnp_host(X, x, cam0, opts)
    # Both converge to the same optimum (float32 device vs float64 host)
    np.testing.assert_allclose(
        np.asarray(host.camera.pose.t), np.asarray(dev.camera.pose.t),
        atol=2e-3,
    )
    q_h, q_d = np.asarray(host.camera.pose.q), np.asarray(dev.camera.pose.q)
    assert abs(float(np.dot(q_h, q_d))) > 1.0 - 1e-6
    assert abs(_rmse(host.camera, X, x) - _rmse(dev.camera, X, x)) < 1e-2
    assert host.inlier_ratio == pytest.approx(float(dev.inlier_ratio))


def test_host_matches_device_intrinsics():
    X, x, cam0 = _problem(1, n=12, noise=0.2)
    opts = PnPOptions(
        bundle_opts=BundleOptions(loss_type=TRIVIAL),
        optimize_focal_length=True,
        optimize_principal_point=True,
    )
    dev = solve_pnp(X, x, cam0, opts)
    host = solve_pnp_host(X, x, cam0, opts)
    assert abs(_rmse(host.camera, X, x) - _rmse(dev.camera, X, x)) < 2e-2
    i_h, i_d = host.camera.intrinsics, dev.camera.intrinsics
    assert float(i_h.fy) == pytest.approx(float(i_d.fy), rel=5e-3)
    assert float(i_h.cx) == pytest.approx(float(i_d.cx), abs=1.0)
    assert float(i_h.cy) == pytest.approx(float(i_d.cy), abs=1.0)


def test_host_intrinsics_gate_three_points():
    """<=3 points: intrinsics untouched (cpp/pnp/pnp_problem.h:34-35)."""
    X, x, cam0 = _problem(2, n=3, noise=0.0)
    opts = PnPOptions(
        optimize_focal_length=True, optimize_principal_point=True
    )
    host = solve_pnp_host(X, x, cam0, opts)
    i0, i1 = cam0.intrinsics, host.camera.intrinsics
    assert float(i1.fy) == float(i0.fy)
    assert float(i1.cx) == float(i0.cx)
    assert float(i1.cy) == float(i0.cy)


def test_pinmode_host_vs_device_route(monkeypatch):
    """find_transformation gives the same answer through both routes."""
    from polychase_tpu.engine.geometry import (
        SceneTransformations, TRANSFORM_MODEL,
    )
    from polychase_tpu.engine.pinmode import PinUpdate, find_transformation

    intr = make_intrinsics()
    scene = SceneTransformations(
        model_matrix=jnp.eye(4),
        view_matrix=jnp.asarray(
            np.block(
                [[np.eye(3), np.array([[0.0], [0.0], [3.0]])],
                 [np.zeros((1, 3)), np.ones((1, 1))]]
            ),
            jnp.float32,
        ),
        intrinsics=intr,
    )
    obj = np.array(
        [
            [0.3, 0.3, 0.0], [-0.3, 0.3, 0.1], [-0.3, -0.3, 0.0],
            [0.3, -0.3, -0.1], [0.0, 0.0, 0.2],
        ],
        np.float32,
    )
    mv = np.asarray(scene.view_matrix, np.float64)
    Xc = obj @ mv[:3, :3].T + mv[:3, 3]
    K = np.asarray(C.proj_matrix_3x3(intr), np.float64)
    p = Xc @ K.T
    px = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    upd = PinUpdate(2, px[2] + np.array([10.0, 6.0], np.float32))

    monkeypatch.setenv("POLYCHASE_HOST_PIN_MAX", "4096")
    out_host = find_transformation(obj, scene, scene, upd, TRANSFORM_MODEL)
    monkeypatch.setenv("POLYCHASE_HOST_PIN_MAX", "0")
    out_dev = find_transformation(obj, scene, scene, upd, TRANSFORM_MODEL)
    np.testing.assert_allclose(
        np.asarray(out_host.model_matrix), np.asarray(out_dev.model_matrix),
        atol=2e-4,
    )


def test_host_solve_latency():
    """The point of the fast path: an 8-pin solve is sub-millisecond-ish
    on host, below a device dispatch's latency."""
    import time

    X, x, cam0 = _problem(3)
    opts = PnPOptions(bundle_opts=BundleOptions(loss_type=TRIVIAL))
    solve_pnp_host(X, x, cam0, opts)  # warm numpy
    t0 = time.perf_counter()
    for _ in range(10):
        solve_pnp_host(X, x, cam0, opts)
    dt = (time.perf_counter() - t0) / 10
    assert dt < 0.005, f"host pin solve too slow: {dt*1e3:.2f} ms"


def test_host_matches_device_nonunit_aspect():
    """fx/fy clamp independently near the FOV bounds when aspect != 1;
    the host twin must mirror the device step exactly."""
    rng = np.random.default_rng(7)
    intr = C.Intrinsics.create(
        720.0, 600.0, 320.0, 240.0, 1.2, 640.0, 480.0, C.OPENCV
    )
    X = rng.normal(0.0, 0.5, (12, 3)).astype(np.float32)
    q_true = P.quat_normalize(jnp.asarray([1.0, 0.04, -0.02, 0.01]))
    t_true = jnp.asarray([0.05, -0.02, 3.0])
    x = np.asarray(
        C.project(intr, P.pose_apply(P.Pose(q_true, t_true),
                                     jnp.asarray(X)))
    ).astype(np.float32)
    # Start with a badly wrong focal so the clamp region is visited
    intr0 = intr._replace(fx=np.float32(1.2 * 450.0), fy=np.float32(450.0))
    cam0 = C.CameraState(intr0, P.Pose(q_true, t_true))
    opts = PnPOptions(
        bundle_opts=BundleOptions(loss_type=TRIVIAL),
        optimize_focal_length=True,
    )
    dev = solve_pnp(X, x, cam0, opts)
    host = solve_pnp_host(X, x, cam0, opts)
    assert float(host.camera.intrinsics.fy) == pytest.approx(
        float(dev.camera.intrinsics.fy), rel=1e-3
    )
    assert float(host.camera.intrinsics.fx) == pytest.approx(
        float(dev.camera.intrinsics.fx), rel=1e-3
    )
