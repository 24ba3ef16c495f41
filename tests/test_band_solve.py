"""Block-tridiagonal (banded) LM solve: parity with the dense path.

The skip pattern bounds BA edge span, so the damped normal matrix is
block-tridiagonal in span-sized super-blocks; this solve replaces the
dense Cholesky with a lax.scan of small blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from polychase_tpu.engine.levmarq import (
    BundleOptions,
    CAUCHY,
    damped_block_tridiag_solve,
    damped_cholesky_solve,
)

from synthetic import (
    make_intrinsics,
    make_sphere_mesh,
    orbit_pose,
    project_points,
    sample_surface_points,
    visible_from,
)


@pytest.mark.parametrize("lam", [1e-5, 1e-2, 1.0])
def test_banded_matches_dense_solver(rng, lam):
    nb, bs = 6, 24
    n = nb * bs
    A = np.zeros((n, n))
    for i in range(nb):
        Q = rng.normal(0, 1, (bs, bs))
        A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = (
            Q @ Q.T + 5 * np.eye(bs)
        )
        if i + 1 < nb:
            E = rng.normal(0, 0.3, (bs, bs))
            A[(i + 1) * bs:(i + 2) * bs, i * bs:(i + 1) * bs] = E
            A[i * bs:(i + 1) * bs, (i + 1) * bs:(i + 2) * bs] = E.T
    b = rng.normal(0, 1, n)
    Aj, bj = jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32)
    s1, ok1 = damped_cholesky_solve(Aj, bj, jnp.float32(lam))
    s2, ok2 = damped_block_tridiag_solve(
        Aj, bj, jnp.float32(lam), nb=nb, bs=bs
    )
    assert bool(ok1) and bool(ok2)
    rel = float(jnp.max(jnp.abs(s1 - s2)) / jnp.max(jnp.abs(s1)))
    assert rel < 1e-4


def test_banded_handles_anchor_zero_rows(rng):
    """Anchored cameras contribute empty rows; the diag clamp must keep
    the factorization valid."""
    nb, bs = 6, 12
    n = nb * bs
    A = np.zeros((n, n))
    for i in range(nb):
        Q = rng.normal(0, 1, (bs, bs))
        A[i * bs:(i + 1) * bs, i * bs:(i + 1) * bs] = (
            Q @ Q.T + 3 * np.eye(bs)
        )
    # Zero-out first and last blocks (anchors)
    A[:bs] = 0.0; A[:, :bs] = 0.0
    A[-bs:] = 0.0; A[:, -bs:] = 0.0
    b = rng.normal(0, 1, n)
    b[:bs] = 0.0; b[-bs:] = 0.0
    s1, ok1 = damped_cholesky_solve(
        jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.float32(1e-3),
    )
    s2, ok2 = damped_block_tridiag_solve(
        jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32),
        jnp.float32(1e-3), nb=nb, bs=bs,
    )
    assert bool(ok1) and bool(ok2)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-5)


def test_refine_banded_matches_dense(tmp_path, monkeypatch):
    """End-to-end refine with the banded solve active vs forced dense."""
    from polychase_tpu.engine import camera as C, pose as P
    from polychase_tpu.engine.refiner import compute_band, refine_trajectory
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.io.database import Database

    rng = np.random.default_rng(4)
    mesh = make_sphere_mesh(10, 14)
    intr = make_intrinsics()
    N = 30
    poses = jax.device_get([orbit_pose(0.02 * t) for t in range(N)])

    db_path = str(tmp_path / "flow.db")
    db = Database(db_path)
    pts3d = {}
    for i in range(N):
        pts, normals = sample_surface_points(mesh, rng, 100)
        cam = C.CameraState(intr, poses[i])
        px, vis = project_points(cam, pts)
        vis &= visible_from(cam, pts, normals)
        db.write_keypoints(i, px[vis])
        pts3d[i] = pts[vis]
    for i in range(N):
        for skip in (-4, -2, -1, 1, 2, 4):
            j = i + skip
            if not 0 <= j < N:
                continue
            proj, ok = project_points(
                C.CameraState(intr, poses[j]), pts3d[i]
            )
            idx = np.nonzero(ok)[0].astype(np.uint32)
            db.write_image_pair_flow(
                i, j, idx,
                proj[ok] + rng.normal(0, 0.25, (idx.size, 2)).astype(
                    np.float32
                ),
                np.zeros(idx.size, np.float32),
            )
    db.close()

    def make_traj():
        rng2 = np.random.default_rng(9)
        traj = CameraTrajectory(0, N)
        for i in range(N):
            t = np.asarray(poses[i].t, np.float64)
            if i not in (0, N - 1):
                t = t + rng2.normal(0, 0.004, 3)
            traj.set(i, C.CameraState(
                intr,
                P.Pose(jnp.asarray(np.asarray(poses[i].q), jnp.float32),
                       jnp.asarray(t, jnp.float32)),
            ))
        return traj

    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0,
                         max_iterations=15)

    # The test scene must actually activate the banded path
    from polychase_tpu.engine.refiner import build_refiner_data

    db = Database(db_path)
    data = build_refiner_data(db, make_traj(), mesh, np.eye(4))
    db.close()
    assert compute_band(data, N, 6) != ()

    monkeypatch.setenv("POLYCHASE_BAND_SOLVE", "1")
    banded = refine_trajectory(
        db_path, make_traj(), np.eye(4, dtype=np.float32), mesh,
        bundle_opts=opts,
    )
    monkeypatch.setenv("POLYCHASE_BAND_SOLVE", "0")
    dense = refine_trajectory(
        db_path, make_traj(), np.eye(4, dtype=np.float32), mesh,
        bundle_opts=opts,
    )

    for f in range(N):
        tb = np.asarray(jax.device_get(banded.get(f).pose.t))
        td = np.asarray(jax.device_get(dense.get(f).pose.t))
        np.testing.assert_allclose(tb, td, atol=5e-4)
