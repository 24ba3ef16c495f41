"""End-to-end tracking tests on synthetic geometric flow databases."""

import numpy as np
import jax.numpy as jnp
import pytest

from polychase_tpu.engine import camera as C
from polychase_tpu.engine import pose as P
from polychase_tpu.engine.geometry import SceneTransformations
from polychase_tpu.engine.opticalflow import IMAGE_SKIPS
from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.tracker import (
    FrameTrackingResult,
    TrackingError,
    track_camera_trajectory,
    track_sequence,
)
from polychase_tpu.io.database import Database
from polychase_tpu.engine.trajectory import CameraTrajectory

from synthetic import (
    make_intrinsics,
    make_sphere_mesh,
    orbit_pose,
    project_points,
    sample_surface_points,
    visible_from,
)


def build_flow_db(path, mesh, intr, poses, rng, n_points=400):
    """Write a geometrically exact flow DB for the given camera path."""
    pts, normals = sample_surface_points(mesh, rng, n_points)
    db = Database(str(path))
    cams = [C.CameraState(intr, p) for p in poses]

    # Keypoints for frame f: projections of the points visible in f.
    vis, px = [], []
    for cam in cams:
        p, ok = project_points(cam, pts)
        ok &= visible_from(cam, pts, normals)
        vis.append(ok)
        px.append(p)
    for f, cam in enumerate(cams):
        db.write_keypoints(f, px[f][vis[f]])

    # Pair flows along the skip pattern: a match exists where the point is
    # visible in both frames.
    for f in range(len(cams)):
        idx_f = np.nonzero(vis[f])[0]
        lookup = {int(g): i for i, g in enumerate(idx_f)}
        for skip in IMAGE_SKIPS:
            g = f + skip
            if g < 0 or g >= len(cams):
                continue
            both = vis[f] & vis[g]
            point_ids = np.nonzero(both)[0]
            src_idx = np.array(
                [lookup[int(i)] for i in point_ids], np.uint32
            )
            db.write_image_pair_flow(
                f, g, src_idx, px[g][point_ids],
                np.zeros(len(point_ids), np.float32),
            )
    db.close()
    return pts


def pose_errors(a: P.Pose, b: P.Pose):
    qa, qb = np.asarray(a.q), np.asarray(b.q)
    dq = abs(float(np.dot(qa, qb)))
    rot_err = 2 * np.arccos(min(dq, 1.0))
    t_err = float(np.linalg.norm(np.asarray(a.t) - np.asarray(b.t)))
    return rot_err, t_err


@pytest.mark.parametrize("backward", [False, True])
def test_track_orbit(tmp_path, rng, backward):
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    n_frames = 12
    poses = [orbit_pose(0.04 * t) for t in range(n_frames)]
    db_path = tmp_path / "flow.db"
    build_flow_db(db_path, mesh, intr, poses, rng)

    start = n_frames - 1 if backward else 0
    end = 0 if backward else n_frames - 1
    scene = SceneTransformations(
        model_matrix=jnp.eye(4),
        view_matrix=P.pose_rt4x4(poses[start]),
        intrinsics=intr,
    )

    results = []
    track_sequence(
        str(db_path), start, end, scene, mesh,
        callback=lambda r: results.append(r) or True,
        bundle_opts=BundleOptions(loss_type=CAUCHY, loss_scale=1.0),
    )

    assert len(results) == n_frames - 1
    for r in results:
        assert isinstance(r, FrameTrackingResult)
        rot_err, t_err = pose_errors(r.pose, poses[r.frame])
        assert rot_err < 2e-3, (r.frame, rot_err)
        assert t_err < 5e-3, (r.frame, t_err)
        assert r.inlier_ratio > 0.99


def test_track_model_matrix(tmp_path, rng):
    """Tracking with a non-identity model matrix (object not at origin)."""
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    n_frames = 6

    # The "world" poses observe a translated+scaled object: fold the object
    # transform into the keypoint generation by moving the camera instead.
    model = np.eye(4, dtype=np.float32)
    model[:3, 3] = [0.3, -0.2, 0.1]

    # GT world camera poses; mesh points are in object space, world pts =
    # model @ obj.
    poses = [orbit_pose(0.05 * t) for t in range(n_frames)]

    pts_obj, normals = sample_surface_points(mesh, rng, 300)
    pts_world = pts_obj @ model[:3, :3].T + model[:3, 3]

    db = Database(str(tmp_path / "flow.db"))
    cams = [C.CameraState(intr, p) for p in poses]
    vis, px = [], []
    for cam in cams:
        p, ok = project_points(cam, pts_world)
        ok &= visible_from(cam, pts_world, normals)
        vis.append(ok)
        px.append(p)
    for f in range(n_frames):
        db.write_keypoints(f, px[f][vis[f]])
        idx_f = np.nonzero(vis[f])[0]
        lookup = {int(g): i for i, g in enumerate(idx_f)}
        for skip in IMAGE_SKIPS:
            g = f + skip
            if 0 <= g < n_frames:
                both = np.nonzero(vis[f] & vis[g])[0]
                src = np.array([lookup[int(i)] for i in both], np.uint32)
                db.write_image_pair_flow(
                    f, g, src, px[g][both], np.zeros(len(both), np.float32)
                )
    db.close()

    scene = SceneTransformations(
        model_matrix=jnp.asarray(model),
        view_matrix=P.pose_rt4x4(poses[0]),
        intrinsics=intr,
    )
    results = []
    track_sequence(
        str(tmp_path / "flow.db"), 0, n_frames - 1, scene, mesh,
        callback=lambda r: results.append(r) or True,
    )
    assert len(results) == n_frames - 1
    for r in results:
        rot_err, t_err = pose_errors(r.pose, poses[r.frame])
        assert rot_err < 2e-3 and t_err < 5e-3


def test_track_insufficient_features_raises(tmp_path):
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    db = Database(str(tmp_path / "flow.db"))
    db.write_keypoints(0, np.zeros((0, 2), np.float32))
    db.close()
    scene = SceneTransformations(
        model_matrix=jnp.eye(4),
        view_matrix=P.pose_rt4x4(orbit_pose(0.0)),
        intrinsics=intr,
    )
    with pytest.raises(TrackingError):
        track_sequence(str(tmp_path / "flow.db"), 0, 3, scene, mesh)


def test_track_callback_cancel(tmp_path, rng):
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(8)]
    db_path = tmp_path / "flow.db"
    build_flow_db(db_path, mesh, intr, poses, rng)
    scene = SceneTransformations(
        model_matrix=jnp.eye(4),
        view_matrix=P.pose_rt4x4(poses[0]),
        intrinsics=intr,
    )
    seen = []
    track_sequence(
        str(db_path), 0, 7, scene, mesh,
        callback=lambda r: seen.append(r.frame) or len(seen) < 3,
    )
    assert seen == [1, 2, 3]


def test_scan_chain_matches_per_frame(tmp_path, rng, monkeypatch):
    """The device-resident scan chain must produce the same trajectory as
    the per-frame dispatch path (same warm starts, same solves)."""
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    def run():
        traj = CameraTrajectory(0, len(poses))
        traj.set(0, C.CameraState(intr, poses[0]))
        track_camera_trajectory(
            Database(db_path), traj, 0, len(poses) - 1,
            np.eye(4, dtype=np.float32), mesh,
        )
        return traj

    from polychase_tpu.engine import tracker as T

    # The quantized target upload is its own (tolerance) test below;
    # this one pins the exact-chain equivalence.
    monkeypatch.setattr(T, "QUANT_TGT", False)
    monkeypatch.setenv("POLYCHASE_SCAN_TRACK", "0")
    ref = run()
    monkeypatch.setenv("POLYCHASE_SCAN_TRACK", "1")
    got = run()
    for i in range(1, len(poses)):
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.q), np.asarray(ref.get(i).pose.q),
            atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.t), np.asarray(ref.get(i).pose.t),
            atol=1e-4,
        )


def test_packed_idx_upload_bit_exact(tmp_path, rng, monkeypatch):
    """The packed-index upload format (keypoint table + u16 indices +
    counts) must be BIT-IDENTICAL to the legacy f32-pixels + bool-mask
    format: the device gather yields the same f32 keypoint values and
    ``iota < count`` equals the prefix mask, so every downstream f32 op
    sees the same operands."""
    from polychase_tpu.engine import tracker as T

    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    def run():
        traj = CameraTrajectory(0, len(poses))
        traj.set(0, C.CameraState(intr, poses[0]))
        track_camera_trajectory(
            Database(db_path), traj, 0, len(poses) - 1,
            np.eye(4, dtype=np.float32), mesh,
        )
        return traj

    monkeypatch.setattr(T, "QUANT_TGT", False)
    monkeypatch.setattr(T, "PACKED_IDX", False)
    ref = run()
    monkeypatch.setattr(T, "PACKED_IDX", True)
    got = run()
    for i in range(1, len(poses)):
        np.testing.assert_array_equal(
            np.asarray(got.get(i).pose.q), np.asarray(ref.get(i).pose.q)
        )
        np.testing.assert_array_equal(
            np.asarray(got.get(i).pose.t), np.asarray(ref.get(i).pose.t)
        )


def test_fused_meta_upload_bit_exact(tmp_path, rng, monkeypatch):
    """The consolidated i32 meta upload (src_idx|cnt|tgt_i|warm_i|qs in
    one array, 3 host buffers per chunk instead of 7) must be
    BIT-IDENTICAL to the separate-array packed format: integers are
    copied verbatim and the f32 scale round-trips through an i32
    bitcast."""
    from polychase_tpu.engine import tracker as T

    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    def run():
        traj = CameraTrajectory(0, len(poses))
        traj.set(0, C.CameraState(intr, poses[0]))
        track_camera_trajectory(
            Database(db_path), traj, 0, len(poses) - 1,
            np.eye(4, dtype=np.float32), mesh,
        )
        return traj

    for quant in (False, True):
        monkeypatch.setattr(T, "QUANT_TGT", quant)
        monkeypatch.setattr(T, "_FUSED_META", False)
        ref = run()
        monkeypatch.setattr(T, "_FUSED_META", True)
        got = run()
        for i in range(1, len(poses)):
            np.testing.assert_array_equal(
                np.asarray(got.get(i).pose.q), np.asarray(ref.get(i).pose.q)
            )
            np.testing.assert_array_equal(
                np.asarray(got.get(i).pose.t), np.asarray(ref.get(i).pose.t)
            )


def test_quant_tgt_upload_parity(tmp_path, rng, monkeypatch):
    """The i16-delta target upload (POLYCHASE_TRACK_QTGT, default on)
    reconstructs targets within 0.5*scale (~0.003 px for a 100 px flow);
    the solved trajectory must match the exact-f32 upload to solver
    tolerance."""
    from polychase_tpu.engine import tracker as T

    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    def run():
        traj = CameraTrajectory(0, len(poses))
        traj.set(0, C.CameraState(intr, poses[0]))
        track_camera_trajectory(
            Database(db_path), traj, 0, len(poses) - 1,
            np.eye(4, dtype=np.float32), mesh,
        )
        return traj

    monkeypatch.setattr(T, "QUANT_TGT", False)
    ref = run()
    monkeypatch.setattr(T, "QUANT_TGT", True)
    got = run()
    for i in range(1, len(poses)):
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.q), np.asarray(ref.get(i).pose.q),
            atol=2e-5,
        )
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.t), np.asarray(ref.get(i).pose.t),
            atol=2e-4,
        )


def test_scan_chain_callback_cancel(tmp_path, rng):
    """Cancelling from the callback stops the scan path mid-run."""
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    traj = CameraTrajectory(0, len(poses))
    traj.set(0, C.CameraState(intr, poses[0]))
    seen = []

    def cb(res):
        seen.append(res.frame)
        return res.frame < 4

    track_camera_trajectory(
        Database(db_path), traj, 0, len(poses) - 1,
        np.eye(4, dtype=np.float32), mesh, callback=cb,
    )
    assert seen == [1, 2, 3, 4]
    # The frame whose callback returned False is reported but not
    # committed, matching the per-frame path's ordering.
    assert traj.is_frame_filled(3)
    assert not traj.is_frame_filled(4)
    assert not traj.is_frame_filled(5)


def test_function_tol_tracks_like_reference_termination(
    tmp_path, rng, monkeypatch
):
    """The tracker's default relative function tolerance (a
    termination aid for the reference's f32 λ-doubling rejection tail,
    cpp/pnp/lev_marq.h:146-227) must cut LM iterations without moving
    the trajectory: POLYCHASE_TRACK_FTOL=0 restores the reference-exact
    exits, and both runs must agree to well under the solves' own
    error."""
    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(10)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    def run():
        traj = CameraTrajectory(0, len(poses))
        traj.set(0, C.CameraState(intr, poses[0]))
        iters = []
        track_camera_trajectory(
            Database(db_path), traj, 0, len(poses) - 1,
            np.eye(4, dtype=np.float32), mesh,
            callback=lambda r: iters.append(
                int(r.bundle_stats.iterations)
            ) or True,
        )
        return traj, sum(iters)

    monkeypatch.setenv("POLYCHASE_TRACK_FTOL", "0")
    ref, ref_iters = run()
    monkeypatch.delenv("POLYCHASE_TRACK_FTOL")
    got, got_iters = run()

    # This DB is geometrically exact, so the cost floor is ~0 and the
    # RELATIVE tolerance rarely fires (accepted steps keep halving the
    # cost) — the tolerance must never take MORE iterations, and the
    # iteration-cutting behavior on noisy data is pinned by
    # test_function_tol_cuts_iterations_on_noisy_pnp below.
    assert got_iters <= ref_iters, (got_iters, ref_iters)
    for i in range(1, len(poses)):
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.q), np.asarray(ref.get(i).pose.q),
            atol=1e-4,
        )
        np.testing.assert_allclose(
            np.asarray(got.get(i).pose.t), np.asarray(ref.get(i).pose.t),
            atol=1e-3,
        )


def test_function_tol_explicit_opts_respected(tmp_path, rng, monkeypatch):
    """A caller-provided function_tol wins over the env default (the
    tracker only fills it in when left at 0)."""
    from polychase_tpu.engine import tracker as T

    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    poses = [orbit_pose(0.04 * t) for t in range(8)]
    db_path = str(tmp_path / "flow.db")
    build_flow_db(db_path, mesh, intr, poses, rng)

    seen = []
    real = T._scan_track_fn

    def spy(opt_f, opt_pp, opts_key, **kw):
        seen.append(BundleOptions(*opts_key).function_tol)
        return real(opt_f, opt_pp, opts_key, **kw)

    monkeypatch.setattr(T, "_scan_track_fn", spy)
    monkeypatch.setenv("POLYCHASE_TRACK_FTOL", "1e-5")

    traj = CameraTrajectory(0, len(poses))
    traj.set(0, C.CameraState(intr, poses[0]))
    track_camera_trajectory(
        Database(db_path), traj, 0, len(poses) - 1,
        np.eye(4, dtype=np.float32), mesh,
        bundle_opts=BundleOptions(function_tol=3e-7),
    )
    assert seen == [3e-7]


def test_function_tol_cuts_iterations_on_noisy_pnp(rng):
    """On noisy correspondences (nonzero cost floor — every real
    tracking problem), function_tol must terminate the f32 rejection
    tail early while landing on the same camera."""
    from polychase_tpu.engine.pnp import PnPOptions, solve_pnp

    mesh = make_sphere_mesh()
    intr = make_intrinsics()
    pose = orbit_pose(0.3)
    pts, normals = sample_surface_points(mesh, rng, 200)
    cam = C.CameraState(intr, pose)
    px, ok = project_points(cam, pts)
    ok &= visible_from(cam, pts, normals)
    X = pts[ok]
    x = px[ok] + rng.normal(0.0, 0.4, px[ok].shape).astype(np.float32)

    warm = C.CameraState(intr, orbit_pose(0.33))

    def solve(ftol):
        opts = PnPOptions(
            bundle_opts=BundleOptions(
                loss_type=CAUCHY, loss_scale=1.0, function_tol=ftol,
            )
        )
        return solve_pnp(X, x, warm, opts)

    ref = solve(0.0)
    got = solve(1e-5)
    assert int(got.stats.iterations) < int(ref.stats.iterations), (
        int(got.stats.iterations), int(ref.stats.iterations),
    )
    np.testing.assert_allclose(
        np.asarray(got.camera.pose.t), np.asarray(ref.camera.pose.t),
        atol=1e-3,
    )
    np.testing.assert_allclose(
        np.asarray(got.camera.pose.q), np.asarray(ref.camera.pose.q),
        atol=1e-4,
    )
