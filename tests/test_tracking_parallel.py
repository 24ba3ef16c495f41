"""Segment-parallel tracking: parity with the sequential chain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from polychase_tpu.engine import camera as C
from polychase_tpu.engine import pose as P
from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.tracker import track_camera_trajectory
from polychase_tpu.engine.trajectory import CameraTrajectory
from polychase_tpu.io.database import Database
from polychase_tpu.parallel.tracking import make_track_mesh, track_segments

from synthetic import (
    make_intrinsics,
    make_sphere_mesh,
    orbit_pose,
    project_points,
    sample_surface_points,
    visible_from,
)

N = 24
SEGS = [(0, 8), (8, 16), (16, 23)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(8)
    mesh = make_sphere_mesh(12, 16)
    intr = make_intrinsics()
    poses = jax.device_get([orbit_pose(0.02 * t) for t in range(N)])

    db_path = str(tmp_path_factory.mktemp("trackpar") / "flow.db")
    db = Database(db_path)
    pts3d = {}
    for i in range(N):
        pts, normals = sample_surface_points(mesh, rng, 160)
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
                proj[ok] + rng.normal(0, 0.2, (idx.size, 2)).astype(
                    np.float32
                ),
                np.zeros(idx.size, np.float32),
            )
    db.close()
    return dict(mesh=mesh, intr=intr, poses=poses, db_path=db_path)


def _seeded(sc, a, b):
    traj = CameraTrajectory(a, b - a + 1)
    p = sc["poses"][a]
    traj.set(a, C.CameraState(sc["intr"], P.Pose(p.q, p.t)))
    return traj


def _ts(traj):
    return np.stack([
        np.asarray(jax.device_get(traj.get(f).pose.t))
        for f in range(traj.first_frame, traj.last_frame + 1)
    ])


@pytest.mark.parametrize("use_mesh", [False, True])
def test_parallel_tracking_matches_sequential(scene, use_mesh):
    sc = scene
    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0)

    seq = []
    for a, b in SEGS:
        traj = _seeded(sc, a, b)
        db = Database(sc["db_path"])
        track_camera_trajectory(
            db, traj, a, b, np.eye(4, dtype=np.float32), sc["mesh"],
            bundle_opts=opts,
        )
        db.close()
        seq.append(traj)

    par = [_seeded(sc, a, b) for a, b in SEGS]
    dev_mesh = make_track_mesh() if use_mesh else False
    counts = track_segments(
        sc["db_path"], par, np.eye(4, dtype=np.float32), sc["mesh"],
        bundle_opts=opts, device_mesh=dev_mesh,
    )
    assert counts.shape[0] == len(SEGS)
    assert (counts[:, :7] >= 3).all()

    for s, p, (a, b) in zip(seq, par, SEGS):
        t_seq, t_par = _ts(s), _ts(p)
        gt = np.stack([
            np.asarray(sc["poses"][f].t) for f in range(a, b + 1)
        ])
        # Both recover the ground-truth orbit closely
        assert np.linalg.norm(t_seq - gt, axis=-1).max() < 5e-3
        assert np.linalg.norm(t_par - gt, axis=-1).max() < 5e-3
        np.testing.assert_allclose(t_par, t_seq, atol=2e-4)


def test_multichip_scan_chain_cuda_lowering(scene):
    """The per-device program of track_segments (vmap over segments ->
    lax.scan chain -> XLA LM ``while_loop``) lowers for CUDA, as XLA
    code and library calls with no hand-written kernel.  This is the program a multi-GPU host
    runs; the CPU tests run it only on the CPU backend."""
    from polychase_tpu.engine.pnp import normalize_bundle_opts
    from polychase_tpu.engine.tracker import _scan_track_fn

    opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0)
    run = _scan_track_fn(
        False, False, tuple(normalize_bundle_opts(opts)),
        packed_idx=True,
    )
    S, F, n, Gp, K, Kmax = 2, 5, 4, 8, 128, 128
    xs = (
        jnp.zeros((S, n, Gp), jnp.int32),
        jnp.zeros((S, n, Gp, K), jnp.uint16),
        jnp.zeros((S, n, Gp), jnp.int32),
        jnp.zeros((S, n, Gp, K, 2), jnp.float32),
        jnp.zeros((S, n), jnp.int32),
        jnp.zeros((S, n), jnp.int32),
    )

    def solve(q0, t0, in0, kps, xs, mesh_, model_, model_inv_, const5_):
        return run(
            mesh_, model_, model_inv_, q0, t0, in0, const5_, kps, xs
        )

    batched = jax.vmap(
        solve, in_axes=(0, 0, 0, 0, 0, None, None, None, None)
    )
    eye = jnp.eye(4, dtype=jnp.float32)
    args = (
        jnp.zeros((S, F, 4), jnp.float32),
        jnp.zeros((S, F, 3), jnp.float32),
        jnp.zeros((S, F, 4), jnp.float32),
        jnp.zeros((S, F, Kmax, 2), jnp.float32),
        xs, scene["mesh"], eye, eye,
        jnp.zeros((5,), jnp.float32),
    )
    exp = jax.export.export(jax.jit(batched), platforms=("cuda",))(*args)
    text = exp.mlir_module()
    assert "stablehlo.while" in text
    assert "triton" not in text


def test_mixed_clip_segments_rejected(scene):
    """Segments with mismatched seed conventions/sizes must raise (the
    packed solve shares one clip's [aspect, w, h, sign])."""
    from polychase_tpu.engine.tracker import TrackingError

    sc = scene
    a = _seeded(sc, 0, 4)
    b = CameraTrajectory(4, 5)
    other = make_intrinsics(w=1920, h=1080, f=1800.0)
    p = sc["poses"][4]
    b.set(4, C.CameraState(other, P.Pose(p.q, p.t)))
    with pytest.raises(TrackingError):
        track_segments(
            sc["db_path"], [a, b], np.eye(4, dtype=np.float32),
            sc["mesh"], device_mesh=False,
        )
