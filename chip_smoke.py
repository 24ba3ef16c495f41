#!/usr/bin/env python3
"""Smoke run of the add-on's main path on one GPU.

Drives analyze → track → refine and pin mode once through
``polychase_tpu.api`` at sizes a match-mover works at, and checks every
result against the repository's plain references:

========  ==================================  ==============================
phase     entry point                         compared with
========  ==================================  ==============================
pin       api.find_transformation             engine.pnp_host (host numpy)
track     api.track_sequence                  baseline_cpu.cpu_track_trajectory
refine    api.refine_trajectory (focal)       baseline_cpu.cpu_refine_trajectory
analyze   api.generate_optical_flow_database  the frames' known shifts
========  ==================================  ==============================

Every program runs as XLA compiled it for the card; the repository has
no hand-written kernel (PERF.md says why).  The tests marked ``cuda``
run in this process too.  Frames, meshes and flow databases are
generated from ``--seed``; nothing is downloaded.  The script needs a GPU: on any other backend it exits
non-zero before the first phase.  Every phase prints its set-up seconds
(first call, compilation included), its wall seconds (second call), the
device's ``peak_bytes_in_use`` so far, and each parity number beside its
tolerance.  A failed phase makes the exit code non-zero.  The last line
is one JSON object naming the device.

``--four`` runs instead the multi-device paths (sharded analyze, sharded
refine, ``track_segments`` and ``refine_segments``) on every visible
device and on ``jax.devices()[:1]``, and compares the two.

    python chip_smoke.py [--seed N] [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Full sizes.  Analyze: 1080p, 24 frames so the ±{1,2,4,8} fan reaches
# steady state.  Track: 120 frames of 2,048 keypoints over a sphere of
# 2·128·256 = 65,536 triangles.  Refine: BASELINE config 4's 250 frames
# of 256 keypoints.  Pin: config 2's 8 pins, and 8,192 pins to take the
# device route above POLYCHASE_HOST_PIN_MAX.
FULL = dict(
    analyze=dict(width=1920, height=1080, n_frames=24),
    track=dict(n_frames=120, kp_per_frame=2048, n_lat=128, n_lon=256),
    refine=dict(n_frames=250, kp_per_frame=256, n_lat=128, n_lon=256),
    pin=dict(n_pins=(8, 8192), n_lat=128, n_lon=256),
)
CUDA_TESTS = ("tests/test_gpu_numerics.py",)
FOUR = dict(
    analyze=dict(width=1920, height=1080, n_frames=12),
    refine=dict(n_frames=120, kp_per_frame=256, n_lat=128, n_lon=256),
    segments=dict(n_segments=4, seg_frames=30, kp_per_frame=512,
                  n_lat=128, n_lon=256),
)

# Analyze: frame t is a crop of one texture at offset (SHIFT·t), so the
# true flow of skip s is -SHIFT·s.
SHIFT = (3, 2)
ANALYZE_EPE_TOL = 0.1      # px, median endpoint error per skip
ANALYZE_OK_MIN = 0.9       # share of features tracked per skip
RMSE_REL_TOL = 0.01        # tests/test_baseline_parity.py's rule


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------


class Check:
    """One parity number beside its bound; ``ok`` when within it."""

    def __init__(self, name, value, tol, upper=True, note=""):
        self.name, self.value, self.tol = name, float(value), float(tol)
        self.ok = bool(self.value <= tol if upper else self.value >= tol)
        self.rel = "<=" if upper else ">="
        self.note = note

    def line(self) -> str:
        status = "ok" if self.ok else "FAIL"
        note = f"  ({self.note})" if self.note else ""
        return (f"    {self.name} = {self.value!r} {self.rel} {self.tol!r}"
                f"  {status}{note}")


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def card_line() -> str:
    """The card's name and power limit, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


# ---------------------------------------------------------------------------
# Shared scene helpers
# ---------------------------------------------------------------------------


def _bench_modules():
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    import baseline_cpu
    import run_all

    return run_all, baseline_cpu


def _api_intrinsics(intr, fy=None):
    from polychase_tpu import api

    f = float(intr.fy) if fy is None else float(fy)
    return api.CameraIntrinsics(
        f * float(intr.aspect_ratio), f, float(intr.cx), float(intr.cy),
        float(intr.aspect_ratio), float(intr.width), float(intr.height),
        api.CameraConvention.OpenCV,
    )


def _accel_mesh(mesh):
    import jax

    from polychase_tpu import api

    v, t = jax.device_get((mesh.vertices, mesh.triangles))
    return api.AcceleratedMesh(np.asarray(v), np.asarray(t))


def _host_bvh(mesh):
    import jax

    from polychase_tpu.native import BvhRaycaster

    v, t = jax.device_get((mesh.vertices, mesh.triangles))
    v = np.asarray(v, np.float32)
    t = np.asarray(t, np.uint32)
    return BvhRaycaster(v, t), v, t


def _qt(pose):
    return (np.asarray(pose.q, np.float64).reshape(4),
            np.asarray(pose.t, np.float64).reshape(3))


def _rot_angle(q1, q2) -> float:
    d = abs(float(np.dot(q1 / np.linalg.norm(q1), q2 / np.linalg.norm(q2))))
    return 2.0 * float(np.arccos(min(1.0, d)))


def _track_opts():
    from polychase_tpu import api

    o = api.BundleOptions()
    o.loss_type = api.LossType.Cauchy
    o.loss_scale = 1.0
    o.function_tol = 1e-5
    return o


# ---------------------------------------------------------------------------
# Phases.  Each returns (setup_s, wall_s, [Check], info dict).
# ---------------------------------------------------------------------------


def phase_pin(seed, n_pins, n_lat, n_lon):
    """``api.find_transformation`` at each pin count against the same
    solve forced onto the host (engine/pnp_host)."""
    import jax.numpy as jnp

    from polychase_tpu import api
    from polychase_tpu.engine import camera as C
    from polychase_tpu.engine import pose as P
    from polychase_tpu.engine.raycast import raycast_grouped

    RA, _ = _bench_modules()
    rng = np.random.default_rng(seed)
    mesh, intr, poses = RA.make_scene(1, n_lat=n_lat, n_lon=n_lon)
    pose = poses[0]
    view = np.asarray(P.pose_rt4x4(pose))
    st = api.SceneTransformations(np.eye(4, dtype=np.float32), view,
                                  _api_intrinsics(intr))
    checks, setup, wall = [], 0.0, 0.0
    info = dict(n_pins=list(n_pins))
    for n in n_pins:
        pix = rng.uniform((700, 330), (1220, 750), (2 * n, 2))
        dirs = C.unproject(intr, jnp.asarray(pix, jnp.float32))
        Rt = P.quat_to_mat(P.quat_conj(pose.q))
        hits = raycast_grouped(mesh, P.pose_center(pose)[None],
                               P.matmul(dirs, Rt.T)[None], True)
        pins = np.asarray(hits.pos[0])[np.asarray(hits.valid[0])][:n]
        assert pins.shape[0] == n, "not enough pins hit the mesh"
        upd = api.PinUpdate(2, np.array([960.0 + 6.0, 540.0 - 4.0],
                                        np.float32))

        def solve():
            return api.find_transformation(
                pins, st, st, upd, api.TransformationType.Camera)

        t0 = time.perf_counter()
        solve()
        setup += time.perf_counter() - t0
        t0 = time.perf_counter()
        got = solve()
        wall += time.perf_counter() - t0
        with mock.patch.dict(os.environ,
                             {"POLYCHASE_HOST_PIN_MAX": str(10 * n)}):
            ref = solve()
        host_max = int(os.environ.get("POLYCHASE_HOST_PIN_MAX", "4096"))
        route = "device" if n > host_max else "host"
        # The device route solves in float32, the host one in float64;
        # compare where the pins land on screen, which is what the user
        # drags.  The pose itself is ill-conditioned along the view axis.
        dpx = np.abs(_pin_pixels(got, pins) - _pin_pixels(ref, pins)).max()
        checks.append(Check(f"{n} pins ({route}) max |px - host px|", dpx,
                            1e-2))
        info[f"{n}_pins_view_max_abs_diff"] = float(
            np.abs(got.view_matrix - ref.view_matrix).max())
    return setup, wall, checks, info


def _pin_pixels(st, pins):
    """Screen positions of ``pins`` under a scene transform (OpenCV
    convention, identity model matrix)."""
    v = np.asarray(st.view_matrix, np.float64)
    X = pins.astype(np.float64) @ v[:3, :3].T + v[:3, 3]
    i = st.intrinsics
    return np.stack([i.fx * X[:, 0] / X[:, 2] + i.cx,
                     i.fy * X[:, 1] / X[:, 2] + i.cy], axis=-1)


def _synth_db(path, RA, mesh, intr, poses, seed, kp_per_frame):
    RA.build_synth_db(path, mesh, intr, poses, np.random.default_rng(seed),
                      kp_per_frame=kp_per_frame)


def phase_track(seed, n_frames, kp_per_frame, n_lat, n_lon, tmp):
    """``api.track_sequence`` over a synthetic flow DB against the CPU
    stand-in tracker on the same DB."""
    import jax

    from polychase_tpu import api
    from polychase_tpu.engine import pose as P
    from polychase_tpu.io.database import Database

    RA, bc = _bench_modules()
    t0 = time.perf_counter()
    mesh, intr, poses = RA.make_scene(n_frames, n_lat=n_lat, n_lon=n_lon)
    db_path = os.path.join(tmp, "track.db")
    _synth_db(db_path, RA, mesh, intr, poses, seed, kp_per_frame)
    accel = _accel_mesh(mesh)
    bvh, verts, tris = _host_bvh(mesh)
    gen_s = time.perf_counter() - t0
    st = api.SceneTransformations(
        np.eye(4, dtype=np.float32), np.asarray(P.pose_rt4x4(poses[0])),
        _api_intrinsics(intr))

    def run():
        out = {0: _qt(poses[0])}

        def cb(r):
            out[r.frame] = _qt(r.pose)
            return True

        t = time.perf_counter()
        api.track_sequence(db_path, 0, n_frames - 1, st, accel, cb,
                           bundle_opts=_track_opts())
        return time.perf_counter() - t, out

    setup, _ = run()
    wall, ours = run()

    cpu = {0: _qt(poses[0])}
    db = Database(db_path)
    try:
        t = time.perf_counter()
        bc.cpu_track_trajectory(db, cpu, 0, n_frames - 1, np.eye(4), bvh,
                                intr, bundle_opts=_track_opts()._to_engine())
        cpu_s = time.perf_counter() - t
        checks = _rmse_checks(bc, db, ours, cpu, n_frames, bvh, intr, verts,
                              tris, per_frame=True)
    finally:
        db.close()
    gt = {i: _qt(p) for i, p in enumerate(jax.device_get(poses))}
    t_err = max(np.linalg.norm(ours[i][1] - gt[i][1]) for i in gt)
    r_err = max(_rot_angle(ours[i][0], gt[i][0]) for i in gt)
    checks.append(Check("max |t - t_gt| (scene units, 4 m depth)", t_err,
                        1e-2))
    checks.append(Check("max rotation error vs generating pose (rad)",
                        r_err, 5e-3))
    info = dict(n_frames=n_frames, frames_solved=len(ours),
                fps_smoke=(n_frames - 1) / wall, scene_gen_s=gen_s,
                cpu_stand_in_s=cpu_s, triangles=int(tris.shape[0]))
    return setup, wall, checks, info


def _rmse_checks(bc, db, ours, cpu, n_frames, bvh, intr, verts, tris,
                 per_frame=False, label=""):
    """Trajectory RMSE within RMSE_REL_TOL of the stand-in's; with
    ``per_frame``, also the worst per-frame RMSE difference, each frame's
    RMSE taken over the flow edges into it."""
    def rmse(traj):
        return bc.reprojection_rmse(db, traj, 0, n_frames - 1, np.eye(4),
                                    bvh, intr, verts, tris)

    r_ours, r_cpu = rmse(ours), rmse(cpu)
    checks = [Check(f"{label}trajectory RMSE rel diff (ours {r_ours:.6f} px,"
                    f" stand-in {r_cpu:.6f} px)",
                    abs(r_ours - r_cpu) / max(r_ours, r_cpu), RMSE_REL_TOL)]
    if per_frame:
        fo = _per_frame_rmse(bc, db, ours, n_frames, bvh, intr, verts, tris)
        fc = _per_frame_rmse(bc, db, cpu, n_frames, bvh, intr, verts, tris)
        frames = [f for f in fo if f in fc]
        rel = [abs(fo[f] - fc[f]) / max(fo[f], fc[f], 1e-12) for f in frames]
        worst = int(np.argmax(rel))
        checks.append(Check(
            f"{label}worst per-frame RMSE rel diff (frame {frames[worst]}: "
            f"ours {fo[frames[worst]]:.6f} px, stand-in "
            f"{fc[frames[worst]]:.6f} px)", rel[worst], RMSE_REL_TOL))
    return checks


def _per_frame_rmse(bc, db, traj, n_frames, bvh, intr, verts, tris):
    prob = bc._BAProblem(db, traj, 0, n_frames - 1, np.eye(4), bvh, intr,
                         None, verts, tris)
    cams = [bc.HostCam(*(tuple(traj[i]) + (intr.fy, intr.cx, intr.cy))[:5])
            for i in range(prob.F)]
    res, valid, _, _ = prob.evaluate(cams, False, False, False)
    r2 = np.sum(res * res, axis=-1)
    out = {}
    for f in range(1, prob.F):
        m = valid & (prob.tf == f)
        if m.any():
            out[f] = float(np.sqrt(r2[m].mean()))
    return out


def _perturbed_traj(poses, intr, seed, focal_scale):
    """Refine's starting trajectory: the two end frames are keyframes
    (exact pose and focal, held fixed by the refiner); every frame
    between has its translation jittered and its focal scaled by
    ``focal_scale``.  Values are ``(q, t, fy, cx, cy)``."""
    rng = np.random.default_rng(seed)
    n = len(poses)
    out = {}
    for i, p in enumerate(poses):
        q, t = _qt(p)
        fy = float(intr.fy)
        if i not in (0, n - 1):
            t = t + rng.normal(0, 0.005, 3)
            fy *= focal_scale
        out[i] = (q, t, fy, float(intr.cx), float(intr.cy))
    return out


def _refine_opts():
    """The API's default BundleOptions with the add-on's Cauchy loss.
    The stand-in has no function-tolerance exit, so refine runs with
    reference-exact termination too (POLYCHASE_REFINE_FTOL=0)."""
    from polychase_tpu import api

    o = api.BundleOptions()
    o.loss_type = api.LossType.Cauchy
    o.loss_scale = 1.0
    return o


def _api_traj(init, intr):
    from polychase_tpu import api

    n = len(init)
    traj = api.CameraTrajectory(0, n)
    for i, (q, t, fy, _cx, _cy) in init.items():
        traj.set(i, api.CameraState(
            _api_intrinsics(intr, fy),
            api.Pose(q.astype(np.float32), t.astype(np.float32))))
    return traj


def _from_api_traj(traj, n):
    out = {}
    for i in range(n):
        s = traj.get(i)
        out[i] = (np.asarray(s.pose.q, np.float64),
                  np.asarray(s.pose.t, np.float64), s.intrinsics.fy,
                  s.intrinsics.cx, s.intrinsics.cy)
    return out


def phase_refine(seed, n_frames, kp_per_frame, n_lat, n_lon, tmp):
    """``api.refine_trajectory`` with focal estimation from a 10% focal
    error against the CPU stand-in's sparse LM."""
    from polychase_tpu import api
    from polychase_tpu.io.database import Database

    RA, bc = _bench_modules()
    t0 = time.perf_counter()
    mesh, intr, poses = RA.make_scene(n_frames, n_lat=n_lat, n_lon=n_lon)
    db_path = os.path.join(tmp, "refine.db")
    _synth_db(db_path, RA, mesh, intr, poses, seed + 1, kp_per_frame)
    accel = _accel_mesh(mesh)
    bvh, verts, tris = _host_bvh(mesh)
    init = _perturbed_traj(poses, intr, seed + 2, 1.1)
    gen_s = time.perf_counter() - t0

    def run():
        traj = _api_traj(init, intr)
        t = time.perf_counter()
        with mock.patch.dict(os.environ, {"POLYCHASE_REFINE_FTOL": "0"}):
            api.refine_trajectory(db_path, traj,
                                  np.eye(4, dtype=np.float32), accel, True,
                                  False, None, _refine_opts())
        return time.perf_counter() - t, _from_api_traj(traj, n_frames)

    setup, _ = run()
    wall, ours = run()

    db = Database(db_path)
    try:
        t = time.perf_counter()
        cpu, _ = bc.cpu_refine_trajectory(
            db, init, 0, n_frames - 1, np.eye(4), bvh, intr, verts, tris,
            optimize_focal_length=True,
            bundle_opts=_refine_opts()._to_engine())
        cpu_s = time.perf_counter() - t
        rmse0 = bc.reprojection_rmse(db, init, 0, n_frames - 1, np.eye(4),
                                     bvh, intr, verts, tris)
        checks = _rmse_checks(bc, db, ours, cpu, n_frames, bvh, intr, verts,
                              tris)
    finally:
        db.close()
    mid = range(1, n_frames - 1)
    f_ours = float(np.median([ours[i][2] for i in mid]))
    f_cpu = float(np.median([cpu[i][2] for i in mid]))
    checks.append(Check("median refined focal rel diff vs stand-in",
                        abs(f_ours - f_cpu) / f_cpu, 1e-2))
    info = dict(n_frames=n_frames, rmse_initial_px=rmse0,
                focal_initial=init[1][2], focal_ours=f_ours,
                focal_stand_in=f_cpu, focal_true=float(intr.fy),
                scene_gen_s=gen_s, cpu_stand_in_s=cpu_s)
    return setup, wall, checks, info


def make_frames(seed, width, height, n_frames):
    """Crops of one seeded texture; frame t sits at offset SHIFT·t.

    The texture is Gaussian-filtered noise at two scales: fine grain for
    the corners, and coarse structure that survives the pyramid's 8x
    reduction, as natural footage has (fine grain alone is flat at the
    top level, so large skips would not converge)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(seed)
    sx, sy = SHIFT
    shape = (height + sy * n_frames, width + sx * n_frames)
    fine = gaussian_filter(rng.random(shape), 1.5)
    coarse = gaussian_filter(rng.random(shape), 6.0)
    big = fine / fine.std() + coarse / coarse.std()
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    return [
        np.ascontiguousarray(big[sy * t : sy * t + height,
                                 sx * t : sx * t + width])
        for t in range(n_frames)
    ]


def flow_errors(db_path, n_frames, width, height):
    """Per signed skip: (median endpoint error of the stored flows
    against the known shift, share of the source frame's features that
    were stored).  Both count only features whose true target lies in
    the frame: one that leaves it cannot be tracked."""
    from polychase_tpu.io.database import Database

    sx, sy = SHIFT
    epe, n_ok, n_all = {}, {}, {}
    db = Database(db_path)
    try:
        for i in range(n_frames):
            kps = db.read_keypoints(i)
            for s in (-8, -4, -2, -1, 1, 2, 4, 8):
                j = i + s
                if not 0 <= j < n_frames:
                    continue
                expect = kps - np.array([sx * s, sy * s], np.float32)
                in_view = ((expect[:, 0] >= 0) & (expect[:, 0] <= width - 1)
                           & (expect[:, 1] >= 0)
                           & (expect[:, 1] <= height - 1))
                flow = db.read_image_pair_flow(i, j)
                idx = flow.src_kps_indices.astype(np.int64)
                keep = in_view[idx]
                e = np.linalg.norm(flow.tgt_kps - expect[idx], axis=-1)
                epe.setdefault(s, []).append(e[keep])
                n_ok[s] = n_ok.get(s, 0) + int(keep.sum())
                n_all[s] = n_all.get(s, 0) + int(in_view.sum())
    finally:
        db.close()
    return {
        s: (float(np.median(np.concatenate(epe[s]))), n_ok[s] / n_all[s])
        for s in sorted(epe)
    }


def _analyze(frames, db_path):
    from polychase_tpu import api

    h, w = frames[0].shape
    info = api.VideoInfo(w, h, 0, len(frames))
    t = time.perf_counter()
    api.generate_optical_flow_database(info, lambda f: frames[f], None,
                                       db_path)
    return time.perf_counter() - t


def phase_analyze(seed, width, height, n_frames, tmp):
    """``api.generate_optical_flow_database`` on crops at known shifts."""
    from polychase_tpu.io.database import Database

    t0 = time.perf_counter()
    frames = make_frames(seed, width, height, n_frames)
    gen_s = time.perf_counter() - t0
    setup = _analyze(frames, os.path.join(tmp, "analyze0.db"))
    db_path = os.path.join(tmp, "analyze.db")
    wall = _analyze(frames, db_path)
    db = Database(db_path)
    try:
        kp = [db.read_keypoints(i).shape[0] for i in range(n_frames)]
    finally:
        db.close()
    checks = []
    for s, (e, share) in flow_errors(db_path, n_frames, width,
                                     height).items():
        checks.append(Check(f"skip {s:+d} median EPE (px)", e,
                            ANALYZE_EPE_TOL))
        checks.append(Check(f"skip {s:+d} ok-share", share, ANALYZE_OK_MIN,
                            upper=False))
    info = dict(width=width, height=height, n_frames=n_frames,
                mean_corners_per_frame=float(np.mean(kp)),
                wall_per_frame_s=wall / n_frames, frame_gen_s=gen_s)
    return setup, wall, checks, info


# ---------------------------------------------------------------------------
# Four devices
# ---------------------------------------------------------------------------


def phase_four_analyze(seed, width, height, n_frames, tmp, devices):
    """Sharded analyze on ``devices`` against the same call on one
    device: same tracked features, same positions."""
    from polychase_tpu.engine import lk
    from polychase_tpu.io.database import Database
    from polychase_tpu.parallel.analyze import make_target_mesh

    frames = make_frames(seed, width, height, n_frames)
    out, times = {}, {}
    for tag, devs in (("one", devices[:1]), ("all", devices)):
        lk._ANALYZE_MESH = make_target_mesh(devs)
        try:
            t_cold = _analyze(frames, os.path.join(tmp, f"a_{tag}0.db"))
            path = os.path.join(tmp, f"a_{tag}.db")
            times[tag] = (t_cold, _analyze(frames, path))
        finally:
            lk._ANALYZE_MESH = None
        out[tag] = path
    a, b = Database(out["one"]), Database(out["all"])
    worst_pos, agree, total = 0.0, 0, 0
    try:
        for i in range(n_frames):
            for j in a.find_optical_flows_from_image(i):
                fa = a.read_image_pair_flow(i, j)
                fb = b.read_image_pair_flow(i, j)
                common, ia, ib = np.intersect1d(
                    fa.src_kps_indices, fb.src_kps_indices,
                    return_indices=True)
                agree += common.size
                total += max(fa.src_kps_indices.size,
                             fb.src_kps_indices.size)
                if common.size:
                    worst_pos = max(worst_pos, float(np.median(np.abs(
                        fa.tgt_kps[ia] - fb.tgt_kps[ib]))))
    finally:
        a.close()
        b.close()
    checks = [
        Check("tracked features in both / in either", agree / total, 0.999,
              upper=False),
        Check("worst per-pair median |pos one - pos all| (px)", worst_pos,
              1e-3),
    ]
    return times, checks


def phase_four_refine(seed, n_frames, kp_per_frame, n_lat, n_lon, tmp,
                      devices):
    """Edge-sharded refine on ``devices`` against one device."""
    from polychase_tpu.engine.refiner import refine_trajectory
    from polychase_tpu.io.database import Database
    from polychase_tpu.parallel.sharded import make_edge_mesh

    RA, bc = _bench_modules()
    mesh, intr, poses = RA.make_scene(n_frames, n_lat=n_lat, n_lon=n_lon)
    db_path = os.path.join(tmp, "four_refine.db")
    _synth_db(db_path, RA, mesh, intr, poses, seed + 1, kp_per_frame)
    bvh, verts, tris = _host_bvh(mesh)
    init = _perturbed_traj(poses, intr, seed + 2, 1.1)
    opts = _refine_opts()._to_engine()
    res, times = {}, {}
    for tag, devs in (("one", devices[:1]), ("all", devices)):
        runs = []
        for _ in range(2):
            traj = _api_traj(init, intr)._traj
            t = time.perf_counter()
            with mock.patch.dict(os.environ, {"POLYCHASE_REFINE_FTOL": "0"}):
                refine_trajectory(db_path, traj,
                                  np.eye(4, dtype=np.float32), mesh, True,
                                  False, None, opts,
                                  device_mesh=make_edge_mesh(devs))
            runs.append(time.perf_counter() - t)
        times[tag] = tuple(runs)
        res[tag] = {
            i: (np.asarray(s.pose.q, np.float64),
                np.asarray(s.pose.t, np.float64), float(s.intrinsics.fy),
                float(s.intrinsics.cx), float(s.intrinsics.cy))
            for i, s in ((i, traj.get(i)) for i in range(n_frames))
        }
    db = Database(db_path)
    try:
        checks = _rmse_checks(bc, db, res["all"], res["one"], n_frames, bvh,
                              intr, verts, tris, label="all vs one: ")
    finally:
        db.close()
    return times, checks


def phase_four_segments(seed, n_segments, seg_frames, kp_per_frame, n_lat,
                        n_lon, tmp, devices):
    """``track_segments`` then ``refine_segments`` spread over
    ``devices`` against the same calls on one device."""
    from polychase_tpu.engine import camera as C
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.parallel.segments import (
        make_segment_mesh, refine_segments,
    )
    from polychase_tpu.parallel.tracking import (
        make_track_mesh, track_segments,
    )

    RA, _ = _bench_modules()
    n = n_segments * seg_frames
    mesh, intr, poses = RA.make_scene(n, n_lat=n_lat, n_lon=n_lon)
    db_path = os.path.join(tmp, "segments.db")
    _synth_db(db_path, RA, mesh, intr, poses, seed + 3, kp_per_frame)
    opts = _track_opts()._to_engine()
    bounds = [(s * seg_frames, (s + 1) * seg_frames - 1)
              for s in range(n_segments)]
    res, times = {}, {}
    for tag, devs in (("one", devices[:1]), ("all", devices)):
        runs = []
        for _ in range(2):
            trajs = []
            for a, b in bounds:
                t = CameraTrajectory(a, b - a + 1)
                t.set(a, C.CameraState(intr, poses[a]))
                trajs.append(t)
            t0 = time.perf_counter()
            track_segments(db_path, trajs, np.eye(4, dtype=np.float32),
                           mesh, bundle_opts=opts,
                           device_mesh=make_track_mesh(devs))
            t1 = time.perf_counter()
            refined = refine_segments(
                db_path, trajs, np.eye(4, dtype=np.float32), mesh,
                bundle_opts=opts, device_mesh=make_segment_mesh(devs))
            runs.append((t1 - t0, time.perf_counter() - t1))
        times[tag] = tuple(runs)
        res[tag] = [
            [_qt(r.get(f).pose) for f in range(a, b + 1)]
            for r, (a, b) in zip(refined, bounds)
        ]
    dt = max(np.linalg.norm(x[1] - y[1])
             for sa, sb in zip(res["one"], res["all"])
             for x, y in zip(sa, sb))
    dr = max(_rot_angle(x[0], y[0])
             for sa, sb in zip(res["one"], res["all"])
             for x, y in zip(sa, sb))
    gt = max(np.linalg.norm(x[1] - _qt(poses[a + k])[1])
             for s, (a, _b) in zip(res["all"], bounds)
             for k, x in enumerate(s))
    checks = [
        Check("max |t one - t all| after track+refine", dt, 1e-4),
        Check("max rotation one vs all (rad)", dr, 1e-4),
        Check("max |t all - t_gt|", gt, 1e-2),
    ]
    return times, checks


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def _run(name, fn, failures):
    print(f"== {name}", flush=True)
    try:
        setup, wall, checks, info = fn()
    except Exception:
        traceback.print_exc()
        failures.append(name)
        print(f"   phase {name} FAILED with an exception", flush=True)
        return
    print(f"   setup_s={setup!r} wall_s={wall!r} "
          f"peak_bytes_in_use={_peak_bytes()!r}")
    print(f"   info={json.dumps(info, default=float)}")
    for c in checks:
        print(c.line())
    if not all(c.ok for c in checks):
        failures.append(name)
    print(flush=True)


def _run_four(name, fn, failures):
    print(f"== {name} (one device vs all)", flush=True)
    try:
        times, checks = fn()
    except Exception:
        traceback.print_exc()
        failures.append(name)
        print(f"   phase {name} FAILED with an exception", flush=True)
        return
    print(f"   seconds (first call, second call) {json.dumps(times)}  "
          f"peak_bytes_in_use={_peak_bytes()!r}")
    for c in checks:
        print(c.line())
    if not all(c.ok for c in checks):
        failures.append(name)
    print(flush=True)


def run_cuda_tests() -> int:
    """Run the tests marked ``cuda`` in this process, on this card;
    returns how many passed, raising if any failed or skipped."""
    import pytest

    class Tally:
        passed = 0
        bad: list = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Tally.passed += 1
            elif report.failed or report.skipped:
                Tally.bad.append((report.nodeid, report.outcome))

    os.environ["POLYCHASE_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "cuda", "-p", "no:cacheprovider"]
                     + [os.path.join(ROOT, t) for t in CUDA_TESTS],
                     plugins=[Tally()])
    if rc != 0 or Tally.bad or Tally.passed == 0:
        raise RuntimeError(f"cuda tests: rc={rc} passed={Tally.passed} "
                           f"not passed={Tally.bad}")
    return Tally.passed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="compare the multi-device paths on every visible "
                         "device with one device; no other phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}; "
              "no phase was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from polychase_tpu.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    import jaxlib

    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__} "
          f"compile cache {cache}")
    print(f"devices: {len(jax.devices())} x {dev.device_kind}", flush=True)

    failures: list = []
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        if args.four:
            devices = jax.devices()
            f = FOUR
            _run_four("four/analyze", lambda: phase_four_analyze(
                args.seed, tmp=tmp, devices=devices, **f["analyze"]),
                failures)
            _run_four("four/refine", lambda: phase_four_refine(
                args.seed, tmp=tmp, devices=devices, **f["refine"]),
                failures)
            _run_four("four/segments", lambda: phase_four_segments(
                args.seed, tmp=tmp, devices=devices, **f["segments"]),
                failures)
        else:
            f = FULL
            print("== cuda tests", flush=True)
            try:
                print(f"   {run_cuda_tests()} passed", flush=True)
            except Exception:
                traceback.print_exc()
                failures.append("cuda tests")
            _run("pin", lambda: phase_pin(args.seed, **f["pin"]), failures)
            _run("track", lambda: phase_track(args.seed, tmp=tmp,
                                              **f["track"]), failures)
            _run("refine", lambda: phase_refine(args.seed, tmp=tmp,
                                                **f["refine"]), failures)
            _run("analyze", lambda: phase_analyze(args.seed, tmp=tmp,
                                                  **f["analyze"]), failures)

    print(card_line(), flush=True)
    if failures:
        print(f"chip_smoke: FAILED phases: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
