#!/usr/bin/env python3
"""BASELINE.md benchmark configs, one JSON line per metric.

Configs (BASELINE.md "Targets for this rebuild"):
  1. Analyze Video throughput, 640x480 clip  -> delegated to /bench.py
  2. Pin-mode single-frame pose: 8-pin PnP solve latency (ms)
  3. Forward camera tracking over a 120-frame synthetic clip (frames/s)
  4. Trajectory refinement: BA over a 250-frame segment with focal
     estimation (wall seconds)

The reference publishes no numbers and its prebuilt wheels in this image
are git-lfs pointers, so baselines are *measured* from faithful CPU
reimplementations of its hot paths: config 1 runs OpenCV GFTT+LK (the
reference's actual kernels), configs 3-5 run benchmarks/baseline_cpu.py
(numpy + native-BVH tracker and sparse-LM refiner, RMSE-parity-tested
against the device path in tests/test_baseline_parity.py).

Run: python benchmarks/run_all.py [--skip-analyze] [--no-baseline]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


MEASURE_BASELINE = True
RESULTS: list = []  # every emitted record, persisted by --json


def emit(metric, value, unit, vs_baseline=None, baseline_value=None):
    rec = {
        "metric": metric, "value": round(value, 4), "unit": unit,
        "vs_baseline": vs_baseline,
    }
    if baseline_value is not None:
        rec["baseline_value"] = round(baseline_value, 4)
    # CPU baselines halve under concurrent host load;
    # record the environment each ratio was measured in.
    rec["host_nproc"] = os.cpu_count()
    rec["host_loadavg_1m"] = round(os.getloadavg()[0], 2)
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def _host_scene_arrays(mesh, intr):
    """Host copies + native BVH for the CPU baselines (one transfer)."""
    import jax

    from polychase_tpu.native import BvhRaycaster, available

    if not available():
        return None
    verts, tris = jax.device_get((mesh.vertices, mesh.triangles))
    verts = np.asarray(verts, np.float32)
    tris = np.asarray(tris, np.uint32)
    return BvhRaycaster(verts, tris), verts, tris


def make_scene(n_frames, width=1920, height=1080, focal=1800.0,
               n_lat=24, n_lon=32):
    """Synthetic orbiting-camera scene over a unit sphere mesh of about
    ``2 * n_lat * n_lon`` triangles."""
    import jax.numpy as jnp

    from polychase_tpu.engine import camera as C, pose as P
    from polychase_tpu.engine.geometry import Mesh

    verts, tris = [], []
    for i in range(n_lat + 1):
        th = np.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * np.pi * j / n_lon
            verts.append([np.sin(th) * np.cos(ph),
                          np.sin(th) * np.sin(ph), np.cos(th)])
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                tris.append([a, c, b])
            if i < n_lat - 1:
                tris.append([b, c, d])
    mesh = Mesh.create(np.asarray(verts, np.float32),
                       np.asarray(tris, np.uint32))
    intr = C.Intrinsics.create(
        focal, focal, width / 2, height / 2, 1.0, width, height, C.OPENCV
    )
    poses = []
    for t in range(n_frames):
        ang = 0.01 * t
        q = np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0], np.float32)
        tr = np.array([0.05 * np.sin(0.05 * t), 0.02 * t / n_frames, 4.0],
                      np.float32)
        poses.append(P.Pose(jnp.asarray(q), jnp.asarray(tr)))
    return mesh, intr, poses


def build_synth_db(db_path, mesh, intr, poses, rng, kp_per_frame=256):
    """Project random mesh surface points to build a consistent flow DB.

    All math is host numpy except one batched raycast over all frames —
    eager per-pair device ops would pay a host round trip each.
    """
    import jax
    import jax.numpy as jnp

    from polychase_tpu.engine.tracker import (
        _np_quat_to_mat,
        unproject_np,
    )
    from polychase_tpu.engine.raycast import raycast_grouped
    from polychase_tpu.io.database import Database

    n = len(poses)
    db = Database(db_path)
    width = float(intr.width)
    height = float(intr.height)
    fx, fy = float(intr.fx), float(intr.fy)
    cx, cy = float(intr.cx), float(intr.cy)

    Rs = [_np_quat_to_mat(np.asarray(p.q)) for p in poses]
    ts = [np.asarray(p.t, np.float64).reshape(3) for p in poses]

    pix_all = rng.uniform(
        (width * 0.3, height * 0.3), (width * 0.7, height * 0.7),
        (n, kp_per_frame, 2),
    ).astype(np.float32)
    origins = np.stack([-(R.T @ t) for R, t in zip(Rs, ts)]).astype(
        np.float32
    )
    dirs = np.stack(
        [
            unproject_np(intr, pix_all[i]) @ Rs[i]
            for i in range(n)
        ]
    ).astype(np.float32)
    hits = raycast_grouped(
        mesh, jnp.asarray(origins), jnp.asarray(dirs), True
    )
    valid_all, pos_all = jax.device_get((hits.valid, hits.pos))

    pts3d, kps = {}, {}
    for i in range(n):
        valid = valid_all[i]
        kps[i] = pix_all[i][valid]
        pts3d[i] = pos_all[i][valid].astype(np.float64)
        db.write_keypoints(i, kps[i])

    for i in range(n):
        X = pts3d[i]
        if X.shape[0] == 0:
            continue
        for skip in (-8, -4, -2, -1, 1, 2, 4, 8):
            j = i + skip
            if not 0 <= j < n:
                continue
            Z = X @ Rs[j].T + ts[j]
            proj = np.stack(
                [fx * Z[:, 0] / Z[:, 2] + cx, fy * Z[:, 1] / Z[:, 2] + cy],
                axis=-1,
            ).astype(np.float32)
            inb = (
                (proj[:, 0] > 0) & (proj[:, 0] < width)
                & (proj[:, 1] > 0) & (proj[:, 1] < height)
            )
            idx = np.nonzero(inb)[0].astype(np.uint32)
            noise = rng.normal(0, 0.3, (idx.size, 2)).astype(np.float32)
            db.write_image_pair_flow(
                i, j, idx, proj[inb] + noise,
                np.zeros(idx.size, np.float32),
            )
    db.close()


def bench_analyze_1080p():
    """Config 1b: Analyze throughput at 1080p (~25k corners/frame)."""
    import time as _time

    import cv2

    from polychase_tpu.engine.opticalflow import (
        VideoInfo,
        generate_optical_flow_database,
    )

    W, H, n = 1920, 1080, 8
    rng = np.random.default_rng(0)
    big = rng.integers(0, 255, (H + 60, W + 90)).astype(np.float32)
    big = cv2.GaussianBlur(big, (0, 0), 1.5)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    frames = [
        np.ascontiguousarray(big[4 * t : 4 * t + H, 7 * t : 7 * t + W])
        for t in range(n)
    ]
    info = VideoInfo(W, H, 0, n)

    def run():
        with tempfile.TemporaryDirectory() as td:
            t0 = _time.perf_counter()
            generate_optical_flow_database(
                info, lambda fid: frames[fid], None,
                os.path.join(td, "flow.db"),
            )
            return _time.perf_counter() - t0

    run()
    dt = min(run() for _ in range(2))
    emit("analyze_fps_1080p", n / dt, "frames/sec")


def bench_pin_drag():
    """Config 2: 8-pin PnP solve per mouse-move (api.find_transformation)."""
    import jax
    import jax.numpy as jnp

    import polychase_tpu.polychase_core as pc
    from polychase_tpu.engine import camera as C, pose as P

    rng = np.random.default_rng(0)
    mesh, intr, poses = make_scene(1)
    pose = poses[0]

    # 8 pins on the mesh surface
    from polychase_tpu.engine.raycast import raycast_grouped

    pix = rng.uniform((700, 400), (1200, 700), (8, 2)).astype(np.float32)
    dirs_cam = C.unproject(intr, jnp.asarray(pix))
    Rt = P.quat_to_mat(P.quat_conj(pose.q))
    hits = raycast_grouped(
        mesh, P.pose_center(pose)[None], (dirs_cam @ Rt.T)[None], True
    )
    pins = np.asarray(hits.pos[0])[np.asarray(hits.valid[0])][:8]

    view = np.asarray(P.pose_rt4x4(pose))
    core_intr = pc.CameraIntrinsics(
        float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
        1.0, float(intr.width), float(intr.height),
        pc.CameraConvention.OpenCV,
    )
    st = pc.SceneTransformations(
        model_matrix=np.eye(4, dtype=np.float32), view_matrix=view,
        intrinsics=core_intr,
    )
    def solve(k):
        u = pc.PinUpdate(2, np.array([955.0 + k, 542.0], np.float32))
        return pc.find_transformation(
            pins, st, st, u, pc.TransformationType.Camera,
        )

    solve(0)  # compile
    solve(1)
    t0 = time.perf_counter()
    reps = 20
    for k in range(reps):
        solve(k % 5)
    dt = (time.perf_counter() - t0) / reps
    emit("pin_drag_solve_ms", dt * 1000, "ms/solve")


def bench_tracking():
    """Config 3: forward tracking over a 120-frame 1080p-scale clip."""
    import jax.numpy as jnp

    from polychase_tpu.engine import camera as C
    from polychase_tpu.engine.tracker import track_camera_trajectory
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.io.database import Database

    rng = np.random.default_rng(1)
    n = 120
    mesh, intr, poses = make_scene(n)
    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        t0 = time.perf_counter()
        build_synth_db(db_path, mesh, intr, poses, rng)
        print(f"# db build: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

        def run():
            traj = CameraTrajectory(0, n)
            traj.set(0, C.CameraState(intr, poses[0]))
            db = Database(db_path)
            t0 = time.perf_counter()
            track_camera_trajectory(
                db, traj, 0, n - 1, np.eye(4, dtype=np.float32), mesh
            )
            dt = time.perf_counter() - t0
            db.close()
            return dt, traj

        dt_w, _ = run()  # warm
        print(f"# warm run: {dt_w:.1f}s", file=sys.stderr)
        dt, traj = run()
        fps = (n - 1) / dt

        base_fps = None
        if MEASURE_BASELINE:
            base_fps = _baseline_track_fps(db_path, mesh, intr, poses, n)
        emit(
            "tracking_fps_120f_1080p", fps, "frames/sec",
            vs_baseline=(round(fps / base_fps, 3) if base_fps else None),
            baseline_value=base_fps,
        )


def _baseline_track_fps(db_path, mesh, intr, poses, n, masked_bits=None,
                        opt_f=False, opt_pp=False):
    """Measured CPU baseline: the reference tracker's data flow in numpy
    + native BVH (benchmarks/baseline_cpu.py)."""
    import jax

    import baseline_cpu as bc
    from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
    from polychase_tpu.io.database import Database

    host = _host_scene_arrays(mesh, intr)
    if host is None:
        return None
    bvh, _verts, _tris = host
    p0 = jax.device_get(poses[0])

    def run():
        traj = {0: (np.asarray(p0.q, np.float64),
                    np.asarray(p0.t, np.float64))}
        db = Database(db_path)
        t0 = time.perf_counter()
        bc.cpu_track_trajectory(
            db, traj, 0, n - 1, np.eye(4), bvh, intr,
            masked_triangles=masked_bits,
            optimize_focal_length=opt_f, optimize_principal_point=opt_pp,
            bundle_opts=BundleOptions(loss_type=CAUCHY, loss_scale=1.0),
        )
        dt = time.perf_counter() - t0
        db.close()
        return dt

    run()  # warm numpy/sqlite caches
    return (n - 1) / min(run() for _ in range(2))


def bench_refine():
    """Config 4: BA over a 250-frame segment with focal estimation."""
    import jax.numpy as jnp

    from polychase_tpu.engine import camera as C, pose as P
    from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
    from polychase_tpu.engine.refiner import refine_trajectory
    from polychase_tpu.engine.trajectory import CameraTrajectory

    rng = np.random.default_rng(2)
    n = 250
    mesh, intr, poses = make_scene(n)
    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        build_synth_db(db_path, mesh, intr, poses, rng, kp_per_frame=128)

        def make_traj():
            traj = CameraTrajectory(0, n)
            for i, p in enumerate(poses):
                t = np.asarray(p.t)
                if i not in (0, n - 1):
                    t = t + rng.normal(0, 0.005, 3).astype(np.float32)
                traj.set(i, C.CameraState(
                    intr, P.Pose(p.q, jnp.asarray(t))
                ))
            return traj

        opts = BundleOptions(
            loss_type=CAUCHY, loss_scale=1.0, max_iterations=30
        )
        refine_trajectory(  # warm (compile)
            db_path, make_traj(), np.eye(4, dtype=np.float32), mesh,
            optimize_focal_length=True, bundle_opts=opts,
        )
        t0 = time.perf_counter()
        refine_trajectory(
            db_path, make_traj(), np.eye(4, dtype=np.float32), mesh,
            optimize_focal_length=True, bundle_opts=opts,
        )
        wall = time.perf_counter() - t0

        base_wall = None
        if MEASURE_BASELINE:
            base_wall = _baseline_refine_wall(
                db_path, mesh, intr, make_traj(), n, opts
            )
        emit(
            "refine_250f_walltime_s", wall, "seconds",
            vs_baseline=(round(base_wall / wall, 3) if base_wall else None),
            baseline_value=base_wall,
        )


def _baseline_refine_wall(db_path, mesh, intr, traj, n, opts):
    """Measured CPU baseline: sparse-LM BA in numpy/scipy
    (benchmarks/baseline_cpu.py)."""
    import jax

    import baseline_cpu as bc
    from polychase_tpu.io.database import Database

    host = _host_scene_arrays(mesh, intr)
    if host is None:
        return None
    bvh, verts, tris = host
    states = jax.device_get([traj.get(i) for i in range(n)])
    tdict = {
        i: (np.asarray(s.pose.q, np.float64),
            np.asarray(s.pose.t, np.float64))
        for i, s in enumerate(states)
    }
    db = Database(db_path)
    t0 = time.perf_counter()
    bc.cpu_refine_trajectory(
        db, tdict, 0, n - 1, np.eye(4), bvh, intr, verts, tris,
        optimize_focal_length=True, bundle_opts=opts,
    )
    dt = time.perf_counter() - t0
    db.close()
    return dt


def bench_segment_parallel():
    """Segment-parallel tracking + refine over the visible device mesh.

    On one device this measures the vmapped batch (all segments in one
    dispatch); on several, each device takes a segment shard."""
    import jax
    import jax.numpy as jnp

    from polychase_tpu.engine import camera as C, pose as P
    from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.parallel.segments import refine_segments
    from polychase_tpu.parallel.tracking import track_segments

    rng = np.random.default_rng(5)
    n_seg = max(int(jax.device_count()), 4)
    seg_len = 16
    n = n_seg * (seg_len - 1) + 1
    mesh, intr, poses = make_scene(n)
    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        build_synth_db(db_path, mesh, intr, poses, rng, kp_per_frame=128)

        def seeded():
            out = []
            for s in range(n_seg):
                a = s * (seg_len - 1)
                traj = CameraTrajectory(a, seg_len)
                traj.set(a, C.CameraState(intr, poses[a]))
                out.append(traj)
            return out

        opts = BundleOptions(loss_type=CAUCHY, loss_scale=1.0)
        track_segments(  # warm/compile
            db_path, seeded(), np.eye(4, dtype=np.float32), mesh,
            bundle_opts=opts,
        )
        t0 = time.perf_counter()
        trajs = seeded()
        track_segments(
            db_path, trajs, np.eye(4, dtype=np.float32), mesh,
            bundle_opts=opts,
        )
        dt = time.perf_counter() - t0
        emit(
            "segment_parallel_tracking_fps",
            n_seg * (seg_len - 1) / dt, "frames/sec",
        )

        ropts = BundleOptions(
            loss_type=CAUCHY, loss_scale=1.0, max_iterations=20
        )
        refine_segments(  # warm/compile
            db_path, trajs, np.eye(4, dtype=np.float32), mesh,
            bundle_opts=ropts,
        )
        t0 = time.perf_counter()
        refine_segments(
            db_path, trajs, np.eye(4, dtype=np.float32), mesh,
            bundle_opts=ropts,
        )
        emit(
            "segment_parallel_refine_walltime_s",
            time.perf_counter() - t0, "seconds",
        )


def bench_4k_pipeline():
    """Config 5: 4K clip — analyze (GFTT + LK) fps, then object tracking
    with a 3D-masked mesh and variable focal + principal point."""
    import cv2
    import jax.numpy as jnp

    from polychase_tpu.engine import camera as C
    from polychase_tpu.engine.geometry import mask_array_size
    from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
    from polychase_tpu.engine.opticalflow import (
        VideoInfo, generate_optical_flow_database,
    )
    from polychase_tpu.engine.tracker import track_camera_trajectory
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.io.database import Database

    # --- analyze on a real 4K image stream -------------------------------
    W4, H4, NF = 3840, 2160, 6
    rng = np.random.default_rng(3)
    big = rng.integers(0, 255, (H4 + 40, W4 + 60)).astype(np.float32)
    big = cv2.GaussianBlur(big, (0, 0), 1.5)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    frames = [
        np.ascontiguousarray(big[3 * t : 3 * t + H4, 5 * t : 5 * t + W4])
        for t in range(NF)
    ]
    info = VideoInfo(W4, H4, 0, NF)

    def run_analyze():
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "flow.db")
            t0 = time.perf_counter()
            generate_optical_flow_database(
                info, lambda fid: frames[fid], None, path
            )
            return time.perf_counter() - t0

    run_analyze()  # warm
    emit("analyze_fps_4k", NF / run_analyze(), "frames/sec")

    # --- object tracking: masked mesh + variable intrinsics ---------------
    n = 60
    mesh, intr, poses = make_scene(n, width=W4, height=H4, focal=3600.0)
    bits = np.zeros(mask_array_size(mesh.num_triangles), np.uint32)
    for t in range(0, mesh.num_triangles // 10):   # mask 10% of triangles
        bits[t // 32] |= np.uint32(1 << (t % 32))
    mesh = mesh._replace(masked_triangles=jnp.asarray(bits))

    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        build_synth_db(db_path, mesh, intr, poses, rng, kp_per_frame=256)

        def run_track():
            traj = CameraTrajectory(0, n)
            traj.set(0, C.CameraState(intr, poses[0]))
            db = Database(db_path)
            t0 = time.perf_counter()
            track_camera_trajectory(
                db, traj, 0, n - 1, np.eye(4, dtype=np.float32), mesh,
                optimize_focal_length=True, optimize_principal_point=True,
                bundle_opts=BundleOptions(loss_type=CAUCHY, loss_scale=1.0),
            )
            db.close()
            return time.perf_counter() - t0

        run_track()
        fps = (n - 1) / run_track()
        base_fps = None
        if MEASURE_BASELINE:
            base_fps = _baseline_track_fps(
                db_path, mesh, intr, poses, n,
                masked_bits=bits, opt_f=True, opt_pp=True,
            )
        emit(
            "object_tracking_fps_4k_masked_varintr", fps, "frames/sec",
            vs_baseline=(round(fps / base_fps, 3) if base_fps else None),
            baseline_value=base_fps,
        )


def _run_headline_analyze():
    """Run /bench.py, re-print its JSON line and capture it in RESULTS."""
    import contextlib
    import io

    import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()
    out = buf.getvalue()
    print(out, end="", flush=True)
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                RESULTS.append(json.loads(line))
            except json.JSONDecodeError:
                pass


def _write_results(path):
    """Persist the full battery as a per-round artifact (VERDICT r3 #8)."""
    import platform
    import subprocess

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ).stdout.strip()
    except OSError:
        commit = None
    doc = {
        "commit": commit,
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "host_nproc": os.cpu_count(),
        "platform": platform.platform(),
        "results": RESULTS,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"# wrote {path} ({len(RESULTS)} records)", file=sys.stderr)


def main():
    global MEASURE_BASELINE
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-analyze", action="store_true")
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="skip the CPU-baseline measurements",
    )
    ap.add_argument(
        "--only",
        choices=["pin", "track", "refine", "analyze", "analyze1080",
                 "full4k", "segpar"],
    )
    ap.add_argument(
        "--json", metavar="PATH",
        help="also write all records (plus commit/host context) to PATH, "
             "e.g. benchmarks/results_r04.json",
    )
    args = ap.parse_args()
    MEASURE_BASELINE = not args.no_baseline

    if args.only:
        {"pin": bench_pin_drag, "track": bench_tracking,
         "refine": bench_refine, "full4k": bench_4k_pipeline,
         "analyze1080": bench_analyze_1080p,
         "segpar": bench_segment_parallel,
         }.get(args.only, lambda: None)()
        if args.only == "analyze":
            _run_headline_analyze()
        if args.json:
            _write_results(args.json)
        return

    if not args.skip_analyze:
        _run_headline_analyze()
    bench_pin_drag()
    bench_tracking()
    bench_refine()
    bench_4k_pipeline()
    bench_segment_parallel()
    if args.json:
        _write_results(args.json)


if __name__ == "__main__":
    main()
