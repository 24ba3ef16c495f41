"""Benchmark on one GPU: analyze and tracking throughput, plus two
measurements of single layers.

Default: drives the real analyze pipeline end to end on a synthetic
640x480 clip (GFTT detection, pyramidal LK into the ±{1,2,4,8} skip
targets, SQLite flow-database writes) through
``generate_optical_flow_database``, and when cv2 is installed the
reference's hot path (OpenCV ``goodFeaturesToTrack`` +
``calcOpticalFlowPyrLK`` with the reference's 4-thread cap,
cpp/opticalflow.cc:269-271) on the same frames; then config-3 tracking
(120 frames at 1080p).  Prints ONE JSON line naming the device.

``--track``: the tracking line alone.
``--lk-trace DIR``: one analyze run at 1080p traced with the JAX
profiler into DIR, reduced to device time per trace line and kernel.

The backend must be a GPU; anything else is refused.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "benchmarks"))

W, H = 640, 480
N_FRAMES = 12


def card():
    """Card name and power limit, read by a child that stays off JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def device_fields():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": card()}


def make_clip(width=W, height=H, n=N_FRAMES):
    import chip_smoke

    return chip_smoke.make_frames(0, width, height, n)


def _track_scene(td, n, kp_per_frame=256, n_lat=24, n_lon=32, seed=1):
    import run_all as RA

    mesh, intr, poses = RA.make_scene(n, n_lat=n_lat, n_lon=n_lon)
    db_path = os.path.join(td, "flow.db")
    RA.build_synth_db(db_path, mesh, intr, poses,
                      np.random.default_rng(seed), kp_per_frame=kp_per_frame)
    return mesh, intr, poses, db_path


def _track_once(mesh, intr, poses, db_path, n):
    from polychase_tpu.engine import camera as C
    from polychase_tpu.engine.tracker import track_camera_trajectory
    from polychase_tpu.engine.trajectory import CameraTrajectory
    from polychase_tpu.io.database import Database

    traj = CameraTrajectory(0, n)
    traj.set(0, C.CameraState(intr, poses[0]))
    db = Database(db_path)
    try:
        t0 = time.perf_counter()
        track_camera_trajectory(db, traj, 0, n - 1,
                                np.eye(4, dtype=np.float32), mesh)
        return time.perf_counter() - t0, traj
    finally:
        db.close()


def bench_track():
    """Config-3 forward tracking: frames/s over 120 frames."""
    n = 120
    with tempfile.TemporaryDirectory() as td:
        scene = _track_scene(td, n)
        _track_once(*scene, n)  # compile
        dt = min(_track_once(*scene, n)[0] for _ in range(3))
    return (n - 1) / dt


def _analyze(frames, path):
    from polychase_tpu.engine.opticalflow import (
        VideoInfo,
        generate_optical_flow_database,
    )

    h, w = frames[0].shape
    t0 = time.perf_counter()
    generate_optical_flow_database(
        VideoInfo(w, h, 0, len(frames)), lambda fid: frames[fid], None, path
    )
    return time.perf_counter() - t0


def bench_ours(frames):
    with tempfile.TemporaryDirectory() as td:
        _analyze(frames, os.path.join(td, "warm.db"))  # compiles
        dt = min(_analyze(frames, os.path.join(td, f"{i}.db"))
                 for i in range(3))
    return len(frames) / dt


def bench_opencv(frames):
    import cv2

    from polychase_tpu.io.database import Database

    cv2.setNumThreads(4)  # the reference's analysis-thread cap
    win = (10, 10)
    crit = (cv2.TERM_CRITERIA_COUNT + cv2.TERM_CRITERIA_EPS, 30, 0.01)

    def run():
        with tempfile.TemporaryDirectory() as td:
            db = Database(os.path.join(td, "flow.db"))
            t0 = time.perf_counter()
            feats = {}
            for i in range(len(frames)):
                pts = cv2.goodFeaturesToTrack(
                    frames[i], maxCorners=0, qualityLevel=0.01,
                    minDistance=5.0, blockSize=3,
                )
                feats[i] = pts.reshape(-1, 1, 2).astype(np.float32)
                db.write_keypoints(i, feats[i].reshape(-1, 2))
                for skip in (-8, -4, -2, -1, 1, 2, 4, 8):
                    j = i + skip
                    if not 0 <= j < len(frames):
                        continue
                    if db.image_pair_flow_exists(i, j):
                        continue
                    nxt, st, err = cv2.calcOpticalFlowPyrLK(
                        frames[i], frames[j], feats[i], None,
                        winSize=win, maxLevel=3, criteria=crit,
                        flags=0, minEigThreshold=1e-4,
                    )
                    keep = st.reshape(-1) == 1
                    db.write_image_pair_flow(
                        i, j,
                        np.nonzero(keep)[0].astype(np.uint32),
                        nxt.reshape(-1, 2)[keep],
                        err.reshape(-1)[keep],
                    )
            dt = time.perf_counter() - t0
            db.close()
            return dt

    run()
    return len(frames) / min(run() for _ in range(3))


def lk_trace(trace_dir, n_frames=24):
    """Trace one warm 1080p analyze run; device time per trace line."""
    import jax

    from polychase_tpu.obs import stop_profiler

    frames = make_clip(1920, 1080, n_frames)
    with tempfile.TemporaryDirectory() as td:
        _analyze(frames, os.path.join(td, "warm.db"))
        untraced = _analyze(frames, os.path.join(td, "plain.db"))
        os.environ["POLYCHASE_PROFILE"] = trace_dir
        try:
            traced = _analyze(frames, os.path.join(td, "traced.db"))
        finally:
            stop_profiler()
            del os.environ["POLYCHASE_PROFILE"]
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    return {
        "metric": "analyze_lk_trace_1080p", "frames": n_frames,
        "wall_s_untraced": untraced, "wall_s_traced": traced,
        "device_lines": device_line_times(path),
        "jax": jax.__version__,
    }


def device_line_times(xplane_path, top=12):
    """Per line of the first GPU plane of a trace: the summed event
    time, the union of the event intervals (busy time), the window from
    first start to last end, and the ``top`` event names by time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    plane = next(p for p in pd.planes if p.name.startswith("/device:GPU:"))
    out = {}
    for line in plane.lines:
        per, spans = {}, []
        for ev in line.events:
            name = ev.name.split("(")[0][:80]
            per[name] = per.get(name, 0.0) + ev.duration_ns * 1e-9
            spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not spans:
            continue
        busy, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                busy += (b - max(a, end)) * 1e-9
                end = b
        out[line.name] = {
            "events": len(spans), "sum_s": sum(per.values()),
            "busy_s": busy,
            "window_s": (max(b for _, b in spans)
                         - min(a for a, _ in spans)) * 1e-9,
            "top_s": dict(sorted(per.items(), key=lambda kv: -kv[1])[:top]),
        }
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--track", action="store_true")
    ap.add_argument("--lk-trace", metavar="DIR")
    args = ap.parse_args()

    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found "
                 f"{jax.devices()[0].platform!r}")
    from polychase_tpu.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = device_fields()

    if args.lk_trace:
        out = lk_trace(os.path.abspath(args.lk_trace))
    elif args.track:
        out = {"metric": "tracking_fps_120f_1080p", "value": bench_track(),
               "unit": "frames/sec"}
    else:
        frames = make_clip()
        ours = bench_ours(frames)
        try:
            import cv2  # noqa: F401
        except ImportError:
            cv_fps = None  # the OpenCV baseline needs cv2
        else:
            cv_fps = bench_opencv(frames)
        out = {
            "metric": "analyze_fps_640x480", "value": ours,
            "unit": "frames/sec",
            "vs_baseline": ours / cv_fps if cv_fps else None,
            "baseline_value": cv_fps,
            "track_fps": bench_track(),
            "host_nproc": os.cpu_count(),
        }
    out.update(dev)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
