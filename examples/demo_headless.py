#!/usr/bin/env python3
"""Headless end-to-end demo: render -> analyze -> track -> refine.

Renders a procedurally-textured sphere with the engine's own ray caster,
builds a real optical-flow database from the images, tracks the camera
forward from one known pose, then refines a perturbed trajectory —
the full Polychase workflow without Blender.

    python examples/demo_headless.py            # default device
    JAX_PLATFORMS=cpu python examples/demo_headless.py
"""

import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "tests"),
)


def main():
    import jax.numpy as jnp

    import polychase_tpu.polychase_core as pc
    from polychase_tpu.engine import pose as P
    from synthetic import make_sphere_mesh, orbit_pose
    from test_e2e_images import _intr, _noise_fn, _render, W, H, FOCAL
    from test_tracker import pose_errors

    n_frames = 10
    rng = np.random.default_rng(1)
    mesh = make_sphere_mesh()
    intr = _intr()
    poses = [orbit_pose(0.03 * i) for i in range(n_frames)]
    tex = _noise_fn(rng)

    t0 = time.perf_counter()
    frames = [_render(mesh, intr, p, tex) for p in poses]
    print(f"rendered {n_frames} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f}s")

    with tempfile.TemporaryDirectory() as td:
        db_path = os.path.join(td, "flow.db")
        info = pc.VideoInfo(width=W, height=H, first_frame=0,
                            num_frames=n_frames)
        t0 = time.perf_counter()
        pc.generate_optical_flow_database(
            info, lambda fid: frames[fid], None, db_path
        )
        print(f"analyzed in {time.perf_counter() - t0:.1f}s")

        core_intr = pc.CameraIntrinsics(
            FOCAL, FOCAL, W / 2, H / 2, 1.0, W, H,
            pc.CameraConvention.OpenCV,
        )
        st = pc.SceneTransformations(
            model_matrix=np.eye(4, dtype=np.float32),
            view_matrix=P.pose_rt4x4_np(poses[0]).astype(np.float32),
            intrinsics=core_intr,
        )
        accel = pc.AcceleratedMesh(
            np.asarray(mesh.vertices), np.asarray(mesh.triangles)
        )
        t0 = time.perf_counter()
        results = []
        pc.track_sequence(db_path, 0, n_frames - 1, st, accel,
                          lambda r: results.append(r) or True)
        dt = time.perf_counter() - t0
        print(f"tracked {len(results)} frames in {dt:.1f}s "
              f"({len(results) / dt:.1f} fps)")
        for r in results:
            rot_err, t_err = pose_errors(
                P.Pose(jnp.asarray(r.pose.q), jnp.asarray(r.pose.t)),
                poses[r.frame],
            )
            print(f"  frame {r.frame}: inliers {r.inlier_ratio:.2f} "
                  f"rot_err {rot_err:.4f} t_err {t_err:.4f}")

        traj = pc.CameraTrajectory(0, n_frames)
        for i, p in enumerate(poses):
            t = np.asarray(p.t)
            if i not in (0, n_frames - 1):
                t = t + rng.normal(0, 0.01, 3).astype(np.float32)
            traj.set(i, pc.CameraState(
                core_intr,
                pc.Pose(np.asarray(p.q, np.float32), t.astype(np.float32)),
            ))
        t0 = time.perf_counter()
        pc.refine_trajectory(db_path, traj, np.eye(4, dtype=np.float32),
                             accel.inner(), False, False, None)
        print(f"refined in {time.perf_counter() - t0:.1f}s")
        worst = max(
            pose_errors(
                P.Pose(jnp.asarray(traj.get(i).pose.q),
                       jnp.asarray(traj.get(i).pose.t)),
                poses[i],
            )[1]
            for i in range(1, n_frames - 1)
        )
        print(f"post-refine worst translation error: {worst:.5f}")


if __name__ == "__main__":
    main()
