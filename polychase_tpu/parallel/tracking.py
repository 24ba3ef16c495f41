"""Segment-parallel forward tracking across a device mesh.

Tracking a segment is inherently sequential (each frame warm-starts from
its neighbor, cpp/tracker.cc:133-192) — but *segments* are independent
given their seed keyframes, exactly like refine (parallel/segments.py).
Each segment's whole chain is one ``lax.scan`` (the same device program
as ``engine.tracker``'s chunked scan, reused verbatim), vmapped over a
leading segment axis and shard_mapped over a 1-D mesh: N devices track
N segments at the single-device chain rate.

``tests/test_tracking_parallel.py`` pins parity with the sequential
``track_camera_trajectory``.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh, PartitionSpec as PSpec
from jax import shard_map

from ..engine import camera as C
from ..engine import pose as P
from ..engine.geometry import Mesh
from ..engine.levmarq import BundleOptions, CAUCHY
from ..engine.tracker import (
    MAX_INLIER_ERROR,
    TrackingError,
    _frame_groups,
    _scan_track_fn,
)
from ..engine.trajectory import CameraTrajectory
from ..io.database import Database

SEGMENT_AXIS = "segments"


def make_track_mesh(devices=None) -> DeviceMesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return DeviceMesh(devices.reshape(-1), (SEGMENT_AXIS,))


def _pack_segment(database, traj, Gp, K, n_steps, Fmax, Kmax):
    """One segment's scan inputs, padded to (n_steps, Gp, K), plus its
    (Fmax, Kmax, 2) keypoint table (packed-index upload format — see
    engine.tracker._scan_track_fn)."""
    first_abs = traj.first_frame
    F = traj.count
    if not traj.is_frame_filled(first_abs):
        raise TrackingError(
            f"segment at {first_abs}: seed frame has no pose"
        )
    frames = list(range(first_abs + 1, first_abs + F))
    available = {first_abs}

    idx_dtype = np.uint16 if Kmax <= np.iinfo(np.uint16).max else np.int32
    src_idx = np.zeros((n_steps, Gp), np.int32)
    kp_idx = np.zeros((n_steps, Gp, K), idx_dtype)
    cnt = np.zeros((n_steps, Gp), np.int32)
    tgt_px = np.zeros((n_steps, Gp, K, 2), np.float32)
    tgt_i = np.zeros((n_steps,), np.int32)
    warm_i = np.zeros((n_steps,), np.int32)
    kps_seg = np.zeros((Fmax, Kmax, 2), np.float32)
    filled_kp: set = set()
    for r, frame_id in enumerate(frames):
        groups = _frame_groups(database, frame_id, available)
        for cand in (frame_id, frame_id - 1, frame_id + 1):
            if cand in available:
                warm = cand
                break
        else:
            warm = frame_id - 1
        tgt_i[r] = frame_id - first_abs
        warm_i[r] = warm - first_abs
        for g, (src_f, idx, tpx) in enumerate(groups):
            n = idx.shape[0]
            src_idx[r, g] = src_f - first_abs
            kp_idx[r, g, :n] = idx
            cnt[r, g] = n
            tgt_px[r, g, :n] = tpx
            if src_f not in filled_kp:
                k = database.read_keypoints(src_f)
                kps_seg[src_f - first_abs, : k.shape[0]] = k
                filled_kp.add(src_f)
        available.add(frame_id)
    for r in range(len(frames), n_steps):  # padding rows: masked no-ops
        tgt_i[r] = tgt_i[len(frames) - 1]
        warm_i[r] = warm_i[len(frames) - 1]
    return (src_idx, kp_idx, cnt, tgt_px, tgt_i, warm_i), kps_seg


def track_segments(
    database,
    trajs: Sequence[CameraTrajectory],
    model_matrix: np.ndarray,
    mesh: Mesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(loss_type=CAUCHY),
    device_mesh=None,
):
    """Track every segment forward from its (filled) first frame, in one
    parallel dispatch.  Poses are written into each trajectory; returns
    ``counts`` (S, steps) of correspondences per solved frame (a frame
    with <3 keeps its warm-start pose, mirroring the sequential path's
    abort point — callers decide whether that is an error).
    """
    if not trajs:
        return np.zeros((0, 0), np.int32)
    own_db = False
    if isinstance(database, str):
        database = Database(database)
        own_db = True

    from ..engine.pnp import bucket_size, normalize_bundle_opts

    try:
        # Shared sizing pass over all segments (one compiled shape).
        sizes = []
        src_frames: set = set()
        for traj in trajs:
            first_abs = traj.first_frame
            available = {first_abs}
            gmax, kmax = 1, 1
            for frame_id in range(first_abs + 1, first_abs + traj.count):
                groups = _frame_groups(database, frame_id, available)
                gmax = max(gmax, len(groups))
                kmax = max(
                    kmax, max((g[1].shape[0] for g in groups), default=1)
                )
                src_frames.update(g[0] for g in groups)
                available.add(frame_id)
            sizes.append((gmax, kmax))
        G = max(g for g, _ in sizes)
        Gp = -(-max(8, G) // 8) * 8
        K = bucket_size(max(k for _, k in sizes))
        n_steps = max(t.count - 1 for t in trajs)
        Fmax = max(t.count for t in trajs)
        Kmax = bucket_size(
            max(
                [database.read_keypoints(f).shape[0] for f in src_frames]
                + [1]
            )
        )

        packed = [
            _pack_segment(database, t, Gp, K, n_steps, Fmax, Kmax)
            for t in trajs
        ]
        xs_list = [p[0] for p in packed]
        kps_all = np.stack([p[1] for p in packed])  # (S, Fmax, Kmax, 2)
    finally:
        if own_db:
            database.close()

    S = len(trajs)
    # One batched host gather for every seed (per-segment device_get
    # would pay a host round trip each).
    seeds = jax.device_get(
        [t.get(t.first_frame) for t in trajs]
    )
    ci0 = seeds[0].intrinsics
    # The packed solve shares [aspect, width, height, sign] across all
    # segments — mixed-clip batches would silently mis-unproject.
    for s, seed in enumerate(seeds[1:], 1):
        ci = seed.intrinsics
        if (
            float(ci.aspect_ratio) != float(ci0.aspect_ratio)
            or float(ci.width) != float(ci0.width)
            or float(ci.height) != float(ci0.height)
            or float(ci.sign) != float(ci0.sign)
        ):
            raise TrackingError(
                f"segment {s}: seed intrinsics convention/size differs "
                "from segment 0 (all segments must share one clip)"
            )
    const5 = jnp.asarray(
        [
            float(ci0.aspect_ratio), float(ci0.width), float(ci0.height),
            float(ci0.sign), MAX_INLIER_ERROR,
        ],
        jnp.float32,
    )
    q0 = np.zeros((S, Fmax, 4), np.float32)
    q0[..., 0] = 1.0
    t0 = np.zeros((S, Fmax, 3), np.float32)
    in0 = np.zeros((S, Fmax, 4), np.float32)
    for s, seed in enumerate(seeds):
        q0[s, :] = np.asarray(seed.pose.q)
        t0[s, :] = np.asarray(seed.pose.t)
        in0[s, :] = [
            float(seed.intrinsics.fx), float(seed.intrinsics.fy),
            float(seed.intrinsics.cx), float(seed.intrinsics.cy),
        ]

    # The multi-device path is packed-index only: _pack_segment emits the
    # packed format unconditionally, so the POLYCHASE_TRACK_IDX=0 legacy
    # opt-out applies to the single-device scan chain alone (formats are
    # bit-identical either way — see engine.tracker.PACKED_IDX).
    run = _scan_track_fn(
        bool(optimize_focal_length), bool(optimize_principal_point),
        tuple(normalize_bundle_opts(bundle_opts)),
        packed_idx=True,
    )

    xs = tuple(
        jnp.asarray(np.stack([x[i] for x in xs_list]))
        for i in range(6)
    )
    kps_d = jnp.asarray(kps_all)
    carry0 = (jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(in0))

    model = jnp.asarray(np.asarray(model_matrix, np.float32))
    model_inv = jnp.asarray(
        np.linalg.inv(np.asarray(model_matrix, np.float64)).astype(
            np.float32
        )
    )

    def solve(q0, t0, in0, kps, xs, mesh_, model_, model_inv_, const5_):
        return run(
            mesh_, model_, model_inv_, q0, t0, in0, const5_, kps, xs
        )

    batched = jax.vmap(
        solve, in_axes=(0, 0, 0, 0, 0, None, None, None, None)
    )

    dev_mesh = None
    if device_mesh is not False:
        if device_mesh is not None:
            dev_mesh = device_mesh
        elif jax.device_count() > 1:
            dev_mesh = make_track_mesh()

    n_dummy = 0
    if dev_mesh is not None:
        D = int(dev_mesh.devices.size)
        n_dummy = (-S) % D
        if n_dummy:
            pad = lambda a: jnp.concatenate(
                [a, jnp.repeat(a[:1], n_dummy, 0)]
            )
            carry0 = tuple(pad(c) for c in carry0)
            xs = tuple(pad(x) for x in xs)
            kps_d = pad(kps_d)
        seg = PSpec(SEGMENT_AXIS)
        rep = PSpec()
        fn = shard_map(
            batched,
            mesh=dev_mesh,
            in_specs=(
                seg, seg, seg, seg, (seg,) * 6,
                jax.tree.map(lambda _: rep, mesh), rep, rep, rep,
            ),
            out_specs=((seg, seg, seg), seg, seg),
            check_vma=False,
        )
        carry, vecs, counts = fn(
            *carry0, kps_d, xs, mesh, model, model_inv, const5
        )
    else:
        carry, vecs, counts = batched(
            *carry0, kps_d, xs, mesh, model, model_inv, const5
        )

    q_all, t_all, in_all = jax.device_get(carry)
    counts_h = np.asarray(jax.device_get(counts))
    for s, traj in enumerate(trajs):
        first_abs = traj.first_frame
        ci = jax.device_get(traj.get(first_abs).intrinsics)
        for r in range(traj.count - 1):
            if counts_h[s, r] < 3:
                continue
            i = r + 1  # tgt index within the segment (forward order)
            intr = C.Intrinsics(
                fx=np.float32(in_all[s, i, 0]),
                fy=np.float32(in_all[s, i, 1]),
                cx=np.float32(in_all[s, i, 2]),
                cy=np.float32(in_all[s, i, 3]),
                aspect_ratio=ci.aspect_ratio, width=ci.width,
                height=ci.height, sign=ci.sign,
            )
            traj.set(
                first_abs + i,
                C.CameraState(
                    intr,
                    P.Pose(
                        jnp.asarray(q_all[s, i]), jnp.asarray(t_all[s, i])
                    ),
                ),
            )
    return counts_h[:S]
