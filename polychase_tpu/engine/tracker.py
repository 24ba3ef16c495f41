"""Sequential frame-by-frame pose tracking.

Rebuild of the reference tracker (cpp/tracker.{h,cc}).  The
frame chain stays sequential (each frame's solve warm-starts from its
neighbor, cpp/tracker.cc:133-192), but everything inside a frame is
batched on device:

- all matches from all solved source frames are ray-cast **at once**
  (one batched Möller–Trumbore sweep instead of the reference's
  per-keypoint Embree query loop, cpp/tracker.cc:64-92);
- the PnP solve evaluates every correspondence in parallel and runs its
  whole LM iteration as a single XLA program (engine/pnp.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..io.database import Database
from ..obs import get_logger, profile_region
from . import camera as C
from . import pose as P
from .geometry import Mesh, SceneTransformations
from .levmarq import BundleOptions, BundleStats
from .raycast import raycast_grouped
from .trajectory import CameraTrajectory


class FrameTrackingResult(NamedTuple):
    """Per-frame tracking output (cpp/tracker.h:15-21)."""

    frame: int
    pose: P.Pose
    intrinsics: C.Intrinsics
    bundle_stats: BundleStats
    inlier_ratio: float


# TrackingCallback: FrameTrackingResult -> continue?
TrackingCallback = Callable[[FrameTrackingResult], bool]

# Max reprojection error for the inlier ratio (cpp/tracker.cc:123)
MAX_INLIER_ERROR = 12.0

_log = get_logger("tracker")


class TrackingError(RuntimeError):
    pass


# Host-side pose helpers live in engine.pose; keep these names for
# existing importers.
_np_quat_to_mat = P.quat_to_mat_np
pose_rt4x4_np = P.pose_rt4x4_np


def unproject_np(intrinsics: C.Intrinsics, pixels: np.ndarray) -> np.ndarray:
    """Host copy of camera.unproject (cpp/pnp/types.h:95-98)."""
    intr = jax.device_get(intrinsics)
    s = float(intr.sign)
    p = np.asarray(pixels, np.float64).reshape(-1, 2)
    return np.stack(
        [
            s * (p[:, 0] - float(intr.cx)) / float(intr.fx),
            s * (p[:, 1] - float(intr.cy)) / float(intr.fy),
            np.full(p.shape[0], s),
        ],
        axis=-1,
    )


def rays_object_space(
    model_matrix: np.ndarray,
    view_matrix: np.ndarray,
    intrinsics: C.Intrinsics,
    pixels: np.ndarray,
):
    """Batched pixel → object-space ray (cpp/ray_casting.h:53-63)."""
    mv = np.asarray(view_matrix, np.float64) @ np.asarray(
        model_matrix, np.float64
    )
    inv = np.linalg.inv(mv).astype(np.float32)
    dirs_cam = unproject_np(intrinsics, pixels).astype(np.float32)
    origins = np.broadcast_to(inv[:3, 3], dirs_cam.shape)
    dirs = dirs_cam @ inv[:3, :3].T
    return origins, dirs


def pack_frame_rays(
    database: Database,
    camera_traj: CameraTrajectory,
    model_matrix: np.ndarray,
    frame_id: int,
):
    """Host half of correspondence gathering: read flows, build padded
    (Gp, K) ray groups + flowed target pixels (cpp/tracker.cc:43-62).

    Returns (origins (Gp,3), dirs (Gp,K,3), tgt (Gp,K,2), mask (Gp,K))
    or None when no usable flows exist.
    """
    model_matrix = np.asarray(model_matrix, np.float32)
    raw = []
    for flow_frame_id in database.find_optical_flows_to_image(frame_id):
        if flow_frame_id == frame_id:
            raise TrackingError("self-flow in database")
        if not camera_traj.is_frame_filled(flow_frame_id):
            continue
        keypoints = database.read_keypoints(flow_frame_id)
        flow = database.read_image_pair_flow(flow_frame_id, frame_id)
        if flow.src_kps_indices.size == 0:
            continue
        raw.append(
            (
                camera_traj.get(flow_frame_id),
                keypoints[flow.src_kps_indices],
                flow.tgt_kps,
            )
        )
    # One batched transfer for all source cameras (a per-group
    # device_get costs a host round trip each).
    cams_h = jax.device_get([cam for cam, _, _ in raw])
    groups = []
    for cam, src_px, tgt_kps in zip(cams_h, (r[1] for r in raw),
                                    (r[2] for r in raw)):
        view = pose_rt4x4_np(cam.pose).astype(np.float32)
        origins, dirs = rays_object_space(
            model_matrix, view, cam.intrinsics, src_px
        )
        groups.append((origins[0], dirs, tgt_kps))

    if not groups:
        return None

    from .pnp import bucket_size

    G = len(groups)
    # Pad the group axis to multiples of 8 so frames reuse compiled
    # shapes (a frame can receive up to 16 flows when both directions of
    # the +-{1,2,4,8} skip pattern are filled).
    Gp = -(-max(8, G) // 8) * 8
    K = bucket_size(max(d.shape[0] for _, d, _ in groups))
    origins_arr = np.zeros((Gp, 3), np.float32)
    dirs_arr = np.zeros((Gp, K, 3), np.float32)
    dirs_arr[..., 2] = 1.0  # padding rays: unit z, masked off below
    tgt_arr = np.zeros((Gp, K, 2), np.float32)
    mask = np.zeros((Gp, K), bool)
    for g, (o, d, tgt) in enumerate(groups):
        n = d.shape[0]
        origins_arr[g] = o
        dirs_arr[g, :n] = d
        tgt_arr[g, :n] = tgt
        mask[g, :n] = True
    return origins_arr, dirs_arr, tgt_arr, mask


_CAST_SOLVE_CACHE = {}


def _cast_and_solve_fn(opt_f: bool, opt_pp: bool, opts_key):
    """Fused per-frame program: ray cast + world transform + PnP solve in
    ONE dispatch (the tracker chain pays per-frame latency, so two
    separate round trips would each cost it)."""
    from .pnp import solve_arrays
    from functools import partial as _partial

    key = (opt_f, opt_pp, opts_key)
    fn = _CAST_SOLVE_CACHE.get(key)
    if fn is not None:
        return fn

    opts = BundleOptions(*opts_key)

    @_partial(jax.jit, static_argnames=())
    def fused(mesh, origins, dirs, tgt, mask, model, params):
        hits = raycast_grouped(mesh, origins, dirs, True)
        valid = hits.valid & mask
        X_obj = hits.pos.reshape(-1, 3)
        X = P.matmul(X_obj, model[:3, :3].T) + model[:3, 3]
        x = tgt.reshape(-1, 2)
        m = valid.reshape(-1)
        weights = jnp.where(m, 1.0, 0.0)
        vec = solve_arrays(
            X, x, weights, m, params, opt_f=opt_f, opt_pp=opt_pp, opts=opts
        )
        return vec, jnp.sum(m)

    _CAST_SOLVE_CACHE[key] = fused
    return fused


def solve_frame(
    database: Database,
    camera_traj: CameraTrajectory,
    model_matrix: np.ndarray,
    frame_id: int,
    mesh: Mesh,
    optimize_focal_length: bool,
    optimize_principal_point: bool,
    bundle_opts: BundleOptions,
):
    """Solve one frame's camera from flows into it (cpp/tracker.cc:36-131).

    Returns a PnPResult or None when fewer than 3 correspondences exist.
    """
    from .levmarq import BundleStats as _BS
    from .pnp import PnPResult

    with profile_region("tracker.gather"):
        packed = pack_frame_rays(
            database, camera_traj, np.asarray(model_matrix, np.float32),
            frame_id,
        )
    if packed is None:
        _log.info("frame %d: no usable flows", frame_id)
        return None
    origins_arr, dirs_arr, tgt_arr, mask = packed

    # Warm start from current/prev/next pose (cpp/tracker.cc:112-119)
    cam0: Optional[C.CameraState] = None
    for fid in (frame_id, frame_id - 1, frame_id + 1):
        if camera_traj.is_frame_filled(fid):
            cam0 = camera_traj.get(fid)
            break
    if cam0 is None:
        raise TrackingError(f"no warm-start pose near frame {frame_id}")

    from .pnp import normalize_bundle_opts, pack_camera_params

    c = jax.device_get(cam0)
    ci = c.intrinsics
    params = pack_camera_params(c, MAX_INLIER_ERROR)
    opts_key = tuple(normalize_bundle_opts(bundle_opts))
    fused = _cast_and_solve_fn(
        bool(optimize_focal_length), bool(optimize_principal_point),
        opts_key,
    )
    with profile_region("tracker.cast_and_solve"):
        vec, count = jax.device_get(
            fused(
                mesh, jnp.asarray(origins_arr), jnp.asarray(dirs_arr),
                jnp.asarray(tgt_arr), jnp.asarray(mask),
                jnp.asarray(np.asarray(model_matrix, np.float32)),
                params,
            )
        )
    if int(count) < 3:
        _log.info(
            "frame %d: only %d correspondences, cannot solve",
            frame_id, int(count),
        )
        return None

    intr_out = C.Intrinsics(
        fx=np.float32(vec[7]), fy=np.float32(vec[8]),
        cx=np.float32(vec[9]), cy=np.float32(vec[10]),
        aspect_ratio=ci.aspect_ratio, width=ci.width, height=ci.height,
        sign=ci.sign,
    )
    camera = C.CameraState(intr_out, P.Pose(vec[0:4], vec[4:7]))
    stats = _BS(
        iterations=np.int32(vec[11]), initial_cost=np.float32(vec[12]),
        cost=np.float32(vec[13]), lambda_=np.float32(vec[14]),
        invalid_steps=np.int32(vec[15]), step_norm=np.float32(vec[16]),
        grad_norm=np.float32(vec[17]),
    )
    result = PnPResult(
        camera=camera, stats=stats, inlier_ratio=np.float32(vec[18])
    )
    _log.debug(
        "frame %d: n=%d inlier_ratio=%.3f cost=%.3f iters=%d",
        frame_id, int(count), float(result.inlier_ratio),
        float(result.stats.cost), int(result.stats.iterations),
    )
    return result


# --------------------------------------------------------------------------
# Device-resident tracking chain
#
# The reference's chain is inherently sequential (each frame warm-starts
# from its neighbor, cpp/tracker.cc:133-192), which would cost one
# host↔device round trip per frame.  Instead the chain itself becomes
# a device program — a ``lax.scan`` over a chunk of frames carries the
# trajectory (poses + intrinsics) on device, and each scan step builds
# the source-camera rays from the
# *carried* poses, ray-casts, and runs the full PnP LM solve.  Only the
# per-frame result vectors come back to the host, once per chunk.
# --------------------------------------------------------------------------

# Frames per device dispatch of the scan chain.  Larger chunks amortize
# the per-dispatch round trip at the cost of coarser cancel/callback
# granularity.  The default is not measured on the GPU;
# POLYCHASE_SCAN_CHUNK overrides.
SCAN_CHUNK = int(os.environ.get("POLYCHASE_SCAN_CHUNK", "32"))

_SCAN_TRACK_CACHE = {}

# Upload format of the scan chain's per-frame inputs.  The packed-index
# format (default) uploads each frame's keypoints ONCE as a clip-wide
# (F, Kmax, 2) array plus u16 per-group indices and per-group counts —
# the legacy format re-uploads the same source keypoints as f32 pixels
# for every target frame (up to 16×) plus a bool prefix mask.  Both
# produce bit-identical solves (the gather yields the same f32 values
# and ``iota < count`` equals the prefix mask); packed-index moves
# ~2× fewer bytes to the device.  POLYCHASE_TRACK_IDX=0 restores legacy
# on THIS single-device scan chain only — the multi-device segment path
# (parallel/tracking.py) is packed-only by construction.
PACKED_IDX = os.environ.get("POLYCHASE_TRACK_IDX", "1") != "0"

# Quantized target-pixel upload (packed-index format only).  The target
# keypoints are the dominant upload of the scan chain (f32 (CH,Gp,K,2)
# per chunk ≈ 8/9 of the uploaded bytes).  Each frame's targets are encoded as i16 deltas
# against the clip keypoint table already on device, with a per-frame
# dynamic scale (max|delta|/32700 → quantum ≈ 0.003 px for a 100 px
# flow, bounded 0.5·scale).  Same design as the accepted LK result
# compression (engine/lk.py, POLYCHASE_LK_COMPRESS).
# POLYCHASE_TRACK_QTGT=0 restores the exact-f32 upload.
QUANT_TGT = os.environ.get("POLYCHASE_TRACK_QTGT", "1") != "0"

# Consolidated upload: the five small per-chunk arrays (src_idx, cnt,
# tgt_i, warm_i, qs) ride ONE i32 meta array, so a chunk dispatch moves
# 3 host buffers instead of 7, saving per-device_put fixed cost.
# Internal toggle for interleaved A/Bs only.
_FUSED_META = True


def _scan_track_fn(opt_f: bool, opt_pp: bool, opts_key,
                   packed_idx: bool = True, quant_tgt: bool = False,
                   fused_meta: bool = False):
    from .pnp import solve_arrays
    from functools import partial as _partial

    key = (opt_f, opt_pp, opts_key, packed_idx, quant_tgt, fused_meta)
    fn = _SCAN_TRACK_CACHE.get(key)
    if fn is not None:
        return fn

    opts = BundleOptions(*opts_key)
    if quant_tgt and not packed_idx:
        raise ValueError("quant_tgt requires the packed-index format")
    if fused_meta and not packed_idx:
        raise ValueError("fused_meta requires the packed-index format")

    @_partial(jax.jit, static_argnames=())
    def run(mesh, model, model_inv, q0, t0, in0, const5, kps_all, xs):
        """Scan a chunk of frames.  Carry: (F,4) quats, (F,3) translations,
        (F,4) [fx,fy,cx,cy].  ``const5`` = [aspect, width, height, sign,
        max_inlier_error] shared by every frame of the clip.  ``kps_all``
        is the (F, Kmax, 2) clip keypoint table (packed-index format) or
        a (1, 1, 2) dummy (legacy format)."""

        def step(carry, x):
            q_all, t_all, in_all = carry
            if fused_meta:
                # meta row layout: [src_idx(Gp) | cnt(Gp) | tgt_i |
                # warm_i | qs bitcast to i32]; values identical to the
                # separate-array format (qs round-trips via bitcast).
                if quant_tgt:
                    meta, kp_idx, tgt_q = x
                else:
                    meta, kp_idx, tgt = x
                Gp_ = kp_idx.shape[0]
                src_idx = meta[:Gp_]
                cnt = meta[Gp_ : 2 * Gp_]
                tgt_i = meta[2 * Gp_]
                warm_i = meta[2 * Gp_ + 1]
                if quant_tgt:
                    qs = jax.lax.bitcast_convert_type(
                        meta[2 * Gp_ + 2], jnp.float32
                    )
            elif packed_idx:
                if quant_tgt:
                    src_idx, kp_idx, cnt, tgt_q, qs, tgt_i, warm_i = x
                else:
                    src_idx, kp_idx, cnt, tgt, tgt_i, warm_i = x
            else:
                src_idx, kp, tgt, val, tgt_i, warm_i = x
            if packed_idx:
                kp = kps_all[src_idx[:, None], kp_idx.astype(jnp.int32)]
                val = (
                    jnp.arange(kp_idx.shape[1], dtype=jnp.int32)[None, :]
                    < cnt[:, None]
                )
                if quant_tgt:
                    tgt = kp + tgt_q.astype(jnp.float32) * qs

            qs = q_all[src_idx]  # (Gp, 4)
            ts = t_all[src_idx]
            ins = in_all[src_idx]  # (Gp, 4)
            intr_b = C.Intrinsics(
                fx=ins[:, 0, None], fy=ins[:, 1, None],
                cx=ins[:, 2, None], cy=ins[:, 3, None],
                aspect_ratio=const5[0], width=const5[1],
                height=const5[2], sign=const5[3],
            )
            dir_cam = C.unproject(intr_b, kp)  # (Gp, K, 3)
            dir_w = P.quat_rotate(P.quat_conj(qs)[:, None, :], dir_cam)
            origin_w = P.pose_center(P.Pose(qs, ts))  # (Gp, 3)
            origin_o = P.matmul(origin_w, model_inv[:3, :3].T) + model_inv[:3, 3]
            dir_o = P.matmul(dir_w, model_inv[:3, :3].T)

            hits = raycast_grouped(mesh, origin_o, dir_o, True)
            m = (hits.valid & val).reshape(-1)
            X = P.matmul(hits.pos.reshape(-1, 3), model[:3, :3].T) + model[:3, 3]
            weights = jnp.where(m, 1.0, 0.0)

            params = jnp.concatenate(
                [q_all[warm_i], t_all[warm_i], in_all[warm_i], const5]
            )  # the 16-float solve_arrays layout
            vec = solve_arrays(
                X, tgt.reshape(-1, 2), weights, m, params,
                opt_f=opt_f, opt_pp=opt_pp, opts=opts,
            )
            count = jnp.sum(m)
            ok = count >= 3
            q_new = jnp.where(ok, vec[0:4], q_all[tgt_i])
            t_new = jnp.where(ok, vec[4:7], t_all[tgt_i])
            in_new = jnp.where(ok, vec[7:11], in_all[tgt_i])
            q_all = q_all.at[tgt_i].set(q_new)
            t_all = t_all.at[tgt_i].set(t_new)
            in_all = in_all.at[tgt_i].set(in_new)
            return (q_all, t_all, in_all), (vec, count)

        carry, (vecs, counts) = jax.lax.scan(step, (q0, t0, in0), xs)
        return carry, vecs, counts

    _SCAN_TRACK_CACHE[key] = run
    return run


def _frame_groups(database: Database, frame_id: int, available):
    """Host half of the gather for one frame: flows into ``frame_id``
    from frames in ``available`` (cpp/tracker.cc:43-62), as
    (src_frame_id, src_kps_indices, tgt_px) triples — no pose math, so
    it can run before the sources are actually solved.  Keypoint pixels
    are NOT materialized here: the scan chain uploads each frame's
    keypoint table once and gathers by index on device."""
    groups = []
    for flow_frame_id in database.find_optical_flows_to_image(frame_id):
        if flow_frame_id == frame_id:
            raise TrackingError("self-flow in database")
        if flow_frame_id not in available:
            continue
        flow = database.read_image_pair_flow(flow_frame_id, frame_id)
        if flow.src_kps_indices.size == 0:
            continue
        groups.append(
            (flow_frame_id, flow.src_kps_indices, flow.tgt_kps)
        )
    return groups


def _build_native_packer(
    all_per_frame, first_abs, Gp, K, Kmax, idx_dtype, quant, kps_all
):
    """Fused C chunk packer (native/bvh.cc ``pack_track_chunk``).

    The per-chunk numpy pack is the tracking chain's host floor: ~256
    fancy-index gathers + slice writes + a per-frame quantization pass
    per 32-frame chunk.  This flattens every group's (idx, tgt) arrays
    into two contiguous buffers once per run, then packs each chunk
    with ONE C call producing bit-identical outputs to ``pack_chunk``
    (pinned by tests/test_native_pack.py).  Returns a ``pack(c)``
    closure, or None when the native library is unavailable.
    """
    import ctypes

    from ..native import native_fn

    i32 = ctypes.c_int32
    fn = native_fn(
        "pack_track_chunk", None, [i32] * 6 + [ctypes.c_void_p] * 11
    )
    if fn is None:
        return None

    CH = SCAN_CHUNK
    n_chunks = len(all_per_frame)
    idx_parts, tpx_parts = [], []
    g_src = np.zeros((n_chunks, CH, Gp), np.int32)
    g_n = np.zeros((n_chunks, CH, Gp), np.int32)
    g_off = np.zeros((n_chunks, CH, Gp), np.int64)
    tgt_i = np.zeros((n_chunks, CH), np.int32)
    warm_i = np.zeros((n_chunks, CH), np.int32)
    off = 0
    for c, per_frame in enumerate(all_per_frame):
        for r, (frame_id, warm, groups) in enumerate(per_frame):
            tgt_i[c, r] = frame_id - first_abs
            warm_i[c, r] = warm - first_abs
            for g, (src_f, idx, tpx) in enumerate(groups):
                g_src[c, r, g] = src_f - first_abs
                g_n[c, r, g] = idx.shape[0]
                g_off[c, r, g] = off
                idx_parts.append(np.ascontiguousarray(idx, np.uint32))
                tpx_parts.append(
                    np.ascontiguousarray(tpx, np.float32).reshape(-1, 2)
                )
                off += idx.shape[0]
        nf = len(per_frame)
        if nf:  # padding rows mirror pack_chunk's masked no-ops
            tgt_i[c, nf:] = tgt_i[c, nf - 1]
            warm_i[c, nf:] = warm_i[c, nf - 1]
    flat_idx = (
        np.concatenate(idx_parts)
        if idx_parts else np.empty((0,), np.uint32)
    )
    flat_tpx = (
        np.concatenate(tpx_parts)
        if tpx_parts else np.empty((0, 2), np.float32)
    )
    kps_all = np.ascontiguousarray(kps_all, np.float32)
    dt_code = {np.uint8: 0, np.uint16: 1, np.int32: 2}[idx_dtype]

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    def pack(c):
        meta = np.empty((CH, 2 * Gp + 3), np.int32)
        kp_idx = np.empty((CH, Gp, K), idx_dtype)
        tgt = np.empty(
            (CH, Gp, K, 2), np.int16 if quant else np.float32
        )
        fn(
            CH, Gp, K, Kmax, dt_code, 1 if quant else 0,
            ptr(tgt_i[c]), ptr(warm_i[c]), ptr(g_src[c]), ptr(g_n[c]),
            ptr(g_off[c]), ptr(flat_idx), ptr(flat_tpx), ptr(kps_all),
            ptr(meta), ptr(kp_idx), ptr(tgt),
        )
        return (meta, kp_idx, tgt)

    return pack


def _track_chunked_scan(
    database: Database,
    camera_traj: CameraTrajectory,
    frames,
    direction: int,
    model_matrix: np.ndarray,
    mesh: Mesh,
    callback: Optional[TrackingCallback],
    optimize_focal_length: bool,
    optimize_principal_point: bool,
    bundle_opts: BundleOptions,
) -> None:
    """Drive the device-resident chain over ``frames`` in chunks."""
    from .levmarq import BundleStats as _BS
    from .pnp import bucket_size, normalize_bundle_opts

    first_abs = camera_traj.first_frame
    F = camera_traj.count

    # Deterministic availability: initially-filled frames plus every
    # earlier frame of this run (they will be solved by the time the
    # scan reaches their dependents).
    available = {
        fid
        for fid in range(first_abs, first_abs + F)
        if camera_traj.is_frame_filled(fid)
    }

    cam_ref = camera_traj.get(frames[0] - direction)
    ci = jax.device_get(cam_ref.intrinsics)
    const5 = np.array(
        [
            float(ci.aspect_ratio), float(ci.width), float(ci.height),
            float(ci.sign), MAX_INLIER_ERROR,
        ],
        np.float32,
    )

    # Initial device carry from the host trajectory.
    q0 = np.zeros((F, 4), np.float32)
    q0[:, 0] = 1.0
    t0 = np.zeros((F, 3), np.float32)
    in0 = np.zeros((F, 4), np.float32)
    in0[:] = [float(ci.fx), float(ci.fy), float(ci.cx), float(ci.cy)]
    filled = sorted(available)
    filled_h = jax.device_get([camera_traj.get(fid) for fid in filled])
    for fid, c in zip(filled, filled_h):
        i = fid - first_abs
        q0[i] = np.asarray(c.pose.q)
        t0[i] = np.asarray(c.pose.t)
        in0[i] = [
            float(c.intrinsics.fx), float(c.intrinsics.fy),
            float(c.intrinsics.cx), float(c.intrinsics.cy),
        ]

    opts_key = tuple(normalize_bundle_opts(bundle_opts))
    run = _scan_track_fn(
        bool(optimize_focal_length), bool(optimize_principal_point),
        opts_key, packed_idx=PACKED_IDX,
        quant_tgt=PACKED_IDX and QUANT_TGT,
        fused_meta=PACKED_IDX and _FUSED_META,
    )

    # Gather the run's flow metadata in ONE query (per-pair point reads
    # cost ~17 sqlite round-trips per frame), then pipeline the chunk
    # dispatches: chunk c+1 is packed and dispatched before chunk c's
    # results are pulled, keeping the device busy across the link.
    flows_by_tgt = database.read_flows_to_image_range(
        first_abs, first_abs + F - 1
    )
    chunk_frames = [
        frames[i : i + SCAN_CHUNK] for i in range(0, len(frames), SCAN_CHUNK)
    ]
    all_per_frame = []
    for chunk in chunk_frames:
        per_frame = []
        for frame_id in chunk:
            groups = []
            for flow in flows_by_tgt.get(frame_id, ()):
                if flow.image_id_from == frame_id:
                    raise TrackingError("self-flow in database")
                if flow.image_id_from not in available:
                    continue
                if flow.src_kps_indices.size == 0:
                    continue
                groups.append(
                    (flow.image_id_from, flow.src_kps_indices, flow.tgt_kps)
                )
            # Warm-start preference order (cpp/tracker.cc:112-119).
            for cand in (frame_id, frame_id - 1, frame_id + 1):
                if cand in available:
                    warm = cand
                    break
            else:
                warm = frame_id - direction
            per_frame.append((frame_id, warm, groups))
            available.add(frame_id)
        all_per_frame.append(per_frame)
    # One compiled shape for the whole run: size the group/keypoint axes
    # over every chunk (each distinct shape is a fresh remote compile).
    G = max(
        [len(gs) for pf in all_per_frame for _, _, gs in pf] + [1]
    )
    Gp = -(-max(8, G) // 8) * 8
    K = bucket_size(
        max(
            [g[1].shape[0] for pf in all_per_frame
             for _, _, gs in pf for g in gs] + [1]
        )
    )

    # Clip-wide keypoint table, uploaded once: rows are only filled for
    # frames actually referenced as flow sources (others stay zero).
    src_frames = sorted(
        {src_f for pf in all_per_frame for _, _, gs in pf
         for src_f, _, _ in gs}
    )
    kps_range = database.read_keypoints_range(
        min(src_frames, default=0), max(src_frames, default=0)
    )
    kps_by_frame = {
        f: kps_range.get(f, np.empty((0, 2), np.float32))
        for f in src_frames
    }
    Kmax = bucket_size(
        max([k.shape[0] for k in kps_by_frame.values()] + [1])
    )
    kps_all = np.zeros((F, Kmax, 2), np.float32)
    for f, k in kps_by_frame.items():
        kps_all[f - first_abs, : k.shape[0]] = k
    # Smallest index dtype that holds Kmax-1 (the device gather casts to
    # i32 either way, so this only changes link bytes, not values).
    if Kmax <= 1 << 8:
        idx_dtype = np.uint8
    elif Kmax <= np.iinfo(np.uint16).max:
        idx_dtype = np.uint16
    else:
        idx_dtype = np.int32
    quant = PACKED_IDX and QUANT_TGT

    # Fused C packer for the default (packed + fused-meta) format;
    # POLYCHASE_NATIVE_PACK=0 or an unavailable toolchain falls back to
    # the numpy pack below (bit-identical outputs).
    pack_native = None
    if (
        PACKED_IDX and _FUSED_META
        and os.environ.get("POLYCHASE_NATIVE_PACK", "1") != "0"
    ):
        pack_native = _build_native_packer(
            all_per_frame, first_abs, Gp, K, Kmax, idx_dtype, quant,
            kps_all,
        )

    def pack_chunk(chunk, per_frame):
        CH = len(chunk)
        src_idx = np.zeros((SCAN_CHUNK, Gp), np.int32)
        tgt_px = np.zeros((SCAN_CHUNK, Gp, K, 2), np.float32)
        tgt_i = np.zeros((SCAN_CHUNK,), np.int32)
        warm_i = np.zeros((SCAN_CHUNK,), np.int32)
        if PACKED_IDX:
            kp_idx = np.zeros((SCAN_CHUNK, Gp, K), idx_dtype)
            cnt = np.zeros((SCAN_CHUNK, Gp), np.int32)
        else:
            kp_px = np.zeros((SCAN_CHUNK, Gp, K, 2), np.float32)
            val = np.zeros((SCAN_CHUNK, Gp, K), bool)
        if quant:
            tgt_q = np.zeros((SCAN_CHUNK, Gp, K, 2), np.int16)
            qs = np.ones((SCAN_CHUNK,), np.float32)
        for r, (frame_id, warm, groups) in enumerate(per_frame):
            tgt_i[r] = frame_id - first_abs
            warm_i[r] = warm - first_abs
            for g, (src_f, idx, tpx) in enumerate(groups):
                n = idx.shape[0]
                src_idx[r, g] = src_f - first_abs
                if quant:
                    # Store the delta vs the device keypoint table; the
                    # scan reconstructs tgt = kp + delta_q * scale.
                    tgt_px[r, g, :n] = tpx - kps_by_frame[src_f][idx]
                else:
                    tgt_px[r, g, :n] = tpx
                if PACKED_IDX:
                    kp_idx[r, g, :n] = idx
                    cnt[r, g] = n
                else:
                    kp_px[r, g, :n] = kps_by_frame[src_f][idx]
                    val[r, g, :n] = True
            if quant:
                m = float(np.abs(tgt_px[r]).max())
                scale = (m / 32700.0) if m > 0.0 else 1.0
                qs[r] = scale
                np.rint(tgt_px[r] * (1.0 / scale), out=tgt_px[r])
                tgt_q[r] = tgt_px[r]
        for r in range(CH, SCAN_CHUNK):  # padding rows: masked no-ops
            tgt_i[r] = tgt_i[CH - 1]
            warm_i[r] = warm_i[CH - 1]
        if PACKED_IDX and _FUSED_META:
            meta = np.empty((SCAN_CHUNK, 2 * Gp + 3), np.int32)
            meta[:, :Gp] = src_idx
            meta[:, Gp : 2 * Gp] = cnt
            meta[:, 2 * Gp] = tgt_i
            meta[:, 2 * Gp + 1] = warm_i
            if quant:
                meta[:, 2 * Gp + 2] = qs.view(np.int32)
                return (meta, kp_idx, tgt_q)
            meta[:, 2 * Gp + 2] = 0
            return (meta, kp_idx, tgt_px)
        if quant:
            return (src_idx, kp_idx, cnt, tgt_q, qs, tgt_i, warm_i)
        elif PACKED_IDX:
            return (src_idx, kp_idx, cnt, tgt_px, tgt_i, warm_i)
        else:
            return (src_idx, kp_px, tgt_px, val, tgt_i, warm_i)

    if not PACKED_IDX:
        kps_all = np.zeros((1, 1, 2), np.float32)  # unused dummy
    kps_all_d = jnp.asarray(kps_all)

    model = jnp.asarray(np.asarray(model_matrix, np.float32))
    model_inv = jnp.asarray(
        np.linalg.inv(np.asarray(model_matrix, np.float64)).astype(
            np.float32
        )
    )
    carry = (jnp.asarray(q0), jnp.asarray(t0), jnp.asarray(in0))
    const5_j = jnp.asarray(const5)

    pending = []  # (chunk_frames, vecs, counts) with async copies running

    def flush_one() -> bool:
        chunk, vecs_d, counts_d = pending.pop(0)
        vecs, counts = jax.device_get((vecs_d, counts_d))
        for r, frame_id in enumerate(chunk):
            vec, count = vecs[r], int(counts[r])
            if count < 3:
                _log.info(
                    "frame %d: only %d correspondences, cannot solve",
                    frame_id, count,
                )
                raise TrackingError(
                    f"Could not track to frame: {frame_id}. "
                    "Not enough features."
                )
            intr_out = C.Intrinsics(
                fx=np.float32(vec[7]), fy=np.float32(vec[8]),
                cx=np.float32(vec[9]), cy=np.float32(vec[10]),
                aspect_ratio=ci.aspect_ratio, width=ci.width,
                height=ci.height, sign=ci.sign,
            )
            camera = C.CameraState(
                intr_out, P.Pose(vec[0:4].copy(), vec[4:7].copy())
            )
            stats = _BS(
                iterations=np.int32(vec[11]),
                initial_cost=np.float32(vec[12]),
                cost=np.float32(vec[13]), lambda_=np.float32(vec[14]),
                invalid_steps=np.int32(vec[15]),
                step_norm=np.float32(vec[16]),
                grad_norm=np.float32(vec[17]),
            )
            if callback is not None:
                ok = callback(
                    FrameTrackingResult(
                        frame=frame_id,
                        pose=camera.pose,
                        intrinsics=camera.intrinsics,
                        bundle_stats=stats,
                        inlier_ratio=float(vec[18]),
                    )
                )
                if not ok:
                    return False
            camera_traj.set(frame_id, camera)
        return True

    # How many chunks may be in flight before blocking on results.  A
    # flush is a device_get whose async copy typically started only a
    # few ms earlier, so every flush can expose most of a round trip.
    # The carry rides on device — no chunk needs the previous chunk's
    # RESULTS on the host — so without a callback every chunk is
    # dispatched back-to-back and the drain pays the latency ONCE.  With
    # a callback, one chunk in flight keeps the reference's streaming
    # progress/cancel semantics (cpp/tracker_thread.h:62-84).
    max_inflight = len(chunk_frames) if callback is None else 1

    with profile_region("tracker.scan_chain"):
        # Chunks are packed lazily: chunk c+1's host packing runs while
        # chunk c (dispatched below) is still computing on device.
        for ci_chunk, (chunk, per_frame) in enumerate(
            zip(chunk_frames, all_per_frame)
        ):
            # numpy args go straight into the jit dispatch: the runtime
            # batches the host->device transfers in one C++ call, which
            # measures faster than per-array device_puts from Python.
            xs = (
                pack_native(ci_chunk)
                if pack_native is not None
                else pack_chunk(chunk, per_frame)
            )
            carry, vecs, counts = run(
                mesh, model, model_inv, *carry, const5_j, kps_all_d, xs
            )
            for arr in (vecs, counts):
                try:
                    arr.copy_to_host_async()
                except Exception:  # pragma: no cover
                    pass
            pending.append((chunk, vecs, counts))
            while len(pending) > max_inflight:
                if not flush_one():
                    return
        if callback is None and len(pending) > 1:
            # Deferred drain: ONE batched device_get for every chunk
            # still in flight instead of one blocking fetch per chunk.
            got = jax.device_get([(v, c) for _, v, c in pending])
            pending[:] = [
                (chunk, v, c)
                for (chunk, _, _), (v, c) in zip(pending, got)
            ]
        while pending:
            if not flush_one():
                return


def track_camera_trajectory(
    database: Database,
    camera_traj: CameraTrajectory,
    frame_from: int,
    frame_to_inclusive: int,
    model_matrix: np.ndarray,
    mesh: Mesh,
    callback: Optional[TrackingCallback] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
) -> None:
    """Chain solves frame by frame (cpp/tracker.cc:133-192).

    The callback may return False to stop; solved poses are written into
    ``camera_traj`` as they are produced.  Segments of 4+ frames run the
    device-resident scan chain (one dispatch per SCAN_CHUNK frames);
    shorter runs and ``POLYCHASE_SCAN_TRACK=0`` use the per-frame path.

    Pipelined-callback timing note: on the scan path, chunk c's
    callbacks fire only after chunk c+1 has already been dispatched, so
    a cancelling callback wastes up to one chunk of device work and
    callbacks observe batched rather than strictly per-frame timing
    (cancel/commit semantics are identical and parity-tested).
    """
    import os as _os

    first = min(frame_from, frame_to_inclusive)
    last = max(frame_from, frame_to_inclusive)
    direction = 1 if frame_from < frame_to_inclusive else -1

    if not camera_traj.is_valid_frame(first) or not camera_traj.is_valid_frame(
        last
    ):
        raise TrackingError("tracking range outside trajectory")
    if not camera_traj.is_frame_filled(frame_from):
        raise TrackingError("start frame has no pose")

    frames = list(
        range(frame_from + direction, frame_to_inclusive + direction,
              direction)
    )

    # Termination aid: the reference's LM (f32 like ours,
    # cpp/pnp/lev_marq.h:146-227) exits converged solves through a
    # λ-doubling rejection tail — free on CPU, ~7-9 extra while_loop
    # iterations per warm-started frame on device.  Enable the
    # Ceres-style relative function tolerance on accepted steps unless
    # the caller set one.  Measured (CPU, synthetic configs): 1e-5 cuts
    # total LM iterations 537→249 on config 3 and 797→241 on the masked
    # varintr config with pose/focal deltas ≤0.05% of the solves' own
    # error; the noisy-flow demo's errors are unchanged.  Applied here
    # (not in the per-path helpers) so the scan chain and the per-frame
    # fallback keep identical semantics.  POLYCHASE_TRACK_FTOL
    # overrides; 0 disables (exact reference termination).
    if getattr(bundle_opts, "function_tol", 0.0) == 0.0:
        _ftol = float(_os.environ.get("POLYCHASE_TRACK_FTOL", "1e-5"))
        if _ftol > 0.0:
            bundle_opts = bundle_opts._replace(function_tol=_ftol)

    if (
        len(frames) >= 4
        and _os.environ.get("POLYCHASE_SCAN_TRACK", "1") != "0"
    ):
        _track_chunked_scan(
            database, camera_traj, frames, direction, model_matrix, mesh,
            callback, optimize_focal_length, optimize_principal_point,
            bundle_opts,
        )
        return

    for frame_id in frames:
        result = solve_frame(
            database, camera_traj, model_matrix, frame_id, mesh,
            optimize_focal_length, optimize_principal_point, bundle_opts,
        )
        if result is None:
            raise TrackingError(
                f"Could not track to frame: {frame_id}. Not enough features."
            )

        if callback is not None:
            ok = callback(
                FrameTrackingResult(
                    frame=frame_id,
                    pose=result.camera.pose,
                    intrinsics=result.camera.intrinsics,
                    bundle_stats=result.stats,
                    inlier_ratio=float(result.inlier_ratio),
                )
            )
            if not ok:
                return

        camera_traj.set(frame_id, result.camera)


def track_sequence(
    database_path: str,
    frame_from: int,
    frame_to_inclusive: int,
    scene_transform: SceneTransformations,
    mesh: Mesh,
    callback: Optional[TrackingCallback] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
) -> None:
    """Seed a trajectory from the scene transform and track
    (cpp/tracker.cc:194-213)."""
    db = Database(database_path)
    try:
        num_frames = abs(frame_to_inclusive - frame_from) + 1
        traj = CameraTrajectory(
            min(frame_from, frame_to_inclusive), num_frames
        )
        traj.set(
            frame_from,
            C.CameraState(
                scene_transform.intrinsics,
                P.pose_from_rt(jnp.asarray(scene_transform.view_matrix)),
            ),
        )
        track_camera_trajectory(
            db, traj, frame_from, frame_to_inclusive,
            np.asarray(scene_transform.model_matrix), mesh, callback,
            optimize_focal_length, optimize_principal_point, bundle_opts,
        )
    finally:
        db.close()
