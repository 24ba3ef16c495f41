"""Trajectory refinement: global bundle adjustment over a frame segment.

Rebuild of the reference refiner (cpp/refiner.{h,cc} +
cpp/pnp/lev_marq.h:391-871).  The reference walks flow edges with TBB
threads, evaluates per-residual Jacobians one keypoint at a time, and
scatters into an Eigen block-sparse matrix with atomics.  Here the whole
problem is arrays:

- all (edge, match) residuals and their analytic Jacobian chains
  (unproject → center/derotate → ray-plane intersect → apply → project,
  cpp/refiner.cc:363-506) are evaluated in one batched program;
- JᵀJ is assembled **dense** — a segment has at most a few hundred
  frames, so P = 6..9·F stays small enough for a dense (or banded)
  damped Cholesky on the device;
- the per-(frame, keypoint) intersection cache
  (cpp/refiner.cc:320-349) becomes a prim-id array refreshed by a single
  batched ray-cast sweep at the start and after every accepted step;
  between refreshes the cached triangle is intersected analytically
  (bounded for cost validity, plane-only for Jacobians — exactly the
  reference's local-plane treatment);
- first/last frames are ground-truth anchors: their Jacobians are zeroed
  and their parameters never stepped (cpp/refiner.cc:269-272,611-646);
- edge weight = 1/(1 + distance of the source frame from the nearer
  segment end) and per-edge cost normalization (``kShouldNormalize``)
  match cpp/refiner.cc:250-257 and cpp/pnp/lev_marq.h:705-710.

The LM schedule has two equivalent drivers: a host loop (one dispatch +
a 5-scalar transfer per iteration — used for the host-BVH and sharded
paths) and a device-resident chunk program (``lm_chunk_device``, the
default on a single device) that runs several complete LM iterations
per dispatch and returns a stat matrix the host replays, preserving the
reference's per-iteration progress callback and cancellation semantics
(cpp/refiner.cc:670-678).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.database import Database
from ..obs import get_logger, profile_region
from . import camera as C
from . import pose as P
from .geometry import Mesh, Bbox3
from .levmarq import (
    BundleOptions,
    BundleStats,
    damped_block_tridiag_solve,
    damped_cholesky_solve,
    loss_value,
    loss_weight,
)
from .raycast import (
    intersect_ray_plane_jac,
    intersect_ray_triangle,
    raycast_grouped,
)
from .trajectory import CameraTrajectory

_INVALID = np.int32(-1)
_log = get_logger("refiner")
_HI = jax.lax.Precision.HIGHEST


class RefineTrajectoryUpdate(NamedTuple):
    """Progress message (cpp/refiner.h:13-20)."""

    progress: float
    message: str
    stats: Optional[BundleStats]


RefineTrajectoryCallback = Callable[[RefineTrajectoryUpdate], bool]


# ---------------------------------------------------------------------------
# Problem data (host-side packing)
# ---------------------------------------------------------------------------


class TrajParams(NamedTuple):
    """Per-frame camera parameters as stacked arrays (the BA unknowns)."""

    q: jax.Array   # (F, 4)
    t: jax.Array   # (F, 3)
    fx: jax.Array  # (F,)
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array


class RefinerData(NamedTuple):
    """Padded, device-resident problem description."""

    # keypoints
    kps: jax.Array        # (F, K, 2) filtered source keypoints
    kp_valid: jax.Array   # (F, K) bool
    # flow edges
    src_frame: jax.Array  # (E,) int32 frame *index* (0-based)
    tgt_frame: jax.Array  # (E,) int32
    src_kp: jax.Array     # (E, M) int32 index into kps[src_frame]
    tgt_px: jax.Array     # (E, M, 2)
    match_valid: jax.Array  # (E, M) bool
    edge_weight: jax.Array  # (E,)
    edge_valid: jax.Array   # (E,) bool
    # constants
    anchor: jax.Array     # (F,) bool — ground-truth frames
    aspect: jax.Array     # () aspect ratio (shared)
    conv_sign: jax.Array  # () +1 OpenCV / -1 OpenGL


def _round_up(n, m):
    return ((max(n, 1) + m - 1) // m) * m


def _compute_bbox(state: C.CameraState, mesh_bbox_h, model_matrix) -> tuple:
    """Image-space mesh bbox + 20px pad (cpp/refiner.cc:53-69).

    Pure host numpy on pre-fetched values: this runs once per frame while
    packing the problem, and eager device ops would cost a round trip
    each.  ``state`` and ``mesh_bbox_h`` must already be host arrays.
    """
    mvp = (
        C.proj_matrix_4x4_np(state.intrinsics)
        @ P.pose_rt4x4_np(state.pose)
        @ np.asarray(model_matrix, np.float64)
    )
    lo = np.asarray(mesh_bbox_h[0], np.float64)
    hi = np.asarray(mesh_bbox_h[1], np.float64)
    corners = np.array(
        [
            [x, y, z]
            for x in (lo[0], hi[0])
            for y in (lo[1], hi[1])
            for z in (lo[2], hi[2])
        ]
    )
    hom = np.concatenate([corners, np.ones((8, 1))], axis=-1) @ mvp.T
    xy = hom[:, :2] / hom[:, 3:4]
    pad = 20.0
    return xy.min(axis=0) - pad, xy.max(axis=0) + pad


def build_refiner_data(
    database: Database,
    traj: CameraTrajectory,
    mesh: Mesh,
    model_matrix: np.ndarray,
) -> RefinerData:
    """Load + filter the database into padded arrays
    (the CachedDatabase equivalent, cpp/refiner.cc:71-197)."""
    first, last = traj.first_frame, traj.last_frame
    F = traj.count

    # One batched transfer for every frame's camera state: per-frame
    # device_get inside _compute_bbox would pay a device round trip per
    # frame.
    states_h = jax.device_get(
        [traj.get(fid) for fid in range(first, last + 1)]
    )
    mesh_bbox_h = jax.device_get((mesh.bbox.pmin, mesh.bbox.pmax))

    kps_list, remaps = [], []
    for frame_id in range(first, last + 1):
        kps = database.read_keypoints(frame_id)
        state = states_h[frame_id - first]
        pmin, pmax = _compute_bbox(state, mesh_bbox_h, model_matrix)
        inside = (
            (kps[:, 0] > pmin[0]) & (kps[:, 0] < pmax[0])
            & (kps[:, 1] > pmin[1]) & (kps[:, 1] < pmax[1])
        )
        remap = np.full(len(kps), -1, np.int64)
        remap[inside] = np.arange(int(inside.sum()))
        kps_list.append(kps[inside])
        remaps.append(remap)

    K = _round_up(max((len(k) for k in kps_list), default=1), 64)
    kps_arr = np.zeros((F, K, 2), np.float32)
    kp_valid = np.zeros((F, K), bool)
    for i, k in enumerate(kps_list):
        kps_arr[i, : len(k)] = k
        kp_valid[i, : len(k)] = True

    edges = []
    for frame_id in range(first, last + 1):
        for tgt_id in database.find_optical_flows_from_image(frame_id):
            if not (first <= tgt_id <= last):
                continue
            flow = database.read_image_pair_flow(frame_id, tgt_id)
            if flow.src_kps_indices.size == 0:
                continue
            remap = remaps[frame_id - first]
            new_idx = remap[flow.src_kps_indices]
            keep = new_idx >= 0
            if not keep.any():
                continue
            edges.append(
                (
                    frame_id - first,
                    tgt_id - first,
                    new_idx[keep].astype(np.int32),
                    flow.tgt_kps[keep],
                )
            )

    E = _round_up(len(edges), 8)
    M = _round_up(max((len(e[2]) for e in edges), default=1), 64)
    src_frame = np.zeros(E, np.int32)
    tgt_frame = np.zeros(E, np.int32)
    src_kp = np.zeros((E, M), np.int32)
    tgt_px = np.zeros((E, M, 2), np.float32)
    match_valid = np.zeros((E, M), bool)
    edge_weight = np.zeros(E, np.float32)
    edge_valid = np.zeros(E, bool)

    for i, (sf, tf, idx, px) in enumerate(edges):
        src_frame[i] = sf
        tgt_frame[i] = tf
        src_kp[i, : len(idx)] = idx
        tgt_px[i, : len(idx)] = px
        match_valid[i, : len(idx)] = True
        # FrameWeight of the source frame (cpp/refiner.cc:250-257,596-599)
        distance = min(sf, (F - 1) - sf)
        edge_weight[i] = 1.0 / (distance + 1.0)
        edge_valid[i] = True

    anchor = np.zeros(F, bool)
    anchor[0] = anchor[F - 1] = True

    intr0 = traj.get(first).intrinsics
    return RefinerData(
        kps=jnp.asarray(kps_arr),
        kp_valid=jnp.asarray(kp_valid),
        src_frame=jnp.asarray(src_frame),
        tgt_frame=jnp.asarray(tgt_frame),
        src_kp=jnp.asarray(src_kp),
        tgt_px=jnp.asarray(tgt_px),
        match_valid=jnp.asarray(match_valid),
        edge_weight=jnp.asarray(edge_weight),
        edge_valid=jnp.asarray(edge_valid),
        anchor=jnp.asarray(anchor),
        aspect=jnp.asarray(intr0.aspect_ratio, jnp.float32),
        conv_sign=jnp.asarray(intr0.sign, jnp.float32),
    )


def traj_to_params(traj: CameraTrajectory) -> TrajParams:
    # One batched host gather — per-frame np.asarray would pay a device
    # round trip per leaf when poses are device arrays.
    states = [
        traj.get(fid)
        for fid in range(traj.first_frame, traj.last_frame + 1)
    ]
    states = jax.device_get(states)
    return TrajParams(
        q=jnp.asarray(
            np.stack([np.asarray(s.pose.q) for s in states]), jnp.float32
        ),
        t=jnp.asarray(
            np.stack([np.asarray(s.pose.t) for s in states]), jnp.float32
        ),
        fx=jnp.asarray([float(s.intrinsics.fx) for s in states], jnp.float32),
        fy=jnp.asarray([float(s.intrinsics.fy) for s in states], jnp.float32),
        cx=jnp.asarray([float(s.intrinsics.cx) for s in states], jnp.float32),
        cy=jnp.asarray([float(s.intrinsics.cy) for s in states], jnp.float32),
    )


def params_to_traj(
    params: TrajParams, traj: CameraTrajectory
) -> CameraTrajectory:
    """Write params back into a copy of ``traj`` (intrinsics metadata such
    as width/height/aspect are preserved per frame)."""
    out = CameraTrajectory(traj.first_frame, traj.count)
    q, t, fx, fy, cx, cy = jax.device_get(
        (params.q, params.t, params.fx, params.fy, params.cx, params.cy)
    )
    # Keep the written-back states HOST numpy: one jnp conversion per
    # field per frame costs a device_put each, and every consumer accepts
    # numpy.
    for i, fid in enumerate(range(traj.first_frame, traj.last_frame + 1)):
        old = traj.get(fid)
        intr = old.intrinsics._replace(
            fx=np.float32(fx[i]), fy=np.float32(fy[i]),
            cx=np.float32(cx[i]), cy=np.float32(cy[i]),
        )
        out.set(
            fid,
            C.CameraState(intr, P.Pose(q[i], t[i])),
        )
    return out


# ---------------------------------------------------------------------------
# Device programs
# ---------------------------------------------------------------------------


def _frame_intrinsics(params: TrajParams, data: RefinerData, idx):
    """Gather per-edge Intrinsics pytree for frame indices ``idx``."""
    zeros = jnp.zeros_like(params.fx[idx])
    return C.Intrinsics(
        fx=params.fx[idx], fy=params.fy[idx],
        cx=params.cx[idx], cy=params.cy[idx],
        aspect_ratio=data.aspect + zeros,
        width=zeros, height=zeros,  # unused in project/unproject
        sign=data.conv_sign + zeros,
    )


def _all_rays(params: TrajParams, data: RefinerData, model_inv):
    """Object-space rays for every (frame, keypoint): origins (F, 1, 3)
    broadcast, dirs (F, K, 3) (cpp/refiner.cc:307-318)."""
    F, K = data.kps.shape[:2]
    fidx = jnp.arange(F)
    intr = _frame_intrinsics(params, data, fidx)
    intr_b = jax.tree.map(lambda a: a[:, None], intr)
    dir_cam = C.unproject(intr_b, data.kps)  # (F, K, 3)
    origin_w = P.pose_center(P.Pose(params.q, params.t))  # (F, 3)
    dir_world = P.quat_rotate(
        P.quat_conj(params.q)[:, None, :], dir_cam
    )  # (F, K, 3)
    origin_o = (
        P.matmul(origin_w, model_inv[:3, :3].T) + model_inv[:3, 3]
    )  # (F, 3)
    dir_o = P.matmul(dir_world, model_inv[:3, :3].T)
    return origin_o, dir_o


_all_rays_jit = jax.jit(_all_rays)

# Triangle count above which the prim refresh casts on the host BVH
# instead of the fused device sweep.  Not measured on the GPU
# (benchmarks/bench_raycast_grid.py compares brute sweep, grid DDA and
# host BVH; engine/gridcast.py is benchmark-only).
BVH_TRIANGLE_THRESHOLD = 131072


def _refresh_routing(mesh: Mesh):
    """The prim-refresh backend decision, shared by the refresher factory
    and refine_trajectory's LM-driver selection: host C++ BVH above the
    measured BVH_TRIANGLE_THRESHOLD crossover, else the fused device
    brute sweep.
    """
    use_bvh = False
    if mesh.num_triangles >= BVH_TRIANGLE_THRESHOLD:
        try:
            from .. import native

            use_bvh = native.available()
        except Exception:  # pragma: no cover
            use_bvh = False
    return use_bvh


def _make_prim_refresher(data: RefinerData, mesh: Mesh, model, model_inv,
                         tri_corners, loss_scale, loss_type: int,
                         device_mesh=None,
                         routing=None):
    """Choose the prim-cache refresh path by measured crossover.

    Default is the fused single-dispatch device sweep (raycast + cost in
    one program, zero transfers); above BVH_TRIANGLE_THRESHOLD the rays
    are pulled to the host and cast through the native C++ BVH — the
    reference's Embree role (cpp/ray_casting.cc:21-121).
    """
    if routing is None:
        routing = _refresh_routing(mesh)
    use_bvh = routing

    if not use_bvh:

        if device_mesh is not None:
            # Multi-chip: shard the F·K-ray sweep over the mesh — the
            # raycast is the refresh's dominant cost and embarrassingly
            # parallel over rays (SURVEY §2.4).
            from ..parallel.raycast import sharded_raycast_flat

            F, K = data.kps.shape[:2]

            def refresh(params):
                origin_o, dir_o = _all_rays_jit(params, data, model_inv)
                o_flat = jnp.broadcast_to(
                    origin_o[:, None, :], (F, K, 3)
                ).reshape(-1, 3)
                hits = sharded_raycast_flat(
                    device_mesh, mesh, o_flat, dir_o.reshape(-1, 3),
                    check_mask=True,
                )
                prims = jnp.where(
                    hits.valid.reshape(F, K) & data.kp_valid,
                    hits.prim_id.reshape(F, K).astype(jnp.int32),
                    _INVALID,
                )
                cost = total_cost(
                    params, data, prims, tri_corners, model, model_inv,
                    loss_scale, loss_type=loss_type,
                )
                return prims, cost

            return refresh

        def refresh(params):
            return refresh_prims_and_cost(
                params, data, mesh, model, model_inv, tri_corners,
                loss_scale, loss_type=loss_type,
            )

        return refresh

    from .. import native
    from .raycast import INVALID_ID

    bvh = native.BvhRaycaster(
        np.asarray(mesh.vertices), np.asarray(mesh.triangles)
    )
    masked_bits = np.asarray(mesh.masked_triangles)
    if not masked_bits.any():
        masked_bits = None
    kp_valid = np.asarray(data.kp_valid)
    F, K = kp_valid.shape

    def refresh(params):
        origin_o, dir_o = jax.device_get(
            _all_rays_jit(params, data, model_inv)
        )
        o_flat = np.ascontiguousarray(
            np.broadcast_to(origin_o[:, None, :], (F, K, 3)).reshape(-1, 3)
        )
        _, _, _, _, prim = bvh.raycast(
            o_flat, np.ascontiguousarray(dir_o.reshape(-1, 3)), masked_bits
        )
        prim = prim.reshape(F, K)
        valid = (prim != np.uint32(INVALID_ID)) & kp_valid
        prims = jnp.asarray(
            np.where(valid, prim.astype(np.int32), _INVALID)
        )
        cost = total_cost(
            params, data, prims, tri_corners, model, model_inv,
            loss_scale, loss_type=loss_type,
        )
        return prims, cost

    return refresh


@partial(jax.jit, static_argnames=())
def refresh_prims(
    params: TrajParams, data: RefinerData, mesh: Mesh, model_inv,
) -> jax.Array:
    """Batched ray-cast of every (frame, keypoint) ray → prim ids (F, K).

    The device equivalent of the reference's lazily-filled intersection
    cache (cpp/refiner.cc:320-349): one masked brute-force sweep instead
    of per-miss Embree queries (the host BVH handles meshes above
    BVH_TRIANGLE_THRESHOLD — see _make_prim_refresher).
    """
    F, K = data.kps.shape[:2]
    origin_o, dir_o = _all_rays(params, data, model_inv)
    hits = raycast_grouped(mesh, origin_o, dir_o, check_mask=True)
    prim = jnp.where(
        hits.valid & data.kp_valid,
        hits.prim_id.astype(jnp.int32),
        _INVALID,
    )
    return prim


def _edge_eval(
    params: TrajParams,
    data: RefinerData,
    prims: jax.Array,
    tri_corners,          # (p1, p2, p3) each (T, 3) object space
    model,                # (4, 4)
    model_inv,
    with_jac: bool,
    opt_f: bool,
    opt_pp: bool,
):
    """Evaluate all (edge, match) residuals (+ Jacobians).

    Returns res (E, M, 2), valid (E, M), and if ``with_jac`` also
    J_src/J_tgt (E, M, 2, 9).  Follows cpp/refiner.cc:274-506.
    """
    E, M = data.src_kp.shape
    sf, tf = data.src_frame, data.tgt_frame

    src_q = params.q[sf]            # (E, 4)
    src_t = params.t[sf]
    tgt_q = params.q[tf]
    tgt_t = params.t[tf]
    src_intr = _frame_intrinsics(params, data, sf)
    tgt_intr = _frame_intrinsics(params, data, tf)
    src_intr_b = jax.tree.map(lambda a: a[:, None], src_intr)
    tgt_intr_b = jax.tree.map(lambda a: a[:, None], tgt_intr)

    src_px = jnp.take_along_axis(
        data.kps[sf], data.src_kp[..., None], axis=1
    )  # (E, M, 2)
    prim = jnp.take_along_axis(prims[sf], data.src_kp, axis=1)  # (E, M)
    prim_ok = prim != _INVALID
    safe_prim = jnp.where(prim_ok, prim, 0)

    # Ray in world space (cpp/refiner.cc:307-312, 398-417)
    R_src = P.quat_to_mat(src_q)            # (E, 3, 3)
    dir_cam, dDirCam_dp, dDirCam_dInt = C.unproject_with_jac(
        src_intr_b, src_px
    )  # (E, M, 3), ..., (E, M, 3, 3)
    origin, dOrigin_dR, dOrigin_dt = P.center_with_jac(R_src, src_t)
    # derotate (Rᵀ d) per match
    Rt_src = jnp.swapaxes(R_src, -1, -2)
    dir_world = jnp.einsum(
        "eij,emj->emi", Rt_src, dir_cam, precision=_HI
    )
    dDirWorld_dDirCam = Rt_src                      # (E, 3, 3)
    dDirWorld_dR = P.skew(dir_world)                # (E, M, 3, 3)

    # Cached triangle in world space (cpp/refiner.cc:419-428)
    p1o, p2o, p3o = tri_corners
    t1 = p1o[safe_prim]  # (E, M, 3)
    t2 = p2o[safe_prim]
    t3 = p3o[safe_prim]
    t1w = P.matmul(t1, model[:3, :3].T) + model[:3, 3]
    normal_o = jnp.cross(t2 - t1, t3 - t1)
    # normal transforms with the inverse-transpose
    normal_w = P.matmul(normal_o, model_inv[:3, :3])

    origin_b = jnp.broadcast_to(origin[:, None, :], dir_world.shape)
    X, dX_dOrigin, dX_dDir, isect_ok = intersect_ray_plane_jac(
        origin_b, dir_world, t1w, normal_w
    )

    # Target camera (cpp/refiner.cc:438-454)
    R_tgt = P.quat_to_mat(tgt_q)
    R_tgt_b = jnp.broadcast_to(R_tgt[:, None], (*X.shape[:2], 3, 3))
    XCam, dXCam_dX, dXCam_dR, _ = P.apply_with_jac(
        R_tgt_b, jnp.broadcast_to(tgt_t[:, None, :], X.shape), X
    )
    behind = C.is_behind(tgt_intr_b, XCam)
    p, dp_dXCam, dp_dInt = C.project_with_jac(tgt_intr_b, XCam)
    res = p - data.tgt_px

    valid = data.match_valid & prim_ok & isect_ok & ~behind

    if not with_jac:
        # Cost validity additionally requires the ray to still hit the
        # *bounded* cached triangle (cpp/refiner.cc:326-333).
        _, tri_ok = intersect_ray_triangle(origin_b, dir_world, t1, t2, t3)
        valid = valid & tri_ok
        return res, valid, None, None

    dp_dX = jnp.einsum("emij,emjk->emik", dp_dXCam, dXCam_dX, precision=_HI)

    # Source block (cpp/refiner.cc:460-480)
    dX_dR = jnp.einsum(
        "emij,ejk->emik", dX_dOrigin, dOrigin_dR, precision=_HI
    ) + jnp.einsum("emij,emjk->emik", dX_dDir, dDirWorld_dR, precision=_HI)
    Js_rot = jnp.einsum("emij,emjk->emik", dp_dX, dX_dR, precision=_HI)
    Js_t = jnp.einsum(
        "emij,emjk,ekl->emil", dp_dX, dX_dOrigin,
        dOrigin_dt, precision=_HI,
    )
    Js_int = jnp.einsum(
        "emij,emjk,ekl,emln->emin",
        dp_dX, dX_dDir, dDirWorld_dDirCam, dDirCam_dInt, precision=_HI,
    )

    # Target block (cpp/refiner.cc:484-502)
    Jt_rot = jnp.einsum("emij,emjk->emik", dp_dXCam, dXCam_dR, precision=_HI)
    Jt_t = dp_dXCam
    Jt_int = dp_dInt

    if not opt_f:
        Js_int = Js_int.at[..., 0].set(0.0)
        Jt_int = Jt_int.at[..., 0].set(0.0)
    if not opt_pp:
        Js_int = Js_int.at[..., 1:].set(0.0)
        Jt_int = Jt_int.at[..., 1:].set(0.0)
    if not (opt_f or opt_pp):
        Js_int = jnp.zeros_like(Js_int)
        Jt_int = jnp.zeros_like(Jt_int)

    J_src = jnp.concatenate([Js_rot, Js_t, Js_int], axis=-1)  # (E, M, 2, 9)
    J_tgt = jnp.concatenate([Jt_rot, Jt_t, Jt_int], axis=-1)

    # Anchor frames contribute no Jacobian (cpp/refiner.cc:611-612)
    J_src = jnp.where(data.anchor[sf][:, None, None, None], 0.0, J_src)
    J_tgt = jnp.where(data.anchor[tf][:, None, None, None], 0.0, J_tgt)

    return res, valid, J_src, J_tgt


@partial(jax.jit, static_argnames=("loss_type",))
def refresh_prims_and_cost(
    params, data: RefinerData, mesh: Mesh, model, model_inv,
    tri_corners, loss_scale, *, loss_type: int,
):
    """Fused accepted-step update: one dispatch for the prim-cache sweep
    and the post-refresh cost (the host loop otherwise pays two device
    round-trips per accepted LM step)."""
    prims = refresh_prims(params, data, mesh, model_inv)
    cost = total_cost(
        params, data, prims, tri_corners, model, model_inv, loss_scale,
        loss_type=loss_type,
    )
    return prims, cost


@partial(jax.jit, static_argnames=("loss_type",))
def total_cost(
    params, data: RefinerData, prims, tri_corners, model, model_inv,
    loss_scale, *, loss_type: int,
):
    """Per-edge-normalized robust cost (cpp/pnp/lev_marq.h:773-824)."""
    res, valid, _, _ = _edge_eval(
        params, data, prims, tri_corners, model, model_inv,
        with_jac=False, opt_f=False, opt_pp=False,
    )
    r2 = jnp.sum(res * res, axis=-1)
    cost_m = jnp.where(valid, loss_value(loss_type, loss_scale, r2), 0.0)
    n_valid = jnp.maximum(jnp.sum(valid, axis=-1), 1)
    edge_cost = jnp.sum(cost_m, axis=-1) / n_valid
    return jnp.sum(
        jnp.where(data.edge_valid, data.edge_weight * edge_cost, 0.0)
    )


@partial(jax.jit, static_argnames=("loss_type", "opt_f", "opt_pp", "ppc"))
def build_normal_equations(
    params, data: RefinerData, prims, tri_corners, model, model_inv,
    loss_scale, *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int,
):
    """Dense JᵀJ (P, P) + Jᵀr (P,) over all edges
    (cpp/pnp/lev_marq.h:653-771)."""
    res, valid, J_src, J_tgt = _edge_eval(
        params, data, prims, tri_corners, model, model_inv,
        with_jac=True, opt_f=opt_f, opt_pp=opt_pp,
    )
    F = params.q.shape[0]
    E, M = valid.shape
    r2 = jnp.sum(res * res, axis=-1)
    w = jnp.where(valid, loss_weight(loss_type, loss_scale, r2), 0.0)

    J_pair = jnp.concatenate([J_src[..., :ppc], J_tgt[..., :ppc]], axis=-1)
    # Per-edge accumulation (E, 2ppc, 2ppc), (E, 2ppc)
    JtJ_pair = jnp.einsum(
        "emli,emlj,em->eij", J_pair, J_pair, w, precision=_HI
    )
    Jtr_pair = jnp.einsum(
        "emli,eml,em->ei", J_pair, res, w, precision=_HI
    )
    n_valid = jnp.maximum(jnp.sum(valid, axis=-1), 1).astype(jnp.float32)
    scale = jnp.where(
        data.edge_valid, data.edge_weight / n_valid, 0.0
    )
    JtJ_pair = JtJ_pair * scale[:, None, None]
    Jtr_pair = Jtr_pair * scale[:, None]

    # Scatter into the dense (F·ppc, F·ppc) system
    off = jnp.arange(ppc)
    rows = jnp.concatenate(
        [data.src_frame[:, None] * ppc + off, data.tgt_frame[:, None] * ppc + off],
        axis=1,
    )  # (E, 2ppc)
    Pn = F * ppc
    JtJ = jnp.zeros((Pn, Pn), jnp.float32)
    JtJ = JtJ.at[rows[:, :, None], rows[:, None, :]].add(JtJ_pair)
    Jtr = jnp.zeros((Pn,), jnp.float32).at[rows].add(Jtr_pair)
    return JtJ, Jtr


@partial(
    jax.jit,
    static_argnames=("loss_type", "opt_f", "opt_pp", "ppc", "band"),
)
def rebuild_and_try_lm_step(
    params, data: RefinerData, prims, tri_corners, model, model_inv,
    loss_scale, lam, bounds: C.Bounds,
    *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int,
    band: tuple = (),
):
    """Normal-equation rebuild + solve + step + candidate cost, fused into
    one dispatch (accepted iterations otherwise pay two round trips).
    Returns (JtJ, Jtr, params_new, vec) — JtJ/Jtr stay device-resident
    for rejected-step retries at a new lambda."""
    JtJ, Jtr = build_normal_equations(
        params, data, prims, tri_corners, model, model_inv, loss_scale,
        loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
    )
    params_new, vec = try_lm_step(
        JtJ, Jtr, params, data, prims, tri_corners, model, model_inv,
        loss_scale, lam, bounds,
        loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
        band=band,
    )
    return JtJ, Jtr, params_new, vec


@partial(
    jax.jit,
    static_argnames=("loss_type", "opt_f", "opt_pp", "ppc", "band"),
)
def try_lm_step(
    JtJ, Jtr, params, data: RefinerData, prims, tri_corners, model,
    model_inv, loss_scale, lam, bounds: C.Bounds,
    *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int,
    band: tuple = (),
):
    """Solve + step + candidate cost in ONE dispatch.

    The LM host loop needs five scalars to make its accept/λ decision;
    fetching them one eager op at a time costs a device round trip
    each.  Returns (params_new, vec) with
    vec = [grad_norm, solve_ok, step_norm, cost_new, expected_decrease].

    ``band``: static ``(nb, bs)`` to solve the block-tridiagonal system
    via the banded Cholesky (the skip pattern bounds edge span, see
    damped_block_tridiag_solve); ``()`` = dense.
    """
    if band:
        nb, bs = band
        n0 = JtJ.shape[0]
        n = nb * bs
        JtJ_p = jnp.zeros((n, n), JtJ.dtype).at[:n0, :n0].set(JtJ)
        Jtr_p = jnp.zeros((n,), Jtr.dtype).at[:n0].set(Jtr)
        step_p, ok = damped_block_tridiag_solve(
            JtJ_p, Jtr_p, lam, nb=nb, bs=bs
        )
        step = step_p[:n0]
    else:
        step, ok = damped_cholesky_solve(JtJ, Jtr, lam)
    step_norm = jnp.linalg.norm(step)
    params_new = apply_step(
        params, data, step, bounds, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc
    )
    cost_new = total_cost(
        params_new, data, prims, tri_corners, model, model_inv, loss_scale,
        loss_type=loss_type,
    )
    expected = jnp.dot(
        step, 2.0 * Jtr + P.matmul(JtJ, step), precision=_HI
    )
    vec = jnp.stack(
        [
            jnp.linalg.norm(Jtr),
            jnp.where(ok, 1.0, 0.0),
            step_norm,
            cost_new,
            expected,
        ]
    )
    return params_new, vec


@partial(jax.jit, static_argnames=("opt_f", "opt_pp", "ppc"))
def apply_step(
    params: TrajParams, data: RefinerData, step, bounds: C.Bounds,
    *, opt_f: bool, opt_pp: bool, ppc: int,
):
    """Step every non-anchor camera (cpp/refiner.cc:508-537,618-646)."""
    F = params.q.shape[0]
    dp = step.reshape(F, ppc)
    dp = jnp.where(data.anchor[:, None], 0.0, dp)

    q = P.quat_step_post(params.q, dp[:, 0:3])
    t = params.t + dp[:, 3:6]
    fx, fy, cx, cy = params.fx, params.fy, params.cx, params.cy
    if opt_f:
        fy = jnp.clip(fy + dp[:, 6], bounds.f_low, bounds.f_high)
        fx = jnp.clip(fy * data.aspect, bounds.f_low, bounds.f_high)
    if opt_pp:
        cx = jnp.clip(cx + dp[:, 7], bounds.cx_low, bounds.cx_high)
        cy = jnp.clip(cy + dp[:, 8], bounds.cy_low, bounds.cy_high)
    return TrajParams(q, t, fx, fy, cx, cy)


# ---------------------------------------------------------------------------
# Device-resident LM schedule
#
# The host LM driver below costs one round trip per iteration (plus one
# per accepted refresh).  This chunk
# program runs several full LM iterations per dispatch with the entire
# Nielsen schedule (λ updates, accept/reject, invalid-step counting,
# tolerance breaks, prim refresh on acceptance) in traced control flow;
# params/prims/JᵀJ stay device-resident across chunks and only a small
# per-iteration stat matrix returns to the host, which replays it to
# drive callbacks/stats identically to the host driver.
# ---------------------------------------------------------------------------

def compute_band(data: RefinerData, F: int, ppc: int) -> tuple:
    """Static ``(nb, bs)`` for the block-tridiagonal solve, or ``()``.

    Valid when every edge spans at most S frames (the ±{1,2,4,8} skip
    pattern gives S=8): super-blocks of S frames make the normal matrix
    block-tridiagonal.  Small problems keep the dense solve (the scan's
    per-step overhead only pays off once the dense factorization is the
    bound); ``POLYCHASE_BAND_SOLVE=0`` forces dense everywhere.
    """
    import os as _os

    if _os.environ.get("POLYCHASE_BAND_SOLVE", "1") == "0":
        return ()
    sf, tf, ev = jax.device_get(
        (data.src_frame, data.tgt_frame, data.edge_valid)
    )
    span_arr = np.abs(np.asarray(sf) - np.asarray(tf)) * np.asarray(ev)
    span = int(span_arr.max()) if span_arr.size else 1
    span = max(span, 1)
    nb = -(-F // span)
    if nb < 6:  # dense is fine (and cheaper) for short segments
        return ()
    return (nb, span * ppc)


# Per-iteration replay row:
# [counted, emit, applied, was_rebuild, invalid, grad_norm, step_norm,
#  cost_after, lam_after, invalid_inc, done, stepped]
# ("stepped" = the iteration got past the invalid-solve check, so the
# host driver would have recorded step_norm; inactive rows have
# counted = -1.)
_LM_ROW = 12

# LM iterations per device chunk dispatch.  Interleaved A/B on the
# 250-frame refine config measured 4 iters/chunk at 3.34 s vs 8 at
# 4.24 s — unlike the tracker scan, bigger LM chunks LOSE (the chunk
# overshoots past convergence/rejection breaks with masked-but-compiled
# iterations), so 4 stays.  POLYCHASE_LM_CHUNK overrides.
import os as _os_mod

_LM_CHUNK_ITERS = int(_os_mod.environ.get("POLYCHASE_LM_CHUNK", "4"))


@partial(
    jax.jit,
    static_argnames=(
        "loss_type", "opt_f", "opt_pp", "ppc", "n_iters", "band",
    ),
)
def lm_chunk_device(
    params, prims, JtJ, Jtr, scal,
    data: RefinerData, mesh: Mesh, model, model_inv, tri_corners,
    loss_scale, bounds: C.Bounds, tol4,
    *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int, n_iters: int,
    band: tuple = (),
):
    """Run up to ``n_iters`` LM iterations on device.

    ``scal`` = [cost, lam, v, rebuild, done, invalid_steps, iters_done,
    budget]; ``tol4`` = [gradient_tol, step_tol, min_lambda, max_lambda,
    function_tol] (the name predates the fifth entry; function_tol=0
    disables the stagnation exit = reference-exact termination).
    Mirrors LevMarqSparseSolver::Solve (cpp/pnp/lev_marq.h:492-588) with
    the refiner's accepted-step prim refresh (cpp/refiner.cc:320-349).
    """

    def body(i, st):
        params, prims, JtJ, Jtr, scal, rows, hist = st
        cost, lam, v, rebuild, done = (
            scal[0], scal[1], scal[2], scal[3], scal[4]
        )
        inval, iters_done, budget = scal[5], scal[6], scal[7]

        def inactive(_):
            row = (
                jnp.zeros((_LM_ROW,), jnp.float32)
                .at[0].set(-1.0)
                .at[10].set(1.0)
            )
            return params, prims, JtJ, Jtr, scal, row, params

        def active(_):
            JtJ2, Jtr2 = jax.lax.cond(
                rebuild > 0,
                lambda: build_normal_equations(
                    params, data, prims, tri_corners, model, model_inv,
                    loss_scale, loss_type=loss_type, opt_f=opt_f,
                    opt_pp=opt_pp, ppc=ppc,
                ),
                lambda: (JtJ, Jtr),
            )
            params_new, vec = try_lm_step(
                JtJ2, Jtr2, params, data, prims, tri_corners, model,
                model_inv, loss_scale, lam, bounds,
                loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
                band=band,
            )
            grad_norm, ok, step_norm = vec[0], vec[1], vec[2]
            cost_new, expected = vec[3], vec[4]

            was_rebuild = rebuild > 0
            grad_break = was_rebuild & (grad_norm < tol4[0])
            invalid = (ok == 0.0) & ~grad_break
            step_break = ~grad_break & ~invalid & (step_norm < tol4[1])
            improved = (
                ~grad_break & ~invalid & ~step_break & (cost_new < cost)
            )
            reject = ~grad_break & ~invalid & ~step_break & ~improved
            bad = invalid | reject
            lam_break = bad & (lam >= tol4[3])

            rho = jnp.where(
                expected != 0.0, (cost_new - cost) / expected, -1.0
            )
            factor = jnp.maximum(
                1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
            )
            lam_accept = jnp.where(
                rho > 0.0, jnp.clip(lam * factor, tol4[2], tol4[3]), lam
            )
            lam_bad = jnp.minimum(tol4[3], lam * v)
            bad_cont = bad & ~lam_break

            prims2, cost2 = jax.lax.cond(
                improved,
                lambda p: refresh_prims_and_cost(
                    p, data, mesh, model, model_inv, tri_corners,
                    loss_scale, loss_type=loss_type,
                ),
                lambda p: (prims, cost),
                params_new,
            )

            params_out = jax.tree.map(
                lambda a, b: jnp.where(improved, a, b), params_new, params
            )
            cost_out = jnp.where(improved, cost2, cost)
            lam_out = jnp.where(
                improved, lam_accept, jnp.where(bad_cont, lam_bad, lam)
            )
            v_out = jnp.where(
                improved, 2.0, jnp.where(bad_cont, v * 2.0, v)
            )
            rebuild_out = jnp.where(
                improved, 1.0, jnp.where(bad_cont, 0.0, rebuild)
            )
            counted = improved | ((reject | invalid) & ~lam_break)
            iters_out = iters_done + jnp.where(counted, 1.0, 0.0)
            # Cost-stagnation exit (same contract as lm_solve,
            # levmarq.py: |attempted change| <= ftol·cost on an accepted
            # step = at the noise floor, on a rejected step = the
            # λ-doubling tail whose every later attempt is strictly
            # smaller).  tol4[4] = 0 disables (reference-exact).
            # (shape is static: legacy 4-entry tol vectors mean ftol=0,
            # and a clamped tol4[4] gather would silently read
            # max_lambda instead)
            ftol = tol4[4] if tol4.shape[0] > 4 else jnp.float32(0.0)
            stagnated = (ftol > 0.0) & (
                jnp.abs(cost_new - cost) <= ftol * cost
            )
            done_out = jnp.where(
                grad_break | step_break | lam_break
                | ((improved | reject) & stagnated)
                | (iters_out >= budget),
                1.0, 0.0,
            )
            inval_out = inval + jnp.where(bad, 1.0, 0.0)
            emit = improved | (reject & ~lam_break)

            row = jnp.stack(
                [
                    jnp.where(counted, 1.0, 0.0),
                    jnp.where(emit, 1.0, 0.0),
                    jnp.where(improved, 1.0, 0.0),
                    jnp.where(was_rebuild, 1.0, 0.0),
                    jnp.where(invalid, 1.0, 0.0),
                    grad_norm, step_norm, cost_out, lam_out,
                    jnp.where(bad, 1.0, 0.0),
                    done_out,
                    jnp.where(~grad_break & ~invalid, 1.0, 0.0),
                ]
            )
            scal_out = jnp.stack(
                [
                    cost_out, lam_out, v_out, rebuild_out, done_out,
                    inval_out, iters_out, budget,
                ]
            )
            return params_out, prims2, JtJ2, Jtr2, scal_out, row, params_out

        params, prims, JtJ, Jtr, scal, row, params_snap = jax.lax.cond(
            done > 0, inactive, active, None
        )
        rows = rows.at[i].set(row)
        # Per-iteration parameter snapshot so a host-side cancel at row i
        # returns exactly iteration i's trajectory (the chunk may run a
        # few iterations past the cancel point).
        hist = jax.tree.map(
            lambda h, p: h.at[i].set(p), hist, params_snap
        )
        return params, prims, JtJ, Jtr, scal, rows, hist

    rows0 = jnp.zeros((n_iters, _LM_ROW), jnp.float32)
    hist0 = jax.tree.map(
        lambda a: jnp.zeros((n_iters,) + a.shape, a.dtype), params
    )
    state = (params, prims, JtJ, Jtr, scal, rows0, hist0)
    params, prims, JtJ, Jtr, scal, rows, hist = jax.lax.fori_loop(
        0, n_iters, body, state
    )
    return params, prims, JtJ, Jtr, scal, rows, hist


# ---------------------------------------------------------------------------
# Host LM driver (mirrors LevMarqSparseSolver::Solve, lev_marq.h:492-588)
# ---------------------------------------------------------------------------


def _pad_edges_to(data: RefinerData, multiple: int) -> RefinerData:
    """Pad edge-indexed arrays so E divides the mesh size (padding edges
    carry edge_valid=False and contribute nothing)."""
    E = int(data.src_frame.shape[0])
    E2 = -(-E // multiple) * multiple
    if E2 == E:
        return data
    pad = E2 - E

    def pad_e(a):
        return jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)], axis=0
        )

    return data._replace(
        src_frame=pad_e(data.src_frame),
        tgt_frame=pad_e(data.tgt_frame),
        src_kp=pad_e(data.src_kp),
        tgt_px=pad_e(data.tgt_px),
        match_valid=pad_e(data.match_valid),
        edge_weight=pad_e(data.edge_weight),
        edge_valid=pad_e(data.edge_valid),
    )


_EDGE_FIELDS = frozenset(
    (
        "src_frame", "tgt_frame", "src_kp", "tgt_px", "match_valid",
        "edge_weight", "edge_valid",
    )
)


def refine_trajectory(
    database,
    traj: CameraTrajectory,
    model_matrix: np.ndarray,
    mesh: Mesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    callback: Optional[RefineTrajectoryCallback] = None,
    bundle_opts: BundleOptions = BundleOptions(),
    device_mesh=None,
) -> CameraTrajectory:
    """Refine a fully-filled trajectory segment in place; returns the
    refined trajectory (cpp/refiner.cc:649-725).

    ``device_mesh`` selects the multi-chip path (SURVEY §2.4/§5.8): pass a
    1-D ``jax.sharding.Mesh`` to shard the BA edge sweep over it, ``None``
    (default) to auto-shard over all visible devices when more than one is
    present, or ``False`` to force single-device execution.  The full LM
    schedule (lambda updates, cost gating, prim refresh, anchors,
    callbacks) is identical on both paths; only the normal-equation build
    is distributed, with one psum over the interconnect per iteration.
    """
    if traj.count <= 2:
        raise ValueError("refinement needs more than 2 frames")
    for fid in range(traj.first_frame, traj.last_frame + 1):
        if not traj.is_frame_filled(fid):
            raise ValueError(f"frame {fid} has no pose")

    # Termination aid, same rationale as the tracker's
    # (engine/tracker.py): the reference's LM exits converged solves
    # through a λ-doubling rejection tail that costs real device
    # dispatches here.  On the config-4 shape (250-frame BA with focal)
    # it cut iterations 25 -> 4 at the same final cost to 1e-4 relative
    # (the parity/quality test pins the recovery contract).
    # POLYCHASE_REFINE_FTOL overrides; 0 restores reference-exact
    # termination.  Callers that set function_tol keep their value.
    if getattr(bundle_opts, "function_tol", 0.0) == 0.0:
        _ftol = float(os.environ.get("POLYCHASE_REFINE_FTOL", "1e-5"))
        if _ftol > 0.0:
            bundle_opts = bundle_opts._replace(function_tol=_ftol)

    own_db = False
    if isinstance(database, str):
        database = Database(database)
        own_db = True
    try:
        data = build_refiner_data(database, traj, mesh, model_matrix)
    finally:
        if own_db:
            database.close()

    mesh_obj = None
    if device_mesh is not False:
        if device_mesh is not None:
            mesh_obj = device_mesh
        elif jax.device_count() > 1:
            from ..parallel.sharded import make_edge_mesh

            mesh_obj = make_edge_mesh()
    if mesh_obj is not None:
        from jax.sharding import NamedSharding, PartitionSpec as PSpec

        from ..parallel.sharded import EDGE_AXIS

        data = _pad_edges_to(data, int(mesh_obj.devices.size))
        edge_sh = NamedSharding(mesh_obj, PSpec(EDGE_AXIS))
        rep_sh = NamedSharding(mesh_obj, PSpec())
        data = RefinerData(
            **{
                f: jax.device_put(
                    getattr(data, f),
                    edge_sh if f in _EDGE_FIELDS else rep_sh,
                )
                for f in data._fields
            }
        )

    ppc = 9 if (optimize_focal_length or optimize_principal_point) else 6
    opt_f, opt_pp = bool(optimize_focal_length), bool(optimize_principal_point)
    loss_type = int(bundle_opts.loss_type)
    loss_scale = jnp.float32(bundle_opts.loss_scale)

    model = jnp.asarray(np.asarray(model_matrix, np.float32))
    model_inv = jnp.asarray(
        np.linalg.inv(np.asarray(model_matrix, np.float64)).astype(np.float32)
    )
    tri_corners = mesh.triangle_corners()
    bounds = C.intrinsics_bounds(traj.get(traj.first_frame).intrinsics)

    _log.info(
        "refine segment [%d, %d]: %d frames, %d edges, %d keypoint slots",
        traj.first_frame, traj.last_frame, traj.count,
        int(data.src_frame.shape[0]), int(data.kps.shape[1]),
    )
    params = traj_to_params(traj)
    import os as _os

    routing = _refresh_routing(mesh)
    wants_bvh = routing
    # The fully device-resident LM schedule needs the prim refresh on
    # device too (fused brute sweep or grid); the host-BVH and sharded
    # paths keep the per-iteration host driver.
    use_device_lm = (
        mesh_obj is None
        and not wants_bvh
        and _os.environ.get("POLYCHASE_DEVICE_LM", "1") != "0"
    )
    refresh = _make_prim_refresher(
        data, mesh, model, model_inv, tri_corners, loss_scale, loss_type,
        device_mesh=mesh_obj, routing=routing,
    )
    prims, cost0 = refresh(params)

    def cost_of(p, pr):
        return float(
            total_cost(
                p, data, pr, tri_corners, model, model_inv, loss_scale,
                loss_type=loss_type,
            )
        )

    cost = float(cost0)
    band = compute_band(data, traj.count, ppc)
    stats = dict(
        iterations=0, initial_cost=cost, cost=cost,
        lambda_=float(bundle_opts.initial_lambda),
        invalid_steps=0, step_norm=-1.0, grad_norm=-1.0,
    )

    def make_stats():
        return BundleStats(
            iterations=jnp.int32(stats["iterations"]),
            initial_cost=jnp.float32(stats["initial_cost"]),
            cost=jnp.float32(stats["cost"]),
            lambda_=jnp.float32(stats["lambda_"]),
            invalid_steps=jnp.int32(stats["invalid_steps"]),
            step_norm=jnp.float32(stats["step_norm"]),
            grad_norm=jnp.float32(stats["grad_norm"]),
        )

    def emit(final=False):
        if callback is None:
            return True
        update = RefineTrajectoryUpdate(
            progress=stats["iterations"] / max(bundle_opts.max_iterations, 1),
            message=(
                f"Cost: {stats['cost']:.02f} "
                f"(Initial: {stats['initial_cost']:.02f})"
            ),
            stats=make_stats(),
        )
        return callback(update)

    v = 2.0
    rebuild = True
    JtJ = Jtr = None
    lam = float(bundle_opts.initial_lambda)

    if mesh_obj is not None:
        from ..parallel.sharded import sharded_normal_equations_jit

        def normal_equations(p, pr):
            return sharded_normal_equations_jit(
                mesh_obj, p, data, pr, tri_corners, model, model_inv,
                loss_scale, loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp,
                ppc=ppc,
            )
    else:
        def normal_equations(p, pr):
            return build_normal_equations(
                p, data, pr, tri_corners, model, model_inv,
                loss_scale, loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp,
                ppc=ppc,
            )

    if use_device_lm:
        # Device-resident schedule: several LM iterations per dispatch,
        # state (params/prims/JtJ) never leaves the device; the returned
        # stat rows are replayed to drive stats/callbacks exactly like
        # the host driver below.
        tol4 = jnp.asarray(
            [
                float(bundle_opts.gradient_tol),
                float(bundle_opts.step_tol),
                float(bundle_opts.min_lambda),
                float(bundle_opts.max_lambda),
                float(getattr(bundle_opts, "function_tol", 0.0)),
            ],
            jnp.float32,
        )
        Pn = params.q.shape[0] * ppc
        JtJ_d = jnp.zeros((Pn, Pn), jnp.float32)
        Jtr_d = jnp.zeros((Pn,), jnp.float32)
        scal = jnp.asarray(
            [
                cost, lam, 2.0, 1.0, 0.0, 0.0, 0.0,
                float(bundle_opts.max_iterations),
            ],
            jnp.float32,
        )
        params_d, prims_d = params, prims
        stop = False
        while not stop:
            with profile_region("refiner.lm_chunk"):
                params_d, prims_d, JtJ_d, Jtr_d, scal, rows, hist = (
                    lm_chunk_device(
                        params_d, prims_d, JtJ_d, Jtr_d, scal, data, mesh,
                        model, model_inv, tri_corners, loss_scale, bounds,
                        tol4, loss_type=loss_type, opt_f=opt_f,
                        opt_pp=opt_pp, ppc=ppc,
                        n_iters=_LM_CHUNK_ITERS, band=band,
                    )
                )
            for r, row in enumerate(np.asarray(jax.device_get(rows))):
                (counted, emit_f, applied, was_rebuild, invalid, grad_n,
                 step_n, cost_a, lam_a, inval_inc, done_f, stepped) = row
                if counted < 0:  # inactive padding row
                    stop = True
                    break
                if was_rebuild > 0:
                    stats["grad_norm"] = float(grad_n)
                if stepped > 0:
                    stats["step_norm"] = float(step_n)
                stats["invalid_steps"] += int(inval_inc)
                if counted > 0:
                    stats["iterations"] += 1
                    stats["lambda_"] = float(lam_a)
                if applied > 0:
                    stats["cost"] = float(cost_a)
                if emit_f > 0 and not emit():
                    # Cancelled at iteration r: the chunk ran ahead on
                    # device, so roll back to this row's snapshot — same
                    # trajectory the host driver would have returned.
                    params_d = jax.tree.map(lambda h: h[r], hist)
                    stop = True
                    break
                if done_f > 0:
                    stop = True
                    break
            else:
                stop = stats["iterations"] >= bundle_opts.max_iterations
        params = params_d
        lam = stats["lambda_"]

    while (not use_device_lm) and stats["iterations"] < bundle_opts.max_iterations:
        # One dispatch + one 5-scalar transfer per iteration: the rebuild
        # (when needed), solve, step, candidate cost and gain-ratio terms
        # all come back together.
        with profile_region("refiner.try_step"):
            if rebuild and mesh_obj is None:
                JtJ, Jtr, params_new, vec = rebuild_and_try_lm_step(
                    params, data, prims, tri_corners, model, model_inv,
                    loss_scale, jnp.float32(lam), bounds,
                    loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp,
                    ppc=ppc, band=band,
                )
            else:
                if rebuild:
                    with profile_region("refiner.normal_equations"):
                        JtJ, Jtr = normal_equations(params, prims)
                params_new, vec = try_lm_step(
                    JtJ, Jtr, params, data, prims, tri_corners, model,
                    model_inv, loss_scale, jnp.float32(lam), bounds,
                    loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp,
                    ppc=ppc, band=band,
                )
        grad_norm, solve_ok, step_norm, cost_new, expected = (
            float(x) for x in np.asarray(vec)
        )
        if rebuild:
            stats["grad_norm"] = grad_norm
            if grad_norm < bundle_opts.gradient_tol:
                break

        if solve_ok == 0.0:
            stats["invalid_steps"] += 1
            if lam >= bundle_opts.max_lambda:
                break
            lam = min(bundle_opts.max_lambda, lam * v)
            v *= 2.0
            rebuild = False
            stats["iterations"] += 1
            continue

        stats["step_norm"] = step_norm
        if step_norm < bundle_opts.step_tol:
            break

        # Cost-stagnation exit (mirrors lm_solve / lm_chunk_device):
        # |attempted change| <= ftol·cost.  ftol=0 disables.
        _ftol = float(getattr(bundle_opts, "function_tol", 0.0))
        stagnated = _ftol > 0.0 and (
            abs(cost_new - stats["cost"]) <= _ftol * stats["cost"]
        )

        if cost_new < stats["cost"]:
            actual = cost_new - stats["cost"]
            rho = actual / expected if expected != 0 else -1.0
            if rho > 0:
                factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam = float(
                    np.clip(
                        lam * factor,
                        bundle_opts.min_lambda, bundle_opts.max_lambda,
                    )
                )
            params = params_new
            v = 2.0
            rebuild = True
            # Param change → refresh the intersection cache (the batched
            # analogue of the reference's per-miss re-casting); one fused
            # dispatch on small meshes, host-BVH casting on large ones.
            prims, new_cost = refresh(params)
            stats["cost"] = float(new_cost)
        else:
            stats["invalid_steps"] += 1
            if lam >= bundle_opts.max_lambda:
                break
            lam = min(bundle_opts.max_lambda, lam * v)
            v *= 2.0
            rebuild = False

        stats["iterations"] += 1
        stats["lambda_"] = lam
        if stagnated:
            break
        if not emit():
            break

    stats["lambda_"] = lam
    _log.info(
        "refine done: cost %.4f -> %.4f in %d iterations"
        " (%d invalid steps)",
        stats["initial_cost"], stats["cost"], stats["iterations"],
        stats["invalid_steps"],
    )
    emit(final=True)

    refined = params_to_traj(params, traj)
    for fid in range(traj.first_frame, traj.last_frame + 1):
        traj.set(fid, refined.get(fid))
    return traj
