"""CPU reference baselines: numpy reimplementations of the reference's
tracker and refiner hot paths.

The reference binary cannot run in this image (its prebuilt wheels are
git-lfs pointers), so BASELINE.md configs 3-5 need a measured CPU
stand-in.  This module re-creates the reference's exact data flow in
host numpy + the native BVH (the Embree analogue):

- ``cpu_track_trajectory``: sequential frame chaining — gather flows
  into the frame from solved neighbors, ray-cast source keypoints onto
  the mesh, warm-start, iterative 9-param PnP (cpp/tracker.cc:36-192).
  The LM solve is ``engine.pnp_host`` (the reference's PnP math in
  float64 numpy).
- ``cpu_refine_trajectory``: segment bundle adjustment — bbox+20px
  keypoint filter, per-(frame,keypoint) intersection primitive cache,
  plane-fixed analytic Jacobians through
  unproject→derotate/center→ray-plane→apply→project, per-edge
  normalization, 1/(1+distance) edge weights, anchored endpoints, and a
  block-sparse LM with the Nielsen λ schedule
  (cpp/refiner.cc:274-506, cpp/pnp/lev_marq.h:391-871).

Everything here is pure host compute (no JAX arrays are created), so it
can run next to an accelerator-backed process for side-by-side timing.  It
doubles as the *independent implementation* for the end-to-end RMSE
parity tests (tests/test_baseline_parity.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from polychase_tpu.engine import camera as C
from polychase_tpu.engine import pose as P
from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.pnp import PnPOptions
from polychase_tpu.engine.pnp_host import (
    _loss_value,
    _loss_weight,
    _quat_step_post,
    _rotmat,
    solve_pnp_host,
)
from polychase_tpu.io.database import Database
from polychase_tpu.native import BvhRaycaster

MAX_INLIER_ERROR = 12.0  # px (cpp/tracker.cc:123)
_INVALID = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# Shared host camera helpers
# ---------------------------------------------------------------------------


def _unproject(intr, px):
    """Pixel → camera ray dir (cpp/pnp/types.h:95-98). px (..., 2)."""
    s = float(intr.sign)
    return np.stack(
        [
            s * (px[..., 0] - float(intr.cx)) / float(intr.fx),
            s * (px[..., 1] - float(intr.cy)) / float(intr.fy),
            np.full(px.shape[:-1], s),
        ],
        axis=-1,
    )


def _project(fx, fy, cx, cy, X):
    return np.stack(
        [fx * X[..., 0] / X[..., 2] + cx, fy * X[..., 1] / X[..., 2] + cy],
        axis=-1,
    )


class HostCam:
    """One camera's free parameters: q, t (+ fy, cx, cy when optimized)."""

    __slots__ = ("q", "t", "fy", "cx", "cy")

    def __init__(self, q, t, fy, cx, cy):
        self.q = np.asarray(q, np.float64).reshape(4).copy()
        self.t = np.asarray(t, np.float64).reshape(3).copy()
        self.fy, self.cx, self.cy = float(fy), float(cx), float(cy)


# ---------------------------------------------------------------------------
# Sequential tracker (cpp/tracker.cc:36-192)
# ---------------------------------------------------------------------------


def cpu_track_trajectory(
    db: Database,
    traj: Dict[int, Tuple[np.ndarray, np.ndarray]],  # fid -> (q, t)
    first: int,
    last_inclusive: int,
    model_matrix: np.ndarray,
    bvh: BvhRaycaster,
    intr: C.Intrinsics,
    masked_triangles: Optional[np.ndarray] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(loss_type=CAUCHY),
) -> Dict[int, float]:
    """Chain per-frame PnP solves exactly like the reference tracker.

    ``traj`` must contain the seed frame; solved frames are written back
    as (q, t) float64 pairs.  Returns {fid: inlier_ratio}.
    """
    model = np.asarray(model_matrix, np.float64).reshape(4, 4)
    direction = 1 if last_inclusive >= first else -1
    ratios: Dict[int, float] = {}
    intr_cur = intr

    for fid in range(first + direction, last_inclusive + direction,
                     direction):
        Xw_parts, tgt_parts = [], []
        # Gather flows INTO fid from already-solved frames
        # (cpp/tracker.cc:43-49)
        for src in db.find_optical_flows_to_image(fid):
            if src not in traj:
                continue
            kps = db.read_keypoints(src)
            flow = db.read_image_pair_flow(src, fid)
            if flow.src_kps_indices.size == 0:
                continue
            q_s, t_s = traj[src]
            R_s = _rotmat(np.asarray(q_s, np.float64))
            src_px = kps[flow.src_kps_indices].astype(np.float64)
            # Pixel → object-space ray through the source camera
            # (cpp/tracker.cc:64-92)
            d_cam = _unproject(intr_cur, src_px)
            d_world = d_cam @ R_s  # R_sᵀ per row
            origin_w = -(R_s.T @ np.asarray(t_s, np.float64))
            minv = np.linalg.inv(model)
            origin_o = minv[:3, :3] @ origin_w + minv[:3, 3]
            d_obj = d_world @ minv[:3, :3].T
            pos, _n, _b, _t, prim = bvh.raycast(
                np.broadcast_to(origin_o, d_obj.shape).astype(np.float32),
                d_obj.astype(np.float32), masked_triangles,
            )
            hit = prim != _INVALID
            if not hit.any():
                continue
            Xo = pos[hit].astype(np.float64)
            Xw_parts.append(Xo @ model[:3, :3].T + model[:3, 3])
            tgt_parts.append(flow.tgt_kps[hit].astype(np.float64))

        if not Xw_parts:
            continue
        X = np.concatenate(Xw_parts)
        x = np.concatenate(tgt_parts)
        if X.shape[0] < 3:  # cpp/tracker.cc:95-97
            continue

        # Warm start current/prev/next (cpp/tracker.cc:112-119)
        warm = None
        for wf in (fid, fid - direction, fid + direction):
            if wf in traj:
                warm = traj[wf]
                break
        cam0 = C.CameraState(
            intr_cur,
            P.Pose(
                np.asarray(warm[0], np.float32),
                np.asarray(warm[1], np.float32),
            ),
        )
        result = solve_pnp_host(
            X.astype(np.float32), x.astype(np.float32), cam0,
            PnPOptions(
                bundle_opts=bundle_opts,
                max_inlier_error=MAX_INLIER_ERROR,
                optimize_focal_length=optimize_focal_length,
                optimize_principal_point=optimize_principal_point,
            ),
        )
        traj[fid] = (
            np.asarray(result.camera.pose.q, np.float64),
            np.asarray(result.camera.pose.t, np.float64),
        )
        intr_cur = result.camera.intrinsics
        ratios[fid] = float(result.inlier_ratio)
    return ratios


# ---------------------------------------------------------------------------
# Segment bundle adjustment (cpp/refiner.cc + lev_marq.h:391-871)
# ---------------------------------------------------------------------------


class _BAProblem:
    """Packed BA problem: flat match arrays grouped by edge."""

    def __init__(self, db: Database, traj, first, last, model, bvh, intr,
                 masked_triangles, verts, tris):
        self.first, self.last = first, last
        self.F = last - first + 1
        self.model = np.asarray(model, np.float64).reshape(4, 4)
        self.model_inv = np.linalg.inv(self.model)
        self.intr = intr
        self.aspect = float(intr.aspect_ratio)
        self.sign = float(intr.sign)

        # bbox + 20px keypoint filter (cpp/refiner.cc:53-69)
        lo = verts.min(axis=0).astype(np.float64)
        hi = verts.max(axis=0).astype(np.float64)
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
             for z in (lo[2], hi[2])]
        )
        kps, remaps = {}, {}
        fx, fy = float(intr.fx), float(intr.fy)
        cx, cy = float(intr.cx), float(intr.cy)
        for fid in range(first, last + 1):
            raw = db.read_keypoints(fid)
            q, t = traj[fid][:2]
            R = _rotmat(np.asarray(q, np.float64))
            cw = (corners @ self.model[:3, :3].T + self.model[:3, 3])
            cc = cw @ R.T + np.asarray(t, np.float64)
            proj = _project(fx, fy, cx, cy, cc)
            pmin, pmax = proj.min(0) - 20.0, proj.max(0) + 20.0
            inside = (
                (raw[:, 0] > pmin[0]) & (raw[:, 0] < pmax[0])
                & (raw[:, 1] > pmin[1]) & (raw[:, 1] < pmax[1])
            )
            remap = np.full(len(raw), -1, np.int64)
            remap[inside] = np.arange(int(inside.sum()))
            kps[fid] = raw[inside].astype(np.float64)
            remaps[fid] = remap

        # Edges within the segment
        edges = []  # (sf, tf, src_kp_idx, tgt_px)
        for fid in range(first, last + 1):
            for tgt in db.find_optical_flows_from_image(fid):
                if not first <= tgt <= last:
                    continue
                flow = db.read_image_pair_flow(fid, tgt)
                if flow.src_kps_indices.size == 0:
                    continue
                new_idx = remaps[fid][flow.src_kps_indices]
                keep = new_idx >= 0
                if not keep.any():
                    continue
                edges.append(
                    (fid - first, tgt - first,
                     new_idx[keep], flow.tgt_kps[keep].astype(np.float64))
                )

        # Primitive cache: one closest-hit cast per (frame, keypoint)
        # (cpp/refiner.cc:320-349), the hit triangle's plane held fixed
        # until the next refresh.
        self.kps = kps
        self._bvh, self._verts, self._tris = bvh, verts, tris
        self._masked = masked_triangles
        cams0 = [
            HostCam(*(tuple(traj[fid]) + (intr.fy, intr.cx, intr.cy))[:5])
            for fid in range(first, last + 1)
        ]

        # Flatten matches grouped by edge
        sf_l, tf_l, spx_l, tpx_l, idx_l = [], [], [], [], []
        self.edge_slices = []
        self.edge_weight = []
        pos = 0
        for sf, tf, idx, tpx in edges:
            k = len(idx)
            sf_l.append(np.full(k, sf))
            tf_l.append(np.full(k, tf))
            spx_l.append(self.kps[first + sf][idx])
            tpx_l.append(tpx)
            idx_l.append(idx)
            self.edge_slices.append((pos, pos + k))
            # FrameWeight of the source frame (cpp/refiner.cc:250-257)
            distance = min(sf, (self.F - 1) - sf)
            self.edge_weight.append(1.0 / (distance + 1.0))
            pos += k
        if pos == 0:
            raise ValueError("no matches in segment")
        self.sf = np.concatenate(sf_l).astype(np.int64)
        self.tf = np.concatenate(tf_l).astype(np.int64)
        self.src_px = np.concatenate(spx_l)
        self.tgt_px = np.concatenate(tpx_l)
        self.src_idx = np.concatenate(idx_l).astype(np.int64)
        self.edge_weight = np.asarray(self.edge_weight)
        self.n_matches = pos
        self.anchor = np.zeros(self.F, bool)
        self.anchor[0] = self.anchor[-1] = True
        self.refresh(cams0)

    def refresh(self, cams):
        """Re-cast every (frame, keypoint) ray from ``cams`` and cache
        the hit triangles (the refiner re-casts after each accepted
        step, engine/refiner.py)."""
        verts, tris = self._verts, self._tris
        tri = {}
        for i, c in enumerate(cams):
            pts = self.kps[self.first + i]
            if pts.shape[0] == 0:
                z3 = np.zeros((0, 3))
                tri[i] = (z3, z3, z3, np.zeros(0, bool))
                continue
            R = _rotmat(c.q)
            s = self.sign
            fx = c.fy * self.aspect
            d_cam = np.stack(
                [s * (pts[:, 0] - c.cx) / fx, s * (pts[:, 1] - c.cy) / c.fy,
                 np.full(len(pts), s)], axis=-1)
            d_world = d_cam @ R
            origin_w = -(R.T @ c.t)
            origin_o = self.model_inv[:3, :3] @ origin_w \
                + self.model_inv[:3, 3]
            d_obj = d_world @ self.model_inv[:3, :3].T
            _pos, _n, _b, _t, prim = self._bvh.raycast(
                np.broadcast_to(origin_o, d_obj.shape).astype(np.float32),
                d_obj.astype(np.float32), self._masked,
            )
            hit = prim != _INVALID
            safe = np.where(hit, prim, 0)
            tri[i] = tuple(
                verts[tris[safe, k]].astype(np.float64) for k in range(3)
            ) + (hit,)
        # Gather per match from its source frame's cache.
        parts = [[], [], [], []]
        for a, b in self.edge_slices:
            sf = int(self.sf[a])
            idx = self.src_idx[a:b]
            for k in range(4):
                parts[k].append(tri[sf][k][idx])
        self.t1, self.t2, self.t3 = (np.concatenate(p) for p in parts[:3])
        self.prim_ok = np.concatenate(parts[3])
        # World-space plane (fixed model transform)
        self.t1w = self.t1 @ self.model[:3, :3].T + self.model[:3, 3]
        nrm_o = np.cross(self.t2 - self.t1, self.t3 - self.t1)
        self.nw = nrm_o @ self.model_inv[:3, :3]

    # -- evaluation ---------------------------------------------------------

    def _cam_arrays(self, cams):
        q = np.stack([c.q for c in cams])
        t = np.stack([c.t for c in cams])
        fy = np.array([c.fy for c in cams])
        cx = np.array([c.cx for c in cams])
        cy = np.array([c.cy for c in cams])
        R = np.stack([_rotmat(c.q) for c in cams])
        return q, t, fy, cx, cy, R

    def evaluate(self, cams, with_jac, opt_f, opt_pp):
        """Residuals (N,2) + validity; optionally J_src/J_tgt (N,2,9)
        (cpp/refiner.cc:274-506)."""
        _q, t_all, fy_all, cx_all, cy_all, R_all = self._cam_arrays(cams)
        fx_all = fy_all * self.aspect
        s = self.sign
        sf, tf = self.sf, self.tf
        spx, nw, t1w = self.src_px, self.nw, self.t1w

        fx_s, fy_s = fx_all[sf], fy_all[sf]
        cx_s, cy_s = cx_all[sf], cy_all[sf]
        R_s = R_all[sf]               # (N, 3, 3)
        t_s = t_all[sf]

        # unproject + jac (cpp/pnp/types.h:100-125)
        dc = np.stack(
            [
                s * (spx[:, 0] - cx_s) / fx_s,
                s * (spx[:, 1] - cy_s) / fy_s,
                np.full(len(sf), s),
            ],
            axis=-1,
        )
        # world ray
        d = np.einsum("nji,nj->ni", R_s, dc)      # R_sᵀ dc
        o = -np.einsum("nji,nj->ni", R_s, t_s)    # camera center
        d_dot_n = np.einsum("ni,ni->n", d, nw)
        plane_ok = np.abs(d_dot_n) > 1e-10
        safe = np.where(plane_ok, d_dot_n, 1.0)
        tt = np.einsum("ni,ni->n", t1w - o, nw) / safe
        X = o + d * tt[:, None]

        # target camera
        R_t = R_all[tf]
        Xc = np.einsum("nij,nj->ni", R_t, X) + t_all[tf]
        behind = s * Xc[:, 2] < 0.0
        fx_t, fy_t = fx_all[tf], fy_all[tf]
        cx_t, cy_t = cx_all[tf], cy_all[tf]
        zs = np.where(Xc[:, 2] == 0.0, 1e-12, Xc[:, 2])
        p = np.stack(
            [fx_t * Xc[:, 0] / zs + cx_t, fy_t * Xc[:, 1] / zs + cy_t],
            axis=-1,
        )
        res = p - self.tgt_px
        valid = self.prim_ok & plane_ok & ~behind

        if not with_jac:
            # Cost validity also needs the bounded cached triangle hit
            # (cpp/refiner.cc:326-333): Möller–Trumbore in object space.
            oo = (o @ self.model_inv[:3, :3].T) + self.model_inv[:3, 3]
            do = d @ self.model_inv[:3, :3].T
            e1, e2 = self.t2 - self.t1, self.t3 - self.t1
            rce2 = np.cross(do, e2)
            det = np.einsum("ni,ni->n", e1, rce2)
            mt_ok = np.abs(det) > 1e-10
            inv_det = 1.0 / np.where(mt_ok, det, 1.0)
            sv = oo - self.t1
            u = inv_det * np.einsum("ni,ni->n", sv, rce2)
            sce1 = np.cross(sv, e1)
            v = inv_det * np.einsum("ni,ni->n", do, sce1)
            tmt = inv_det * np.einsum("ni,ni->n", e2, sce1)
            mt_ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (
                tmt >= 0
            )
            return res, valid & mt_ok, None, None

        N = len(sf)
        inv_z = 1.0 / zs
        zero = np.zeros(N)
        one = np.ones(N)
        dp_dXc = np.stack(
            [
                fx_t * inv_z, zero, -fx_t * Xc[:, 0] * inv_z * inv_z,
                zero, fy_t * inv_z, -fy_t * Xc[:, 1] * inv_z * inv_z,
            ],
            axis=-1,
        ).reshape(N, 2, 3)

        # plane-intersection jacs (cpp/ray_casting.h:76-112)
        dn = d[:, :, None] * nw[:, None, :] / safe[:, None, None]
        jac_o = np.eye(3)[None] - dn          # dX/dorigin
        jac_d = jac_o * tt[:, None, None]     # dX/ddir

        # source blocks
        skew_dw = _skew(d)                    # dDirWorld/dω = skew(d)
        Rt_s = np.swapaxes(R_s, 1, 2)
        c_center = o
        skew_c = _skew(c_center)              # dOrigin/dω = skew(center)
        dO_dt = -Rt_s                         # dOrigin/dt
        dX_dR = np.einsum("nij,njk->nik", jac_o, skew_c) + np.einsum(
            "nij,njk->nik", jac_d, skew_dw
        )
        dp_dXw = np.einsum(
            "nij,njk->nik", dp_dXc, R_t
        )  # d p / d X (world)
        Js_rot = np.einsum("nij,njk->nik", dp_dXw, dX_dR)
        Js_t = np.einsum(
            "nij,njk,nkl->nil", dp_dXw, jac_o, dO_dt
        )
        # d dirCam / d (fy, cx, cy)
        dDc_dInt = np.stack(
            [
                s * (cx_s - spx[:, 0]) / (fy_s * fy_s * self.aspect),
                -s / fx_s, zero,
                s * (cy_s - spx[:, 1]) / (fy_s * fy_s),
                zero, -s / fy_s,
                zero, zero, zero,
            ],
            axis=-1,
        ).reshape(N, 3, 3)
        Js_int = np.einsum(
            "nij,njk,nkl,nlm->nim", dp_dXw, jac_d, Rt_s, dDc_dInt
        )

        # target blocks
        dXc_dR = np.einsum("nij,njk->nik", R_t, _skew(-X))
        Jt_rot = np.einsum("nij,njk->nik", dp_dXc, dXc_dR)
        Jt_t = dp_dXc
        dp_dInt_t = np.stack(
            [
                self.aspect * Xc[:, 0] * inv_z, one, zero,
                Xc[:, 1] * inv_z, zero, one,
            ],
            axis=-1,
        ).reshape(N, 2, 3)
        Jt_int = dp_dInt_t

        if not opt_f:
            Js_int[..., 0] = 0.0
            Jt_int[..., 0] = 0.0
        if not opt_pp:
            Js_int[..., 1:] = 0.0
            Jt_int[..., 1:] = 0.0
        if not (opt_f or opt_pp):
            Js_int[:] = 0.0
            Jt_int[:] = 0.0

        J_src = np.concatenate([Js_rot, Js_t, Js_int], axis=-1)
        J_tgt = np.concatenate([Jt_rot, Jt_t, Jt_int], axis=-1)
        J_src[self.anchor[sf]] = 0.0  # cpp/refiner.cc:611-612
        J_tgt[self.anchor[tf]] = 0.0
        return res, valid, J_src, J_tgt

    def cost(self, cams, loss_type, loss_scale):
        """Per-edge-normalized robust cost (cpp/pnp/lev_marq.h:773-824)."""
        res, valid, _, _ = self.evaluate(cams, False, False, False)
        r2 = np.sum(res * res, axis=-1)
        cm = np.where(valid, _loss_value(loss_type, loss_scale, r2), 0.0)
        total = 0.0
        for (a, b), w in zip(self.edge_slices, self.edge_weight):
            nv = max(int(valid[a:b].sum()), 1)
            total += w * cm[a:b].sum() / nv
        return total


def _skew(v):
    N = v.shape[0]
    m = np.zeros((N, 3, 3))
    m[:, 0, 1] = -v[:, 2]; m[:, 0, 2] = v[:, 1]
    m[:, 1, 0] = v[:, 2];  m[:, 1, 2] = -v[:, 0]
    m[:, 2, 0] = -v[:, 1]; m[:, 2, 1] = v[:, 0]
    return m


def cpu_refine_trajectory(
    db: Database,
    traj: Dict[int, Tuple[np.ndarray, np.ndarray]],
    first: int,
    last: int,
    model_matrix: np.ndarray,
    bvh: BvhRaycaster,
    intr: C.Intrinsics,
    verts: np.ndarray,
    tris: np.ndarray,
    masked_triangles: Optional[np.ndarray] = None,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(loss_type=CAUCHY),
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Block-sparse LM bundle adjustment (lev_marq.h:391-871) on host.

    ``traj`` values are ``(q, t)``, starting from ``intr``'s focal and
    principal point, or ``(q, t, fy, cx, cy)``.  Returns ``(refined
    {fid: (q, t, fy, cx, cy)}, final cost)``; ``traj`` is not modified.  When
    intrinsics are optimized the shared-per-frame (fy, cx, cy) ride in
    the per-camera blocks exactly like the reference (9 params/camera).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    prob = _BAProblem(
        db, traj, first, last, model_matrix, bvh, intr, masked_triangles,
        verts, tris,
    )
    F = prob.F
    opt_f = bool(optimize_focal_length)
    opt_pp = bool(optimize_principal_point)
    ppc = 9 if (opt_f or opt_pp) else 6
    loss_type = int(bundle_opts.loss_type)
    loss_scale = float(bundle_opts.loss_scale)

    cams = [
        HostCam(*(tuple(traj[first + i]) + (intr.fy, intr.cx, intr.cy))[:5])
        for i in range(F)
    ]

    from polychase_tpu.engine.pnp_host import _bounds
    bounds = _bounds(float(intr.width), float(intr.height), prob.sign)

    def build_normal_equations(cams):
        res, valid, J_src, J_tgt = prob.evaluate(cams, True, opt_f, opt_pp)
        r2 = np.sum(res * res, axis=-1)
        w = np.where(valid, _loss_weight(loss_type, loss_scale, r2), 0.0)
        Pn = F * ppc
        JtJ = np.zeros((Pn, Pn))
        Jtr = np.zeros(Pn)
        off = np.arange(ppc)
        for e, ((a, b), ew) in enumerate(
            zip(prob.edge_slices, prob.edge_weight)
        ):
            nv = max(int(valid[a:b].sum()), 1)
            scale = ew / nv
            Jp = np.concatenate(
                [J_src[a:b, :, :ppc], J_tgt[a:b, :, :ppc]], axis=-1
            )  # (m, 2, 2ppc)
            we = w[a:b]
            blk = np.einsum("mli,mlj,m->ij", Jp, Jp, we) * scale
            gv = np.einsum("mli,ml,m->i", Jp, res[a:b], we) * scale
            sfe, tfe = int(prob.sf[a]), int(prob.tf[a])
            rows = np.concatenate([sfe * ppc + off, tfe * ppc + off])
            JtJ[np.ix_(rows, rows)] += blk
            Jtr[rows] += gv
        return JtJ, Jtr

    def apply_step(cams, dp):
        out = []
        for i, c in enumerate(cams):
            if prob.anchor[i]:
                out.append(HostCam(c.q, c.t, c.fy, c.cx, c.cy))
                continue
            d = dp[i * ppc:(i + 1) * ppc]
            q = _quat_step_post(c.q, d[0:3])
            t = c.t + d[3:6]
            fy, cx, cy = c.fy, c.cx, c.cy
            if opt_f:
                f_low, f_high = bounds[0], bounds[1]
                fy = float(np.clip(fy + d[6], f_low, f_high))
            if opt_pp:
                cx = float(np.clip(cx + d[7], bounds[2], bounds[3]))
                cy = float(np.clip(cy + d[8], bounds[4], bounds[5]))
            out.append(HostCam(q, t, fy, cx, cy))
        return out

    def damped_solve(JtJ, Jtr, lam):
        diag = np.clip(np.diagonal(JtJ), 1e-6, 1e32)
        A = JtJ.copy()
        np.fill_diagonal(A, diag * (1.0 + lam))
        # Anchored cameras have empty rows: give them identity so the
        # sparse factorization stays nonsingular (their step is ignored).
        empty = np.diagonal(A) == 0.0
        A[empty, empty] = 1.0
        As = sp.csc_matrix(A)
        try:
            lu = spla.splu(As)
            step = -lu.solve(Jtr)
        except RuntimeError:
            return np.zeros_like(Jtr), False
        ok = bool(np.all(np.isfinite(step)))
        return (step if ok else np.zeros_like(step)), ok

    b = bundle_opts
    cost = prob.cost(cams, loss_type, loss_scale)
    JtJ, Jtr = build_normal_equations(cams)
    lam, v = float(b.initial_lambda), 2.0
    it = 0
    done = float(np.linalg.norm(Jtr)) < b.gradient_tol
    while not done and it < b.max_iterations:
        step, ok = damped_solve(JtJ, Jtr, lam)
        step_norm = float(np.linalg.norm(step))
        cams_new = apply_step(cams, step)
        cost_new = prob.cost(cams_new, loss_type, loss_scale)
        improved = ok and cost_new < cost
        tiny = ok and step_norm < b.step_tol
        accept = improved and not tiny
        if accept:
            actual = cost_new - cost
            expected = float(np.dot(step, 2.0 * Jtr + JtJ @ step))
            rho = actual / expected if expected else 0.0
            cams = cams_new
            # Parameters moved: re-cast the intersection cache, as the
            # refiner does after each accepted step.
            prob.refresh(cams)
            cost = prob.cost(cams, loss_type, loss_scale)
            if rho > 0:
                factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                lam = float(np.clip(lam * factor, b.min_lambda,
                                    b.max_lambda))
            v = 2.0
            JtJ, Jtr = build_normal_equations(cams)
            done = float(np.linalg.norm(Jtr)) < b.gradient_tol
        else:
            if lam >= b.max_lambda:
                break
            lam = min(b.max_lambda, lam * v)
            v *= 2.0
        if tiny:
            break
        it += 1

    return {
        first + i: (c.q.copy(), c.t.copy(), c.fy, c.cx, c.cy)
        for i, c in enumerate(cams)
    }, cost


# ---------------------------------------------------------------------------
# Reprojection RMSE over the flow graph (shared metric for parity tests)
# ---------------------------------------------------------------------------


def reprojection_rmse(
    db: Database,
    traj: Dict[int, Tuple[np.ndarray, np.ndarray]],
    first: int,
    last: int,
    model_matrix: np.ndarray,
    bvh: BvhRaycaster,
    intr: C.Intrinsics,
    verts: np.ndarray,
    tris: np.ndarray,
    masked_triangles: Optional[np.ndarray] = None,
) -> float:
    """RMS reprojection error of a trajectory over every DB flow edge in
    [first, last] (residual definition of cpp/refiner.cc:274-361).

    ``traj`` values are ``(q, t)``, with ``intr``'s focal and principal
    point, or ``(q, t, fy, cx, cy)`` for per-frame intrinsics."""
    prob = _BAProblem(
        db, traj, first, last, model_matrix, bvh, intr, masked_triangles,
        verts, tris,
    )
    cams = [
        HostCam(*(tuple(traj[first + i]) + (intr.fy, intr.cx, intr.cy))[:5])
        for i in range(prob.F)
    ]
    res, valid, _, _ = prob.evaluate(cams, False, False, False)
    r2 = np.sum(res * res, axis=-1)[valid]
    return float(np.sqrt(r2.mean())) if r2.size else 0.0
