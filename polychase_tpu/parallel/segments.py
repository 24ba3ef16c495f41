"""Segment-parallel trajectory refinement across a device mesh.

The addon's refine-all runs keyframe segments sequentially, exactly like
the reference (blender_addon/operators/refiner.py; reference
/root/reference/blender_addon/operators/refiner.py:99-136) — but the
segments are *independent* bundle-adjustment problems, which on a
multi-chip mesh is the cheapest parallel axis there is: no collectives
at all, each chip solves whole segments.

Implementation: every segment's problem is padded to common shapes
(frames, keypoints, edges, matches), stacked on a leading segment axis,
and the fully device-resident LM schedule (`engine.refiner.
lm_chunk_device`, one-shot with the whole iteration budget) is vmapped
over that axis inside a ``shard_map`` over a 1-D "segments" device mesh.
Padded frames are anchored and padded edges invalid, so they cost FLOPs
but cannot move.  Prim refresh uses the fused on-device sweep, so the
whole multi-segment refine is ONE dispatch.

``tests/test_segments_parallel.py`` pins this against the sequential
``refine_trajectory`` path.
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as DeviceMesh
from jax.sharding import PartitionSpec as PSpec
from jax import shard_map

from ..engine import camera as C
from ..engine.geometry import Mesh
from ..engine.levmarq import BundleOptions
from ..engine.refiner import (
    RefinerData,
    TrajParams,
    lm_chunk_device,
    params_to_traj,
    refresh_prims_and_cost,
    traj_to_params,
    build_refiner_data,
)
from ..engine.trajectory import CameraTrajectory
from ..io.database import Database

SEGMENT_AXIS = "segments"


def make_segment_mesh(devices=None) -> DeviceMesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return DeviceMesh(devices.reshape(-1), (SEGMENT_AXIS,))


def _pad_segment(params: TrajParams, data: RefinerData, F, K, E, M):
    """Pad one segment's problem (HOST numpy arrays — the caller fetches
    everything in one batched device_get first, so padding never pays a
    per-leaf link round trip) to the stack-wide shapes.

    Padded frames repeat the last real frame's state and are anchored;
    padded keypoints/edges/matches are invalid."""
    f0 = int(params.q.shape[0])

    def pad_f(a, fill_last=True):
        if f0 == F:
            return a
        pad = [(0, F - f0)] + [(0, 0)] * (a.ndim - 1)
        mode = "edge" if fill_last else "constant"
        return np.pad(np.asarray(a), pad, mode=mode)

    params = TrajParams(*(pad_f(a) for a in params))

    def pad_to(a, axis, n, value=0):
        a = np.asarray(a)
        cur = a.shape[axis]
        if cur == n:
            return a
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, n - cur)
        return np.pad(a, pad, constant_values=value)

    anchor = pad_to(data.anchor, 0, F, value=True)
    kps = pad_to(pad_to(data.kps, 0, F), 1, K)
    kp_valid = pad_to(pad_to(data.kp_valid, 0, F), 1, K)
    return params, RefinerData(
        kps=kps,
        kp_valid=kp_valid,
        src_frame=pad_to(data.src_frame, 0, E),
        tgt_frame=pad_to(data.tgt_frame, 0, E),
        src_kp=pad_to(pad_to(data.src_kp, 0, E), 1, M),
        tgt_px=pad_to(pad_to(data.tgt_px, 0, E), 1, M),
        match_valid=pad_to(pad_to(data.match_valid, 0, E), 1, M),
        edge_weight=pad_to(data.edge_weight, 0, E),
        edge_valid=pad_to(data.edge_valid, 0, E),
        anchor=anchor,
        aspect=data.aspect,
        conv_sign=data.conv_sign,
    )


@partial(
    jax.jit,
    static_argnames=(
        "dev_mesh", "loss_type", "opt_f", "opt_pp", "ppc", "n_iters",
        "band",
    ),
)
def _solve_segments_sharded(
    dev_mesh: Optional[DeviceMesh],
    params_s: TrajParams,          # leading S axis
    data_s: RefinerData,           # leading S axis
    bounds_s: C.Bounds,            # leading S axis
    mesh: Mesh, model, model_inv, tri_corners,
    loss_scale, lam0, tol4,
    *, loss_type: int, opt_f: bool, opt_pp: bool, ppc: int, n_iters: int,
    band: tuple = (),
):
    """One dispatch: every segment's full LM schedule, vmapped over the
    segment axis and sharded over the device mesh (no collectives)."""

    def solve_one(params, data, bounds, mesh, model, model_inv,
                  tri_corners, loss_scale, lam0, tol4):
        prims, cost0 = refresh_prims_and_cost(
            params, data, mesh, model, model_inv, tri_corners,
            loss_scale, loss_type=loss_type,
        )
        F = params.q.shape[0]
        Pn = F * ppc
        scal0 = jnp.stack(
            [
                cost0, lam0, jnp.float32(2.0), jnp.float32(1.0),
                jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
                jnp.float32(n_iters - 2),
            ]
        )
        out = lm_chunk_device(
            params, prims, jnp.zeros((Pn, Pn), jnp.float32),
            jnp.zeros((Pn,), jnp.float32), scal0,
            data, mesh, model, model_inv, tri_corners, loss_scale,
            bounds, tol4,
            loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
            n_iters=n_iters, band=band,
        )
        params_f, _prims, _JtJ, _Jtr, scal, rows, _hist = out
        return params_f, scal, rows

    consts = (mesh, model, model_inv, tri_corners, loss_scale, lam0, tol4)
    batched = jax.vmap(
        solve_one, in_axes=(0, 0, 0) + (None,) * len(consts)
    )
    if dev_mesh is None:
        return batched(params_s, data_s, bounds_s, *consts)

    seg = PSpec(SEGMENT_AXIS)
    rep = PSpec()
    rep_tree = lambda x: jax.tree.map(lambda _: rep, x)
    seg_tree = lambda x: jax.tree.map(lambda _: seg, x)
    fn = shard_map(
        batched,
        mesh=dev_mesh,
        in_specs=(
            seg_tree(params_s), seg_tree(data_s), seg_tree(bounds_s),
            *(rep_tree(c) for c in consts),
        ),
        out_specs=(seg_tree(params_s), seg, seg),
        check_vma=False,
    )
    return fn(params_s, data_s, bounds_s, *consts)


def refine_segments(
    database,
    trajs: Sequence[CameraTrajectory],
    model_matrix: np.ndarray,
    mesh: Mesh,
    optimize_focal_length: bool = False,
    optimize_principal_point: bool = False,
    bundle_opts: BundleOptions = BundleOptions(),
    device_mesh=None,
) -> List[CameraTrajectory]:
    """Refine independent trajectory segments in parallel.

    ``device_mesh``: a 1-D ``jax.sharding.Mesh`` to spread segments over,
    ``None`` to auto-build one over all devices when more than one is
    visible, or ``False`` to run the vmapped batch on a single device.
    Returns the refined trajectories in input order.
    """
    if not trajs:
        return []
    # Same auto-injected termination default as refine_trajectory
    # (POLYCHASE_REFINE_FTOL, 0 restores reference-exact).
    if getattr(bundle_opts, "function_tol", 0.0) == 0.0:
        _ftol = float(os.environ.get("POLYCHASE_REFINE_FTOL", "1e-5"))
        if _ftol > 0.0:
            bundle_opts = bundle_opts._replace(function_tol=_ftol)
    own_db = False
    if isinstance(database, str):
        database = Database(database)
        own_db = True
    try:
        packed = [
            (traj_to_params(t), build_refiner_data(
                database, t, mesh, model_matrix
            ))
            for t in trajs
        ]
    finally:
        if own_db:
            database.close()

    # ONE batched transfer of every segment's packed problem; padding
    # and stacking then run on host arrays (per-leaf np.asarray on
    # device arrays would pay a host round trip each).
    packed = jax.device_get(packed)
    F = max(int(p.q.shape[0]) for p, _ in packed)
    K = max(int(d.kps.shape[1]) for _, d in packed)
    E = max(int(d.src_frame.shape[0]) for _, d in packed)
    M = max(int(d.src_kp.shape[1]) for _, d in packed)
    padded = [_pad_segment(p, d, F, K, E, M) for p, d in packed]

    dev_mesh = None
    if device_mesh is not False:
        if device_mesh is not None:
            dev_mesh = device_mesh
        elif jax.device_count() > 1:
            dev_mesh = make_segment_mesh()

    S = len(padded)
    n_dummy = 0
    if dev_mesh is not None:
        D = int(dev_mesh.devices.size)
        n_dummy = (-S) % D
        if n_dummy:
            # Dummy segments: copies with every edge invalid — zero cost,
            # zero gradient, terminate on the first tiny step.
            p0, d0 = padded[0]
            dead = d0._replace(
                edge_valid=np.zeros_like(d0.edge_valid),
                match_valid=np.zeros_like(d0.match_valid),
            )
            padded = padded + [(p0, dead)] * n_dummy

    params_s = jax.tree.map(lambda *a: jnp.stack(a), *[p for p, _ in padded])
    data_s = jax.tree.map(lambda *a: jnp.stack(a), *[d for _, d in padded])
    bounds_list = [
        C.intrinsics_bounds(t.get(t.first_frame).intrinsics) for t in trajs
    ]
    bounds_list += [bounds_list[0]] * n_dummy
    bounds_s = jax.tree.map(lambda *a: jnp.stack(a), *bounds_list)

    b = bundle_opts
    ppc = 9 if (optimize_focal_length or optimize_principal_point) else 6
    tol4 = jnp.asarray(
        [b.gradient_tol, b.step_tol, b.min_lambda, b.max_lambda,
         getattr(b, "function_tol", 0.0)],
        jnp.float32,
    )
    model = jnp.asarray(np.asarray(model_matrix, np.float32))
    model_inv = jnp.asarray(
        np.linalg.inv(np.asarray(model_matrix, np.float64)).astype(
            np.float32
        )
    )

    from ..engine.refiner import compute_band

    bands = {
        compute_band(d, F, ppc) for _, d in padded
    }
    # The band must be one static shape across the stacked segments.
    band = bands.pop() if len(bands) == 1 else ()

    params_f, scal, _rows = _solve_segments_sharded(
        dev_mesh, params_s, data_s, bounds_s,
        mesh, model, model_inv, mesh.triangle_corners(),
        jnp.float32(b.loss_scale), jnp.float32(b.initial_lambda), tol4,
        loss_type=int(b.loss_type),
        opt_f=bool(optimize_focal_length),
        opt_pp=bool(optimize_principal_point),
        ppc=ppc,
        n_iters=int(b.max_iterations) + 2,
        band=band,
    )

    params_h = jax.device_get(params_f)
    out = []
    for i, traj in enumerate(trajs):
        f_real = traj.count
        params_i = TrajParams(
            *(jnp.asarray(np.asarray(a)[i][:f_real]) for a in params_h)
        )
        out.append(params_to_traj(params_i, traj))
    return out
