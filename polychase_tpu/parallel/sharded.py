"""Multi-device sharding of the bundle-adjustment hot path.

The reference is a single-node CPU program whose BA edge sweep is a TBB
``parallel_for`` with atomic scatter-adds into a shared sparse matrix
(cpp/pnp/lev_marq.h:653-771).  The scale-out design (SURVEY.md
§2.4, §5.8) replaces that shared-memory reduction with a device mesh:

- flow **edges are sharded across devices** (the data-parallel axis — each
  edge's residual block is independent);
- every device evaluates its edge shard's residuals/Jacobians and
  accumulates a **local dense JᵀJ / Jᵀr**;
- one ``psum`` over the interconnect reduces the normal equations — this is the
  only communication in the whole iteration (P ≤ 9·F parameters, a few
  MB at most);
- the damped Cholesky solve + parameter step run replicated (identical
  on every chip), so no broadcast is needed afterwards.

Everything is expressed with ``shard_map`` over a 1-D ``jax.sharding.Mesh``
so the same code runs on any chip count, including a single device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec
from jax import shard_map

from ..engine import camera as C
from ..engine.levmarq import damped_cholesky_solve, loss_weight
from ..engine.refiner import (
    RefinerData,
    TrajParams,
    _edge_eval,
    apply_step,
)

EDGE_AXIS = "edges"


def make_edge_mesh(devices=None) -> Mesh:
    """1-D device mesh over which BA edges are sharded."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (EDGE_AXIS,))


def _local_normal_equations(
    params: TrajParams,
    data: RefinerData,
    prims,
    tri_p1, tri_p2, tri_p3,
    model,
    model_inv,
    loss_scale,
    loss_type: int,
    opt_f: bool,
    opt_pp: bool,
    ppc: int,
):
    """Per-shard dense JᵀJ/Jᵀr over the local edge block, then psum."""
    res, valid, J_src, J_tgt = _edge_eval(
        params, data, prims, (tri_p1, tri_p2, tri_p3), model, model_inv,
        with_jac=True, opt_f=opt_f, opt_pp=opt_pp,
    )
    F = params.q.shape[0]
    r2 = jnp.sum(res * res, axis=-1)
    w = jnp.where(valid, loss_weight(loss_type, loss_scale, r2), 0.0)

    J_pair = jnp.concatenate([J_src[..., :ppc], J_tgt[..., :ppc]], axis=-1)
    hi = jax.lax.Precision.HIGHEST
    JtJ_pair = jnp.einsum("emli,emlj,em->eij", J_pair, J_pair, w, precision=hi)
    Jtr_pair = jnp.einsum("emli,eml,em->ei", J_pair, res, w, precision=hi)
    n_valid = jnp.maximum(jnp.sum(valid, axis=-1), 1).astype(jnp.float32)
    scale = jnp.where(data.edge_valid, data.edge_weight / n_valid, 0.0)
    JtJ_pair = JtJ_pair * scale[:, None, None]
    Jtr_pair = Jtr_pair * scale[:, None]

    off = jnp.arange(ppc)
    rows = jnp.concatenate(
        [
            data.src_frame[:, None] * ppc + off,
            data.tgt_frame[:, None] * ppc + off,
        ],
        axis=1,
    )
    Pn = F * ppc
    JtJ = jnp.zeros((Pn, Pn), jnp.float32)
    JtJ = JtJ.at[rows[:, :, None], rows[:, None, :]].add(JtJ_pair)
    Jtr = jnp.zeros((Pn,), jnp.float32).at[rows].add(Jtr_pair)

    # The single collective: reduce partial normal equations over the mesh.
    JtJ = jax.lax.psum(JtJ, EDGE_AXIS)
    Jtr = jax.lax.psum(Jtr, EDGE_AXIS)
    return JtJ, Jtr


def _edge_sharded_spec(mesh: Mesh):
    """PartitionSpecs: edge-indexed arrays sharded on dim 0, rest replicated."""
    edge = PSpec(EDGE_AXIS)
    rep = PSpec()
    data_spec = RefinerData(
        kps=rep, kp_valid=rep,
        src_frame=edge, tgt_frame=edge, src_kp=edge, tgt_px=edge,
        match_valid=edge, edge_weight=edge, edge_valid=edge,
        anchor=rep, aspect=rep, conv_sign=rep,
    )
    return data_spec, rep


def sharded_normal_equations(
    mesh: Mesh,
    params: TrajParams,
    data: RefinerData,
    prims,
    tri_corners,
    model,
    model_inv,
    loss_scale,
    *,
    loss_type: int,
    opt_f: bool,
    opt_pp: bool,
    ppc: int,
):
    """JᵀJ/Jᵀr with edges sharded over ``mesh`` and a psum reduction."""
    data_spec, rep = _edge_sharded_spec(mesh)
    params_spec = TrajParams(rep, rep, rep, rep, rep, rep)
    fn = shard_map(
        partial(
            _local_normal_equations,
            loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
        ),
        mesh=mesh,
        in_specs=(
            params_spec, data_spec, rep, rep, rep, rep, rep, rep, rep,
        ),
        out_specs=(rep, rep),
        check_vma=False,
    )
    p1, p2, p3 = tri_corners
    return fn(
        params, data, prims, p1, p2, p3, model, model_inv, loss_scale
    )


sharded_normal_equations_jit = partial(
    jax.jit,
    static_argnames=("mesh", "loss_type", "opt_f", "opt_pp", "ppc"),
)(sharded_normal_equations)


@partial(
    jax.jit,
    static_argnames=("mesh", "loss_type", "opt_f", "opt_pp", "ppc"),
)
def sharded_refine_step(
    mesh: Mesh,
    params: TrajParams,
    data: RefinerData,
    prims,
    tri_corners,
    model,
    model_inv,
    loss_scale,
    lam,
    bounds: C.Bounds,
    *,
    loss_type: int,
    opt_f: bool,
    opt_pp: bool,
    ppc: int,
):
    """One full damped Gauss-Newton step of the sharded BA.

    Build (sharded, psum-reduced) normal equations, solve the damped
    system replicated, and step every non-anchor camera.  This is the
    jit target the multi-chip dry run compiles.
    """
    JtJ, Jtr = sharded_normal_equations(
        mesh, params, data, prims, tri_corners, model, model_inv,
        loss_scale, loss_type=loss_type, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc,
    )
    step, ok = damped_cholesky_solve(JtJ, Jtr, lam)
    new_params = apply_step(
        params, data, step, bounds, opt_f=opt_f, opt_pp=opt_pp, ppc=ppc
    )
    return new_params, jnp.linalg.norm(step), ok
