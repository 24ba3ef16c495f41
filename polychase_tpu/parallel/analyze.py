"""Multi-device sharding of the Analyze (optical-flow) fan-out.

SURVEY §2.4 row 1: the reference's per-skip-pair TBB pool
(cpp/opticalflow.cc:269-309) maps to sharding the *target-frame axis* of
the multi-target LK solve over a 1-D device mesh — each device tracks the
shared source frame's features into its shard of the ±{1,2,4,8} skip
targets.  There is no cross-target communication, so the only collective
cost is the result gather.

The source frame's prepared pyramid (images + derivatives + the shared
per-feature normal matrices) is replicated; the stacked target images are
sharded on their leading axis.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec
from jax import shard_map

from ..engine import lk as _lk

TARGET_AXIS = "targets"


def make_target_mesh(devices=None) -> Mesh:
    """1-D device mesh over which LK targets are sharded."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (TARGET_AXIS,))


@partial(
    jax.jit,
    static_argnames=("mesh", "win", "max_iters", "levels"),
)
def sharded_lk_multi(
    mesh: Mesh,
    prev_levels,            # per level: (img, dx, dy, shape) — replicated
    next_images_stacked,    # per level: (T, Hp, Wp) — sharded on T
    pts,                    # (N, 2) full-res positions — replicated
    eps2,
    min_eig_thr,
    *,
    win: int,
    max_iters: int,
    levels: int,
):
    """Target-sharded coarse-to-fine LK (XLA path).

    ``T`` must be a multiple of the mesh size (pad with copies of the
    source images; their outputs are dropped by the caller).  Returns the
    same (T, N, 2)/(T, N)/(T, N) tuple as ``_lk_all_levels_multi``.
    """
    target = PSpec(TARGET_AXIS)

    # shard_map body: each device runs the plain multi-target program on
    # its local shard of the stacked images (no collectives needed).
    def body(next_images_local):
        return _lk._lk_all_levels_multi(
            prev_levels, next_images_local, pts, eps2, min_eig_thr,
            win=win, max_iters=max_iters, levels=levels,
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(tuple(target for _ in range(levels)),),
        out_specs=(target, target, target),
        check_vma=False,
    )
    return fn(next_images_stacked)


def shard_targets(mesh: Mesh, stacked) -> tuple:
    """device_put per-level stacked target images with the target sharding."""
    sh = NamedSharding(mesh, PSpec(TARGET_AXIS))
    return tuple(jax.device_put(s, sh) for s in stacked)


# ---------------------------------------------------------------------------
# Feature-axis sharding: the axis that actually grows (a 4K noise frame
# keeps ~170k corners while T is capped at 8 by the skip pattern).
# Features are independent, so there are no collectives; target images
# are replicated across the mesh and each device iterates its feature
# shard into every target.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh", "win", "max_iters", "levels"))
def sharded_lk_multi_feat(
    mesh: Mesh,
    prev_levels,            # per level: (img, dx, dy, shape) — replicated
    next_images_stacked,    # per level: (T, Hp, Wp) — replicated
    pts,                    # (N, 2) — sharded on N
    eps2,
    min_eig_thr,
    *,
    win: int,
    max_iters: int,
    levels: int,
):
    """Feature-sharded coarse-to-fine LK (XLA path).

    ``N`` must be a multiple of the mesh size (callers pad; padded rows
    solve a zero-motion problem at (0, 0) and are dropped on unpad)."""
    feat = PSpec(TARGET_AXIS)

    def body(pts_local):
        return _lk._lk_all_levels_multi(
            prev_levels, next_images_stacked, pts_local, eps2, min_eig_thr,
            win=win, max_iters=max_iters, levels=levels,
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(feat,),
        out_specs=(
            PSpec(None, TARGET_AXIS),
            PSpec(None, TARGET_AXIS),
            PSpec(None, TARGET_AXIS),
        ),
        check_vma=False,
    )
    return fn(pts)


# ---------------------------------------------------------------------------
# Chained skip-fan phases with the feature axis sharded: chaining
# (engine.lk._chained_dispatch) composes with feature sharding because
# seeds are per-feature — each device seeds its own shard from its own
# shard of the previous phase's result, still with zero collectives.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh", "win", "max_iters", "levels"))
def sharded_lk_chain_phase(
    mesh: Mesh, prev_levels, next_images_stacked, pts, src_nxt, src_status,
    scales, eps2, min_eig_thr, *, win, max_iters, levels,
):
    """One chained phase (T slots), feature-sharded.

    ``prev_levels`` and the target images are replicated; points and
    seeds shard with the features."""
    feat = PSpec(TARGET_AXIS)
    tfeat = PSpec(None, TARGET_AXIS)

    def body(pts_local, src_nxt_l, src_st_l):
        init = jnp.where(
            src_st_l[..., None],
            (src_nxt_l - pts_local[None]) * scales[:, None, None],
            0.0,
        )
        return _lk._lk_all_levels_multi(
            prev_levels, next_images_stacked, pts_local, eps2, min_eig_thr,
            init_flow=init, win=win, max_iters=max_iters, levels=levels,
        )

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(feat, tfeat, tfeat),
        out_specs=(tfeat, tfeat, tfeat),
        check_vma=False,
    )
    return fn(pts, src_nxt, src_status)
