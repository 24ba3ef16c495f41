"""Uniform-grid accelerated ray casting on device.

Device analogue of the reference's Embree BVH
(cpp/ray_casting.cc:21-121).  A BVH's per-ray recursive traversal with a
node stack is hostile to a lockstep vector machine, so the acceleration
structure here is a uniform voxel grid:

- **Build** (host, once per mesh — the Embree-build analogue): every
  triangle is conservatively binned into the grid cells its bbox
  overlaps; the (cell → triangle) lists are stored CSR-style as two flat
  int32 arrays that live on device afterwards.
- **Traverse** (device): all N rays walk the grid in lockstep with the
  Amanatides–Woo 3D-DDA inside ONE ``lax.while_loop``.  Each iteration a
  ray either tests a small block of its current cell's candidate
  triangles (gather + batched Möller–Trumbore across all rays) or
  steps to the next cell.  A ray terminates when its best hit
  lies before the exit of the current cell — because binning is
  conservative, every triangle intersecting the ray closer than that has
  already been tested — so the result is EXACT closest-hit, bit-matching
  the brute-force sweep in engine/raycast.py up to tie order.

Mask semantics match the reference: the closest hit is found over all
triangles (masked ones still occlude) and then discarded if that
triangle is masked (cpp/ray_casting.cc:100-120).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import Mesh
from .raycast import INVALID_ID, RayHits

_BIG = jnp.float32(np.inf)


class GridAccel(NamedTuple):
    """Device-resident uniform grid over a mesh (pytree of arrays).

    ``cell_start`` has ``prod(res) + 1`` CSR offsets into ``items`` (the
    flat cell→triangle lists, x-major: ``flat = (ix·ry + iy)·rz + iz``).
    ``res`` is an int32 (3,) array so one jitted traversal program is
    reused across meshes whose item/cell array sizes happen to match.
    """

    cell_start: jax.Array  # (prod(res) + 1,) int32
    items: jax.Array  # (max(n_items, 1),) int32 triangle ids
    item_data: jax.Array  # (max(n_items, 1), 12) f32 [p1, e1, e2, id, 0, 0]
    lo: jax.Array  # (3,) f32 grid origin
    h: jax.Array  # (3,) f32 cell size
    res: jax.Array  # (3,) int32 cells per axis


def build_grid_accel(
    vertices,
    triangles,
    max_cells: int = 1 << 21,
    max_mean_items: float = 12.0,
) -> GridAccel:
    """Host-side grid build (the ``AcceleratedMesh`` build step).

    Resolution is chosen so the grid holds ~2 cells per triangle
    (anisotropic, proportional to the mesh extent per axis) and is
    halved until conservative bbox binning keeps the mean items-per-
    triangle below ``max_mean_items`` — a skewed mesh (e.g. one huge
    ground plane) degrades resolution instead of exploding memory.
    """
    v = np.asarray(jax.device_get(vertices), np.float64)
    tri = np.asarray(jax.device_get(triangles), np.int64)
    T = tri.shape[0]
    if T == 0 or v.shape[0] == 0:
        return GridAccel(
            cell_start=jnp.zeros(2, jnp.int32),
            items=jnp.zeros(1, jnp.int32),
            item_data=jnp.zeros((1, 12), jnp.float32),
            lo=jnp.zeros(3, jnp.float32),
            h=jnp.ones(3, jnp.float32),
            res=jnp.ones(3, jnp.int32),
        )

    p = v[tri]  # (T, 3, 3)
    tlo = p.min(axis=1)
    thi = p.max(axis=1)
    lo = tlo.min(axis=0)
    hi = thi.max(axis=0)
    pad = 1e-6 * max(float((hi - lo).max()), 1.0)
    lo = lo - pad
    hi = hi + pad
    extent = np.maximum(hi - lo, 4 * pad)

    total = float(min(max_cells, max(8, 2 * T)))
    scale = (total / float(extent.prod())) ** (1.0 / 3.0)
    res = np.maximum(1, np.floor(extent * scale).astype(np.int64))
    # Degenerate axes clamp to 1 cell, which can inflate the product far
    # past the budget on thin meshes — enforce it explicitly.
    while res.prod() > max_cells:
        res = np.maximum(1, res // 2)

    while True:
        h = extent / res
        c0 = np.clip(((tlo - lo) / h).astype(np.int64), 0, res - 1)
        c1 = np.clip(((thi - lo) / h).astype(np.int64), 0, res - 1)
        span = c1 - c0 + 1  # (T, 3)
        counts = span.prod(axis=1)
        n_items = int(counts.sum())
        if n_items <= max_mean_items * T or (res == 1).all():
            break
        res = np.maximum(1, res // 2)

    # Emit (cell, tri) pairs without a Python loop: a global item index
    # is decomposed into (triangle, local xyz offset inside its span).
    tri_of = np.repeat(np.arange(T, dtype=np.int64), counts)
    first = np.concatenate(([0], np.cumsum(counts)[:-1]))
    local = np.arange(n_items, dtype=np.int64) - np.repeat(first, counts)
    span_t = span[tri_of]
    nyz = span_t[:, 1] * span_t[:, 2]
    lx = local // nyz
    rem = local - lx * nyz
    ly = rem // span_t[:, 2]
    lz = rem - ly * span_t[:, 2]
    cx = c0[tri_of, 0] + lx
    cy = c0[tri_of, 1] + ly
    cz = c0[tri_of, 2] + lz
    flat = (cx * res[1] + cy) * res[2] + cz

    order = np.argsort(flat, kind="stable")
    flat_sorted = flat[order]
    items = tri_of[order].astype(np.int32)
    n_cells = int(res.prod())
    cell_start = np.zeros(n_cells + 1, np.int64)
    np.add.at(cell_start, flat_sorted + 1, 1)
    cell_start = np.cumsum(cell_start)

    if n_items == 0:
        items = np.zeros(1, np.int32)
    # Pre-gathered per-item triangle data so the traversal loop does ONE
    # wide gather per candidate instead of four narrow ones.
    pf = p.astype(np.float32)
    item_data = np.zeros((items.shape[0], 12), np.float32)
    ids = items if n_items else np.zeros(1, np.int64)
    item_data[:, 0:3] = pf[ids, 0]
    item_data[:, 3:6] = pf[ids, 1] - pf[ids, 0]
    item_data[:, 6:9] = pf[ids, 2] - pf[ids, 0]
    # Triangle id stored as the ordinary float value (id + 2^23): exact
    # in float32 for id < 2^23 and never denormal, so canonicalizing /
    # flush-to-zero ops on item_data cannot corrupt it (a raw bitcast of
    # small ids would be a denormal bit pattern).
    if T >= (1 << 23):
        raise ValueError("grid accel supports < 2^23 triangles")
    item_data[:, 9] = (ids.astype(np.float64) + float(1 << 23)).astype(
        np.float32
    )

    return GridAccel(
        cell_start=jnp.asarray(cell_start.astype(np.int32)),
        items=jnp.asarray(items),
        item_data=jnp.asarray(item_data),
        lo=jnp.asarray(lo.astype(np.float32)),
        h=jnp.asarray(h.astype(np.float32)),
        res=jnp.asarray(res.astype(np.int32)),
    )


def _slab_entry(lo, hi, origins, dirs):
    """Entry/exit parameters of rays vs the grid AABB, axis-degenerate
    directions handled explicitly.  Returns (t0, t1); hit iff t1 >= t0
    and t1 >= 0 (with finite t0)."""
    d0 = dirs == 0.0
    inv = 1.0 / jnp.where(d0, 1.0, dirs)
    near = jnp.where(d0, jnp.where(origins >= lo, -_BIG, _BIG),
                     (lo - origins) * inv)
    far = jnp.where(d0, jnp.where(origins <= hi, _BIG, -_BIG),
                    (hi - origins) * inv)
    # d==0 outside the slab: force rejection via t0 = +inf (setting
    # far = -inf instead would re-sort into an unconstrained interval).
    bad = d0 & ((origins < lo) | (origins > hi))
    near = jnp.where(bad, _BIG, near)
    far = jnp.where(bad, _BIG, far)
    a = jnp.minimum(near, far)
    b = jnp.maximum(near, far)
    t0 = jnp.max(a, axis=-1)
    t1 = jnp.min(b, axis=-1)
    return t0, t1


def _moller_block(o, d, p1, e1, e2):
    """Möller–Trumbore on (N, B, 3) candidate blocks; o/d are (N, 1, 3).

    Takes precomputed edges (p2-p1, p3-p1); same formulation and epsilon
    as engine/raycast.py so grid results bit-match the brute sweep."""
    eps = 1e-10
    rce2 = jnp.cross(d, e2)
    det = jnp.sum(e1 * rce2, axis=-1)
    ok = jnp.abs(det) > eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    s = o - p1
    u = inv_det * jnp.sum(s * rce2, axis=-1)
    sce1 = jnp.cross(s, e1)
    v = inv_det * jnp.sum(d * sce1, axis=-1)
    t = inv_det * jnp.sum(e2 * sce1, axis=-1)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return t, u, v, hit


@partial(jax.jit, static_argnames=("check_mask", "block", "max_iters"))
def grid_raycast(
    mesh: Mesh,
    accel: GridAccel,
    origins: jax.Array,  # (N, 3)
    dirs: jax.Array,  # (N, 3)
    check_mask: bool = True,
    block: int = 4,
    max_iters: int = 200_000,
) -> RayHits:
    """Closest-hit cast of N rays through the grid (flat shapes).

    Exact (up to tie order) replacement for :func:`raycast.raycast` on
    large meshes: O(candidates along the ray) per ray instead of
    O(num_triangles)."""
    origins = jnp.atleast_2d(jnp.asarray(origins, jnp.float32))
    dirs = jnp.atleast_2d(jnp.asarray(dirs, jnp.float32))
    n = origins.shape[0]
    if mesh.num_triangles == 0:
        return RayHits(
            pos=jnp.zeros((n, 3), jnp.float32),
            normal=jnp.zeros((n, 3), jnp.float32),
            barycentric=jnp.zeros((n, 2), jnp.float32),
            t=jnp.full((n,), _BIG),
            prim_id=jnp.full((n,), INVALID_ID),
            valid=jnp.zeros((n,), bool),
        )
    p1, p2, p3 = mesh.triangle_corners()
    ni = accel.items.shape[0]

    res = accel.res
    glo = accel.lo
    ghi = accel.lo + accel.h * res.astype(jnp.float32)

    t0, t1 = _slab_entry(glo, ghi, origins, dirs)
    inside = (t1 >= jnp.maximum(t0, 0.0)) & (t0 < _BIG)
    t_start = jnp.maximum(t0, 0.0)

    pstart = origins + dirs * t_start[:, None]
    cell = jnp.clip(
        jnp.floor((pstart - glo) / accel.h).astype(jnp.int32),
        0,
        res - 1,
    )  # (N, 3)

    step = jnp.sign(dirs).astype(jnp.int32)
    d0 = dirs == 0.0
    safe_d = jnp.where(d0, 1.0, dirs)
    # Parameter of the next boundary crossing per axis from the start cell.
    next_bound = glo + (cell + jnp.where(step > 0, 1, 0)).astype(
        jnp.float32
    ) * accel.h
    tmax = jnp.where(d0, _BIG, (next_bound - origins) / safe_d)
    tdelta = jnp.where(d0, _BIG, jnp.abs(accel.h / safe_d))

    def flat_of(c):
        return (c[:, 0] * res[1] + c[:, 1]) * res[2] + c[:, 2]

    f0 = flat_of(cell)
    ptr = jnp.where(inside, accel.cell_start[f0], 0)
    end = jnp.where(inside, accel.cell_start[f0 + 1], 0)

    barange = jnp.arange(block, dtype=jnp.int32)

    state = dict(
        it=jnp.int32(0),
        active=inside,
        cell=cell,
        tmax=tmax,
        ptr=ptr,
        end=end,
        best_t=jnp.full((n,), _BIG),
        best_uv=jnp.zeros((n, 2), jnp.float32),
        best_id=jnp.full((n,), INVALID_ID),
    )

    o_b = origins[:, None, :]
    d_b = dirs[:, None, :]

    def cond(s):
        return jnp.any(s["active"]) & (s["it"] < max_iters)

    def body(s):
        active, cell, tmax = s["active"], s["cell"], s["tmax"]
        ptr, end = s["ptr"], s["end"]
        best_t, best_uv, best_id = s["best_t"], s["best_uv"], s["best_id"]

        has = ptr < end
        do_cand = active & has

        # --- candidate phase: test a block of the current cell's list ---
        idx = ptr[:, None] + barange[None, :]  # (N, B)
        cval = do_cand[:, None] & (idx < end[:, None])
        blob = accel.item_data[jnp.clip(idx, 0, ni - 1)]  # (N, B, 12)
        ids = blob[..., 9].astype(jnp.int32) - (1 << 23)
        ids = jnp.where(cval, ids, 0)
        t, u, v, hit = _moller_block(
            o_b, d_b, blob[..., 0:3], blob[..., 3:6], blob[..., 6:9]
        )
        hit = hit & cval
        t = jnp.where(hit, t, _BIG)
        j = jnp.argmin(t, axis=-1)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        closer = tj < best_t
        uj = jnp.take_along_axis(u, j[:, None], axis=-1)[:, 0]
        vj = jnp.take_along_axis(v, j[:, None], axis=-1)[:, 0]
        idj = jnp.take_along_axis(ids, j[:, None], axis=-1)[:, 0]
        best_uv = jnp.where(
            closer[:, None], jnp.stack([uj, vj], axis=-1), best_uv
        )
        best_id = jnp.where(closer, idj.astype(jnp.uint32), best_id)
        best_t = jnp.where(closer, tj, best_t)
        ptr = jnp.where(do_cand, jnp.minimum(ptr + block, end), ptr)

        # --- advance phase: cell exhausted → finish or DDA-step ---
        do_adv = active & ~has
        t_exit = jnp.min(tmax, axis=-1)
        hit_done = best_t <= t_exit
        axis = jnp.argmin(tmax, axis=-1)  # (N,)
        onehot = axis[:, None] == jnp.arange(3)[None, :]
        newcell = cell + jnp.where(onehot, step, 0)
        oob = jnp.any((newcell < 0) | (newcell >= res), axis=-1)
        done = do_adv & (hit_done | oob)
        move = do_adv & ~done
        cell = jnp.where(move[:, None], newcell, cell)
        tmax = jnp.where(move[:, None] & onehot, tmax + tdelta, tmax)
        fc = flat_of(cell)
        s_new = accel.cell_start[fc]
        e_new = accel.cell_start[fc + 1]
        ptr = jnp.where(move, s_new, ptr)
        end = jnp.where(move, e_new, end)

        return dict(
            it=s["it"] + 1,
            active=active & ~done,
            cell=cell,
            tmax=tmax,
            ptr=ptr,
            end=end,
            best_t=best_t,
            best_uv=best_uv,
            best_id=best_id,
        )

    out = jax.lax.while_loop(cond, body, state)
    best_t, best_uv, best_id = out["best_t"], out["best_uv"], out["best_id"]

    valid = best_id != INVALID_ID
    if check_mask:
        masked = mesh.is_triangle_masked(jnp.where(valid, best_id, 0))
        valid = valid & ~masked

    safe_id = jnp.where(valid, best_id, 0).astype(jnp.int32)
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]
    u, v = best_uv[:, 0], best_uv[:, 1]
    pos = (1.0 - u - v)[:, None] * q1 + u[:, None] * q2 + v[:, None] * q3
    ng = jnp.cross(q2 - q1, q3 - q1)
    normal = ng / jnp.maximum(
        jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20
    )

    return RayHits(
        pos=jnp.where(valid[:, None], pos, 0.0),
        normal=jnp.where(valid[:, None], normal, 0.0),
        barycentric=jnp.where(valid[:, None], best_uv, 0.0),
        t=jnp.where(valid, best_t, _BIG),
        prim_id=jnp.where(valid, best_id, INVALID_ID),
        valid=valid,
    )


def grid_raycast_grouped(
    mesh: Mesh,
    accel: GridAccel,
    origins: jax.Array,  # (G, 3)
    dirs: jax.Array,  # (G, K, 3)
    check_mask: bool = True,
    block: int = 4,
) -> RayHits:
    """Grouped-shape wrapper matching raycast.raycast_grouped: G groups
    of K rays sharing one origin per group, results with (G, K) dims."""
    origins = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    G = origins.shape[0]
    dirs = jnp.asarray(dirs, jnp.float32).reshape(G, -1, 3)
    K = dirs.shape[1]
    o_flat = jnp.broadcast_to(origins[:, None, :], (G, K, 3)).reshape(-1, 3)
    hits = grid_raycast(
        mesh, accel, o_flat, dirs.reshape(-1, 3), check_mask, block
    )
    return RayHits(
        pos=hits.pos.reshape(G, K, 3),
        normal=hits.normal.reshape(G, K, 3),
        barycentric=hits.barycentric.reshape(G, K, 2),
        t=hits.t.reshape(G, K),
        prim_id=hits.prim_id.reshape(G, K),
        valid=hits.valid.reshape(G, K),
    )
