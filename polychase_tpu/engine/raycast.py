"""Batched ray casting against triangle meshes, with analytic Jacobians.

Device replacement for the reference's Embree path
(cpp/ray_casting.{h,cc}).  Two modes are provided:

- :func:`raycast` — brute-force batched Möller–Trumbore: every ray is tested
  against every triangle in fixed-size chunks via ``lax.scan``, keeping the
  closest hit.  This is exact and data-parallel for meshes up to a few
  hundred thousand triangles.  (A host-side C++ BVH in
  ``polychase_tpu/native`` covers the single-ray low-latency picking path.)
- :func:`intersect_ray_plane_jac` / :func:`intersect_ray_triangle` — the
  differentiable single-primitive intersections used by bundle adjustment
  (cpp/ray_casting.h:76-179).

Mask semantics match the reference exactly: the *closest* hit is found over
all triangles and then discarded if that triangle is masked
(cpp/ray_casting.cc:100-120) — masked triangles still occlude.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .geometry import Mesh, SceneTransformations
from . import camera

INVALID_ID = jnp.uint32(0xFFFFFFFF)


class RayHits(NamedTuple):
    """Batched ray-hit results (mirrors RayHit, cpp/ray_casting.h:15-21)."""

    pos: jax.Array  # (N, 3) hit position (object space)
    normal: jax.Array  # (N, 3) normalized geometric normal
    barycentric: jax.Array  # (N, 2) (u, v); pos = (1-u-v)p1 + u p2 + v p3
    t: jax.Array  # (N,) ray parameter
    prim_id: jax.Array  # (N,) uint32, INVALID_ID on miss
    valid: jax.Array  # (N,) bool


def _moller_trumbore(origins, dirs, p1, p2, p3):
    """Batched Möller–Trumbore: rays (N, 3) × triangles (T, 3) → (N, T).

    Returns (t, u, v, hit_mask).  Follows the reference's formulation and
    epsilon (cpp/ray_casting.h:125-179).
    """
    eps = 1e-10
    e1 = p2 - p1  # (T, 3)
    e2 = p3 - p1
    # ray_cross_e2: (N, T, 3)
    rce2 = jnp.cross(dirs[:, None, :], e2[None, :, :])
    det = jnp.sum(e1[None] * rce2, axis=-1)  # (N, T)
    ok = jnp.abs(det) > eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    s = origins[:, None, :] - p1[None]  # (N, T, 3)
    u = inv_det * jnp.sum(s * rce2, axis=-1)
    sce1 = jnp.cross(s, e1[None])  # (N, T, 3)
    v = inv_det * jnp.sum(dirs[:, None, :] * sce1, axis=-1)
    t = inv_det * jnp.sum(e2[None] * sce1, axis=-1)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 0)
    return t, u, v, hit


@partial(jax.jit, static_argnames=("check_mask", "chunk"))
def raycast(
    mesh: Mesh,
    origins: jax.Array,
    dirs: jax.Array,
    check_mask: bool = True,
    chunk: int = 1024,
) -> RayHits:
    """Closest-hit ray cast of N rays against the whole mesh.

    ``origins``/``dirs`` are (N, 3); direction need not be normalized
    (cpp/geometry.h:27-30).  Triangles are streamed in ``chunk``-sized blocks
    with a ``lax.scan`` so peak memory is O(N · chunk).
    """
    origins = jnp.atleast_2d(origins)
    dirs = jnp.atleast_2d(dirs)
    n = origins.shape[0]
    p1, p2, p3 = mesh.triangle_corners()
    num_tris = p1.shape[0]

    # Pad triangle arrays to a multiple of chunk with degenerate triangles.
    pad = (-num_tris) % chunk
    if pad:
        padrow = jnp.zeros((pad, 3), p1.dtype)
        p1 = jnp.concatenate([p1, padrow])
        p2 = jnp.concatenate([p2, padrow])
        p3 = jnp.concatenate([p3, padrow])
    num_chunks = (num_tris + pad) // chunk

    p1c = p1.reshape(num_chunks, chunk, 3)
    p2c = p2.reshape(num_chunks, chunk, 3)
    p3c = p3.reshape(num_chunks, chunk, 3)
    base_ids = jnp.arange(num_chunks, dtype=jnp.uint32) * jnp.uint32(chunk)

    init = (
        jnp.full((n,), jnp.inf, jnp.float32),  # best t
        jnp.zeros((n, 2), jnp.float32),  # best (u, v)
        jnp.full((n,), INVALID_ID),  # best prim
    )

    def body(carry, blk):
        best_t, best_uv, best_id = carry
        cp1, cp2, cp3, base = blk
        t, u, v, hit = _moller_trumbore(origins, dirs, cp1, cp2, cp3)
        tri_ids = base + jnp.arange(chunk, dtype=jnp.uint32)
        hit = hit & (tri_ids[None, :] < num_tris)
        t = jnp.where(hit, t, jnp.inf)
        j = jnp.argmin(t, axis=-1)  # (N,)
        tj = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
        closer = tj < best_t
        uj = jnp.take_along_axis(u, j[:, None], axis=-1)[:, 0]
        vj = jnp.take_along_axis(v, j[:, None], axis=-1)[:, 0]
        best_uv = jnp.where(
            closer[:, None], jnp.stack([uj, vj], axis=-1), best_uv
        )
        best_id = jnp.where(closer, base + j.astype(jnp.uint32), best_id)
        best_t = jnp.where(closer, tj, best_t)
        return (best_t, best_uv, best_id), None

    (best_t, best_uv, best_id), _ = jax.lax.scan(
        body, init, (p1c, p2c, p3c, base_ids)
    )

    valid = best_id != INVALID_ID
    if check_mask:
        masked = mesh.is_triangle_masked(jnp.where(valid, best_id, 0))
        valid = valid & ~masked

    safe_id = jnp.where(valid, best_id, 0).astype(jnp.int32)
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]
    u, v = best_uv[:, 0], best_uv[:, 1]
    pos = (1.0 - u - v)[:, None] * q1 + u[:, None] * q2 + v[:, None] * q3
    ng = jnp.cross(q2 - q1, q3 - q1)
    normal = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)

    return RayHits(
        pos=jnp.where(valid[:, None], pos, 0.0),
        normal=jnp.where(valid[:, None], normal, 0.0),
        barycentric=jnp.where(valid[:, None], best_uv, 0.0),
        t=jnp.where(valid, best_t, jnp.inf),
        prim_id=jnp.where(valid, best_id, INVALID_ID),
        valid=valid,
    )


@partial(jax.jit, static_argnames=("check_mask", "chunk"))
def raycast_grouped(
    mesh: Mesh,
    origins: jax.Array,   # (G, 3) one shared origin per ray group
    dirs: jax.Array,      # (G, K, 3)
    check_mask: bool = True,
    chunk: int = 0,
) -> RayHits:
    """Closest-hit cast of G groups of K rays sharing one origin per group.

    This is the hot batched shape — the tracker casts all of a frame's
    keypoint rays from that frame's camera center, and the refiner's
    prim-cache sweep casts (frame, keypoint) rays frame by frame
    (cpp/refiner.cc:307-349).  A shared origin lets every Möller-Trumbore
    scalar triple product factor into per-triangle constants contracted
    against the ray direction:

        det   = d · (e2 × e1)
        u·det = d · (e2 × (o − v0))
        v·det = d · ((o − v0) × e1)
        t·det =      e2 · ((o − v0) × e1)

    so a triangle chunk costs three (K,3)x(3,Tc) contractions plus
    elementwise tests — no (N, T, 3) cross-product intermediates like the
    general :func:`raycast`, ~3x less arithmetic and far less HBM
    traffic.  Returns RayHits with (G, K) leading dims.
    """
    origins = jnp.asarray(origins, jnp.float32).reshape(-1, 3)
    G = origins.shape[0]
    dirs = jnp.asarray(dirs, jnp.float32).reshape(G, -1, 3)
    K = dirs.shape[1]
    p1, p2, p3 = mesh.triangle_corners()
    num_tris = p1.shape[0]

    if chunk <= 0:
        # Keep the (G, K, Tc) intermediates around ~32M elements.
        chunk = max(64, min(4096, (1 << 25) // max(G * K, 1)))
        chunk = max(64, (chunk // 64) * 64)
        if num_tris < chunk:
            # Small mesh: don't sweep padding; cover it with the next
            # power of two (not measured on the GPU).
            cover = 64
            while cover < num_tris:
                cover *= 2
            chunk = cover

    pad = (-num_tris) % chunk
    if pad:
        padrow = jnp.zeros((pad, 3), p1.dtype)
        p1 = jnp.concatenate([p1, padrow])
        p2 = jnp.concatenate([p2, padrow])
        p3 = jnp.concatenate([p3, padrow])
    num_chunks = (num_tris + pad) // chunk

    p1c = p1.reshape(num_chunks, chunk, 3)
    e1c = (p2 - p1).reshape(num_chunks, chunk, 3)
    e2c = (p3 - p1).reshape(num_chunks, chunk, 3)
    base_ids = jnp.arange(num_chunks, dtype=jnp.uint32) * jnp.uint32(chunk)
    eps = 1e-10

    init = (
        jnp.full((G, K), jnp.inf, jnp.float32),
        jnp.full((G, K), INVALID_ID),
    )

    d0 = dirs[..., 0:1]  # (G, K, 1) — broadcast against (G, 1, Tc)
    d1 = dirs[..., 1:2]
    d2 = dirs[..., 2:3]

    def body(carry, blk):
        # The chunk body carries ONLY (best_t, best_id): the hit test is
        # sign arithmetic on the undivided determinants (u·det, v·det
        # against |det| — multiplying by ±1 is exact in f32) and the
        # barycentrics of the winning triangle are recomputed once per
        # ray after the scan.  This keeps the whole body a single fused
        # pass per (G, K, Tc) tile — the previous form materialized u
        # and v as full HBM arrays just so take_along_axis could read
        # one element each after the argmin.
        best_t, best_id = carry
        v0, e1, e2, base = blk                      # (Tc, 3)
        A = jnp.cross(e2, e1)                       # (Tc, 3)
        omv = origins[:, None, :] - v0[None]        # (G, Tc, 3)
        B = jnp.cross(e2[None], omv)                # (G, Tc, 3)
        Cq = jnp.cross(omv, e1[None])               # (G, Tc, 3)
        sdet = jnp.sum(e2[None] * Cq, axis=-1)      # (G, Tc)

        # Contractions over the 3-dim as explicit broadcast FMAs: XLA
        # fuses them with the tests below into one pass over (G, K, Tc)
        # (an einsum with inner dim 3 would become a tiny matmul).
        def dot3(x0, x1, x2):  # each (G, 1, Tc) or (1, 1, Tc) -> (G, K, Tc)
            return d0 * x0 + d1 * x1 + d2 * x2

        det = dot3(A[None, None, :, 0], A[None, None, :, 1],
                   A[None, None, :, 2])
        udet = dot3(B[:, None, :, 0], B[:, None, :, 1], B[:, None, :, 2])
        vdet = dot3(Cq[:, None, :, 0], Cq[:, None, :, 1], Cq[:, None, :, 2])

        s = jnp.where(det >= 0, 1.0, -1.0)
        adet = det * s                              # |det|
        u_, v_ = udet * s, vdet * s
        t_ = sdet[:, None, :] * s
        tri_ids = base + jnp.arange(chunk, dtype=jnp.uint32)
        hit = (
            (adet > eps) & (u_ >= 0) & (v_ >= 0) & (u_ + v_ <= adet)
            & (t_ > 0) & (tri_ids[None, None, :] < num_tris)
        )
        t = jnp.where(hit, t_ / jnp.where(hit, adet, 1.0), jnp.inf)
        j = jnp.argmin(t, axis=-1)                  # (G, K)
        tj = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
        closer = tj < best_t
        best_id = jnp.where(closer, base + j.astype(jnp.uint32), best_id)
        best_t = jnp.where(closer, tj, best_t)
        return (best_t, best_id), None

    (best_t, best_id), _ = jax.lax.scan(
        body, init, (p1c, e1c, e2c, base_ids)
    )

    valid = best_id != INVALID_ID
    if check_mask:
        masked = mesh.is_triangle_masked(jnp.where(valid, best_id, 0))
        valid = valid & ~masked

    safe_id = jnp.where(valid, best_id, 0).astype(jnp.int32)
    q1, q2, q3 = p1[safe_id], p2[safe_id], p3[safe_id]

    # Recompute the winning triangle's barycentrics: one Möller-Trumbore
    # evaluation per ray against its own best triangle — (G, K) work,
    # negligible beside the (G, K, Tc) sweep it replaces.
    be1, be2 = q2 - q1, q3 - q1
    bomv = origins[:, None, :] - q1                 # (G, K, 3)
    bB = jnp.cross(be2, bomv)
    bCq = jnp.cross(bomv, be1)
    bdet = jnp.sum(dirs * jnp.cross(be2, be1), axis=-1)
    # The winner passed the in-scan |det| > eps test, but this recompute
    # can round differently (different fusion order); f32 cancellation
    # noise near a grazing hit could reach 0 or flip sign.  Fold that
    # degenerate case into ``valid`` so a valid hit can never carry
    # non-finite barycentrics/pos into the PnP solve.
    bdet_ok = jnp.abs(bdet) > eps
    valid = valid & bdet_ok
    binv = jnp.where(valid, 1.0 / jnp.where(bdet_ok, bdet, 1.0), 0.0)
    u = jnp.sum(dirs * bB, axis=-1) * binv
    v = jnp.sum(dirs * bCq, axis=-1) * binv
    best_uv = jnp.stack([u, v], axis=-1)
    pos = (
        (1.0 - u - v)[..., None] * q1
        + u[..., None] * q2
        + v[..., None] * q3
    )
    ng = jnp.cross(q2 - q1, q3 - q1)
    normal = ng / jnp.maximum(
        jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-20
    )

    return RayHits(
        pos=jnp.where(valid[..., None], pos, 0.0),
        normal=jnp.where(valid[..., None], normal, 0.0),
        barycentric=jnp.where(valid[..., None], best_uv, 0.0),
        t=jnp.where(valid, best_t, jnp.inf),
        prim_id=jnp.where(valid, best_id, INVALID_ID),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# Screen-point → ray helpers (cpp/ray_casting.h:53-74)
# ---------------------------------------------------------------------------


_HI = jax.lax.Precision.HIGHEST


def get_ray_object_space(scene: SceneTransformations, pos: jax.Array):
    """Unproject a pixel into an object-space ray (cpp/ray_casting.h:53-63)."""
    mat = jnp.linalg.inv(
        jnp.matmul(scene.view_matrix, scene.model_matrix, precision=_HI)
    )
    origin = mat[:3, 3]
    direction = jnp.matmul(
        mat[:3, :3], camera.unproject(scene.intrinsics, pos), precision=_HI
    )
    return origin, direction


def get_ray_world_space(scene: SceneTransformations, pos: jax.Array):
    """Unproject a pixel into a world-space ray (cpp/ray_casting.h:65-74)."""
    mat = jnp.linalg.inv(scene.view_matrix)
    origin = mat[:3, 3]
    direction = jnp.matmul(
        mat[:3, :3], camera.unproject(scene.intrinsics, pos), precision=_HI
    )
    return origin, direction


# ---------------------------------------------------------------------------
# Differentiable intersections for bundle adjustment
# ---------------------------------------------------------------------------


def intersect_ray_plane_jac(origin, direction, plane_point, plane_normal):
    """Ray–plane intersection with Jacobians (cpp/ray_casting.h:76-112).

    Batched over leading dims.  Returns ``(x, jac_origin, jac_dir, ok)``:
    ``jac_origin = I − d nᵀ / (d·n)``, ``jac_dir = jac_origin · t``.
    Intermediate dot products run in float64-equivalent precision by
    promoting to float32 accumulation (the reference uses double here).
    """
    d_dot_n = jnp.sum(direction * plane_normal, axis=-1)
    ok = jnp.abs(d_dot_n) > 1e-10
    safe = jnp.where(ok, d_dot_n, 1.0)
    t = jnp.sum((plane_point - origin) * plane_normal, axis=-1) / safe
    x = origin + direction * t[..., None]
    dn = (
        direction[..., :, None]
        * plane_normal[..., None, :]
        / safe[..., None, None]
    )
    eye = jnp.eye(3, dtype=direction.dtype)
    jac_origin = eye - dn
    jac_dir = jac_origin * t[..., None, None]
    return x, jac_origin, jac_dir, ok


def intersect_ray_triangle(origin, direction, p1, p2, p3):
    """Single ray–triangle Möller–Trumbore (cpp/ray_casting.h:125-162).

    Batched over leading dims.  Returns ``(x, ok)``.
    """
    eps = 1e-10
    e1, e2 = p2 - p1, p3 - p1
    rce2 = jnp.cross(direction, e2)
    det = jnp.sum(e1 * rce2, axis=-1)
    ok = jnp.abs(det) > eps
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    s = origin - p1
    u = inv_det * jnp.sum(s * rce2, axis=-1)
    sce1 = jnp.cross(s, e1)
    v = inv_det * jnp.sum(direction * sce1, axis=-1)
    t = inv_det * jnp.sum(e2 * sce1, axis=-1)
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t >= 0)
    x = origin + direction * t[..., None]
    return x, ok
