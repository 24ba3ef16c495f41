"""Geometry primitives: triangles, planes, rays, bboxes, meshes.

Rebuild of cpp/geometry.h.  The ``Mesh`` pytree keeps vertices,
triangle indices and the packed triangle bitmask as JAX arrays so that
masking is a vectorized bit test on device (cpp/geometry.h:114-151).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Bbox3(NamedTuple):
    pmin: jax.Array  # (3,)
    pmax: jax.Array  # (3,)

    def contains(self, p) -> jax.Array:
        return jnp.all((p > self.pmin) & (p < self.pmax), axis=-1)


class Bbox2(NamedTuple):
    pmin: jax.Array  # (2,)
    pmax: jax.Array  # (2,)

    def contains(self, p) -> jax.Array:
        return jnp.all((p > self.pmin) & (p < self.pmax), axis=-1)


def mask_array_size(num_triangles: int) -> int:
    """Packed-u32 mask length padded to a uvec4 multiple
    (cpp/geometry.h:63-70)."""
    n = (num_triangles + 31) // 32
    return n + (4 - n % 4) % 4


class Mesh(NamedTuple):
    """Triangle mesh + packed per-triangle mask bits (cpp/geometry.h:52-96).

    ``vertices`` (V, 3) float32; ``triangles`` (T, 3) uint32;
    ``masked_triangles`` (ceil(T/32) padded to 4,) uint32 bitmask.
    """

    vertices: jax.Array
    triangles: jax.Array
    masked_triangles: jax.Array
    bbox: Bbox3

    @staticmethod
    def create(vertices, triangles, masked_triangles=None) -> "Mesh":
        vertices = jnp.asarray(vertices, jnp.float32)
        triangles = jnp.asarray(triangles, jnp.uint32)
        size = mask_array_size(int(triangles.shape[0]))
        if masked_triangles is None or np.size(masked_triangles) == 0:
            masked_triangles = jnp.zeros((size,), jnp.uint32)
        else:
            masked_triangles = jnp.asarray(masked_triangles, jnp.uint32)
            if masked_triangles.shape[0] < size:
                raise ValueError(
                    f"masked_triangles too short: {masked_triangles.shape[0]}"
                    f" < {size}"
                )
        bbox = Bbox3(
            jnp.min(vertices, axis=0) if vertices.shape[0] else jnp.zeros(3),
            jnp.max(vertices, axis=0) if vertices.shape[0] else jnp.zeros(3),
        )
        return Mesh(vertices, triangles, masked_triangles, bbox)

    @property
    def num_triangles(self) -> int:
        return int(self.triangles.shape[0])

    def triangle_corners(self):
        """Gather per-triangle corner positions → three (T, 3) arrays."""
        v = self.vertices
        t = self.triangles.astype(jnp.int32)
        return v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]

    def is_triangle_masked(self, tri_idx) -> jax.Array:
        """Vectorized bit test (cpp/geometry.h:114-121)."""
        tri_idx = jnp.asarray(tri_idx, jnp.uint32)
        elem = self.masked_triangles[(tri_idx // 32).astype(jnp.int32)]
        return (elem >> (tri_idx % 32)) & 1 != 0

    def with_masked(self, masked_triangles) -> "Mesh":
        return self._replace(
            masked_triangles=jnp.asarray(masked_triangles, jnp.uint32)
        )


def set_mask_bits(masked: np.ndarray, tri_idx: int, op: str) -> np.ndarray:
    """Host-side mask/unmask/toggle of one triangle bit
    (cpp/geometry.h:123-151)."""
    masked = np.asarray(masked, np.uint32).copy()
    elem, bit = tri_idx // 32, np.uint32(1) << np.uint32(tri_idx % 32)
    if op == "mask":
        masked[elem] |= bit
    elif op == "unmask":
        masked[elem] &= ~bit
    elif op == "toggle":
        masked[elem] ^= bit
    else:
        raise ValueError(op)
    return masked


class SceneTransformations(NamedTuple):
    """Model matrix + view matrix + intrinsics (cpp/geometry.h:156-163)."""

    model_matrix: jax.Array  # (4, 4) object→world
    view_matrix: jax.Array  # (4, 4) world→camera
    intrinsics: "Intrinsics"  # noqa: F821


# TransformationType (cpp/geometry.h:165-168)
TRANSFORM_CAMERA = 0
TRANSFORM_MODEL = 1


