"""Native BVH ray caster vs the device-side brute-force reference."""

import numpy as np
import jax.numpy as jnp
import pytest

from polychase_tpu import native
from polychase_tpu.engine.raycast import raycast
from polychase_tpu.engine.geometry import set_mask_bits

from synthetic import make_sphere_mesh

pytestmark = pytest.mark.skipif(
    not native.available(), reason="no C++ toolchain for the native BVH"
)


def random_rays(rng, n=500):
    origins = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    origins *= (3.0 / np.linalg.norm(origins, axis=1, keepdims=True))
    targets = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    dirs = targets - origins
    return origins, dirs


def test_bvh_matches_brute_force(rng):
    mesh = make_sphere_mesh(16, 24)
    caster = native.BvhRaycaster(
        np.asarray(mesh.vertices), np.asarray(mesh.triangles)
    )
    origins, dirs = random_rays(rng)
    pos, normal, bary, t, prim = caster.raycast(origins, dirs)
    golden = raycast(mesh, jnp.asarray(origins), jnp.asarray(dirs), False)

    g_valid = np.asarray(golden.valid)
    n_valid = prim != 0xFFFFFFFF
    np.testing.assert_array_equal(n_valid, g_valid)
    assert g_valid.sum() > 100
    np.testing.assert_allclose(
        t[g_valid], np.asarray(golden.t)[g_valid], rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        pos[g_valid], np.asarray(golden.pos)[g_valid], rtol=1e-3, atol=1e-4
    )
    np.testing.assert_array_equal(
        prim[g_valid], np.asarray(golden.prim_id)[g_valid]
    )


def test_bvh_mask_occludes(rng):
    mesh = make_sphere_mesh()
    caster = native.BvhRaycaster(
        np.asarray(mesh.vertices), np.asarray(mesh.triangles)
    )
    origin = np.array([[0.0, 0.0, -3.0]], np.float32)
    direction = np.array([[0.0, 0.0, 1.0]], np.float32)
    _, _, _, _, prim = caster.raycast(origin, direction)
    hit_prim = int(prim[0])
    assert hit_prim != 0xFFFFFFFF

    masked = np.zeros(
        (len(np.asarray(mesh.triangles)) + 31) // 32 + 4, np.uint32
    )
    masked = set_mask_bits(masked, hit_prim, "mask")
    _, _, _, t2, prim2 = caster.raycast(origin, direction, masked)
    # Masked triangle occludes: no hit reported, not the back surface
    assert prim2[0] == 0xFFFFFFFF


def test_bvh_empty_mesh():
    caster = native.BvhRaycaster(
        np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint32)
    )
    pos, normal, bary, t, prim = caster.raycast(
        np.zeros((2, 3), np.float32), np.ones((2, 3), np.float32)
    )
    assert (prim == 0xFFFFFFFF).all()


def test_native_fn_binding_cache():
    """native_fn binds once (cached), returns None for absent symbols
    without raising, and the cache holds the None too."""
    from polychase_tpu import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    import ctypes

    f1 = native.native_fn(
        "gftt_quality_order", None,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p],
    )
    f2 = native.native_fn("gftt_quality_order", None, [])
    assert f1 is not None and f1 is f2  # argtypes of the first call win
    assert native.native_fn("no_such_symbol_xyz", None, []) is None
    assert "no_such_symbol_xyz" in native._FN_CACHE


def test_library_built_from_source(tmp_path):
    """The library comes from bvh.cc, not from a shipped binary."""
    import ctypes

    out = native.build_library(str(tmp_path / "bvh_test.so"))
    lib = ctypes.CDLL(out)
    for sym in ("bvh_build", "bvh_raycast", "bvh_free", "pack_track_chunk",
                "gftt_sort_suppress"):
        assert hasattr(lib, sym), sym
    assert [p.name for p in tmp_path.iterdir()] == ["bvh_test.so"]


def test_build_failure_says_why(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cc"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library(str(tmp_path / "bvh_test.so"))
    assert not list(tmp_path.iterdir())  # no half-written library left


@pytest.mark.parametrize("n_lat,n_lon", [(32, 64), (128, 256)])
def test_rays_through_shared_edges_hit_the_near_side(n_lat, n_lon):
    """A ray through the edge two triangles share hits one of them, so
    it never slips through to the far side of a closed mesh (Embree's
    test is watertight; a float32 Möller–Trumbore is not)."""
    mesh = make_sphere_mesh(n_lat, n_lon)
    v = np.asarray(mesh.vertices, np.float64)
    tris = np.asarray(mesh.triangles)
    caster = native.BvhRaycaster(v.astype(np.float32), tris)
    origin = np.array([0.3, -0.2, -4.0])
    # Midpoints of every triangle edge on the camera's side.
    a = v[tris]
    mids = np.concatenate([(a[:, 0] + a[:, 1]) / 2, (a[:, 1] + a[:, 2]) / 2,
                           (a[:, 2] + a[:, 0]) / 2])
    front = np.einsum("ij,ij->i", mids, mids - origin) < -0.2
    mids = mids[front]
    dirs = (mids - origin).astype(np.float32)
    origins = np.broadcast_to(origin, dirs.shape).astype(np.float32)
    _, _, _, t, prim = caster.raycast(origins, dirs)
    assert (prim != 0xFFFFFFFF).all()
    # The midpoint sits at t = 1 along its direction (the chord's midpoint
    # is inside the sphere, so the near surface comes just before it).
    assert t.max() < 1.0 + 1e-4
