"""Native host components: C++ BVH ray caster with a ctypes binding.

The shared library is not shipped in the source tree: it is compiled
from ``bvh.cc`` on first use (g++ -O3 -march=native) into this package
directory, or ahead of time with ``scripts/build_native.sh``.  When the
build fails the reason is logged and callers fall back to the device-side
batched ray cast and numpy, so the native path is a pure acceleration.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_FAILED = False

_SRC = os.path.join(os.path.dirname(__file__), "bvh.cc")
_SO = os.path.join(os.path.dirname(__file__), "_bvh.so")

_log = logging.getLogger(__name__)


def build_library(out_path: str = _SO, arch: str = "-march=native") -> str:
    """Compile ``bvh.cc`` into ``out_path``.

    The compiler writes a temporary file beside the target, which then
    replaces it in one rename, so processes that build at once never
    load a half-written library.  Raises ``RuntimeError`` with the
    compiler's message when the build fails."""
    fd, tmp = tempfile.mkstemp(
        suffix=".so", dir=os.path.dirname(os.path.abspath(out_path))
    )
    os.close(fd)
    try:
        r = subprocess.run(
            ["g++", "-O3", arch, "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({r.returncode}): {r.stderr.strip()[-2000:]}"
            )
        os.replace(tmp, out_path)
    except OSError as e:
        raise RuntimeError(f"cannot build {out_path}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out_path


def _load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_FAILED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        try:
            if not os.path.exists(_SO) or (
                os.path.getmtime(_SO) < os.path.getmtime(_SRC)
            ):
                build_library()
            lib = ctypes.CDLL(_SO)
            lib.bvh_build.restype = ctypes.c_void_p
            lib.bvh_build.argtypes = [
                ctypes.c_void_p, ctypes.c_uint32,
                ctypes.c_void_p, ctypes.c_uint32,
            ]
            lib.bvh_free.argtypes = [ctypes.c_void_p]
            lib.bvh_raycast.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            _LIB = lib
        except (RuntimeError, OSError, AttributeError) as e:
            _log.warning(
                "native BVH library unavailable, falling back to the "
                "device ray cast and numpy: %s", e,
            )
            _LIB_FAILED = True
            _LIB = None
        return _LIB


def available() -> bool:
    return _load_library() is not None


_FN_CACHE: dict = {}
_FN_LOCK = threading.Lock()


def native_fn(name: str, restype, argtypes):
    """Bind exported function ``name`` once and cache it.

    Returns the bound ctypes function, or None when the library or the
    symbol is absent (logged once so a silent reroute to a slower numpy
    fallback is visible in the logs rather than only in a profile).
    """
    with _FN_LOCK:
        if name in _FN_CACHE:
            return _FN_CACHE[name]
        fn = None
        lib = _load_library()
        if lib is not None and hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        else:
            _log.info(
                "native symbol %s unavailable; numpy fallback in use", name
            )
        _FN_CACHE[name] = fn
        return fn


class BvhRaycaster:
    """Host-side BVH over a triangle mesh (Embree-replacement,
    cpp/ray_casting.cc:21-121)."""

    def __init__(self, vertices: np.ndarray, triangles: np.ndarray):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native BVH library unavailable")
        self._lib = lib
        self._vertices = np.ascontiguousarray(vertices, np.float32)
        self._triangles = np.ascontiguousarray(triangles, np.uint32)
        self._handle = lib.bvh_build(
            self._vertices.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(len(self._vertices)),
            self._triangles.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(len(self._triangles)),
        )

    def raycast(
        self,
        origins: np.ndarray,
        dirs: np.ndarray,
        masked_triangles: Optional[np.ndarray] = None,
    ):
        """Closest-hit cast of N rays.

        Returns ``(pos (N,3), normal (N,3), bary (N,2), t (N,),
        prim (N,) uint32)`` with prim == 0xFFFFFFFF on miss.
        """
        origins = np.ascontiguousarray(origins, np.float32).reshape(-1, 3)
        dirs = np.ascontiguousarray(dirs, np.float32).reshape(-1, 3)
        n = origins.shape[0]
        pos = np.empty((n, 3), np.float32)
        normal = np.empty((n, 3), np.float32)
        bary = np.empty((n, 2), np.float32)
        t = np.empty((n,), np.float32)
        prim = np.empty((n,), np.uint32)
        mask_ptr = None
        if masked_triangles is not None and np.size(masked_triangles):
            masked_triangles = np.ascontiguousarray(
                masked_triangles, np.uint32
            )
            mask_ptr = masked_triangles.ctypes.data_as(ctypes.c_void_p)
        self._lib.bvh_raycast(
            self._handle,
            origins.ctypes.data_as(ctypes.c_void_p),
            dirs.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint32(n),
            mask_ptr,
            pos.ctypes.data_as(ctypes.c_void_p),
            normal.ctypes.data_as(ctypes.c_void_p),
            bary.ctypes.data_as(ctypes.c_void_p),
            t.ctypes.data_as(ctypes.c_void_p),
            prim.ctypes.data_as(ctypes.c_void_p),
        )
        return pos, normal, bary, t, prim

    def __del__(self):
        lib = getattr(self, "_lib", None)
        handle = getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.bvh_free(handle)
