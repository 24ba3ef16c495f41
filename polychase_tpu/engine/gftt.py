"""Good-features-to-track corner detection on the device.

Rebuild of the reference's GFTT re-implementation
(cpp/feature_detection/gftt.{h,cc}).  The dense part — Shi-Tomasi /
Harris response, per-grid-block thresholding, 3×3 dilation NMS — is one
jitted XLA program of separable convolutions and reshape-maxes.  The
inherently sequential tail (deterministic quality sort + greedy
min-distance suppression, cpp/feature_detection/gftt.cc:98-164) runs on
host over the (small) candidate set.

Semantics matched to the reference:

- response maps follow OpenCV ``cornerMinEigenVal`` / ``cornerHarris``
  exactly (Sobel with reflect-101 borders, unnormalized box filter,
  1/(2^(ksize-1)·block·255) scaling for 8-bit input);
- grid thresholding: the image is split into ``grid_rows × grid_cols``
  blocks and each block is thresholded-to-zero at ``block_max ·
  quality_level`` (cpp/feature_detection/gftt.cc:38-67); the block max
  respects the detection mask;
- NMS keeps strict 3×3 local maxima away from the 1-px image border
  (cpp/feature_detection/gftt.cc:69-86);
- candidates are sorted by quality descending with the reference's
  deterministic tie-break of *higher memory address first*, i.e. later
  row-major position wins ties (cpp/feature_detection/gftt.cc:7-12);
- greedy min-distance suppression over a cell grid, identical visiting
  order (cpp/feature_detection/gftt.cc:100-164).
"""

from __future__ import annotations

import os as _os
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class GFTTOptions(NamedTuple):
    """Detector options (cpp/feature_detection/gftt.h:5-21)."""

    quality_level: float = 0.01
    min_distance: float = 5.0
    block_size: int = 3
    gradient_size: int = 3
    max_corners: int = 0
    use_harris: bool = False
    harris_k: float = 0.04
    grid_rows: int = 4
    grid_cols: int = 4


# ---------------------------------------------------------------------------
# Separable convolution helpers (reflect-101 borders, OpenCV's default)
# ---------------------------------------------------------------------------


def _sep_filter(img: jax.Array, kx: np.ndarray, ky: np.ndarray) -> jax.Array:
    """Separable 2D correlation with BORDER_REFLECT_101 (= np 'reflect')."""
    rx, ry = len(kx) // 2, len(ky) // 2
    p = jnp.pad(img, ((ry, ry), (rx, rx)), mode="reflect")
    H, W = img.shape
    # Horizontal pass over rows of the padded image.
    acc = jnp.zeros((H + 2 * ry, W), img.dtype)
    for i, k in enumerate(kx):
        acc = acc + float(k) * jax.lax.dynamic_slice(
            p, (0, i), (H + 2 * ry, W)
        )
    out = jnp.zeros((H, W), img.dtype)
    for j, k in enumerate(ky):
        out = out + float(k) * jax.lax.dynamic_slice(acc, (j, 0), (H, W))
    return out


def _sobel_kernels(ksize: int) -> Tuple[np.ndarray, np.ndarray]:
    """1st-derivative + smoothing taps, OpenCV ``getDerivKernels``
    (modules/imgproc getSobelKernels, unnormalized): the derivative row
    is the discrete difference of the (ksize-1)-th binomial row, the
    smoothing row the (ksize-1)-th binomial row; ksize=1 smooths with
    the identity.  The reference exposes the knob as ``gradient_size``
    (cpp/feature_detection/gftt.h:5-21) and OpenCV accepts 1/3/5/7."""
    taps = {
        1: ([-1.0, 0.0, 1.0], [1.0]),
        3: ([-1.0, 0.0, 1.0], [1.0, 2.0, 1.0]),
        5: ([-1.0, -2.0, 0.0, 2.0, 1.0], [1.0, 4.0, 6.0, 4.0, 1.0]),
        7: (
            [-1.0, -4.0, -5.0, 0.0, 5.0, 4.0, 1.0],
            [1.0, 6.0, 15.0, 20.0, 15.0, 6.0, 1.0],
        ),
    }
    if ksize not in taps:
        raise ValueError(
            "gradient_size must be 1, 3, 5 or 7 (OpenCV getDerivKernels)"
        )
    deriv, smooth = taps[ksize]
    return np.array(deriv), np.array(smooth)


def _corner_response(
    image: jax.Array,
    block_size: int,
    ksize: int,
    use_harris: bool,
    harris_k: float,
    is_8u: bool,
) -> jax.Array:
    """Shi-Tomasi min-eigenvalue or Harris response map.

    Mirrors OpenCV ``cornerEigenValsVecs`` scaling so the map is
    numerically comparable with ``cv2.cornerMinEigenVal``.
    """
    deriv, smooth = _sobel_kernels(ksize)
    scale = (1 << (ksize - 1)) * block_size
    if is_8u:
        scale *= 255.0
    inv = 1.0 / scale

    dx = _sep_filter(image, deriv * inv, smooth)
    dy = _sep_filter(image, smooth, deriv * inv)

    ones = np.ones(block_size)
    a = _sep_filter(dx * dx, ones, ones)
    b = _sep_filter(dx * dy, ones, ones)
    c = _sep_filter(dy * dy, ones, ones)

    if use_harris:
        return a * c - b * b - harris_k * (a + c) * (a + c)
    ha, hc = 0.5 * a, 0.5 * c
    return (ha + hc) - jnp.sqrt((ha - hc) * (ha - hc) + b * b)


def _grid_threshold(
    eig: jax.Array,
    mask: Optional[jax.Array],
    grid_rows: int,
    grid_cols: int,
    quality_level: float,
) -> jax.Array:
    """Per-block threshold-to-zero at block_max·quality
    (cpp/feature_detection/gftt.cc:38-67)."""
    H, W = eig.shape
    bh = -(-H // grid_rows)
    bw = -(-W // grid_cols)
    ph, pw = grid_rows * bh - H, grid_cols * bw - W

    considered = jnp.isfinite(eig)
    if mask is not None:
        considered = considered & (mask != 0)
    eig_p = jnp.pad(eig, ((0, ph), (0, pw)))
    con_p = jnp.pad(considered, ((0, ph), (0, pw)))

    neg = jnp.float32(-jnp.inf)
    blocks = jnp.where(con_p, eig_p, neg).reshape(grid_rows, bh, grid_cols, bw)
    bmax = jnp.max(blocks, axis=(1, 3))
    bmax = jnp.where(jnp.isfinite(bmax), bmax, 0.0)
    thr = (bmax * quality_level).repeat(bh, axis=0).repeat(bw, axis=1)
    return jnp.where(eig_p > thr, eig_p, 0.0)[:H, :W]


def _dilate3x3(x: jax.Array) -> jax.Array:
    """3×3 max filter with -inf border (cv::dilate default)."""
    p = jnp.pad(x, 1, constant_values=-jnp.inf)
    out = x
    for dy in (0, 1, 2):
        for dx_ in (0, 1, 2):
            if dy == 1 and dx_ == 1:
                continue
            out = jnp.maximum(
                out, jax.lax.dynamic_slice(p, (dy, dx_), x.shape)
            )
    return out


@partial(
    jax.jit,
    static_argnames=(
        "block_size", "ksize", "use_harris", "grid_rows", "grid_cols", "is_8u",
    ),
)
def gftt_response(
    image: jax.Array,
    mask: Optional[jax.Array],
    quality_level,
    harris_k,
    *,
    block_size: int = 3,
    ksize: int = 3,
    use_harris: bool = False,
    grid_rows: int = 4,
    grid_cols: int = 4,
    is_8u: bool = True,
):
    """Dense device half of GFTT: response → grid threshold → NMS.

    Returns ``(eig, candidates)`` where ``candidates`` is a bool (H, W)
    map of strict-local-max pixels that survive thresholding, the border
    exclusion and the detection mask.
    """
    eig = _corner_response(
        image, block_size, ksize, use_harris, harris_k, is_8u
    )
    eig = _grid_threshold(eig, mask, grid_rows, grid_cols, quality_level)
    dil = _dilate3x3(eig)

    H, W = eig.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (yy >= 1) & (yy < H - 1) & (xx >= 1) & (xx < W - 1)
    cand = (eig != 0.0) & (eig == dil) & interior
    if mask is not None:
        cand = cand & (mask != 0)
    return eig, cand


@partial(
    jax.jit,
    static_argnames=(
        "block_size", "ksize", "use_harris", "grid_rows", "grid_cols", "is_8u",
    ),
)
def gftt_response_packed(
    image, mask, quality_level, harris_k,
    *, block_size=3, ksize=3, use_harris=False, grid_rows=4, grid_cols=4,
    is_8u=True,
):
    """Like :func:`gftt_response` but packed into ONE array: the response
    where a pixel is a surviving candidate, 0 elsewhere.  A single
    device→host transfer recovers both positions and qualities.
    """
    eig, cand = gftt_response(
        image, mask, quality_level, harris_k,
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )
    return jnp.where(cand, eig, 0.0)


def _min_distance_suppress(
    xs: np.ndarray,
    ys: np.ndarray,
    vals: np.ndarray,
    w: int,
    h: int,
    min_distance: float,
    max_corners: int,
):
    """Greedy grid-cell suppression in reference visiting order
    (cpp/feature_detection/gftt.cc:100-164).

    Uses the native C implementation when available; the Python path
    below is the behavioural reference and fallback.
    """
    native_result = _native_suppress(
        xs, ys, vals, w, h, min_distance, max_corners
    )
    if native_result is not None:
        return native_result
    cell = int(round(min_distance))
    gw = (w + cell - 1) // cell
    gh = (h + cell - 1) // cell
    grid: list[list[tuple[float, float]]] = [[] for _ in range(gw * gh)]
    md2 = min_distance * min_distance

    out_x, out_y, out_q = [], [], []
    for x, y, q in zip(xs, ys, vals):
        xc, yc = x // cell, y // cell
        good = True
        for yy in range(max(yc - 1, 0), min(yc + 1, gh - 1) + 1):
            for xx in range(max(xc - 1, 0), min(xc + 1, gw - 1) + 1):
                for (mx, my) in grid[yy * gw + xx]:
                    ddx, ddy = x - mx, y - my
                    if ddx * ddx + ddy * ddy < md2:
                        good = False
                        break
                if not good:
                    break
            if not good:
                break
        if good:
            grid[yc * gw + xc].append((float(x), float(y)))
            out_x.append(x)
            out_y.append(y)
            out_q.append(q)
            if max_corners > 0 and len(out_x) == max_corners:
                break
    return (
        np.asarray(out_x, np.float32),
        np.asarray(out_y, np.float32),
        np.asarray(out_q, np.float32),
    )


def _fused_native_enabled() -> bool:
    """The fused C sort/order reroutes honour a kill switch like every
    other performance reroute (POLYCHASE_SCAN_TRACK, POLYCHASE_LK_SORT,
    ...) so A/B timing and field debugging can restore the numpy
    behavioural reference at runtime."""
    return _os.environ.get("POLYCHASE_GFTT_FUSED", "1") != "0"


def _native_suppress(xs, ys, vals, w, h, min_distance, max_corners):
    """C-accelerated greedy suppression; None when the lib is absent."""
    import ctypes

    from .. import native

    fn = native.native_fn(
        "gftt_min_distance_suppress",
        ctypes.c_uint32,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.c_void_p,
        ],
    )
    if fn is None:
        return None
    xs_f = np.ascontiguousarray(xs, np.float32)
    ys_f = np.ascontiguousarray(ys, np.float32)
    out = np.empty(len(xs_f), np.uint32)
    count = fn(
        xs_f.ctypes.data_as(ctypes.c_void_p),
        ys_f.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint32(len(xs_f)),
        ctypes.c_int32(int(w)),
        ctypes.c_int32(int(h)),
        ctypes.c_float(float(min_distance)),
        ctypes.c_int32(int(max_corners)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    idx = out[:count]
    return (
        xs_f[idx],
        ys_f[idx],
        np.ascontiguousarray(vals, np.float32)[idx],
    )


def _native_sort_suppress(vals, lin, w, h, min_distance, max_corners):
    """Fused C quality-sort + greedy suppression over raw candidates.

    Replaces the host lexsort + grid pass (~10 ms/frame at 16k
    candidates) with one C call; ordering is exactly the reference's
    (quality desc, ties later-row-major first).  Returns accepted
    candidate indices in acceptance order, or None when the lib is
    absent or POLYCHASE_GFTT_FUSED=0 (callers keep the numpy path as
    the behavioural reference).
    """
    import ctypes

    from .. import native

    if not _fused_native_enabled():
        return None
    fn = native.native_fn(
        "gftt_sort_suppress",
        ctypes.c_uint32,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
            ctypes.c_int32, ctypes.c_void_p,
        ],
    )
    if fn is None:
        return None
    vals_f = np.ascontiguousarray(vals, np.float32)
    lin_i = np.ascontiguousarray(lin, np.int64)
    out = np.empty(len(vals_f), np.uint32)
    count = fn(
        vals_f.ctypes.data_as(ctypes.c_void_p),
        lin_i.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint32(len(vals_f)),
        ctypes.c_int32(int(w)),
        ctypes.c_int32(int(h)),
        ctypes.c_float(float(min_distance)),
        ctypes.c_int32(int(max_corners)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:count]


def _native_quality_order(vals, lin):
    """C quality-desc ordering (np.lexsort((-lin, -vals)) equivalent);
    None when the lib is absent or POLYCHASE_GFTT_FUSED=0."""
    import ctypes

    from .. import native

    if not _fused_native_enabled():
        return None
    fn = native.native_fn(
        "gftt_quality_order",
        None,
        [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_void_p,
        ],
    )
    if fn is None:
        return None
    vals_f = np.ascontiguousarray(vals, np.float32)
    lin_i = np.ascontiguousarray(lin, np.int64)
    out = np.empty(len(vals_f), np.uint32)
    fn(
        vals_f.ctypes.data_as(ctypes.c_void_p),
        lin_i.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_uint32(len(vals_f)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


@partial(
    jax.jit,
    static_argnames=(
        "k", "block_size", "ksize", "use_harris", "grid_rows", "grid_cols",
        "is_8u",
    ),
)
def gftt_candidates_topk(
    image, mask, quality_level, harris_k, *, k,
    block_size=3, ksize=3, use_harris=False, grid_rows=4, grid_cols=4,
    is_8u=True,
):
    """Device-compacted candidates: top-k (value, linear index) + count.

    Transferring the full packed response map costs H*W*4 bytes per frame
    (1.2 MB at 640x480, 8.3 MB at 1080p) on every host round-trip; the
    candidate set after grid thresholding + NMS is a few-10k pixels, so a
    device-side top-k shrinks the transfer ~5-20x.  ``count`` lets the
    host detect (rare) overflow and fall back to the full map.

    The top-k runs on a 2×2 block-max reduction of the candidate map:
    NMS keeps only pixels equal to their 3×3 dilation, so two candidates
    in one 2×2 block can only be an exact-value tie on adjacent pixels.
    That rare case is detected on device and signalled through an
    overflowed ``count`` so the host falls back to the exact path; every
    other frame pays a 4× smaller sort (measured ~7 → ~3 ms/frame at
    640p — the sort was half the GFTT device budget).
    """
    bvals, blin, count = _candidates_reduced(
        image, mask, quality_level, harris_k,
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )
    kk = min(k, bvals.shape[0])
    vals, bidx = jax.lax.top_k(bvals, kk)
    idx = blin[bidx]
    return vals, idx.astype(jnp.int32), count


def _candidates_reduced(
    image, mask, quality_level, harris_k, *,
    block_size, ksize, use_harris, grid_rows, grid_cols, is_8u,
):
    """Shared candidate compaction: response → NMS → 2×2 block-max."""
    eig, cand = gftt_response(
        image, mask, quality_level, harris_k,
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )
    H, W = eig.shape
    q = jnp.where(cand, eig, 0.0)
    lin = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    ph, pw = H % 2, W % 2
    if ph or pw:
        q = jnp.pad(q, ((0, ph), (0, pw)))
        lin = jnp.pad(lin, ((0, ph), (0, pw)))
        cand_p = jnp.pad(cand, ((0, ph), (0, pw)))
    else:
        cand_p = cand
    Hb, Wb = q.shape[0] // 2, q.shape[1] // 2
    qb = q.reshape(Hb, 2, Wb, 2)
    # ≤1 nonzero per block except exact ties ⇒ block max recovers the
    # candidate; its index via max of (candidate? lin : 0) (pixel 0 is
    # border-excluded, so lin 0 never marks a candidate).
    bvals = qb.max(axis=(1, 3)).reshape(-1)
    blin = (
        jnp.where(cand_p, lin, 0)
        .reshape(Hb, 2, Wb, 2)
        .max(axis=(1, 3))
        .reshape(-1)
    )
    bcount = cand_p.reshape(Hb, 2, Wb, 2).sum(axis=(1, 3))
    collide = jnp.any(bcount > 1)
    count = jnp.sum(cand)
    count = jnp.where(collide, jnp.int32(2**30), count.astype(jnp.int32))
    return bvals, blin.astype(jnp.int32), count


@partial(
    jax.jit,
    static_argnames=(
        "block_size", "ksize", "use_harris", "grid_rows", "grid_cols",
        "is_8u",
    ),
)
def gftt_candidates_reduced(
    image, mask, quality_level, harris_k, *,
    block_size=3, ksize=3, use_harris=False, grid_rows=4, grid_cols=4,
    is_8u=True,
):
    """Unsorted device candidates: the raw 2×2-reduced (value, linear
    index) maps plus the exact count.

    The host finish re-sorts regardless (``_native_sort_suppress``
    packed-key sort), so the device top-k's ORDER is discarded — this
    variant skips the top-k sort entirely (~half the GFTT device budget
    at 640p) at the cost of transferring H·W/4 pairs instead of k
    (+~350 KB at 640p, asynchronous and prefetched 4 frames ahead).
    Semantically identical downstream: non-candidates carry value 0 and
    the finish's ``vals > 0`` filter drops them; 2×2 tie collisions set
    the same overflowed count sentinel.  POLYCHASE_GFTT_TOPK=0 routes
    here (frames below the device-suppression threshold only)."""
    return _candidates_reduced(
        image, mask, quality_level, harris_k,
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )


def _circle_offsets(min_distance: float) -> Tuple[Tuple[int, int], ...]:
    """Integer pixel offsets with dx²+dy² < d² (strict, like the
    reference's distance test, cpp/feature_detection/gftt.cc:139-148)."""
    r = int(np.ceil(min_distance)) - 1
    out = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy < min_distance * min_distance:
                out.append((dy, dx))
    return tuple(out)


@partial(jax.jit, static_argnames=("offsets", "max_rounds"))
def _suppress_device(qmap, *, offsets, max_rounds: int = 128):
    """Exact greedy min-distance suppression as a device fixed point.

    The host algorithm visits candidates in (quality desc, later
    row-major position first) order and keeps a point iff no
    previously-kept point lies within the radius.  Parallel equivalence:
    a point whose priority beats every *undecided* point within the
    radius has all its higher-priority neighbors decided, so it can be
    decided NOW — and two same-round winners can never conflict (the
    higher-priority one would have disqualified the other).  Each round
    decides at least the priority-local-maxima, so random quality fields
    converge in a few dozen rounds; ``converged`` is False if the round
    cap was hit (caller falls back to the host path).

    Returns ``(kept (H, W) bool, converged () bool)``.
    """
    H, W = qmap.shape
    lin = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets) if offsets else 0

    def pad(x, value):
        return jnp.pad(x, r, constant_values=value)

    def shifted(p, dy, dx, shape):
        return jax.lax.dynamic_slice(p, (r + dy, r + dx), shape)

    def body(state):
        und, kept, rounds = state
        # Mass rejection first: ANY undecided point within the radius of
        # a kept point is rejected by the greedy pass no matter when it
        # is visited (kept points only accumulate), so pruning it NOW is
        # exact — and stops doomed high-priority points from blocking
        # their neighborhoods' local-max test for many rounds.
        kp = pad(kept, False)
        conflict = jnp.zeros_like(kept)
        for dy, dx in offsets:
            if dy == 0 and dx == 0:
                continue
            conflict = conflict | shifted(kp, dy, dx, (H, W))
        und = und & ~conflict

        qu = jnp.where(und, qmap, -jnp.inf)
        lu = jnp.where(und, lin, -1)
        qp, lp = pad(qu, -jnp.inf), pad(lu, -1)

        best_q = qu
        best_l = lu
        for dy, dx in offsets:
            if dy == 0 and dx == 0:
                continue
            qs = shifted(qp, dy, dx, (H, W))
            ls = shifted(lp, dy, dx, (H, W))
            take = (qs > best_q) | ((qs == best_q) & (ls > best_l))
            best_q = jnp.where(take, qs, best_q)
            best_l = jnp.where(take, ls, best_l)

        # Tie-break matches the host sort: later row-major position wins.
        # A surviving local max has no kept point in range (pruned above)
        # and no undecided higher-priority neighbor: decide kept.
        selfmax = und & (qmap == best_q) & (lin == best_l)
        kept = kept | selfmax
        und = und & ~selfmax
        return und, kept, rounds + 1

    def cond(state):
        und, _, rounds = state
        return jnp.any(und) & (rounds < max_rounds)

    und0 = qmap > 0.0
    kept0 = jnp.zeros_like(und0)
    und, kept, _ = jax.lax.while_loop(
        cond, body, (und0, kept0, jnp.int32(0))
    )
    return kept, ~jnp.any(und)


@partial(
    jax.jit,
    static_argnames=(
        "k", "block_size", "ksize", "use_harris", "grid_rows", "grid_cols",
        "is_8u", "offsets",
    ),
)
def gftt_suppressed_topk(
    image, mask, quality_level, harris_k, *, k, offsets,
    block_size=3, ksize=3, use_harris=False, grid_rows=4, grid_cols=4,
    is_8u=True,
):
    """Full GFTT tail on device: response → NMS → min-distance
    suppression → top-k of the KEPT set.

    At 4K a noise frame yields ~200k NMS candidates; transferring and
    greedily suppressing them on the host would dominate the frame.
    Here only the suppressed survivors cross to the host.  ``converged`` False (round cap) or count > k (overflow)
    → the host falls back to the exact sequential path.
    """
    eig, cand = gftt_response(
        image, mask, quality_level, harris_k,
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )
    qmap = jnp.where(cand, eig, 0.0)
    kept, converged = _suppress_device(qmap, offsets=offsets)
    flat = jnp.where(kept, qmap, 0.0).reshape(-1)
    vals, idx = jax.lax.top_k(flat, k)
    return vals, idx.astype(jnp.int32), jnp.sum(kept), converged


class GFTTDispatch(NamedTuple):
    """In-flight device-side GFTT for one frame (async pipeline stage)."""

    vals: object          # (k,) device f32
    idx: object           # (k,) device i32
    count: object         # scalar device i32
    shape: Tuple[int, int]
    options: "GFTTOptions"
    fallback: object      # image (host) for the rare top-k overflow
    # Device-suppressed route: count/vals cover the KEPT set and the
    # host skips greedy suppression; ``converged`` False → fall back.
    suppressed: bool = False
    converged: object = None


def _check_options(options: GFTTOptions) -> None:
    if not (
        options.quality_level > 0
        and options.min_distance >= 0
        and options.max_corners >= 0
    ):
        raise ValueError("invalid GFTT options")
    if int(options.gradient_size) not in (1, 3, 5, 7):
        # Same set OpenCV's getDerivKernels accepts; reject at the API
        # boundary instead of deep inside a traced dispatch.
        raise ValueError(
            "gradient_size must be 1, 3, 5 or 7"
        )


def device_suppress_route(num_pixels: int, options: GFTTOptions) -> bool:
    """Would gftt_dispatch run the min-distance suppression on device?

    Big frames run it ON DEVICE (exact — see _suppress_device): at 4K a
    noise frame has ~200k NMS candidates and the top-k transfer + host
    greedy pass dominate the frame budget.  Small frames keep the proven
    transfer-then-host path.  Exposed so the analyze loop can route
    around the fused prep+GFTT program (which has no suppression leg).
    """
    return (
        options.min_distance >= 1
        # The suppression program unrolls the strict-distance disc
        # (O(d²) offsets) twice per round — past d≈8 (~200 offsets) the
        # compiled program balloons, so big radii stay on the host path.
        and options.min_distance <= 8
        and num_pixels
        >= int(_os.environ.get("POLYCHASE_GFTT_DEV_SUPPRESS_MIN",
                               str(2_000_000)))
        and _os.environ.get("POLYCHASE_GFTT_DEV_SUPPRESS", "1") != "0"
    )


def gftt_dispatch(
    image, mask=None, options: GFTTOptions = GFTTOptions(), k: int = 0,
    *, _host_suppress: bool = False,
) -> GFTTDispatch:
    """Start GFTT for a frame; device work is queued, nothing blocks.

    ``image`` may be a host array or an already-uploaded device array
    (the analyze loop uploads each frame once as uint8 and shares the
    device copy between GFTT and the LK pyramid prep, where a duplicate
    f32 upload would move 8× the bytes)."""
    if isinstance(image, jax.Array):
        img = image
        is_8u = img.dtype == jnp.uint8
        imgf = img.astype(jnp.float32)
    else:
        img = np.asarray(image)
        is_8u = img.dtype == np.uint8
        imgf = jnp.asarray(img, jnp.float32)
    if img.ndim != 2:
        raise ValueError("image must be 2D grayscale")
    _check_options(options)
    if mask is None:
        maskj = None
    elif isinstance(mask, jax.Array):
        maskj = mask if mask.dtype == jnp.bool_ else (mask != 0)
    else:
        maskj = jnp.asarray(np.asarray(mask) != 0)

    kw = dict(
        block_size=int(options.block_size),
        ksize=int(options.gradient_size),
        use_harris=bool(options.use_harris),
        grid_rows=max(1, int(options.grid_rows)),
        grid_cols=max(1, int(options.grid_cols)),
        is_8u=is_8u,
    )
    import os as _os

    dev_suppress = not _host_suppress and device_suppress_route(
        img.size, options
    )
    converged = None
    if dev_suppress:
        # Kept points are pairwise >= min_distance apart, so the hex
        # packing bound caps their count; a 4K noise frame keeps ~170k
        # at d=5 (bound ~390k).  Undersizing k would silently fall back
        # to the host path every frame.
        dmin = max(float(options.min_distance), 1.0)
        H_, W_ = img.shape
        pack = int((W_ / dmin + 2) * (H_ / dmin + 2) * 1.16)
        k2 = min(max(32768, pack), img.size)
        vals, idx, count, converged = gftt_suppressed_topk(
            imgf, maskj,
            jnp.float32(options.quality_level),
            jnp.float32(options.harris_k),
            k=k2, offsets=_circle_offsets(float(options.min_distance)),
            **kw,
        )
    elif _os.environ.get("POLYCHASE_GFTT_TOPK", "1") == "0":
        # Skip the device top-k sort: the host finish re-sorts anyway,
        # so ship the raw 2×2-reduced maps (see gftt_candidates_reduced).
        vals, idx, count = gftt_candidates_reduced(
            imgf, maskj,
            jnp.float32(options.quality_level),
            jnp.float32(options.harris_k),
            **kw,
        )
    else:
        if k <= 0:
            # NMS candidates are at most ~1 per 3x3 neighborhood; budget
            # 1/16 of the pixels (4K frames would otherwise overflow a
            # fixed 32k and fall back to the full response map).
            k = max(32768, img.size // 16)
        k = min(k, img.size)
        vals, idx, count = gftt_candidates_topk(
            imgf, maskj,
            jnp.float32(options.quality_level),
            jnp.float32(options.harris_k),
            k=k, **kw,
        )
    # Start the device→host copies as soon as the compute finishes so the
    # transfer overlaps later dispatches (a blocking device_get in
    # gftt_finish would otherwise serialize the copy on every frame).
    arrs = (vals, idx, count) + (
        (converged,) if converged is not None else ()
    )
    for arr in arrs:
        try:
            arr.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without support
            break
    return GFTTDispatch(
        vals, idx, count, img.shape, options, (img, maskj),
        suppressed=dev_suppress, converged=converged,
    )


def gftt_finish(d: GFTTDispatch) -> Tuple[np.ndarray, np.ndarray]:
    """Blocking host half: sort + greedy min-distance suppression."""
    import jax as _jax

    if d.suppressed:
        vals, idx, count, converged = _jax.device_get(
            (d.vals, d.idx, d.count, d.converged)
        )
        if bool(converged) and int(count) <= vals.shape[0]:
            keep = vals > 0.0
            vals = vals[keep]
            lin = idx[keep].astype(np.int64)
            ys = lin // d.shape[1]
            xs = lin % d.shape[1]
            if xs.size == 0:
                return (
                    np.empty((0, 2), np.float32),
                    np.empty((0,), np.float32),
                )
            order = _native_quality_order(vals, lin)
            if order is None:
                order = np.lexsort((-lin, -vals))
            xs, ys, vals = xs[order], ys[order], vals[order]
            n = xs.size
            if d.options.max_corners > 0:
                # Greedy-with-cap == unlimited greedy truncated to the
                # first max_corners acceptances (same visiting order).
                n = min(n, int(d.options.max_corners))
            return (
                np.stack(
                    [xs[:n].astype(np.float32), ys[:n].astype(np.float32)],
                    axis=-1,
                ),
                vals[:n].astype(np.float32),
            )
        # Round cap hit or top-k overflow: exact sequential fallback.
        return good_features_to_track_host(
            d.fallback[0], d.fallback[1], d.options
        )

    vals, idx, count = _jax.device_get((d.vals, d.idx, d.count))
    if int(count) > vals.shape[0]:
        # Top-k overflowed: redo via the full packed map (exact, slow).
        packed = gftt_response_packed(
            jnp.asarray(d.fallback[0], jnp.float32), d.fallback[1],
            jnp.float32(d.options.quality_level),
            jnp.float32(d.options.harris_k),
            block_size=int(d.options.block_size),
            ksize=int(d.options.gradient_size),
            use_harris=bool(d.options.use_harris),
            grid_rows=max(1, int(d.options.grid_rows)),
            grid_cols=max(1, int(d.options.grid_cols)),
            is_8u=d.fallback[0].dtype == np.uint8,
        )
        packed_np = np.asarray(packed)
        ys, xs = np.nonzero(packed_np)
        vals = packed_np[ys, xs]
        # Same val>0 filter as the top-k branch: a NaN response (possible
        # only from non-finite float input) is "nonzero" but would order
        # differently in the C packed-key sort vs np.lexsort — drop it
        # consistently before either path sees it.
        keep = vals > 0.0
        ys, xs, vals = ys[keep], xs[keep], vals[keep]
    else:
        keep = vals > 0.0
        vals = vals[keep]
        lin = idx[keep].astype(np.int64)
        ys = lin // d.shape[1]
        xs = lin % d.shape[1]

    if xs.size == 0:
        return np.empty((0, 2), np.float32), np.empty((0,), np.float32)

    # Deterministic sort: quality desc, then later row-major position first
    # (the reference tie-breaks on pointer address, gftt.cc:7-12).
    lin = ys.astype(np.int64) * d.shape[1] + xs
    options = d.options

    # Fused C sort+suppress (min_distance < 1 degenerates to sort+cap
    # inside the C call, matching the else-branch below).
    vals = np.ascontiguousarray(vals, np.float32)
    acc = _native_sort_suppress(
        vals, lin, d.shape[1], d.shape[0],
        float(options.min_distance), int(options.max_corners),
    )
    if acc is not None:
        return (
            np.stack(
                [xs[acc].astype(np.float32), ys[acc].astype(np.float32)],
                axis=-1,
            ),
            vals[acc],
        )

    order = np.lexsort((-lin, -vals))
    xs, ys, vals = xs[order], ys[order], vals[order]
    if options.min_distance >= 1:
        ox, oy, oq = _min_distance_suppress(
            xs, ys, vals,
            d.shape[1], d.shape[0],
            float(options.min_distance), int(options.max_corners),
        )
    else:
        n = xs.size
        if options.max_corners > 0:
            n = min(n, int(options.max_corners))
        ox = xs[:n].astype(np.float32)
        oy = ys[:n].astype(np.float32)
        oq = vals[:n].astype(np.float32)

    return np.stack([ox, oy], axis=-1), oq


def good_features_to_track(
    image,
    mask=None,
    options: GFTTOptions = GFTTOptions(),
) -> Tuple[np.ndarray, np.ndarray]:
    """Detect corners.  Returns ``(corners (N, 2) float32, quality (N,))``.

    ``image`` is a (H, W) grayscale array; uint8 inputs reproduce
    OpenCV's 8-bit response scaling.  Equivalent of the reference's
    ``GoodFeaturesToTrack`` (cpp/feature_detection/gftt.cc:14-192).
    """
    img = np.asarray(image)
    if img.ndim != 2:
        raise ValueError("image must be 2D grayscale")
    _check_options(options)
    if img.size == 0:
        return np.empty((0, 2), np.float32), np.empty((0,), np.float32)
    return gftt_finish(gftt_dispatch(img, mask, options))


def good_features_to_track_host(
    image, mask, options: GFTTOptions
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact fallback route: device response + top-k, HOST suppression."""
    img = np.asarray(image)
    mask_np = None if mask is None else np.asarray(mask)
    return gftt_finish(
        gftt_dispatch(img, mask_np, options, _host_suppress=True)
    )
