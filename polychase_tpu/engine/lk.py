"""Pyramidal Lucas–Kanade sparse optical flow, batched on the device.

Rebuild of the reference's flow engine, which delegates to
``cv::calcOpticalFlowPyrLK`` (cpp/opticalflow.cc:119-125) with a pyramid
from ``cv::buildOpticalFlowPyramid`` (cpp/opticalflow.cc:180-187).  The
reference tracks each feature independently on CPU threads; here **all
features iterate together** as (N,)-batched array programs — each LK
iteration is one fused gather + reduction over the whole feature set, and
the per-level iteration loop is a ``lax.fori_loop`` with per-feature
active flags, so a full multi-level solve for thousands of features is a
single XLA program.

Semantics follow OpenCV (video/src/lkpyramid.cpp) closely:

- pyramid: 5-tap Gaussian [1 4 6 4 1]/16 pyrDown with reflect-101
  borders, level size ``((w+1)//2, (h+1)//2)``;
- spatial derivatives per level: Scharr smoothing (3, 10, 3) × central
  difference, reflect-101, zero padding outside the level;
- image patches sample the reflect-101-padded level (OpenCV pads each
  level by the window size);
- per level: the 2×2 normal matrix A comes from the *previous* image's
  derivative patch; features are declared lost at level 0 when
  ``min_eig(A)/win_area < min_eigen_threshold`` or A is singular;
- iteration: ``δ = A⁻¹ b`` with ``b`` from the current residual patch;
  stop on ``|δ|² ≤ ε²``, on max iterations, or on the oscillation damping
  rule (two opposite sub-0.01 steps → back up half a step);
- error output: mean absolute patch difference at the final position.

Float arithmetic replaces OpenCV's W_BITS fixed point, so results agree
to sub-pixel tolerance rather than bit-exactly (validated in
tests/test_lk.py against cv2 goldens).
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class LKOptions(NamedTuple):
    """Flow options (cpp/opticalflow.h:27-33)."""

    window_size: int = 10
    max_level: int = 3
    term_max_iters: int = 30
    term_epsilon: float = 0.01
    min_eigen_threshold: float = 1e-4


# ---------------------------------------------------------------------------
# Pyramid construction
# ---------------------------------------------------------------------------


def _pyr_down(img: jax.Array) -> jax.Array:
    """OpenCV pyrDown: Gaussian blur then 2× decimation (even pixels)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    H, W = img.shape
    p = jnp.pad(img, 2, mode="reflect")
    acc = jnp.zeros((H + 4, W), img.dtype)
    for i, c in enumerate(k):
        acc = acc + float(c) * jax.lax.dynamic_slice(p, (0, i), (H + 4, W))
    out = jnp.zeros((H, W), img.dtype)
    for j, c in enumerate(k):
        out = out + float(c) * jax.lax.dynamic_slice(acc, (j, 0), (H, W))
    return out[::2, ::2]


def num_pyramid_levels(h: int, w: int, opts: LKOptions) -> int:
    """Levels actually built: OpenCV stops when a level gets smaller than
    the window (modules/video/src/lkpyramid.cpp buildOpticalFlowPyramid)."""
    levels = 1
    win = opts.window_size
    for _ in range(opts.max_level):
        h, w = (h + 1) // 2, (w + 1) // 2
        if w <= win or h <= win:
            break
        levels += 1
    return levels


@partial(jax.jit, static_argnames=("levels",))
def build_pyramid(image: jax.Array, levels: int) -> Tuple[jax.Array, ...]:
    """Grayscale image → tuple of ``levels`` float32 arrays."""
    img = image.astype(jnp.float32)
    pyr = [img]
    for _ in range(levels - 1):
        img = _pyr_down(img)
        pyr.append(img)
    return tuple(pyr)


def _scharr_derivs(img: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """OpenCV calcSharrDeriv: smooth (3,10,3) × diff (-1,0,1), unscaled.

    The result equals 32× the true intensity gradient, matching the
    magnitude conventions OpenCV's thresholds assume.
    """
    H, W = img.shape
    p = jnp.pad(img, 1, mode="reflect")

    def sep(kx, ky):
        acc = jnp.zeros((H + 2, W), img.dtype)
        for i, c in enumerate(kx):
            if c:
                acc = acc + float(c) * jax.lax.dynamic_slice(
                    p, (0, i), (H + 2, W)
                )
        out = jnp.zeros((H, W), img.dtype)
        for j, c in enumerate(ky):
            if c:
                out = out + float(c) * jax.lax.dynamic_slice(acc, (j, 0), (H, W))
        return out

    dx = sep((-1.0, 0.0, 1.0), (3.0, 10.0, 3.0))
    dy = sep((3.0, 10.0, 3.0), (-1.0, 0.0, 1.0))
    return dx, dy


# ---------------------------------------------------------------------------
# Batched patch sampling
# ---------------------------------------------------------------------------


def _pad_level(img: jax.Array, pad: int, zero: bool) -> jax.Array:
    """Pad a level for out-of-bounds window access.

    OpenCV pads images with reflect-101 and derivatives with zeros.
    Reflect padding wider than the image is done in stages.
    """
    if zero:
        return jnp.pad(img, pad)
    remaining = pad
    out = img
    while remaining > 0:
        step = min(remaining, out.shape[0] - 1, out.shape[1] - 1)
        if step <= 0:
            out = jnp.pad(out, remaining, mode="edge")
            break
        out = jnp.pad(out, step, mode="reflect")
        remaining -= step
    return out


def _gather_patches(padded: jax.Array, ix, iy, pad: int, win: int):
    """Gather (N, win+1, win+1) integer windows with top-left (ix, iy).

    Implemented as a vmapped 2D ``dynamic_slice`` so XLA lowers it to a
    single block-gather of contiguous (win+1, win+1) tiles (a 2D
    cross-product gather of the same windows indexes every pixel
    separately).  ``padded`` carries ``pad ≥ win+2`` extra pixels per
    side, so any window that passes OpenCV's bounds test
    (ix ∈ [-win, W-1]) lies fully inside and the implicit start-clamping
    of ``dynamic_slice`` never fires for windows whose values matter.
    """

    def one(iy0, ix0):
        return jax.lax.dynamic_slice(
            padded, (iy0 + pad, ix0 + pad), (win + 1, win + 1)
        )

    return jax.vmap(one)(iy, ix)


def _bilerp(P: jax.Array, ax, ay):
    """Bilinear blend of an integer patch: (N, w+1, w+1) → (N, w, w)."""
    w00 = ((1 - ax) * (1 - ay))[:, None, None]
    w01 = (ax * (1 - ay))[:, None, None]
    w10 = ((1 - ax) * ay)[:, None, None]
    w11 = (ax * ay)[:, None, None]
    return (
        w00 * P[:, :-1, :-1]
        + w01 * P[:, :-1, 1:]
        + w10 * P[:, 1:, :-1]
        + w11 * P[:, 1:, 1:]
    )


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------

_FLT_SCALE = 1.0 / (1 << 20)  # OpenCV's fixed-point compensation factor
_FLT_EPSILON = np.float32(1.1920929e-07)


@partial(
    jax.jit,
    static_argnames=("win", "max_iters"),
)
def _lk_level(
    img_prev_pad,
    dx_pad,
    dy_pad,
    img_next_pad,
    prev_pts,      # (N, 2) positions at this level's scale
    next_pts,      # (N, 2) current guesses
    status,        # (N,) bool
    level_is_zero: jax.Array,  # scalar bool
    shape,         # (2,) [H, W] of this level (device array)
    eps2,
    min_eig_thr,
    *,
    win: int,
    max_iters: int,
):
    """One pyramid level of batched LK iteration."""
    n = prev_pts.shape[0]
    pad = win + 2
    half = (win - 1) * 0.5
    H = shape[0]
    W = shape[1]

    # --- fixed per-level quantities from the previous image ---------------
    ip = jnp.floor(prev_pts - half)
    ax = prev_pts[:, 0] - half - ip[:, 0]
    ay = prev_pts[:, 1] - half - ip[:, 1]
    ixp = ip[:, 0].astype(jnp.int32)
    iyp = ip[:, 1].astype(jnp.int32)

    # OpenCV bounds test on the previous-point window
    in_bounds = (
        (ixp >= -win) & (ixp < W) & (iyp >= -win) & (iyp < H)
    )

    # Images may be stored bf16 (storage-only: _lk_bf16_enabled); the
    # blend and all downstream math run f32.
    Ipatch = _bilerp(
        _gather_patches(img_prev_pad, ixp, iyp, pad, win).astype(
            jnp.float32
        ),
        ax, ay,
    )
    dxI = _bilerp(_gather_patches(dx_pad, ixp, iyp, pad, win), ax, ay)
    dyI = _bilerp(_gather_patches(dy_pad, ixp, iyp, pad, win), ax, ay)

    A11 = jnp.sum(dxI * dxI, axis=(1, 2)) * _FLT_SCALE
    A12 = jnp.sum(dxI * dyI, axis=(1, 2)) * _FLT_SCALE
    A22 = jnp.sum(dyI * dyI, axis=(1, 2)) * _FLT_SCALE
    D = A11 * A22 - A12 * A12
    win_area = float(win * win)
    min_eig = (
        A22 + A11 - jnp.sqrt((A11 - A22) ** 2 + 4.0 * A12 * A12)
    ) / (2.0 * win_area)

    ok = in_bounds & (min_eig >= min_eig_thr) & (D >= _FLT_EPSILON)
    # Failures finalize status only at level 0 (lkpyramid.cpp behavior).
    status = status & jnp.where(level_is_zero, ok, True)
    invD = jnp.where(ok, 1.0 / jnp.where(ok, D, 1.0), 0.0)

    # --- iterate ----------------------------------------------------------
    def body(j, carry):
        next_pts, active, prev_delta, status = carry
        inx = jnp.floor(next_pts - half)
        bx = next_pts[:, 0] - half - inx[:, 0]
        by = next_pts[:, 1] - half - inx[:, 1]
        ixn = inx[:, 0].astype(jnp.int32)
        iyn = inx[:, 1].astype(jnp.int32)

        oob = (ixn < -win) | (ixn >= W) | (iyn < -win) | (iyn >= H)
        newly_out = active & oob
        status = status & ~(newly_out & level_is_zero)
        active = active & ~oob

        Jp = _bilerp(
            _gather_patches(img_next_pad, ixn, iyn, pad, win).astype(
                jnp.float32
            ),
            bx, by,
        )
        # OpenCV stores patches in ×32 fixed point, putting the residual on
        # the same scale as the ×32 Scharr derivatives; replicate that so
        # δ = A⁻¹b is in true pixel units.
        diff = (Jp - Ipatch) * 32.0
        b1 = jnp.sum(diff * dxI, axis=(1, 2)) * _FLT_SCALE
        b2 = jnp.sum(diff * dyI, axis=(1, 2)) * _FLT_SCALE
        # OpenCV's delta (note the sign convention of its solve)
        dx_ = (A12 * b2 - A22 * b1) * invD
        dy_ = (A12 * b1 - A11 * b2) * invD
        delta = jnp.stack([dx_, dy_], axis=-1)

        stepped = jnp.where(active[:, None], next_pts + delta, next_pts)

        converged = jnp.sum(delta * delta, axis=-1) <= eps2
        oscillating = (
            (j > 0)
            & (jnp.abs(delta[:, 0] + prev_delta[:, 0]) < 0.01)
            & (jnp.abs(delta[:, 1] + prev_delta[:, 1]) < 0.01)
        )
        stepped = jnp.where(
            (active & oscillating)[:, None], stepped - delta * 0.5, stepped
        )
        active = active & ~converged & ~oscillating
        return stepped, active, delta, status

    active0 = ok
    init = (
        next_pts,
        active0,
        jnp.zeros_like(next_pts),
        status,
    )
    next_pts, _, _, status = jax.lax.fori_loop(0, max_iters, body, init)

    # --- error: mean |J - I| at the final position (level 0 only) ---------
    def compute_err(_):
        inx = jnp.floor(next_pts - half)
        bx = next_pts[:, 0] - half - inx[:, 0]
        by = next_pts[:, 1] - half - inx[:, 1]
        ixn = inx[:, 0].astype(jnp.int32)
        iyn = inx[:, 1].astype(jnp.int32)
        Jp = _bilerp(
            _gather_patches(img_next_pad, ixn, iyn, pad, win).astype(
                jnp.float32
            ),
            bx, by,
        )
        return jnp.sum(jnp.abs(Jp - Ipatch), axis=(1, 2)) / win_area

    err = jax.lax.cond(
        level_is_zero,
        compute_err,
        lambda _: jnp.zeros((n,), jnp.float32),
        None,
    )
    return next_pts, status, err


def _lk_bf16_enabled() -> bool:
    """Store pyramid IMAGE levels as bfloat16 (POLYCHASE_LK_BF16=1
    enables; default f32).

    Storage-only: uint8 source pixels are EXACT in bf16 and all
    arithmetic stays f32 (Scharr derivatives stay f32).  Halves the
    bytes each patch gather reads; not measured on the GPU."""
    return os.environ.get("POLYCHASE_LK_BF16", "0") == "1"


@partial(jax.jit, static_argnames=("win", "levels", "bf16"))
def _prepare_levels(
    pyr: Tuple[jax.Array, ...], *, win: int, levels: int, bf16: bool = False
):
    """Pad images + compute/pad Scharr derivatives for every level."""
    pad = win + 2
    img_t = jnp.bfloat16 if bf16 else jnp.float32
    out = []
    for lvl in range(levels):
        img = pyr[lvl]
        dx, dy = _scharr_derivs(img)
        out.append(
            (
                _pad_level(img, pad, zero=False).astype(img_t),
                _pad_level(dx, pad, zero=True),
                _pad_level(dy, pad, zero=True),
                jnp.array(img.shape, jnp.int32),
            )
        )
    return tuple(out)


class PyramidCache:
    """Prepared (padded + differentiated) pyramid for one frame."""

    def __init__(self, levels_data, num_levels: int, opts: LKOptions):
        self.levels = levels_data
        self.num_levels = num_levels
        self.opts = opts


@partial(jax.jit, static_argnames=("levels", "win", "bf16"))
def _prepare_pyramid_program(img, *, levels: int, win: int, bf16: bool = False):
    """Whole pyramid prep (f32 convert → pyrDown chain → Scharr → pad) as
    ONE device program.

    The analyze loop prepares one pyramid per frame; fusing the prep means
    one dispatch, and the frame is uploaded as uint8 (4× fewer bytes than
    a host-side f32 conversion), with the convert running on device."""
    pyr = build_pyramid(img.astype(jnp.float32), levels)
    return _prepare_levels(pyr, win=win, levels=levels, bf16=bf16)


def prepare_pyramid(image, opts: LKOptions = LKOptions()) -> PyramidCache:
    """Build the LK pyramid for a grayscale frame (uint8 or float).

    ``image`` may be a host array or an already-uploaded device array
    (any dtype); uint8 input is uploaded as uint8."""
    if isinstance(image, jax.Array):
        img = image
    else:
        img = jax.device_put(np.asarray(image))
    levels = num_pyramid_levels(img.shape[0], img.shape[1], opts)
    data = _prepare_pyramid_program(
        img, levels=levels, win=opts.window_size, bf16=_lk_bf16_enabled(),
    )
    return PyramidCache(data, levels, opts)


@partial(
    jax.jit,
    static_argnames=(
        "levels", "win", "bf16",
        "block_size", "ksize", "use_harris", "grid_rows", "grid_cols",
        "is_8u", "k",
    ),
)
def _prep_gftt_program(
    img, quality_level, harris_k, *, levels: int, win: int,
    bf16: bool, block_size: int, ksize: int, use_harris: bool,
    grid_rows: int, grid_cols: int, is_8u: bool, k: int,
):
    """Pyramid prep + GFTT candidates fused into ONE device program.

    A separate GFTT response program is a few separable convolutions on
    the frame, so its cost is mostly per-dispatch overhead.  Fused here
    it rides the prep dispatch that the analyze loop already prefetches
    off the critical path (the reference overlaps detection and flow
    across its TBB pool, cpp/opticalflow.cc:269-309).  ``k > 0`` adds the
    device top-k; ``k == 0`` ships the raw 2×2-reduced maps
    (POLYCHASE_GFTT_TOPK=0 semantics)."""
    from . import gftt as G

    imgf = img.astype(jnp.float32)
    pyr = build_pyramid(imgf, levels)
    prep = _prepare_levels(pyr, win=win, levels=levels, bf16=bf16)
    kw = dict(
        block_size=block_size, ksize=ksize, use_harris=use_harris,
        grid_rows=grid_rows, grid_cols=grid_cols, is_8u=is_8u,
    )
    if k > 0:
        vals, idx, count = G.gftt_candidates_topk(
            imgf, None, quality_level, harris_k, k=k, **kw
        )
    else:
        vals, idx, count = G._candidates_reduced(
            imgf, None, quality_level, harris_k, **kw
        )
    return prep, (vals, idx, count)


def prepare_pyramid_with_gftt(
    image, opts: LKOptions, gftt_options, k: int = 0,
):
    """Fused per-frame dispatch: LK pyramid prep + GFTT detection.

    Returns ``(PyramidCache, GFTTDispatch)`` — drop-in for a
    ``prepare_pyramid`` + ``gftt_dispatch`` pair on frames that need
    both (masked and device-suppressed GFTT routes stay separate; the
    caller checks ``gftt.device_suppress_route`` first)."""
    from . import gftt as G

    if isinstance(image, jax.Array):
        img = image
    else:
        img = jax.device_put(np.asarray(image))
    if img.ndim != 2:
        raise ValueError("image must be 2D grayscale")
    G._check_options(gftt_options)
    levels = num_pyramid_levels(img.shape[0], img.shape[1], opts)
    is_8u = img.dtype == jnp.uint8
    if os.environ.get("POLYCHASE_GFTT_TOPK", "1") != "0":
        if k <= 0:
            k = max(32768, img.size // 16)  # gftt_dispatch's budget
        k = min(k, img.size)
    else:
        k = 0
    data, (vals, idx, count) = _prep_gftt_program(
        img,
        jnp.float32(gftt_options.quality_level),
        jnp.float32(gftt_options.harris_k),
        levels=levels, win=opts.window_size, bf16=_lk_bf16_enabled(),
        block_size=int(gftt_options.block_size),
        ksize=int(gftt_options.gradient_size),
        use_harris=bool(gftt_options.use_harris),
        grid_rows=max(1, int(gftt_options.grid_rows)),
        grid_cols=max(1, int(gftt_options.grid_cols)),
        is_8u=is_8u, k=k,
    )
    for arr in (vals, idx, count):
        try:
            arr.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without support
            break
    disp = G.GFTTDispatch(
        vals, idx, count, tuple(img.shape), gftt_options, (img, None),
        suppressed=False, converged=None,
    )
    return PyramidCache(data, levels, opts), disp


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _bucket(n: int) -> int:
    """Pad feature counts to stable buckets.

    Every distinct padded size is a separate compile, so per-frame
    feature-count jitter must not create new shapes.  Power-of-two steps
    up to 2048, then 512-steps: real clips sit at a few thousand features
    and the pow2 jump to 8192 would pad every LK dispatch by ~25%."""
    b = 256
    while b < n and b < 2048:
        b *= 2
    if n <= b:
        return b
    return -(-n // 512) * 512


# ---------------------------------------------------------------------------
# Chained skip-fan initialization
# ---------------------------------------------------------------------------
#
# The analyze fan solves the SAME features into targets at skips
# ±{1,2,4,8}.  The reference (cpp/opticalflow.cc:269-309) and cv2 solve
# every pair independently, each paying a full coarse-to-fine pyramid
# from zero init.  But flow is near-linear over small windows: the
# skip-2k flow ≈ 2× the already-solved skip-k flow, and with that seed
# the per-group early exit collapses most iterations at every level.
# Phases run in |skip| order (one dispatch each, results stay on
# device), so only the ±1 phase pays the cold start.  Features whose
# seed pair FAILED fall back to zero init (status-gated), preserving
# cv2 robustness semantics.
#
# Known trade-off: on REPETITIVE texture (period ≲ the extrapolation
# error) a seeded solve can lock onto a different lattice optimum than
# the zero-init solve, with status=True and low err — the same
# ambiguity zero-init has, just resolved toward the extrapolated motion
# instead of toward zero.  Downstream PnP/BA consume these flows
# through inlier gating and robust (Huber/Cauchy) losses — the defense
# the reference relies on for cv2's own lattice mismatches.
# POLYCHASE_LK_CHAIN=1 enables chaining.  The phases serialize on each
# other's results, so chaining trades fewer iterations for less overlap
# between dispatches; it is off by default and not measured on the GPU.


def _lk_chain_enabled() -> bool:
    """POLYCHASE_LK_CHAIN=1 enables chained seeding (default off)."""
    return os.environ.get("POLYCHASE_LK_CHAIN", "0") == "1"


def _chain_plan(skips):
    """Group a skip fan into chained phases of same-|skip| targets.

    Returns a list of phases; each phase is a list of exactly
    ``_CHAIN_T`` slots ``(orig_idx | None, src (phase, col) | None,
    scale)``.  ``orig_idx`` indexes the caller's target list (None =
    padding: the source frame itself, zero seed).  ``src`` points at
    the same-sign seed solved in an earlier phase; ``scale`` is the
    skip ratio applied to that seed's flow.
    """
    mags = sorted({abs(s) for s in skips})
    solved: dict = {}   # sign -> (mag, phase, col)
    plan = []
    for p, mag in enumerate(mags):
        slots = []
        for i, s in enumerate(skips):
            if abs(s) != mag:
                continue
            sign = s > 0
            src = solved.get(sign)
            if src is None:
                slots.append((i, None, 0.0))
            else:
                slots.append((i, (src[1], src[2]), mag / src[0]))
            solved[sign] = (mag, p, len(slots) - 1)
        while len(slots) < _CHAIN_T:
            slots.append((None, None, 0.0))
        plan.append(slots)
    return plan


_CHAIN_T = 2   # slots per phase: one per sign of the skip


@partial(
    jax.jit,
    static_argnames=("win", "max_iters", "levels"),
)
def _lk_chain_phase_program(
    prev_levels, next_images, pts, src_nxt, src_status, scales, eps2,
    min_eig_thr, *, win, max_iters, levels,
):
    """One chained phase: compute the status-gated seed from the source
    slots' results, then run the multi-target solve.  Phase 1 passes
    ``src_nxt == pts`` / ``src_status == False`` and degenerates to the
    unseeded program, so every phase reuses ONE compile."""
    init = jnp.where(
        src_status[..., None],
        (src_nxt - pts[None]) * scales[:, None, None],
        0.0,
    )
    return _lk_all_levels_multi(
        prev_levels, next_images, pts, eps2, min_eig_thr, init_flow=init,
        win=win, max_iters=max_iters, levels=levels,
    )


def _chained_dispatch(prev_pyr, next_pyrs, skips, pts_p, opts, levels):
    """Dispatch the skip fan as chained phases (device-resident seeds).

    Returns ``(phase_outs, slot_map, pts_dev, pts_p)``: per-phase
    (nxt, status, err) device triples plus, per phase, the original
    target index of every slot (None = padding).  All phases are queued
    without host syncs — phase k+1's program consumes phase k's output
    arrays directly.  On a multi-device mesh the feature axis is sharded
    (seeds shard with the features; ``pts_p`` comes back re-padded to
    the shard step).
    """
    plan = _chain_plan(skips)
    eps = min(max(opts.term_epsilon, 0.0), 10.0)
    mesh = _analyze_mesh()
    sharded = mesh is not None and int(mesh.devices.size) > 1
    if sharded:
        pts_p = _pad_pts(pts_p, int(mesh.devices.size))
    pts_dev = jnp.asarray(pts_p)
    m = pts_p.shape[0]
    prev_levels = tuple(prev_pyr.levels[:levels])
    kw = dict(
        win=opts.window_size, max_iters=opts.term_max_iters, levels=levels,
    )
    thr = (jnp.float32(eps * eps), jnp.float32(opts.min_eigen_threshold))
    zero_status = jnp.zeros((_CHAIN_T, m), bool)
    if sharded:
        from ..parallel.analyze import sharded_lk_chain_phase

    phase_outs = []
    slot_map = []
    for slots in plan:
        pyrs = [
            next_pyrs[i] if i is not None else prev_pyr
            for (i, _, _) in slots
        ]
        next_images = tuple(
            jnp.stack([p.levels[lvl][0] for p in pyrs])
            for lvl in range(levels)
        )
        src_nxt, src_st = [], []
        for (_, src, _) in slots:
            if src is None:
                src_nxt.append(pts_dev)
                src_st.append(zero_status[0])
            else:
                pnxt, pst, _ = phase_outs[src[0]]
                src_nxt.append(pnxt[src[1]])
                src_st.append(pst[src[1]])
        scales = jnp.asarray([sc for (_, _, sc) in slots], jnp.float32)
        args = (
            prev_levels, next_images, pts_dev, jnp.stack(src_nxt),
            jnp.stack(src_st), scales, *thr,
        )
        if sharded:
            out = sharded_lk_chain_phase(mesh, *args, **kw)
        else:
            out = _lk_chain_phase_program(*args, **kw)
        phase_outs.append(out)
        slot_map.append([i for (i, _, _) in slots])
    return phase_outs, slot_map, pts_dev, pts_p


def _feat_shard_min() -> int:
    """Feature count above which Analyze shards the FEATURE axis over the
    mesh instead of the (≤8-wide) target axis — the feature axis is the
    one that grows with resolution (~170k corners on a 4K noise frame).
    The default is not measured on the GPU."""
    return int(os.environ.get("POLYCHASE_FEAT_SHARD_MIN", "32768"))


def calc_optical_flow(
    prev_pyr: PyramidCache,
    next_pyr: PyramidCache,
    prev_pts: np.ndarray,
    opts: LKOptions = LKOptions(),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Track ``prev_pts`` (N, 2) from prev to next frame.

    Returns ``(next_pts (N,2) f32, status (N,) bool, err (N,) f32)`` with
    cv::calcOpticalFlowPyrLK conventions.
    """
    pts = np.ascontiguousarray(prev_pts, np.float32).reshape(-1, 2)
    n = pts.shape[0]
    if n == 0:
        return (
            np.empty((0, 2), np.float32),
            np.empty((0,), bool),
            np.empty((0,), np.float32),
        )
    levels = min(prev_pyr.num_levels, next_pyr.num_levels)

    m = _bucket(n)
    pts_p = np.zeros((m, 2), np.float32)
    pts_p[:n] = pts

    eps = min(max(opts.term_epsilon, 0.0), 10.0)
    nxt, status, err = _lk_all_levels(
        tuple(prev_pyr.levels[:levels]),
        tuple(next_pyr.levels[:levels]),
        jnp.asarray(pts_p),
        jnp.float32(eps * eps),
        jnp.float32(opts.min_eigen_threshold),
        win=opts.window_size,
        max_iters=opts.term_max_iters,
        levels=levels,
    )
    nxt, status, err = jax.device_get((nxt, status, err))
    return nxt[:n], status[:n], err[:n]


@partial(jax.jit, static_argnames=("win", "max_iters", "levels"))
def _lk_all_levels(
    prev_levels,
    next_levels,
    pts,          # (N, 2) full-resolution positions (padded)
    eps2,
    min_eig_thr,
    *,
    win: int,
    max_iters: int,
    levels: int,
):
    """Full coarse-to-fine solve as ONE device program.

    A single dispatch + single result transfer: the level hand-off
    stays on device instead of paying a host round trip per level.
    """
    next_images = tuple(next_levels[lvl][0] for lvl in range(levels))
    return _lk_core(
        prev_levels, next_images, pts, eps2, min_eig_thr, win, max_iters,
        levels,
    )


def _lk_core(prev_levels, next_images, pts, eps2, min_eig_thr, win,
             max_iters, levels, init_flow=None):
    """Coarse-to-fine chain over one (prev, next) pyramid pair.

    ``init_flow`` (N, 2), when given, seeds the top-level guess (chained
    skip initialization); None reproduces cv2's from-scratch start."""
    n = pts.shape[0]
    top = levels - 1
    start = pts if init_flow is None else pts + init_flow
    cur_next = start * (1.0 / (1 << top))
    status = jnp.ones((n,), bool)
    err = jnp.zeros((n,), jnp.float32)

    for lvl in range(top, -1, -1):
        cur_prev = pts * (1.0 / (1 << lvl))
        if lvl != top:
            cur_next = cur_next * 2.0
        imgp, dxp, dyp, shape_p = prev_levels[lvl]
        cur_next, status, err = _lk_level(
            imgp, dxp, dyp, next_images[lvl],
            cur_prev, cur_next, status,
            jnp.bool_(lvl == 0), shape_p,
            eps2, min_eig_thr,
            win=win, max_iters=max_iters,
        )
    return cur_next, status, err


@partial(jax.jit, static_argnames=("win", "max_iters", "levels"))
def _lk_all_levels_multi(
    prev_levels,
    next_images_stacked,   # tuple of (T, Hp, Wp) arrays, one per level
    pts,
    eps2,
    min_eig_thr,
    init_flow=None,        # optional (T, N, 2) top-level seed
    *,
    win: int,
    max_iters: int,
    levels: int,
):
    """Track the SAME features into T target frames in one program.

    The previous frame's patches, derivatives and 2×2 normal matrices
    don't depend on the target, so a ``vmap`` over the target axis
    batches only the iteration (XLA keeps the unbatched prep shared).
    One dispatch covers a full ±{1,2,4,8} skip fan-out — the reference's
    per-pair thread pool (cpp/opticalflow.cc:269-309) becomes a batch
    dimension.  ``init_flow`` (T, N, 2) optionally seeds each target's
    top-level guess (chained skip initialization).
    """
    if init_flow is None:
        def solve_one(next_images):
            return _lk_core(
                prev_levels, next_images, pts, eps2, min_eig_thr, win,
                max_iters, levels,
            )

        return jax.vmap(solve_one)(next_images_stacked)

    def solve_seeded(next_images, init):
        return _lk_core(
            prev_levels, next_images, pts, eps2, min_eig_thr, win,
            max_iters, levels, init_flow=init,
        )

    return jax.vmap(solve_seeded)(next_images_stacked, init_flow)


def _analyze_mesh():
    """Target-sharding mesh for Analyze (SURVEY §2.4 row 1).

    Auto-routes whenever more than one device is visible — mirroring
    ``refine_trajectory``'s auto-shard — so a pod never silently runs the
    flagship pipeline on one device.  ``POLYCHASE_SHARD_ANALYZE=0`` forces
    the single-device program; ``=1`` keeps the old explicit opt-in."""
    flag = os.environ.get("POLYCHASE_SHARD_ANALYZE", "").strip().lower()
    if flag in ("0", "false", "off"):
        return None
    if jax.device_count() < 2:
        return None
    mesh = globals().get("_ANALYZE_MESH")
    if mesh is None:
        from ..parallel.analyze import make_target_mesh

        mesh = make_target_mesh()
        globals()["_ANALYZE_MESH"] = mesh
    return mesh


def _dispatch_multi_xla(prev_pyr, stacked, pts_p, eps, opts, levels, T):
    """Multi-target dispatch; shards the target axis over a device mesh
    when enabled (the reference's per-pair thread pool becomes devices).

    Returns ``(out, pts_dev, pts_p)`` — the device-resident (possibly
    re-padded) points ride along so the compress pack reuses the upload
    instead of uploading them again."""
    kw = dict(
        win=opts.window_size, max_iters=opts.term_max_iters, levels=levels
    )
    mesh = _analyze_mesh()
    if mesh is not None and int(mesh.devices.size) > 1 and (
        pts_p.shape[0] >= _feat_shard_min()
    ):
        from ..parallel.analyze import sharded_lk_multi_feat

        D = int(mesh.devices.size)
        pts_p = _pad_pts(pts_p, D)
        pts_dev = jnp.asarray(pts_p)
        out = sharded_lk_multi_feat(
            mesh, tuple(prev_pyr.levels[:levels]), stacked,
            pts_dev,
            jnp.float32(eps * eps),
            jnp.float32(opts.min_eigen_threshold),
            **kw,
        )
        return out, pts_dev, pts_p
    pts_dev = jnp.asarray(pts_p)
    args = (
        pts_dev,
        jnp.float32(eps * eps),
        jnp.float32(opts.min_eigen_threshold),
    )
    if mesh is not None and T >= 2:
        from ..parallel.analyze import shard_targets, sharded_lk_multi

        D = int(mesh.devices.size)
        pad = (-T) % D
        if pad:
            stacked = tuple(
                jnp.concatenate(
                    [s, jnp.repeat(prev_pyr.levels[lvl][0][None], pad, 0)]
                )
                for lvl, s in enumerate(stacked)
            )
        nxt, status, err = sharded_lk_multi(
            mesh, tuple(prev_pyr.levels[:levels]),
            shard_targets(mesh, stacked), *args, **kw,
        )
        return (nxt[:T], status[:T], err[:T]), pts_dev, pts_p
    out = _lk_all_levels_multi(
        tuple(prev_pyr.levels[:levels]), stacked, *args, **kw
    )
    return out, pts_dev, pts_p


def _lk_compress_enabled() -> bool:
    """Compress the multi-target result transfer (POLYCHASE_LK_COMPRESS=0
    restores raw f32).  Halves the device→host bytes of every analyze
    dispatch; not measured on the GPU."""
    return os.environ.get("POLYCHASE_LK_COMPRESS", "1") != "0"


@jax.jit
def _pack_lk_results(nxt, status, err, pts):
    """Shrink the device→host result transfer 638→~300 KB per dispatch.

    Positions travel as int16 DELTAS from the (f32) input points with a
    per-dispatch dynamic scale: quantization is max|delta|/32700 — about
    0.001 px on a typical 640p fan and still ≤0.04 px for a 1200 px
    4K fast-pan skip-8 flow (a fixed f16 encoding would quantize large
    flows to a 0.25-0.5 px grid).  err is magnitude-only (IRLS weights
    downstream) so f16's 1e-3 relative is plenty; status bools pack
    8-per-byte.  The host reconstructs with the SAME f32 points and the
    transferred scale, so the only loss is the delta rounding.
    """
    delta = nxt - pts[None]
    dmax = jnp.maximum(jnp.max(jnp.abs(delta)), 1e-3)
    scale = 32700.0 / dmax
    q = jnp.round(delta * scale).astype(jnp.int16)
    T, N = status.shape
    bits = status.reshape(T, N // 8, 8).astype(jnp.int32)
    weights = (1 << jnp.arange(8, dtype=jnp.int32))
    packed = jnp.sum(bits * weights, axis=-1).astype(jnp.uint8)
    return q, scale.astype(jnp.float32), packed, err.astype(jnp.float16)


def chain_engages(skips, n_features=None) -> bool:
    """True when a fan with these skips will route through the chained
    dispatch (callers then skip their own target padding — phases pad
    internally).

    On a multi-device mesh, chaining engages only in the feature-shard
    regime (``n_features`` ≥ POLYCHASE_FEAT_SHARD_MIN): seeds are
    per-feature so they shard with the features at zero collectives,
    while below the threshold the target-sharded independent solves
    use the mesh better than 2-wide chained phases would."""
    if skips is None or not _lk_chain_enabled():
        return False
    if len({abs(s) for s in skips}) < 2:
        return False
    mesh = _analyze_mesh()
    if mesh is None or int(mesh.devices.size) <= 1:
        return True
    return n_features is not None and n_features >= _feat_shard_min()


def calc_optical_flow_multi_async(
    prev_pyr: PyramidCache,
    next_pyrs: List[PyramidCache],
    prev_pts: np.ndarray,
    opts: LKOptions = LKOptions(),
    skips=None,
):
    """Dispatch a multi-target solve without blocking.

    Returns an opaque handle for :func:`calc_optical_flow_multi_finish`;
    the device work and the result transfer overlap subsequent host work
    (JAX dispatch is asynchronous).  ``skips`` (frame offsets aligned
    with ``next_pyrs``) enables chained skip initialization on a single
    device (see :func:`_chained_dispatch`).
    """
    pts = np.ascontiguousarray(prev_pts, np.float32).reshape(-1, 2)
    n = pts.shape[0]
    T = len(next_pyrs)
    if n == 0 or T == 0:
        return ("empty", T, n)
    levels = min([prev_pyr.num_levels] + [p.num_levels for p in next_pyrs])
    pts, inv = _spatial_sort(pts)
    m = _bucket(n)
    pts_p = np.zeros((m, 2), np.float32)
    pts_p[:n] = pts

    if skips is not None and len(skips) == T and chain_engages(skips, n):
        phase_outs, slot_map, pts_dev, pts_p = _chained_dispatch(
            prev_pyr, next_pyrs, list(skips), pts_p, opts, levels
        )
        compress = _lk_compress_enabled()
        if compress:
            phase_outs = [
                _pack_lk_results(o[0], o[1], o[2], pts_dev)
                for o in phase_outs
            ]
        for o in phase_outs:
            _start_host_copies(o)
        return (
            "devch", n, phase_outs, slot_map, inv, pts_p, T, compress
        )

    stacked = tuple(
        jnp.stack([p.levels[lvl][0] for p in next_pyrs])
        for lvl in range(levels)
    )
    eps = min(max(opts.term_epsilon, 0.0), 10.0)
    out, pts_dev, pts_p = _dispatch_multi_xla(
        prev_pyr, stacked, pts_p, eps, opts, levels, T
    )
    if _lk_compress_enabled():
        out = _pack_lk_results(out[0], out[1], out[2], pts_dev)
        _start_host_copies(out)
        return ("devc", n, out, inv, pts_p)
    _start_host_copies(out)
    return ("dev", n, out, inv)


def _start_host_copies(out) -> None:
    """Begin device→host copies right after dispatch: the transfer then
    overlaps subsequent dispatches instead of serializing inside the
    blocking finish."""
    for arr in jax.tree.leaves(out):
        try:
            arr.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without support
            break


def _unpack_lk_results(fetched, pts_p):
    """Host half of :func:`_pack_lk_results`."""
    q, scale, packed, errh = fetched
    nxt = pts_p[None] + q.astype(np.float32) * (1.0 / float(scale))
    status = np.unpackbits(packed, axis=-1, bitorder="little").astype(bool)
    return nxt, status, errh.astype(np.float32)


def _pad_pts(pts_p: np.ndarray, step: int) -> np.ndarray:
    """Zero-pad (N, 2) points to a multiple of ``step``.

    Every padded width must ALSO be a multiple of 8 — the packed-status
    transfer reshapes (T, N//8, 8) — so the step is rounded up to the
    lcm with 8 (matters for non-power-of-2 device counts)."""
    step = step * 8 // np.gcd(step, 8)
    m = -(-pts_p.shape[0] // step) * step
    if m == pts_p.shape[0]:
        return pts_p
    return np.concatenate(
        [pts_p, np.zeros((m - pts_p.shape[0], 2), np.float32)]
    )


def calc_optical_flow_multi_finish(handle):
    """Block on a :func:`calc_optical_flow_multi_async` handle."""
    if handle[0] == "empty":
        _, T, n = handle
        return (
            np.empty((T, 0, 2), np.float32),
            np.empty((T, 0), bool),
            np.empty((T, 0), np.float32),
        )
    if handle[0] == "devch":
        _, n, phase_outs, slot_map, inv, pts_p, T, compress = handle
        m = pts_p.shape[0]
        nxt = np.zeros((T, m, 2), np.float32)
        status = np.zeros((T, m), bool)
        err = np.zeros((T, m), np.float32)
        fetched = jax.device_get(phase_outs)
        for slots, out in zip(slot_map, fetched):
            if compress:
                pnxt, pst, perr = _unpack_lk_results(out, pts_p)
            else:
                pnxt, pst, perr = out
            for col, orig in enumerate(slots):
                if orig is None:
                    continue
                nxt[orig] = pnxt[col]
                status[orig] = pst[col]
                err[orig] = perr[col]
    elif handle[0] == "devc":
        _, n, out, inv, pts_p = handle
        nxt, status, err = _unpack_lk_results(jax.device_get(out), pts_p)
    else:
        _, n, out, inv = handle
        nxt, status, err = jax.device_get(out)
    if inv is None:
        return nxt[:, :n], status[:, :n], err[:, :n]
    return nxt[:, inv], status[:, inv], err[:, inv]


def _spatial_sort(pts: np.ndarray):
    """Row-major spatial ordering of features for the LK dispatch.

    Per-feature solves are independent, so any ordering is
    semantics-free — but neighbouring features then gather overlapping
    image windows, which keeps the patch reads cache-local.  Keypoints arrive
    quality-sorted (scattered across the image); re-sort by (y, x) and
    return the inverse permutation for the finish path.
    ``POLYCHASE_LK_SORT=0`` keeps the caller's order.
    """
    n = pts.shape[0]
    if n <= GROUP_SORT_MIN or os.environ.get(
        "POLYCHASE_LK_SORT", "1"
    ) == "0":
        return pts, None
    # Single packed-key argsort == np.lexsort((x, y)) but ~3x faster on
    # the 1-core host: IEEE bits of a float are order-preserving once
    # sign-magnitude is mapped to biased-unsigned.  -0.0 is collapsed to
    # +0.0 first (lexsort compares them equal; the raw bit patterns do
    # not) — same fix as the C packed key in native/bvh.cc.  NaN
    # coordinates are out of scope: the order is inverted back after the
    # dispatch, so any total order is semantics-preserving.
    b = np.ascontiguousarray(pts, np.float32).view(np.uint32)
    b = np.where(b == np.uint32(0x80000000), np.uint32(0), b)
    b = np.where(b & 0x80000000, ~b, b | np.uint32(0x80000000))
    key = (b[:, 1].astype(np.uint64) << np.uint64(32)) | b[:, 0]
    order = np.argsort(key, kind="stable")  # radix for ints == lexsort order
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return pts[order], inv


GROUP_SORT_MIN = 128  # below this the sort costs more than it saves


def calc_optical_flow_multi(
    prev_pyr: PyramidCache,
    next_pyrs: List[PyramidCache],
    prev_pts: np.ndarray,
    opts: LKOptions = LKOptions(),
):
    """Track ``prev_pts`` into several target frames with ONE dispatch.

    Returns ``(next_pts (T,N,2), status (T,N), err (T,N))``.
    """
    pts = np.ascontiguousarray(prev_pts, np.float32).reshape(-1, 2)
    n = pts.shape[0]
    T = len(next_pyrs)
    if n == 0 or T == 0:
        return (
            np.empty((T, 0, 2), np.float32),
            np.empty((T, 0), bool),
            np.empty((T, 0), np.float32),
        )
    return calc_optical_flow_multi_finish(
        calc_optical_flow_multi_async(prev_pyr, next_pyrs, prev_pts, opts)
    )
