"""XLA pyramidal LK (engine/lk.py) on the cases a GPU run depends on:
textureless features marked lost, large motion through the pyramid, odd
frame sizes, feature-count padding, and the multi-target solve equal to
one solve per target."""

import numpy as np
import pytest
from scipy.ndimage import gaussian_filter

from polychase_tpu.engine.lk import (
    LKOptions,
    _bucket,
    calc_optical_flow,
    calc_optical_flow_multi,
    num_pyramid_levels,
    prepare_pyramid,
)

OPTS = LKOptions()


def texture(seed, h, w):
    """Two-scale Gaussian-filtered noise: fine grain plus coarse
    structure that survives the pyramid's reduction."""
    rng = np.random.default_rng(seed)
    fine = gaussian_filter(rng.random((h, w)), 1.5)
    coarse = gaussian_filter(rng.random((h, w)), 6.0)
    img = fine / fine.std() + coarse / coarse.std()
    return (255 * (img - img.min()) / np.ptp(img)).astype(np.uint8)


def pair(seed, h, w, dx, dy, margin=40):
    """Two crops of one texture; the second sees the scene moved by
    (dx, dy) pixels."""
    big = texture(seed, h + 2 * margin, w + 2 * margin)
    a = big[margin : margin + h, margin : margin + w]
    b = big[margin - dy : margin - dy + h, margin - dx : margin - dx + w]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def grid_points(h, w, n, border):
    rng = np.random.default_rng(n)
    return rng.uniform((border, border), (w - border, h - border),
                       (n, 2)).astype(np.float32)


@pytest.mark.parametrize("multi", [False, True])
def test_textureless_features_marked_lost(multi):
    h, w = 120, 160
    a, b = pair(0, h, w, 2, 1)
    a = a.copy()
    b = b.copy()
    a[:, :60] = 128   # flat band: no gradient for LK's normal matrix
    b[:, :60] = 128
    flat = np.array([[20.0, 30.0], [30.0, 60.0], [25.0, 90.0]], np.float32)
    tex = np.array([[100.0, 40.0], [120.0, 70.0], [110.0, 95.0]],
                   np.float32)
    pts = np.concatenate([flat, tex])
    pa, pb = prepare_pyramid(a, OPTS), prepare_pyramid(b, OPTS)
    if multi:
        nxt, status, _ = calc_optical_flow_multi(pa, [pb, pb], pts, OPTS)
        nxt, status = nxt[1], status[1]
    else:
        nxt, status, _ = calc_optical_flow(pa, pb, pts, OPTS)
    assert not status[:3].any()
    assert status[3:].all()
    np.testing.assert_allclose(nxt[3:] - tex, [[2.0, 1.0]] * 3, atol=0.05)


@pytest.mark.parametrize("dx,dy", [(12, -7), (-20, 14), (28, 0)])
def test_large_motion(dx, dy):
    h, w = 240, 320
    a, b = pair(1, h, w, dx, dy)
    pts = grid_points(h, w, 300, 40)
    nxt, status, _ = calc_optical_flow(
        prepare_pyramid(a, OPTS), prepare_pyramid(b, OPTS), pts, OPTS
    )
    assert status.mean() > 0.9
    err = np.linalg.norm(nxt[status] - pts[status] - [dx, dy], axis=-1)
    assert np.median(err) < 0.05
    assert np.mean(err < 0.1) > 0.85


@pytest.mark.parametrize("h,w", [(97, 131), (120, 161), (45, 67)])
def test_odd_frame_sizes(h, w):
    """Levels halve with rounding up; tracking works up to the borders'
    padding at every size."""
    a, b = pair(2, h, w, 1, 2)
    pa = prepare_pyramid(a, OPTS)
    levels = num_pyramid_levels(h, w, OPTS)
    assert pa.num_levels == levels
    hh, ww = h, w
    for lvl in range(levels):
        img_pad, _dx, _dy, shape = pa.levels[lvl]
        assert tuple(np.asarray(shape)) == (hh, ww)
        assert img_pad.shape[0] > hh and img_pad.shape[1] > ww
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
    pts = grid_points(h, w, 40, 12)
    nxt, status, err = calc_optical_flow(pa, prepare_pyramid(b, OPTS), pts,
                                         OPTS)
    assert nxt.shape == (40, 2) and status.shape == (40,)
    assert err.shape == (40,)
    assert status.mean() > 0.8
    flow = nxt[status] - pts[status]
    np.testing.assert_allclose(np.median(flow, axis=0), [1.0, 2.0],
                               atol=0.05)


@pytest.mark.parametrize("n", [1, 255, 257, 2049])
def test_feature_count_padding(n):
    """Feature counts pad to shape buckets; padding never changes the
    real features' results."""
    assert _bucket(n) >= n
    h, w = 96, 128
    a, b = pair(3, h, w, 2, -1)
    pa, pb = prepare_pyramid(a, OPTS), prepare_pyramid(b, OPTS)
    pts = grid_points(h, w, n, 12)
    extra = grid_points(h, w, 7, 12)
    nxt, status, err = calc_optical_flow(pa, pb, pts, OPTS)
    nxt2, status2, err2 = calc_optical_flow(pa, pb,
                                            np.concatenate([pts, extra]),
                                            OPTS)
    assert nxt.shape == (n, 2)
    np.testing.assert_array_equal(status, status2[:n])
    np.testing.assert_allclose(nxt, nxt2[:n], atol=1e-4)


@pytest.mark.parametrize("T", [1, 3, 8])
def test_multi_target_equals_single(T):
    h, w = 96, 128
    big = texture(4, h + 40, w + 40)
    frames = [np.ascontiguousarray(big[2 * t : 2 * t + h, t : t + w])
              for t in range(T + 1)]
    pyrs = [prepare_pyramid(f, OPTS) for f in frames]
    pts = grid_points(h, w, 200, 14)
    nxt, status, err = calc_optical_flow_multi(pyrs[0], pyrs[1:], pts, OPTS)
    assert nxt.shape == (T, 200, 2)
    for t in range(T):
        n1, s1, e1 = calc_optical_flow(pyrs[0], pyrs[t + 1], pts, OPTS)
        np.testing.assert_array_equal(status[t], s1)
        # Multi-target results travel int16-quantized (engine/lk.py
        # _pack_lk_results): within ~0.01 px of the f32 positions.
        np.testing.assert_allclose(nxt[t][s1], n1[s1], atol=1e-2)
