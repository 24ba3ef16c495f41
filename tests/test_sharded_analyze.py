"""Target-sharded Analyze fan-out: parity with the single-device solve."""

import numpy as np
import jax
import jax.numpy as jnp

from polychase_tpu.engine import lk
from polychase_tpu.parallel.analyze import (
    make_target_mesh,
    shard_targets,
    sharded_lk_multi,
)


def _clip(rng, n=10, h=96, w=160):
    import scipy.ndimage as ndi

    big = ndi.gaussian_filter(
        rng.uniform(0, 255, (h + 40, w + 40)).astype(np.float32), 1.5
    )
    return [
        np.ascontiguousarray(big[2 * t : 2 * t + h, 3 * t : 3 * t + w])
        for t in range(n)
    ]


def test_sharded_lk_multi_matches_single(rng):
    assert jax.device_count() >= 8
    frames = _clip(rng)
    opts = lk.LKOptions()
    pyrs = [
        lk._prepare_levels(
            lk.build_pyramid(jnp.asarray(f, jnp.float32), 3),
            win=opts.window_size, levels=3,
        )
        for f in frames
    ]
    pts = rng.uniform((12, 12), (148, 84), (256, 2)).astype(np.float32)
    prev = pyrs[4]
    target_ids = [0, 1, 2, 3, 5, 6, 7, 8]  # T = 8 = mesh size

    stacked = tuple(
        jnp.stack([pyrs[t][lvl][0] for t in target_ids])
        for lvl in range(3)
    )
    args = (
        jnp.asarray(pts),
        jnp.float32(opts.term_epsilon**2),
        jnp.float32(opts.min_eigen_threshold),
    )
    ref = lk._lk_all_levels_multi(
        prev, stacked, *args,
        win=opts.window_size, max_iters=opts.term_max_iters, levels=3,
    )

    mesh = make_target_mesh()
    sharded = sharded_lk_multi(
        mesh, prev, shard_targets(mesh, stacked), *args,
        win=opts.window_size, max_iters=opts.term_max_iters, levels=3,
    )

    nxt_r, st_r, err_r = jax.device_get(ref)
    nxt_s, st_s, err_s = jax.device_get(sharded)
    assert np.array_equal(st_r, st_s)
    both = st_r
    np.testing.assert_allclose(nxt_s[both], nxt_r[both], atol=1e-5)
    np.testing.assert_allclose(err_s[both], err_r[both], atol=1e-4)


def test_feature_sharded_lk_matches_single(rng):
    """Feature-axis sharding (the axis that grows with resolution) must
    match the unsharded multi-target solve exactly on the status mask and
    to float tolerance on positions."""
    from polychase_tpu.parallel.analyze import sharded_lk_multi_feat

    assert jax.device_count() >= 8
    frames = _clip(rng)
    opts = lk.LKOptions()
    pyrs = [
        lk._prepare_levels(
            lk.build_pyramid(jnp.asarray(f, jnp.float32), 3),
            win=opts.window_size, levels=3,
        )
        for f in frames
    ]
    # N = 256 = 8 devices × 32 features
    pts = rng.uniform((12, 12), (148, 84), (256, 2)).astype(np.float32)
    prev = pyrs[4]
    target_ids = [0, 1, 2, 3, 5, 6, 7, 8]
    stacked = tuple(
        jnp.stack([pyrs[t][lvl][0] for t in target_ids])
        for lvl in range(3)
    )
    args = (
        jnp.asarray(pts),
        jnp.float32(opts.term_epsilon**2),
        jnp.float32(opts.min_eigen_threshold),
    )
    ref = lk._lk_all_levels_multi(
        prev, stacked, *args,
        win=opts.window_size, max_iters=opts.term_max_iters, levels=3,
    )
    mesh = make_target_mesh()
    sharded = sharded_lk_multi_feat(
        mesh, prev, stacked, *args,
        win=opts.window_size, max_iters=opts.term_max_iters, levels=3,
    )
    nxt_r, st_r, err_r = jax.device_get(ref)
    nxt_s, st_s, err_s = jax.device_get(sharded)
    assert np.array_equal(st_r, st_s)
    np.testing.assert_allclose(nxt_s[st_r], nxt_r[st_r], atol=1e-5)
    np.testing.assert_allclose(err_s[st_r], err_r[st_r], atol=1e-4)


def test_pipeline_feature_shard_routing(tmp_path, monkeypatch):
    """POLYCHASE_FEAT_SHARD_MIN=1 forces the feature-sharded route through
    the full pipeline; the database must agree with the unsharded run."""
    from polychase_tpu.engine.opticalflow import (
        VideoInfo,
        generate_optical_flow_database,
    )
    from polychase_tpu.io.database import Database

    rng = np.random.default_rng(3)
    W, H, n = 160, 120, 5
    big = np.cumsum(rng.uniform(0, 4, (H + 20, W + 30)), axis=1)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    frames = [
        np.ascontiguousarray(big[2 * t : 2 * t + H, 3 * t : 3 * t + W])
        for t in range(n)
    ]
    info = VideoInfo(W, H, 0, n)

    def run(feat_min):
        monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "1")
        monkeypatch.setenv("POLYCHASE_FEAT_SHARD_MIN", feat_min)
        path = str(tmp_path / f"flow_{feat_min}.db")
        generate_optical_flow_database(
            info, lambda fid: frames[fid], None, path
        )
        db = Database(path)
        kps = {i: db.read_keypoints(i) for i in range(n)}
        flows = {}
        for i in range(n):
            for j in db.find_optical_flows_from_image(i):
                flows[(i, j)] = db.read_image_pair_flow(i, j)
        db.close()
        return kps, flows

    kps_a, flows_a = run("1000000000")   # never: target sharding
    kps_b, flows_b = run("1")            # always: feature sharding
    for i in range(n):
        np.testing.assert_array_equal(kps_a[i], kps_b[i])
    assert set(flows_a) == set(flows_b)
    agree = total = 0
    for key in flows_a:
        fa, fb = flows_a[key], flows_b[key]
        common = np.intersect1d(fa.src_kps_indices, fb.src_kps_indices)
        total += max(len(fa.src_kps_indices), 1)
        agree += len(common)
    assert agree / total > 0.99, agree / total


def test_pipeline_env_gated_sharding_matches_default(tmp_path, monkeypatch):
    """generate_optical_flow_database with POLYCHASE_SHARD_ANALYZE=1 must
    produce the same keypoints and (nearly) the same flows as the
    single-device path, end-to-end through the SQLite database."""
    import os

    import numpy as np

    from polychase_tpu.engine.opticalflow import (
        VideoInfo,
        generate_optical_flow_database,
    )
    from polychase_tpu.io.database import Database

    rng = np.random.default_rng(0)
    W, H, n = 160, 120, 5
    big = np.cumsum(rng.uniform(0, 4, (H + 20, W + 30)), axis=1)
    big = (255 * (big - big.min()) / np.ptp(big)).astype(np.uint8)
    frames = [
        np.ascontiguousarray(big[2 * t : 2 * t + H, 3 * t : 3 * t + W])
        for t in range(n)
    ]
    info = VideoInfo(W, H, 0, n)

    def run(shard):
        monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "1" if shard else "0")
        path = str(tmp_path / f"flow_{int(shard)}.db")
        generate_optical_flow_database(
            info, lambda fid: frames[fid], None, path
        )
        db = Database(path)
        kps = {i: db.read_keypoints(i) for i in range(n)}
        flows = {}
        for i in range(n):
            for j in db.find_optical_flows_from_image(i):
                flows[(i, j)] = db.read_image_pair_flow(i, j)
        db.close()
        return kps, flows

    kps_a, flows_a = run(False)
    kps_b, flows_b = run(True)
    for i in range(n):
        np.testing.assert_array_equal(kps_a[i], kps_b[i])
    assert set(flows_a) == set(flows_b)
    agree = 0
    total = 0
    for key in flows_a:
        fa, fb = flows_a[key], flows_b[key]
        common = np.intersect1d(fa.src_kps_indices, fb.src_kps_indices)
        total += max(len(fa.src_kps_indices), 1)
        agree += len(common)
    assert agree / total > 0.99, agree / total


def test_chained_feature_sharded_matches_single_device(rng, monkeypatch):
    """Chained skip phases with the feature axis sharded over the mesh
    must match the single-device chained solve: seeds are per-feature,
    so sharding them adds no collectives and no numeric difference
    beyond the (shared) f16 transfer rounding."""
    assert jax.device_count() >= 8
    monkeypatch.setenv("POLYCHASE_FEAT_SHARD_MIN", "64")
    monkeypatch.setenv("POLYCHASE_LK_CHAIN", "1")
    frames = _clip(rng)
    opts = lk.LKOptions()
    caches = [lk.prepare_pyramid(f.astype(np.uint8), opts) for f in frames]
    pts = rng.uniform((12, 12), (148, 84), (300, 2)).astype(np.float32)
    prev = caches[1]
    skips = [-1, 1, 2, 4, 8]
    targets = [caches[1 + s] for s in skips]

    assert lk.chain_engages(skips, len(pts))
    h = lk.calc_optical_flow_multi_async(prev, targets, pts, opts,
                                         skips=skips)
    assert h[0] == "devch"
    sn, ss, se = lk.calc_optical_flow_multi_finish(h)

    # Single-device chained reference (mesh off).
    monkeypatch.setenv("POLYCHASE_SHARD_ANALYZE", "0")
    h = lk.calc_optical_flow_multi_async(prev, targets, pts, opts,
                                         skips=skips)
    assert h[0] == "devch"
    rn, rs, re = lk.calc_optical_flow_multi_finish(h)

    for i in range(len(skips)):
        np.testing.assert_array_equal(ss[i], rs[i])
        both = ss[i] & rs[i]
        np.testing.assert_allclose(sn[i][both], rn[i][both], atol=0.02)
