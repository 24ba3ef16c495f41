"""Every float32 product on the tracking hot path asks for HIGHEST
precision: at DEFAULT a GPU may run a float32 dot in TF32 (~3 decimal
digits), about a pixel of reprojection error at tracking depths.  The
CPU cannot show TF32, so the lowered programs are checked instead."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polychase_tpu.engine.levmarq import BundleOptions, CAUCHY
from polychase_tpu.engine.pnp import normalize_bundle_opts

from synthetic import make_sphere_mesh


def _dots(text):
    return [l for l in text.splitlines() if "dot_general" in l]


def _assert_highest(text):
    dots = _dots(text)
    assert dots
    for line in dots:
        if "f32" not in line:
            continue
        assert re.search(r"precision = \[HIGHEST, HIGHEST\]", line), line


@pytest.mark.parametrize("opt", [False, True])
def test_scan_chunk_has_no_default_precision_dot(opt):
    from polychase_tpu.engine.tracker import _scan_track_fn

    run = _scan_track_fn(
        opt, opt, tuple(normalize_bundle_opts(
            BundleOptions(loss_type=CAUCHY, loss_scale=1.0))),
        packed_idx=True, quant_tgt=True, fused_meta=True,
    )
    F, n, Gp, K, Kmax = 6, 4, 8, 64, 64
    xs = (
        jnp.zeros((n, 2 * Gp + 3), jnp.int32),
        jnp.zeros((n, Gp, K), jnp.uint16),
        jnp.zeros((n, Gp, K, 2), jnp.int16),
    )
    eye = jnp.eye(4, dtype=jnp.float32)
    text = run.lower(
        make_sphere_mesh(6, 8), eye, eye,
        jnp.zeros((F, 4), jnp.float32), jnp.zeros((F, 3), jnp.float32),
        jnp.zeros((F, 4), jnp.float32), jnp.zeros((5,), jnp.float32),
        jnp.zeros((F, Kmax, 2), jnp.float32), xs,
    ).as_text()
    _assert_highest(text)


def test_matmul_helper_asks_for_highest():
    from polychase_tpu.engine import pose as P

    a = jnp.ones((5, 3), jnp.float32)
    b = jnp.ones((3, 3), jnp.float32)
    _assert_highest(jax.jit(P.matmul).lower(a, b).as_text())
    np.testing.assert_allclose(P.matmul(a, b), a @ b)
