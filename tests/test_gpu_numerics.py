"""Numerics that only the card can show: a float32 product asked for
HIGHEST precision stays float32-accurate on the GPU (at DEFAULT it may
run in TF32), and the tracking chain compiled for the card agrees with
the CPU stand-in.  The ``cuda_device`` fixture skips these elsewhere;
``chip_smoke.py`` runs them on the card."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.cuda
def test_highest_precision_matmul_is_float32_on_card(cuda_device):
    import jax
    import jax.numpy as jnp

    from polychase_tpu.engine import pose as P

    rng = np.random.default_rng(0)
    a = rng.normal(size=(4096, 3)).astype(np.float32) * 4.0
    b = rng.normal(size=(3, 3)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(jax.jit(P.matmul)(jnp.asarray(a), jnp.asarray(b)))
    # float32 rounding of a 3-term dot: a few ulps of |a|·|b|.
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.max(np.abs(got - ref) / scale) < 1e-6


@pytest.mark.cuda
def test_tracking_chain_matches_stand_in_on_card(cuda_device, tmp_path):
    sys.path.insert(0, ROOT)
    import chip_smoke

    _, _, checks, info = chip_smoke.phase_track(
        0, n_frames=40, kp_per_frame=1024, n_lat=64, n_lon=128,
        tmp=str(tmp_path),
    )
    assert info["frames_solved"] == 40
    failed = [c.line() for c in checks if not c.ok]
    assert not failed, failed
