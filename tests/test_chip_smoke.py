"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phases runs and passes its own checks at a tiny size (multi-device
phases on virtual CPU devices)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _no_result(proc):
    assert proc.returncode != 0
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    assert '"ok"' not in last


def test_cuda_tests_are_listed_and_marked():
    for path in cs.CUDA_TESTS:
        with open(os.path.join(ROOT, path)) as f:
            src = f.read()
        assert "@pytest.mark.cuda" in src and "cuda_device" in src


def test_refuses_cpu_backend():
    proc = _run_script(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    _no_result(proc)
    assert "needs a GPU" in proc.stderr
    assert "==" not in proc.stdout  # no phase started


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    _no_result(_run_script(tmp_path, str(tmp_path / "chip_smoke.py")))


@pytest.mark.parametrize(
    "value,tol,upper,ok",
    [(0.05, 0.1, True, True), (0.2, 0.1, True, False),
     (0.95, 0.9, False, True), (0.5, 0.9, False, False)],
)
def test_check_bounds(value, tol, upper, ok):
    c = cs.Check("x", value, tol, upper=upper)
    assert c.ok is ok
    assert ("ok" if ok else "FAIL") in c.line()


def _assert_checks(checks):
    assert checks
    failed = [c.line() for c in checks if not c.ok]
    assert not failed, failed


def test_phase_pin_tiny(monkeypatch):
    """Both routes: 8 pins on the host, 64 pins on the device."""
    monkeypatch.setenv("POLYCHASE_HOST_PIN_MAX", "16")
    _, _, checks, info = cs.phase_pin(0, n_pins=(8, 64), n_lat=64,
                                      n_lon=128)
    _assert_checks(checks)
    assert "(host)" in checks[0].name and "(device)" in checks[1].name


def test_phase_track_tiny(tmp_path):
    _, _, checks, info = cs.phase_track(
        0, n_frames=10, kp_per_frame=64, n_lat=12, n_lon=16,
        tmp=str(tmp_path),
    )
    _assert_checks(checks)
    assert info["frames_solved"] == 10


def test_phase_refine_tiny(tmp_path):
    _, _, checks, info = cs.phase_refine(
        0, n_frames=12, kp_per_frame=64, n_lat=12, n_lon=16,
        tmp=str(tmp_path),
    )
    _assert_checks(checks)
    # Focal estimation moved the 10% error toward the truth.
    assert abs(info["focal_ours"] - info["focal_true"]) < abs(
        info["focal_initial"] - info["focal_true"])


def test_phase_analyze_tiny(tmp_path):
    """At 320x240 the ±8 skips lose too much of the frame for the full
    size's ok-share bound; every skip still meets the EPE bound, and the
    ±1/±2 skips meet both."""
    _, _, checks, info = cs.phase_analyze(
        0, width=320, height=240, n_frames=10, tmp=str(tmp_path),
    )
    assert info["mean_corners_per_frame"] > 100
    for c in checks:
        if "EPE" in c.name or any(f"skip {s} " in c.name
                                  for s in ("-2", "-1", "+1", "+2")):
            assert c.ok, c.line()


def test_make_frames_shift():
    frames = cs.make_frames(1, 64, 48, 3)
    sx, sy = cs.SHIFT
    assert [f.shape for f in frames] == [(48, 64)] * 3
    assert frames[0].dtype == np.uint8
    np.testing.assert_array_equal(frames[1][: 48 - sy, : 64 - sx],
                                  frames[0][sy:, sx:])


def test_four_phases_on_virtual_devices(tmp_path):
    """The --four comparisons, on four virtual CPU devices."""
    devices = jax.devices()[:4]
    assert len(devices) == 4
    tmp = str(tmp_path)
    _, checks = cs.phase_four_analyze(0, 160, 120, 6, tmp, devices)
    _assert_checks(checks)
    _, checks = cs.phase_four_refine(0, 12, 64, 12, 16, tmp, devices)
    _assert_checks(checks)
    _, checks = cs.phase_four_segments(0, 4, 6, 64, 12, 16, tmp, devices)
    _assert_checks(checks)


def test_last_line_contract(monkeypatch, capsys):
    """With a GPU present the last line is the JSON the driver reads;
    simulated by faking the device and the phases."""

    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return {"peak_bytes_in_use": 1}

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    monkeypatch.setattr(cs, "run_cuda_tests", lambda: 1)
    monkeypatch.setattr(cs, "card_line", lambda: "NVIDIA H100, 700.00 W")
    ok = lambda *a, **k: (0.0, 0.0, [cs.Check("x", 0, 1)], {})  # noqa: E731
    for name in ("pin", "track", "refine", "analyze"):
        monkeypatch.setattr(cs, f"phase_{name}", ok)
    assert cs.main([]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "NVIDIA H100, 700.00 W"
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_failed_phase_exits_nonzero(monkeypatch, capsys):
    class Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

        def memory_stats(self):
            return None

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    monkeypatch.setattr(cs, "run_cuda_tests", lambda: 1)
    monkeypatch.setattr(cs, "card_line", lambda: "card")
    ok = lambda *a, **k: (0.0, 0.0, [cs.Check("x", 0, 1)], {})  # noqa: E731
    bad = lambda *a, **k: (0.0, 0.0, [cs.Check("x", 2, 1)], {})  # noqa: E731
    for name in ("pin", "track", "refine"):
        monkeypatch.setattr(cs, f"phase_{name}", ok)
    monkeypatch.setattr(cs, "phase_analyze", bad)
    assert cs.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out
