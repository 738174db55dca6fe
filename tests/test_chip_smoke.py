"""``chip_smoke.py`` on the CPU: it refuses to run without a GPU, and each
of its phases runs here at tiny sizes (the card runs them at full size)."""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_exits_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", HOME=str(tmp_path))
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


@pytest.fixture(scope="module")
def maooam():
    return chip_smoke.Model(chip_smoke.maooam_params())


@pytest.fixture(scope="module")
def flagship(maooam):
    return chip_smoke.phase_flagship(maooam, batch=8, n_cmp=2, steps_cmp=100,
                                     steps_time=20)


def _passed(ph):
    assert ph.checks
    assert all(err <= tol for _, err, tol, _ in ph.checks)
    assert "card: test" in ph.line("test")


def test_phase_flagship(flagship):
    ph, y64 = flagship
    _passed(ph)
    assert y64.shape == (8, 36)


def test_phase_f32(maooam, flagship):
    _passed(chip_smoke.phase_f32(maooam, flagship[1], batch=8))


# XLA:CPU strips the double-float EFT barriers (see
# tests/test_twofloat.py), so the CPU runs hold the double-float results
# to the CPU tests' bounds instead of the card's 1e-12
CPU_DF_TOL = 1e-9


def test_phase_twofloat(maooam, flagship):
    _passed(chip_smoke.phase_twofloat(maooam, flagship[1], batch=8,
                                      batch_time=8, steps_time=5,
                                      df_tol=CPU_DF_TOL))


def test_phase_tangent(maooam):
    _passed(chip_smoke.phase_tangent(maooam, batch_tgls=4, n_cmp=2, steps=20,
                                     batch_lyap=4, n_pre=2, n_rec=4,
                                     batch_clv=2, df_tol=CPU_DF_TOL))


def test_phase_high_truncation():
    high = chip_smoke.Model(chip_smoke.maooam_params((6, 6), (6, 6)))
    _passed(chip_smoke.phase_high_truncation(high, batch=4, n_cmp=1,
                                             steps=10))


def test_phase_four_on_cpu_mesh(maooam):
    high = chip_smoke.Model(chip_smoke.maooam_params((6, 6), (6, 6)))
    ph = chip_smoke.phase_four(maooam, high, jax.devices()[:4], batch=8,
                               steps=10)
    _passed(ph)
    assert "model_axis_out" in ph.info


def test_failed_check_raises():
    ph = chip_smoke.Phase("phase x")
    ph.check("ok", 1e-13, 1e-12, "why")
    with pytest.raises(chip_smoke.SmokeFailure):
        ph.check("too big", 1e-11, 1e-12, "why")
    with pytest.raises(chip_smoke.SmokeFailure):
        ph.check("nan", np.nan, 1e-12, "why")
