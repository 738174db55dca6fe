"""QgsModel wrapper + compile-artifact checkpointing, and the symbolic
ground/orography configuration cross-check (ref
``model_test/test_aotensor_sym_ground.py``)."""

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.models.model import (
    QgsModel, save_trajectory_checkpoint, load_trajectory_checkpoint,
)
from qgs_jax.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, GroundAnalyticInnerProducts,
)
from qgs_jax.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, GroundSymbolicInnerProducts,
)
from qgs_jax.tensors.qgtensor import QgsTensor


def _ground_params(mode):
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, gtemperature_params=True)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode=mode)
    pars.set_ground_channel_fourier_modes(mode=mode)
    pars.ground_params.set_orography(0.2, 1)
    return pars


def test_symbolic_ground_tensor_matches_analytic():
    ap = _ground_params('analytic')
    aip_a = AtmosphericAnalyticInnerProducts(ap)
    gip_a = GroundAnalyticInnerProducts(ap)
    aip_a.connect_to_ground(gip_a)
    t_ana = QgsTensor(ap, aip_a, None, gip_a)

    sp = _ground_params('symbolic')
    aip_s = AtmosphericSymbolicInnerProducts(sp, quadrature=True)
    gip_s = GroundSymbolicInnerProducts(sp, quadrature=True)
    t_sym = QgsTensor(sp, aip_s, None, gip_s)

    assert ap.ndim == sp.ndim == 30
    d_ana = t_ana.tensor.todense()
    d_sym = t_sym.tensor.todense()
    assert np.allclose(d_sym, d_ana, atol=1e-9), np.abs(d_sym - d_ana).max()


def test_qgs_model_save_load(tmp_path):
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)

    model = QgsModel(pars)
    x = np.random.default_rng(0).random(model.ndim) * 0.05
    fx = np.asarray(model.f(0., x))

    path = tmp_path / "model.qgs"
    model.save(path)
    restored = QgsModel.load(path)
    assert restored.ndim == model.ndim
    assert np.allclose(np.asarray(restored.f(0., x)), fx, rtol=1e-14)

    # trajectory checkpoint roundtrip
    ck = tmp_path / "traj.npz"
    save_trajectory_checkpoint(ck, 123.4, x, note=np.array([1, 2, 3]))
    t, state, extra = load_trajectory_checkpoint(ck)
    assert float(t) == 123.4
    assert np.allclose(state, x)
    assert np.allclose(extra["note"], [1, 2, 3])


def test_throughput_meter():
    from qgs_jax.utils.profiling import ThroughputMeter
    import time

    m = ThroughputMeter(ndim=36, ensemble=100)
    with m:
        time.sleep(0.01)
    m.add_steps(50)
    rep = m.report()
    assert rep["traj_steps_per_s"] > 0
    assert rep["mode_updates_per_s"] == pytest.approx(
        rep["traj_steps_per_s"] * 36)
