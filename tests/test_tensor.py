"""Golden-file regression of the assembled tendency tensor and its Jacobian
against the MAOOAM fixtures (ref ``model_test/test_aotensor*.py``)."""

import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, OceanicAnalyticInnerProducts,
)
from qgs_jax.tensors.qgtensor import QgsTensor
from tests.ref_utils import compare_to_ref


def _tensor(a_modes, o_modes):
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8})
    pars.set_atmospheric_channel_fourier_modes(*a_modes)
    pars.set_oceanic_basin_fourier_modes(*o_modes)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})

    aip = AtmosphericAnalyticInnerProducts(pars)
    oip = OceanicAnalyticInnerProducts(pars)
    aip.connect_to_ocean(oip)
    return QgsTensor(pars, aip, oip)


def test_aotensor():
    t = _tensor((2, 2), (2, 4))
    values = [v.replace('QgsTensor', 'aotensor') for v in t.entries()]
    compare_to_ref(values, "test_aotensor.ref")


def test_aotensor_jacobian():
    t = _tensor((2, 2), (2, 4))
    values = [v.replace('QgsTensorJacobian', 'jac_aotensor')
              for v in t.entries(jacobian=True)]
    compare_to_ref(values, "test_aotensor_jacobian.ref")


def test_aotensor_6x6():
    t = _tensor((6, 6), (6, 6))
    values = [v.replace('QgsTensor', 'aotensor') for v in t.entries()]
    compare_to_ref(values, "test_aotensor_6x6.ref")


def test_contraction_equivalence():
    """The upper-triangularized tensor and the raw tensor must yield the same
    quadratic form T . x . x."""
    t = _tensor((2, 2), (2, 4))
    ndim = t.params.ndim
    rng = np.random.default_rng(0)
    x = np.concatenate([[1.0], rng.standard_normal(ndim)])
    dense_simpl = t.tensor.todense()
    f1 = np.einsum('ijk,j,k->i', dense_simpl, x, x)
    jdense = t.jacobian_tensor.todense()
    jac = np.einsum('ijk,k->ij', jdense, x)
    # directional check: J(x) . x = 2 * quadratic part + linear part; instead
    # verify J against finite differences of f
    eps = 1e-7
    for col in rng.integers(1, ndim + 1, size=5):
        xp = x.copy(); xp[col] += eps
        fp = np.einsum('ijk,j,k->i', dense_simpl, xp, xp)
        fd = (fp - f1) / eps
        assert np.allclose(jac[1:, col], fd[1:], atol=1e-5)
