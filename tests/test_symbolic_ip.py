"""Cross-implementation consistency: symbolic (quadrature) inner products
and tensors vs the analytic closed forms (ref ``model_test/test_aotensor_sym.py``
and ``test_inner_products.py::TestSymbolicInnerProducts``)."""

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, OceanicAnalyticInnerProducts,
)
from qgs_jax.inner_products.definition import StandardSymbolicInnerProductDefinition
from qgs_jax.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, OceanicSymbolicInnerProducts,
)
from qgs_jax.tensors.qgtensor import QgsTensor, QgsTensorDynamicT


def _sym_params(dynamic_T=False, T4=False):
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8}, dynamic_T=dynamic_T, T4=T4)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.set_oceanic_basin_fourier_modes(2, 4, mode='symbolic')
    return pars


def _ana_params():
    pars = QgParams({'rr': 287.e0, 'sb': 5.6e-8})
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    return pars


@pytest.fixture(scope="module")
def systems():
    sp = _sym_params()
    ap = _ana_params()
    saip = AtmosphericSymbolicInnerProducts(sp, quadrature=True)
    soip = OceanicSymbolicInnerProducts(sp, quadrature=True)
    aaip = AtmosphericAnalyticInnerProducts(ap)
    aoip = OceanicAnalyticInnerProducts(ap)
    aaip.connect_to_ocean(aoip)
    return sp, ap, saip, soip, aaip, aoip


def test_symbolic_ips_match_analytic(systems):
    sp, ap, saip, soip, aaip, aoip = systems
    for name in ('_a', '_u', '_c', '_g', '_b', '_s', '_d'):
        s = np.asarray(getattr(saip, name))
        a = np.asarray(getattr(aaip, name))
        assert np.allclose(s, a, atol=1e-10), f"atm {name}: max err {np.abs(s - a).max()}"
    for name in ('_M', '_U', '_N', '_O', '_C', '_K', '_W'):
        s = np.asarray(getattr(soip, name))
        a = np.asarray(getattr(aoip, name))
        assert np.allclose(s, a, atol=1e-10), f"oc {name}: max err {np.abs(s - a).max()}"


def test_symbolic_tensor_matches_analytic(systems):
    sp, ap, saip, soip, aaip, aoip = systems
    t_sym = QgsTensor(sp, saip, soip)
    t_ana = QgsTensor(ap, aaip, aoip)
    d_sym = t_sym.tensor.todense()
    d_ana = t_ana.tensor.todense()
    assert np.allclose(d_sym, d_ana, atol=1e-9), np.abs(d_sym - d_ana).max()


def test_dynamic_T_tensor_builds():
    """dynamic-T configuration: rank-5 tensor with the 0-th order temperature
    variables; checks structure and that the tendencies evaluate finite."""
    pars = _sym_params(dynamic_T=True)
    aip = AtmosphericSymbolicInnerProducts(pars, quadrature=True)
    oip = OceanicSymbolicInnerProducts(pars, quadrature=True)
    t = QgsTensorDynamicT(pars, aip, oip)
    assert pars.ndim == 38           # 10 psi + 1 Ta0 + 10 theta + 8 psi_o + 1 To0 + 8 To
    assert t.tensor.rank == 5
    assert t.tensor.nnz > 0

    from qgs_jax.ops.contraction import make_tendency_fns
    f_b, jac_b = make_tendency_fns(t.tensor, t.jacobian_tensor)
    x = np.random.default_rng(0).random((3, pars.ndim)) * 0.01
    fx = np.asarray(f_b(0., x))
    assert fx.shape == (3, pars.ndim)
    assert np.all(np.isfinite(fx))
    J = np.asarray(jac_b(0., x))
    assert J.shape == (3, pars.ndim, pars.ndim)

    # Jacobian consistency vs finite differences
    eps = 1e-7
    col = 5
    xp = x.copy()
    xp[:, col] += eps
    fd = (np.asarray(f_b(0., xp)) - fx) / eps
    assert np.allclose(J[:, :, col], fd, atol=1e-5)


def test_quartic_z_is_u_for_dynamic_T():
    """With dynamic T, the inserted constant mode makes
    z[i, 0, 0, 0, m] = (F_i, F_m) = u[i, m]."""
    pars = _sym_params(dynamic_T=True)
    aip = AtmosphericSymbolicInnerProducts(pars, quadrature=True)
    z = aip._z
    n = aip.natm
    dense = z.todense()
    assert np.allclose(dense[:, 0, 0, 0, :], np.asarray(aip._u), atol=1e-10)


class _SlowDefinition(StandardSymbolicInnerProductDefinition):
    """Standard inner product whose exact integration stalls: the stand-in
    for a pathological custom basis whose SymPy integrals hang (the case the
    reference guards with its pebble-pool per-integral timeout, ref
    ``qgs/inner_products/symbolic.py:1636-1697``)."""

    def __init__(self, delay):
        super().__init__()
        self.delay = delay

    def symbolic_inner_product(self, S, G, symbolic_expr=False, integrand=False):
        if not integrand:
            import time
            time.sleep(self.delay)      # interruptible, like a SymPy loop
        return super().symbolic_inner_product(S, G, symbolic_expr=symbolic_expr,
                                              integrand=integrand)


def test_exact_timeout_falls_back_to_quadrature():
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(1, 1, mode='symbolic')

    with pytest.warns(UserWarning, match="fell back to numerical quadrature"):
        slow = AtmosphericSymbolicInnerProducts(
            pars, quadrature=False, timeout=0.05,
            inner_product_definition=_SlowDefinition(delay=10.0))

    exact = AtmosphericSymbolicInnerProducts(pars, quadrature=False)
    np.testing.assert_allclose(np.asarray(slow._u, dtype=float),
                               np.asarray(exact._u, dtype=float),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(slow._a, dtype=float),
                               np.asarray(exact._a, dtype=float),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(slow._b, dtype=float),
                               np.asarray(exact._b, dtype=float),
                               rtol=1e-8, atol=1e-10)


def test_exact_timeout_return_symbolic_degrades_to_float():
    from sympy import Float

    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(1, 1, mode='symbolic')
    with pytest.warns(UserWarning, match="fell back"):
        slow = AtmosphericSymbolicInnerProducts(
            pars, quadrature=False, timeout=0.05, return_symbolic=True,
            inner_product_definition=_SlowDefinition(delay=10.0))
    exact = AtmosphericSymbolicInnerProducts(pars, quadrature=False)
    for i in range(slow.natm):
        for j in range(slow.natm):
            v = slow._u[i, j]
            assert v == 0 or isinstance(v, Float)
            np.testing.assert_allclose(float(v), float(exact._u[i, j]),
                                       rtol=1e-8, atol=1e-10)


def test_exact_ip_process_pool_equivalence():
    """The process-pool fan-out of the exact-SymPy engine (the counterpart
    of the reference's pebble ProcessPool setup compute, ref
    ``qgs/inner_products/symbolic.py:26,1636-1697``) must give bitwise the
    same coefficients as the serial path."""
    import numpy as np
    from qgs_jax.params.params import QgParams
    from qgs_jax.inner_products.symbolic import AtmosphericSymbolicInnerProducts

    def build(num_threads):
        pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
        pars.set_atmospheric_channel_fourier_modes(1, 1, mode='symbolic')
        return AtmosphericSymbolicInnerProducts(pars, quadrature=False,
                                                num_threads=num_threads)

    serial = build(1)
    pooled = build(2)
    for name in ('_u', '_a', '_c', '_g', '_b'):
        s = np.asarray(getattr(serial, name), float)
        p = np.asarray(getattr(pooled, name), float)
        assert np.array_equal(s, p), name
