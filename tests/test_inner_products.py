"""Golden-file regression of the analytic inner products against the MAOOAM
ground-truth fixtures (ref ``model_test/test_inner_products.py:23-79``)."""

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, OceanicAnalyticInnerProducts,
)
from tests.ref_utils import collect_entries, compare_to_ref


def _compute(a_modes, o_modes):
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(*a_modes)
    pars.set_oceanic_basin_fourier_modes(*o_modes)
    pars.set_params({'kd': 0.04, 'kdp': 0.04, 'n': 1.5})

    aip = AtmosphericAnalyticInnerProducts(pars)
    oip = OceanicAnalyticInnerProducts(pars)
    aip.connect_to_ocean(oip)
    return pars, aip, oip


def _entries(aip, oip):
    values = []
    values += collect_entries("a", aip._a, offset=1)
    values += collect_entries("c", aip._c, offset=1)
    values += collect_entries("b", aip._b, offset=1)
    values += collect_entries("g", aip._g, offset=1)
    values += collect_entries("d", aip._d, offset=1)
    values += collect_entries("s", aip._s, offset=1)
    values += collect_entries("M", oip._M, offset=1)
    values += collect_entries("N", oip._N, offset=1)
    values += collect_entries("O", oip._O, offset=1)
    values += collect_entries("C", oip._C, offset=1)
    values += collect_entries("K", oip._K, offset=1)
    values += collect_entries("W", oip._W, offset=1)
    return values


def test_inner_products_2x2_2x4():
    pars, aip, oip = _compute((2, 2), (2, 4))
    assert pars.nmod == [10, 8]
    compare_to_ref(_entries(aip, oip), "test_inprod_analytic.ref")


def test_inner_products_6x6():
    pars, aip, oip = _compute((6, 6), (6, 6))
    compare_to_ref(_entries(aip, oip), "test_inprod_analytic_6x6.ref")


def test_g_tensor_antisymmetry():
    """g_{ijk} = (F_i, J(F_j, F_k)) must be totally antisymmetric."""
    _, aip, _ = _compute((2, 2), (2, 4))
    g = aip._g
    assert np.allclose(g, -np.transpose(g, (0, 2, 1)), atol=1e-12)
    assert np.allclose(g, -np.transpose(g, (1, 0, 2)), atol=1e-12)
    assert np.allclose(g, np.transpose(g, (1, 2, 0)), atol=1e-12)
