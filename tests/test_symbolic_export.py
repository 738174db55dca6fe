"""Symbolic tensor and code-generation export: the generated python RHS must
reproduce the numeric tendencies, continuation variables stay symbolic, and
every language emitter produces plausible output."""

import math

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.functions.symbolic_tendencies import create_symbolic_tendencies


@pytest.fixture(scope="module")
def rp_params():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    return pars


def _exec_generated(func_str, extra_names=()):
    ns = {'np': np, 'math': math}
    exec(func_str, ns)
    return ns['f'] if 'f' in ns else ns['jac']


def test_python_export_matches_numeric(rp_params):
    pars = rp_params
    out = create_symbolic_tendencies(pars, continuation_variables=[],
                                     language='python', return_jacobian=True)
    func_str, jac_str = out[0], out[1]
    f_gen = _exec_generated(func_str)
    jac_gen = _exec_generated(jac_str)

    f_num, Df_num = create_tendencies(pars)
    x = np.random.default_rng(0).random(pars.ndim) * 0.2
    fx_gen = f_gen(0., x)
    fx_num = np.asarray(f_num(0., x))
    assert np.allclose(fx_gen, fx_num, rtol=1e-8, atol=1e-10), \
        np.abs(fx_gen - fx_num).max()

    J_gen = jac_gen(0., x)
    J_num = np.asarray(Df_num(0., x))
    assert np.allclose(J_gen, J_num, rtol=1e-8, atol=1e-10)


def test_continuation_variable_stays_free(rp_params):
    pars = rp_params
    kd = pars.atmospheric_params.kd
    out = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                     language='python')
    func_str = out[0]
    assert 'k_d' in func_str
    f_gen = _exec_generated(func_str)

    f_num, _ = create_tendencies(pars)
    x = np.random.default_rng(1).random(pars.ndim) * 0.2
    # evaluating at the parameter's actual value must recover the model
    assert np.allclose(f_gen(0., x, float(kd)), np.asarray(f_num(0., x)),
                       rtol=1e-8, atol=1e-10)
    # and the parameter must actually matter
    assert not np.allclose(f_gen(0., x, 2 * float(kd)),
                           np.asarray(f_num(0., x)), atol=1e-12)


def test_other_language_emitters(rp_params):
    pars = rp_params
    kd = pars.atmospheric_params.kd
    for language, marker in [('julia', 'function f!'),
                             ('fortran', 'SUBROUTINE FUNC'),
                             ('mathematica', 'F = Array')]:
        out = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                         language=language)
        assert marker in out[0], language

    out = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                     language='auto')
    auto_main, auto_conf = out[0]
    assert 'SUBROUTINE FUNC' in auto_main
    assert 'SUBROUTINE STPNT' in auto_main
    assert 'k_d = PAR(1)' in auto_main
    assert 'NDIM = ' + str(pars.ndim) in auto_conf
    assert "ICP = ['k_d']" in auto_conf
