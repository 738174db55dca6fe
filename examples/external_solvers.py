"""Driving the model tendencies with an *external* ODE suite.

The framework's central API contract is the same as the reference's: a
plain callable ``f(t, x)`` (ref ``documentation/source/files/user_guide.rst:8-15``,
demonstrated with Julia DifferentialEquations.jl in
``notebooks/diffeq_test.ipynb``).  Any integrator that accepts an
``f(t, y)`` right-hand side can therefore consume it directly — here we
use scipy's ``solve_ivp`` (adaptive RK45 and the stiff-capable LSODA) and
cross-check against the framework's own fixed-step RK4.

Run: ``JAX_PLATFORMS=cpu python examples/external_solvers.py``
"""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
from scipy.integrate import solve_ivp

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.rk import integrate_runge_kutta


def main():
    # -- Reinhold-Pierrehumbert atmosphere (20 variables) -------------------
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.3})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.4, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)

    # The whole framework's API contract is the pair f(t, x) / Df(t, x) --
    # any external ODE machinery that accepts a callable works.  scipy
    # passes/expects plain float64 ndarrays, so wrap the device calls.
    def rhs(t, y):
        return np.asarray(f(t, y))

    def jac(t, y):
        return np.asarray(Df(t, y))

    # spin onto the attractor with the native integrator
    rng = np.random.default_rng(21)
    ic = rng.random(pars.ndim) * 0.01
    _, y0 = integrate_runge_kutta(f.batched, 0., 2000., 0.1, ic, write_steps=0)
    y0 = np.asarray(y0)

    t_span, t_eval = (0., 100.), np.arange(0., 100.001, 0.1)

    sol_rk45 = solve_ivp(rhs, t_span, y0, method="RK45", t_eval=t_eval,
                         rtol=1e-10, atol=1e-12)
    sol_lsoda = solve_ivp(rhs, t_span, y0, method="LSODA", jac=jac,
                          t_eval=t_eval, rtol=1e-10, atol=1e-12)
    t_native, y_native = integrate_runge_kutta(f.batched, 0., 100., 0.1, y0,
                                               write_steps=1)
    y_native = np.asarray(y_native)

    print(f"scipy RK45 : {sol_rk45.nfev} RHS evals, status={sol_rk45.status}")
    print(f"scipy LSODA: {sol_lsoda.nfev} RHS evals, {sol_lsoda.njev} Jacobian"
          f" evals, status={sol_lsoda.status}")

    for name, sol in (("RK45", sol_rk45), ("LSODA", sol_lsoda)):
        err = np.abs(sol.y - y_native).max() / np.abs(y_native).max()
        print(f"{name} vs native RK4 over 100 time units: max rel diff {err:.2e}")

    # the three solvers must agree far better than the trajectory scale
    assert np.abs(sol_rk45.y - y_native).max() / np.abs(y_native).max() < 1e-4
    print("external-solver interop OK")


if __name__ == "__main__":
    main()
