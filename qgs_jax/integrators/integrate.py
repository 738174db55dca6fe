"""Reference-import-path shim: the reference exposes the functional
integrators as ``qgs.integrators.integrate`` (ref
``qgs/integrators/integrate.py:29,240``); in qgs-jax they live in
:mod:`qgs_jax.integrators.rk`.  Re-exported here so reference code ports
with only the package rename."""

from qgs_jax.integrators.rk import (             # noqa: F401
    integrate_runge_kutta, integrate_runge_kutta_tgls,
    integrate_runge_kutta_df, rk4_tableau, rk2_tableau, time_grid,
)
