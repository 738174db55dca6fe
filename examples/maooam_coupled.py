#!/usr/bin/env python
"""Coupled ocean-atmosphere (MAOOAM): short run + multi-diagnostic
dashboard (atmospheric and oceanic streamfunctions + temperatures)."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator
from qgs_jax.diagnostics.streamfunctions import (
    MiddleAtmosphericStreamfunctionDiagnostic, OceanicLayerStreamfunctionDiagnostic,
)
from qgs_jax.diagnostics.temperatures import (
    MiddleAtmosphericTemperatureAnomalyDiagnostic,
    OceanicLayerTemperatureAnomalyDiagnostic,
)
from qgs_jax.diagnostics.multi import MultiDiagnostic

# The MAOOAM coupled ocean-atmosphere model of De Cruz, Demaeyer &
# Vannitsem (GMD 2016): a 2x2-block channel atmosphere over a 2x4-block
# closed ocean basin, coupled mechanically (wind stress d, friction kd) and
# thermally (heat exchange + linearized radiation).  36 variables.
pars = QgParams()
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.set_oceanic_basin_fourier_modes(2, 4)
pars.set_params({'kd': 0.0290, 'kdp': 0.0290, 'n': 1.5, 'r': 1.e-7,
                 'h': 136.5, 'd': 1.1e-7})
pars.atemperature_params.set_params({'eps': 0.7, 'T0': 289.3, 'hlambda': 15.06})
pars.gotemperature_params.set_params({'gamma': 5.6e8, 'T0': 301.46})
pars.atemperature_params.set_insolation(103.3333, 0)
pars.gotemperature_params.set_insolation(310., 0)

# Compile and integrate.  The ocean's slow heat reservoir makes true
# equilibration take ~1e6 time units (see benchmarks/fidelity.py); 2e4 is
# enough for a qualitative dashboard.
f, Df = create_tendencies(pars)
integrator = RungeKuttaIntegrator()
integrator.set_func(f)
rng = np.random.default_rng(0)
integrator.integrate(0., 2.e4, 0.1, ic=rng.random(pars.ndim) * 0.01, write_steps=0)
_, y0 = integrator.get_trajectories()
integrator.integrate(0., 2000., 0.1, ic=y0, write_steps=20)
t, traj = integrator.get_trajectories()

# Compose a 2x2 dashboard of gridded fields sharing one trajectory:
# atmospheric/oceanic streamfunctions and temperature anomalies.  The same
# object can render movies (m.movie) and interactive widgets (m.animate).
m = MultiDiagnostic(2, 2)
m.add_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(pars))
m.add_diagnostic(MiddleAtmosphericTemperatureAnomalyDiagnostic(pars))
m.add_diagnostic(OceanicLayerStreamfunctionDiagnostic(pars))
m.add_diagnostic(OceanicLayerTemperatureAnomalyDiagnostic(pars))
m(t, traj)
m.plot(time_index=-1)
plt.savefig("maooam_dashboard.png", dpi=100)
print("wrote maooam_dashboard.png")
