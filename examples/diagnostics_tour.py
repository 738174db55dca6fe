#!/usr/bin/env python
"""Tour of the full diagnostics catalog on an RP-atmosphere trajectory."""

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
    LowerLayerAtmosphericStreamfunctionDiagnostic,
    UpperLayerAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericStreamfunctionDiagnostic,
)
from qgs_jax.diagnostics.temperatures import (
    MiddleAtmosphericTemperatureAnomalyDiagnostic,
    AtmosphericTemperatureMeridionalGradientDiagnostic,
)
from qgs_jax.diagnostics.wind import (
    MiddleAtmosphericUWindDiagnostic, MiddleAtmosphericVWindDiagnostic,
    MiddleAtmosphericWindIntensityDiagnostic, MiddleLayerVerticalVelocity,
)
from qgs_jax.diagnostics.vorticity import (
    MiddleAtmosphericVorticityDiagnostic,
    UpperLayerAtmosphericPotentialVorticityDiagnostic,
)
from qgs_jax.diagnostics.eddy import (
    MiddleAtmosphericEddyHeatFluxDiagnostic,
    MiddleAtmosphericEddyHeatFluxProfileDiagnostic,
)
from qgs_jax.diagnostics.multi import MultiDiagnostic

pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2)
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)

f, Df = create_tendencies(pars)
integrator = RungeKuttaIntegrator()
integrator.set_func(f)
rng = np.random.default_rng(0)
integrator.integrate(0., 2.e4, 0.1, ic=rng.random(pars.ndim) * 0.1, write_steps=0)
_, y0 = integrator.get_trajectories()
integrator.integrate(0., 500., 0.1, ic=y0, write_steps=10)
t, traj = integrator.get_trajectories()

# Twelve field diagnostics rendered into one dashboard.  Each reconstructs
# its field on a lat-lon grid as one matmul of the spectral coefficients
# against the gridded basis; MiddleLayerVerticalVelocity additionally
# solves the omega equation from the difference between the full and
# thermodynamic-only tendencies (f - f_thermo).
catalog = [
    LowerLayerAtmosphericStreamfunctionDiagnostic,
    UpperLayerAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericStreamfunctionDiagnostic,
    MiddleAtmosphericTemperatureAnomalyDiagnostic,
    AtmosphericTemperatureMeridionalGradientDiagnostic,
    MiddleAtmosphericUWindDiagnostic,
    MiddleAtmosphericVWindDiagnostic,
    MiddleAtmosphericWindIntensityDiagnostic,
    MiddleLayerVerticalVelocity,
    MiddleAtmosphericVorticityDiagnostic,
    UpperLayerAtmosphericPotentialVorticityDiagnostic,
    MiddleAtmosphericEddyHeatFluxDiagnostic,
]

m = MultiDiagnostic(4, 3)
for cls in catalog:
    m.add_diagnostic(cls(pars))
m(t, traj)
m.plot(time_index=-1, figsize=(22, 18))
plt.savefig("diagnostics_tour.png", dpi=80)

# Profile diagnostics reduce a field to a 1-D meridional profile -- here
# the zonally averaged eddy heat flux v'T'.
prof = MiddleAtmosphericEddyHeatFluxProfileDiagnostic(pars)
prof(t, traj)
prof.plot(time_index=-1)
plt.savefig("eddy_profile.png", dpi=100)
print("wrote diagnostics_tour.png, eddy_profile.png")
