#!/usr/bin/env python
"""Symbolic export: generate the model's RHS as code with free continuation
parameters (here the bottom friction k_d), including an AUTO-07p setup."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.functions.symbolic_tendencies import create_symbolic_tendencies

# Build the model on the SYMBOLIC path: inner products kept as exact SymPy
# expressions (return_symbolic under the hood) so parameters can stay
# symbolic in the final tendencies.
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)

# Choose the continuation parameter(s): every other parameter is
# substituted by its numeric value; k_d stays a free symbol in the
# generated code.
kd = pars.atmospheric_params.kd

python_code, = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                          language='python')
print("--- python RHS (first lines) ---")
print("\n".join(python_code.split("\n")[:8]))

fortran_code, = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                           language='fortran')
with open("qgs_model.f90", "w") as fh:
    fh.write(fortran_code)

# The AUTO-07p target emits a ready-to-run continuation setup: the
# Fortran model file (with PAR declarations and an STPNT initial point)
# plus the c.* configuration file.
(auto_main, auto_conf), = create_symbolic_tendencies(
    pars, continuation_variables=[kd], language='auto')
with open("qgs_auto.f90", "w") as fh:
    fh.write(auto_main)
with open("c.qgs_auto", "w") as fh:
    fh.write(auto_conf)
print("wrote qgs_model.f90, qgs_auto.f90, c.qgs_auto")
