#!/usr/bin/env python
"""AUTO-07p continuation export, end to end: generate the Fortran model
file and the c.* configuration file, inspect them, and validate the
generated code against the numeric tendencies (counterpart of the
reference's ``notebooks/symbolic_outputs`` walkthrough)."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.functions.symbolic_tendencies import create_symbolic_tendencies

# Continuation studies ask: how do the model's fixed points and periodic
# orbits move as a parameter varies?  AUTO-07p answers that, but needs the
# RHS as Fortran source with the continuation parameters left symbolic.
# Build a small RP atmosphere on the symbolic path (inner products kept
# as exact SymPy objects so parameters can stay free):
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_channel_fourier_modes(2, 2, mode='symbolic')
pars.ground_params.set_orography(0.2, 1)
pars.atemperature_params.set_thetas(0.2, 0)

# k_d (surface friction) is the classic bifurcation parameter of this
# configuration; every other parameter gets substituted by its value.
kd = pars.atmospheric_params.kd


# The 'auto' target emits TWO files: the Fortran model file (FUNC/STPNT
# subroutines with the PAR(1) = k_d wiring) and the AUTO constants file.
(auto_main, auto_conf), = create_symbolic_tendencies(
    pars, continuation_variables=[kd], language='auto')

with open("qgs_auto.f90", "w") as fh:
    fh.write(auto_main)
with open("c.qgs_auto", "w") as fh:
    fh.write(auto_conf)
print("wrote qgs_auto.f90 "
      f"({len(auto_main.splitlines())} lines) and c.qgs_auto "
      f"({len(auto_conf.splitlines())} lines)")


# Inspect the generated model file: the FUNC subroutine holds the 20
# evolution equations with k_d appearing symbolically as PAR(1).
lines = auto_main.splitlines()
head = next(i for i, ln in enumerate(lines) if 'SUBROUTINE FUNC' in ln)
print("--- qgs_auto.f90: FUNC subroutine (excerpt) ---")
print("\n".join(lines[head:head + 14]))
eq = next(ln for ln in lines if ln.strip().startswith('F(1)'))
print("...")
print(eq[:110] + " ...")


# The STPNT subroutine initializes the continuation start point, and the
# constants file carries NDIM and the continuation-parameter list ICP:
stpnt = next(i for i, ln in enumerate(lines) if 'SUBROUTINE STPNT' in ln)
print("--- qgs_auto.f90: STPNT subroutine (excerpt) ---")
print("\n".join(lines[stpnt:stpnt + 10]))
print("--- c.qgs_auto ---")
print(auto_conf)


# To run the continuation with an AUTO-07p installation:
#     auto
#     AUTO> r = run('qgs_auto')        # reads qgs_auto.f90 + c.qgs_auto
#     AUTO> plot(r)
# (AUTO is not shipped in this environment, so the validation below checks
# the emitted equations by a different route.)


# Validation: emit the SAME equations as python source, exec them, and
# compare against the numeric JAX tendencies at a random state.  Codegen
# and the numeric pipeline share nothing past the symbolic tensor, so
# agreement here validates the emitted equations end to end -- the same
# expressions the Fortran file carries.
python_code, = create_symbolic_tendencies(pars, continuation_variables=[kd],
                                          language='python')
ns = {'np': np}
exec(python_code, ns)
f_gen = ns['f']

f_num, _ = create_tendencies(pars)
x0 = np.random.default_rng(0).random(pars.ndim) * 0.1
fx_gen = np.asarray(f_gen(0.0, x0, float(kd)), dtype=float)
fx_num = np.asarray(f_num(0.0, x0), dtype=float)
err = np.abs(fx_gen - fx_num).max()
print(f"generated-code tendencies vs numeric pipeline: max |diff| = {err:.2e}")
assert err < 1e-8

# The same machinery emits julia / fortran / mathematica sources
# (language=...), and create_auto_file accepts custom AUTO templates for
# non-default continuation setups.
