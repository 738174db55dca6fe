"""Reference-import-path shim: the reference exposes the tendencies
factory as ``qgs.functions.tendencies`` (ref
``qgs/functions/tendencies.py:20-211``); in qgs-jax the implementation
lives in :mod:`qgs_jax.models.tendencies`.  This module re-exports it so
reference code ports with only the package rename."""

from qgs_jax.models.tendencies import (          # noqa: F401
    create_tendencies, create_atmo_thermo_tendencies,
)
