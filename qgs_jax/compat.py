"""
Drop-in ``qgs`` import compatibility
====================================

Importing this module installs the ``qgs`` package namespace as an alias
of :mod:`qgs_jax`, so code written against the reference framework
(ref ``qgs/__init__.py`` and the module tree under ``qgs/``) runs
unchanged::

    import qgs_jax.compat            # one line added at the top
    from qgs.params.params import QgParams
    from qgs.functions.tendencies import create_tendencies
    from qgs.integrators.integrator import RungeKuttaIntegrator

Every reference module path is covered; the only renames are mapped
explicitly below (``qgs.tensors.atmo_thermo_tensor`` and the Numba
kernels of ``qgs.functions.sparse_mul``, whose reference-semantics
NumPy equivalents live in :mod:`qgs_jax.models.numpy_backend`).

The aliases are installed lazily through a :class:`importlib.abc.MetaPathFinder`
so importing :mod:`qgs_jax.compat` stays cheap (no matplotlib import until a
diagnostics module is actually requested).
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.util
import sys

#: explicit renames (reference path -> qgs_jax path); every other
#: ``qgs.X`` maps to ``qgs_jax.X`` one-to-one.
_SPECIAL = {
    "qgs.tensors.atmo_thermo_tensor": "qgs_jax.tensors.atmo_thermo",
    "qgs.functions.sparse_mul": "qgs_jax.models.numpy_backend",
}


def _target(fullname: str) -> str:
    if fullname in _SPECIAL:
        return _SPECIAL[fullname]
    return "qgs_jax" + fullname[len("qgs"):]


class _QgsAliasLoader(importlib.abc.Loader):
    def create_module(self, spec):
        module = importlib.import_module(_target(spec.name))
        sys.modules[spec.name] = module
        return module

    def exec_module(self, module):  # already executed by the real import
        pass


class _QgsAliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname != "qgs" and not fullname.startswith("qgs."):
            return None
        try:
            real = importlib.util.find_spec(_target(fullname))
        except ModuleNotFoundError:
            return None
        if real is None:
            return None
        spec = importlib.util.spec_from_loader(fullname, _QgsAliasLoader())
        spec.submodule_search_locations = real.submodule_search_locations
        return spec


def install():
    """Install the ``qgs`` alias finder (idempotent)."""
    if not any(isinstance(f, _QgsAliasFinder) for f in sys.meta_path):
        sys.meta_path.append(_QgsAliasFinder())


install()
