"""
Streamfunction diagnostics
==========================

Atmospheric (lower psi^3 = psi - theta, upper psi^1 = psi + theta,
barotropic middle psi) and oceanic streamfunction fields
(ref ``qgs/diagnostics/streamfunctions.py:30-456``).
"""

from __future__ import annotations

import numpy as np

from qgs_jax.diagnostics.base import FieldDiagnostic
from qgs_jax.diagnostics.util import create_grid_basis


class AtmosphericStreamfunctionDiagnostic(FieldDiagnostic):
    """Base class for atmospheric streamfunction fields."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        FieldDiagnostic.__init__(self, model_params, dimensional)
        self._configure_grid_basis(model_params.atmospheric_basis, delta_x, delta_y)
        if (model_params.ground_params is not None
                and model_params.ground_params.hk is not None):
            hk = model_params.ground_params.hk.values
            self._orography = np.einsum('i,i...->...',
                                        hk, self._grid_basis[self._offset:][:len(hk)])

    def _psi_theta_fields(self):
        o = self._offset
        vr = self._model_params.variables_range
        gb = self._grid_basis[o:]
        psi = self._reconstruct(self._data[:vr[0]], gb)
        theta = self._reconstruct(self._data[vr[0] + o:vr[1]], gb)
        return psi, theta


class LowerLayerAtmosphericStreamfunctionDiagnostic(AtmosphericStreamfunctionDiagnostic):
    """psi^3_a = psi_a - theta_a (lower layer)."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        AtmosphericStreamfunctionDiagnostic.__init__(self, model_params, delta_x,
                                                     delta_y, dimensional)
        self._plot_title = r'Atmospheric $\psi_{\rm a}^3$ streamfunction'
        self._plot_units = r" (in " + self._model_params.get_variable_units(0) + r")"

    def _get_diagnostic(self, dimensional):
        psi, theta = self._psi_theta_fields()
        field = psi - theta
        if dimensional:
            field = field * float(self._model_params.streamfunction_scaling)
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field


class UpperLayerAtmosphericStreamfunctionDiagnostic(AtmosphericStreamfunctionDiagnostic):
    """psi^1_a = psi_a + theta_a (upper layer)."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        AtmosphericStreamfunctionDiagnostic.__init__(self, model_params, delta_x,
                                                     delta_y, dimensional)
        self._plot_title = r'Atmospheric $\psi_{\rm a}^1$ streamfunction'
        self._plot_units = r" (in " + self._model_params.get_variable_units(0) + r")"

    def _get_diagnostic(self, dimensional):
        psi, theta = self._psi_theta_fields()
        field = psi + theta
        if dimensional:
            field = field * float(self._model_params.streamfunction_scaling)
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field


class MiddleAtmosphericStreamfunctionDiagnostic(AtmosphericStreamfunctionDiagnostic):
    """Barotropic streamfunction psi_a at 500 hPa (optionally as
    geopotential height in meters)."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True,
                 geopotential=False):
        AtmosphericStreamfunctionDiagnostic.__init__(self, model_params, delta_x,
                                                     delta_y, dimensional)
        self.geopotential = geopotential
        if geopotential:
            self._plot_title = r'Atmospheric 500hPa geopotential height'
            self._plot_units = r" (in m)"
        else:
            self._plot_title = r'Atmospheric $\psi_{\rm a}$ streamfunction'
            self._plot_units = r" (in " + self._model_params.get_variable_units(0) + r")"

    def _get_diagnostic(self, dimensional):
        psi, _ = self._psi_theta_fields()
        field = psi
        if dimensional:
            factor = float(self._model_params.streamfunction_scaling)
            if self.geopotential:
                factor *= float(self._model_params.geopotential_scaling)
            field = field * factor
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field


class OceanicStreamfunctionDiagnostic(FieldDiagnostic):
    """Base class for oceanic streamfunction fields."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        FieldDiagnostic.__init__(self, model_params, dimensional)
        self._configure_grid_basis(model_params.oceanic_basis, delta_x, delta_y)


class OceanicLayerStreamfunctionDiagnostic(OceanicStreamfunctionDiagnostic):
    """Oceanic streamfunction psi_o; with ``conserved=True`` the spatial mean
    of each mode is removed (mass-conserving gyre representation)."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True,
                 conserved=True):
        OceanicStreamfunctionDiagnostic.__init__(self, model_params, delta_x,
                                                 delta_y, dimensional)
        self._plot_title = r'Oceanic $\psi_{\rm o}$ streamfunction'
        self._plot_units = r" (in " + self._model_params.get_variable_units(
            self._model_params.variables_range[1]) + r")"
        self._conserved = conserved
        self._fields_average = None
        if conserved:
            # spatial average of each mode over the domain
            n = float(model_params.scale_params.n)
            avg = self._grid_basis.reshape(self._grid_basis.shape[0], -1).mean(axis=1)
            self._fields_average = avg

    def _get_diagnostic(self, dimensional):
        o = self._offset
        vr = self._model_params.variables_range
        gb = self._grid_basis
        if self._conserved:
            gb = gb - self._fields_average[:, None, None]
        psi = self._reconstruct(self._data[vr[1]:vr[2]], gb[o:])
        if dimensional:
            psi = psi * float(self._model_params.streamfunction_scaling)
        self._diagnostic_data = psi
        self._diagnostic_data_dimensional = dimensional
        return psi
