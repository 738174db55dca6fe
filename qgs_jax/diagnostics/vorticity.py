"""
Vorticity diagnostics
=====================

Layer vorticities (lap psi) and potential vorticities
(ref ``qgs/diagnostics/vorticity.py:28-388``).
"""

from __future__ import annotations

import numpy as np

from qgs_jax.diagnostics.differential import LaplacianFieldDiagnostic


class AtmosphericVorticityDiagnostic(LaplacianFieldDiagnostic):
    """Base class for atmospheric vorticity fields."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        LaplacianFieldDiagnostic.__init__(self, model_params, dimensional)
        self._configure_laplacian_grid(model_params.atmospheric_basis,
                                       delta_x, delta_y)
        self._plot_units = r" (in s$^{-1}$)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _psi_theta_fields(self, grid_basis=None):
        o = self._offset
        vr = self._model_params.variables_range
        gb = (grid_basis if grid_basis is not None else self._grid_basis)[o:]
        psi = self._reconstruct(self._data[:vr[0]], gb)
        theta = self._reconstruct(self._data[vr[0] + o:vr[1]], gb)
        return psi, theta

    @property
    def _vorticity_scaling(self):
        mp = self._model_params
        return float(mp.streamfunction_scaling) / float(mp.scale_params.L) ** 2


def _vorticity_class(name, layer, title):
    class _Vort(AtmosphericVorticityDiagnostic):
        def __init__(self, model_params, delta_x=None, delta_y=None,
                     dimensional=True):
            AtmosphericVorticityDiagnostic.__init__(self, model_params, delta_x,
                                                    delta_y, dimensional)
            self._plot_title = title

        def _get_diagnostic(self, dimensional):
            psi, theta = self._psi_theta_fields()
            if layer == "lower":
                field = psi - theta
            elif layer == "upper":
                field = psi + theta
            else:
                field = psi
            if dimensional:
                field = field * self._vorticity_scaling
            self._diagnostic_data = field
            self._diagnostic_data_dimensional = dimensional
            return field

    _Vort.__name__ = name
    _Vort.__qualname__ = name
    return _Vort


LowerLayerAtmosphericVorticityDiagnostic = _vorticity_class(
    "LowerLayerAtmosphericVorticityDiagnostic", "lower",
    r'Atmospheric vorticity in the lower layer')
MiddleAtmosphericVorticityDiagnostic = _vorticity_class(
    "MiddleAtmosphericVorticityDiagnostic", "middle",
    r'Atmospheric vorticity in the middle layer')
UpperLayerAtmosphericVorticityDiagnostic = _vorticity_class(
    "UpperLayerAtmosphericVorticityDiagnostic", "upper",
    r'Atmospheric vorticity in the upper layer')


class _PotentialVorticityBase(AtmosphericVorticityDiagnostic):
    """Potential vorticity: lap psi_layer + f0 + beta y -/+ f0^2 theta /
    (sigma0 deltap^2) (upper: minus, lower: plus)."""

    _layer = "upper"
    _sign = -1.0

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        AtmosphericVorticityDiagnostic.__init__(self, model_params, delta_x,
                                                delta_y, dimensional)
        from qgs_jax.diagnostics.util import create_grid_basis
        # plain (non-Laplacian) basis grid for the theta stretching term
        self._theta_grid_basis = create_grid_basis(
            model_params.atmospheric_basis, self._X, self._Y)
        self._plot_title = (r'Atmospheric potential vorticity in the '
                            + self._layer + ' layer')

    def _get_diagnostic(self, dimensional):
        mp = self._model_params
        o = self._offset
        vr = mp.variables_range
        theta = self._reconstruct(self._data[vr[0] + o:vr[1]],
                                  self._theta_grid_basis[o:])
        psi, th_lap = self._psi_theta_fields()
        vort = psi - th_lap if self._layer == "lower" else psi + th_lap
        sig0 = mp.atmospheric_params.sig0
        if dimensional:
            vort = vort * self._vorticity_scaling
            field = vort + float(mp.scale_params.f0) \
                + mp.scale_params.beta.dimensional_value * self._Y * float(mp.scale_params.L)
            field = field + self._sign * (float(mp.scale_params.f0) ** 2) \
                * (theta * float(mp.streamfunction_scaling)) \
                / (sig0.dimensional_value * float(mp.scale_params.deltap) ** 2)
        else:
            field = vort + 1 + float(mp.scale_params.beta) * self._Y \
                + self._sign * theta / float(sig0)
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field


class UpperLayerAtmosphericPotentialVorticityDiagnostic(_PotentialVorticityBase):
    _layer = "upper"
    _sign = -1.0


class LowerLayerAtmosphericPotentialVorticityDiagnostic(_PotentialVorticityBase):
    _layer = "lower"
    _sign = 1.0


class OceanicLayerVorticityDiagnostic(LaplacianFieldDiagnostic):
    """Oceanic vorticity lap psi_o."""

    def __init__(self, model_params, delta_x=None, delta_y=None, dimensional=True):
        LaplacianFieldDiagnostic.__init__(self, model_params, dimensional)
        self._configure_laplacian_grid(model_params.oceanic_basis, delta_x, delta_y)
        self._plot_title = r'Oceanic vorticity'
        self._plot_units = r" (in s$^{-1}$)"
        self._default_plot_kwargs = {'cmap': 'coolwarm'}

    def _get_diagnostic(self, dimensional):
        mp = self._model_params
        o = self._offset
        vr = mp.variables_range
        field = self._reconstruct(self._data[vr[1]:vr[2]], self._grid_basis[o:])
        if dimensional:
            field = field * float(mp.streamfunction_scaling) / float(mp.scale_params.L) ** 2
        self._diagnostic_data = field
        self._diagnostic_data_dimensional = dimensional
        return field
