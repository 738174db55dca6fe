"""Diagnostics layer: field reconstruction correctness and the full catalog
smoke-tested on short RP and MAOOAM trajectories."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from qgs_jax.params.params import QgParams
from qgs_jax.models.tendencies import create_tendencies
from qgs_jax.integrators.integrator import RungeKuttaIntegrator


@pytest.fixture(scope="module")
def rp_traj():
    pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.ground_params.set_orography(0.2, 1)
    pars.atemperature_params.set_thetas(0.2, 0)
    f, Df = create_tendencies(pars)
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    ic = np.random.default_rng(0).random(pars.ndim) * 0.05
    integ.integrate(0., 20., 0.1, ic=ic, write_steps=20)
    t, traj = integ.get_trajectories()
    return pars, t, traj


@pytest.fixture(scope="module")
def maooam_traj():
    pars = QgParams()
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_oceanic_basin_fourier_modes(2, 4)
    f, Df = create_tendencies(pars)
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    ic = np.random.default_rng(0).random(pars.ndim) * 0.05
    integ.integrate(0., 20., 0.1, ic=ic, write_steps=20)
    t, traj = integ.get_trajectories()
    return pars, t, traj


def test_streamfunction_reconstruction_exact(rp_traj):
    """psi at a point must equal the explicit mode sum."""
    from qgs_jax.diagnostics.streamfunctions import (
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    pars, t, traj = rp_traj
    psi = MiddleAtmosphericStreamfunctionDiagnostic(pars, dimensional=False)
    field = psi(t, traj)
    X, Y = psi.grid
    funcs = pars.atmospheric_basis.num_functions()
    k = 3   # record index
    iy, ix = 20, 30
    expected = sum(traj[i, k] * funcs[i](X[iy, ix], Y[iy, ix])
                   for i in range(pars.nmod[0]))
    assert np.isclose(field[k, iy, ix], expected, rtol=1e-12)


def test_layer_combinations(rp_traj):
    from qgs_jax.diagnostics.streamfunctions import (
        LowerLayerAtmosphericStreamfunctionDiagnostic,
        UpperLayerAtmosphericStreamfunctionDiagnostic,
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    pars, t, traj = rp_traj
    lo = LowerLayerAtmosphericStreamfunctionDiagnostic(pars)(t, traj)
    up = UpperLayerAtmosphericStreamfunctionDiagnostic(pars)(t, traj)
    mid = MiddleAtmosphericStreamfunctionDiagnostic(pars)(t, traj)
    assert np.allclose((lo + up) / 2, mid, rtol=1e-10)


def test_wind_is_derivative_of_streamfunction(rp_traj):
    from qgs_jax.diagnostics.wind import MiddleAtmosphericUWindDiagnostic
    from qgs_jax.diagnostics.streamfunctions import (
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    pars, t, traj = rp_traj
    U = MiddleAtmosphericUWindDiagnostic(pars, dimensional=False)(t, traj)
    psi = MiddleAtmosphericStreamfunctionDiagnostic(pars, dimensional=False)(t, traj)
    X, Y = MiddleAtmosphericUWindDiagnostic(pars).grid
    dy = Y[1, 0] - Y[0, 0]
    dpsi_dy = np.gradient(psi, dy, axis=1)
    # U = -dpsi/dy (compare away from boundaries, fd error ~ dy^2)
    assert np.allclose(U[:, 5:-5, :], -dpsi_dy[:, 5:-5, :], atol=2e-3)


def test_full_catalog_smoke_rp(rp_traj):
    from qgs_jax.diagnostics.streamfunctions import (
        LowerLayerAtmosphericStreamfunctionDiagnostic,
        UpperLayerAtmosphericStreamfunctionDiagnostic,
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    from qgs_jax.diagnostics.temperatures import (
        MiddleAtmosphericTemperatureAnomalyDiagnostic,
        MiddleAtmosphericTemperatureDiagnostic,
        AtmosphericTemperatureMeridionalGradientDiagnostic,
    )
    from qgs_jax.diagnostics.wind import (
        LowerLayerAtmosphericUWindDiagnostic, LowerLayerAtmosphericVWindDiagnostic,
        MiddleAtmosphericUWindDiagnostic, MiddleAtmosphericVWindDiagnostic,
        UpperLayerAtmosphericUWindDiagnostic, UpperLayerAtmosphericVWindDiagnostic,
        MiddleAtmosphericWindIntensityDiagnostic, MiddleLayerVerticalVelocity,
    )
    from qgs_jax.diagnostics.vorticity import (
        LowerLayerAtmosphericVorticityDiagnostic,
        MiddleAtmosphericVorticityDiagnostic,
        UpperLayerAtmosphericVorticityDiagnostic,
        UpperLayerAtmosphericPotentialVorticityDiagnostic,
        LowerLayerAtmosphericPotentialVorticityDiagnostic,
    )
    from qgs_jax.diagnostics.eddy import (
        MiddleAtmosphericEddyHeatFluxDiagnostic,
        MiddleAtmosphericEddyHeatFluxProfileDiagnostic,
    )
    from qgs_jax.diagnostics.variables import (
        VariablesDiagnostic, GeopotentialHeightDifferenceDiagnostic,
    )

    pars, t, traj = rp_traj
    hd_t0 = pars.atemperature_params
    classes = [
        LowerLayerAtmosphericStreamfunctionDiagnostic,
        UpperLayerAtmosphericStreamfunctionDiagnostic,
        MiddleAtmosphericStreamfunctionDiagnostic,
        MiddleAtmosphericTemperatureAnomalyDiagnostic,
        AtmosphericTemperatureMeridionalGradientDiagnostic,
        LowerLayerAtmosphericUWindDiagnostic, LowerLayerAtmosphericVWindDiagnostic,
        MiddleAtmosphericUWindDiagnostic, MiddleAtmosphericVWindDiagnostic,
        UpperLayerAtmosphericUWindDiagnostic, UpperLayerAtmosphericVWindDiagnostic,
        MiddleAtmosphericWindIntensityDiagnostic,
        MiddleLayerVerticalVelocity,
        LowerLayerAtmosphericVorticityDiagnostic,
        MiddleAtmosphericVorticityDiagnostic,
        UpperLayerAtmosphericVorticityDiagnostic,
        UpperLayerAtmosphericPotentialVorticityDiagnostic,
        LowerLayerAtmosphericPotentialVorticityDiagnostic,
    ]
    for cls in classes:
        d = cls(pars)
        out = d(t, traj)
        assert out is not None and np.all(np.isfinite(out)), cls.__name__
        ax = d.plot(time_index=0)
        assert ax is not None

    vd = VariablesDiagnostic([0, 1, 2], pars)
    out = vd(t, traj)
    assert out.shape == (3, len(t))

    gd = GeopotentialHeightDifferenceDiagnostic(
        [((np.pi / 1.5, np.pi / 4), (np.pi / 1.5, 3 * np.pi / 4))], pars)
    out = gd(t, traj)
    assert out.shape == (1, len(t))


def test_ocean_diagnostics_and_multi(maooam_traj):
    from qgs_jax.diagnostics.streamfunctions import (
        OceanicLayerStreamfunctionDiagnostic,
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    from qgs_jax.diagnostics.temperatures import (
        OceanicLayerTemperatureAnomalyDiagnostic, OceanicLayerTemperatureDiagnostic,
    )
    from qgs_jax.diagnostics.vorticity import OceanicLayerVorticityDiagnostic
    from qgs_jax.diagnostics.multi import MultiDiagnostic

    pars, t, traj = maooam_traj
    for cls in (OceanicLayerStreamfunctionDiagnostic,
                OceanicLayerTemperatureAnomalyDiagnostic,
                OceanicLayerTemperatureDiagnostic,
                OceanicLayerVorticityDiagnostic):
        d = cls(pars)
        out = d(t, traj)
        assert out is not None and np.all(np.isfinite(out)), cls.__name__

    m = MultiDiagnostic(1, 2)
    m.add_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(pars))
    m.add_diagnostic(OceanicLayerStreamfunctionDiagnostic(pars))
    outs = m(t, traj)
    assert len(outs) == 2
    fig, axes = m.plot(0)
    assert len(axes) == 2


def test_ground_temperature_diag():
    from qgs_jax.diagnostics.temperatures import (
        GroundTemperatureAnomalyDiagnostic, GroundTemperatureDiagnostic,
    )
    pars = QgParams(gtemperature_params=True)
    pars.set_atmospheric_channel_fourier_modes(2, 2)
    pars.set_ground_channel_fourier_modes()
    pars.gotemperature_params.set_params({'T0': 300.})
    f, Df = create_tendencies(pars)
    integ = RungeKuttaIntegrator()
    integ.set_func(f)
    ic = np.random.default_rng(0).random(pars.ndim) * 0.05
    integ.integrate(0., 10., 0.1, ic=ic, write_steps=10)
    t, traj = integ.get_trajectories()
    d = GroundTemperatureAnomalyDiagnostic(pars)
    out = d(t, traj)
    assert out is not None and np.all(np.isfinite(out))

    # total ground temperature = anomaly + reference T0 (non-dynamic path)
    dt_total = GroundTemperatureDiagnostic(pars)
    out_total = dt_total(t, traj)
    assert np.allclose(out_total, out + float(pars.gotemperature_params.T0))


def test_parity_api_surface(rp_traj):
    """Reference-parity accessors: grid_shape, plot_grid_point, set_params,
    point coordinates, MultiDiagnostic/FieldsDiagnosticsList catalog, movie
    hooks and ParametersArray properties (ref ``qgs/diagnostics/base.py``,
    ``multi.py``, ``qgs/params/parameter.py:1075-1150``)."""
    from qgs_jax.diagnostics.streamfunctions import (
        MiddleAtmosphericStreamfunctionDiagnostic,
    )
    from qgs_jax.diagnostics.base import FieldPointDiagnostic
    from qgs_jax.diagnostics.eddy import MiddleAtmosphericEddyHeatFluxProfileDiagnostic
    from qgs_jax.diagnostics.multi import MultiDiagnostic, FieldsDiagnosticsList
    from qgs_jax.diagnostics.variables import VariablesDiagnostic
    from qgs_jax.params.parameter import ParametersArray

    pars, t, traj = rp_traj
    psi = MiddleAtmosphericStreamfunctionDiagnostic(pars)
    psi.set_data(t, traj)
    assert psi.grid_shape == psi.grid[0].shape
    assert len(psi) == len(t)
    ax = psi.plot_grid_point(10, 10)
    assert ax is not None

    # field-point probe with movable coordinates
    fp = FieldPointDiagnostic(pars, 1.0, 1.0, MiddleAtmosphericStreamfunctionDiagnostic(pars))
    s1 = fp(t, traj).copy()
    assert fp.point_coordinates == (1.0, 1.0)
    fp.set_point_coordinates(2.0, 2.0)
    s2 = fp.diagnostic
    assert s1.shape == s2.shape == (len(t),) and not np.allclose(s1, s2)

    # set_params re-attaches and invalidates the cache
    psi.set_params(pars)
    assert psi._diagnostic_data is None

    # MultiDiagnostic catalog properties
    m = MultiDiagnostic(2, 1)
    m.add_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(pars))
    m.set_data(t, traj)
    assert m.nrows == 2 and m.ncols == 1 and len(m) == 2
    assert len(m.diagnostics_list) == 1
    assert m.diagnostic_positions == [(0, 0)]
    assert len(m.diagnostic) == 1

    # FieldsDiagnosticsList: indexed feed + joint plot on one axes
    fl = FieldsDiagnosticsList()
    fl.append_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(pars))
    fl.append_diagnostic(MiddleAtmosphericStreamfunctionDiagnostic(pars))
    fl.set_data(t, traj, index=0)
    fl.set_data(t, traj, index=1)
    assert len(fl) == len(t)
    ax = fl.plot(time_index=0, style=["image", "contour"], color_bar=False)
    assert ax is not None

    # profile + scalar animations build (use the FuncAnimation object output)
    prof = MiddleAtmosphericEddyHeatFluxProfileDiagnostic(pars)
    prof.set_data(t, traj)
    anim = prof.movie(output='animate')
    assert anim is not None
    vd = VariablesDiagnostic([0, 1], pars)
    vd.set_data(t, traj)
    anim = vd.movie(output='animate')
    assert anim is not None

    # ParametersArray parity accessors
    pa = ParametersArray([1.0, 2.0], units='[m]',
                         scale_object=pars.scale_params, description='test')
    assert pa.units == '[m]'
    assert list(pa.descriptions) == ['test', 'test']
    assert pa.input_dimensional and not pa.return_dimensional
    assert np.allclose(pa.dimensional_values, [1.0, 2.0])
    assert np.allclose(pa.nondimensional_values, np.asarray(pa, dtype=float))

    # symbolic tensor dict helpers
    from qgs_jax.tensors.symbolic_qgtensor import SymbolicQgsTensor
    dic = {(1, 2, 1): 3.0, (1, 1, 2): 1.0, (2, 0, 0): 0.0}
    nz = SymbolicQgsTensor.remove_dic_zeros(dic)
    assert (2, 0, 0) not in nz and len(nz) == 2
    upp = SymbolicQgsTensor.simplify_dict(nz)
    assert upp == {(1, 1, 2): 4.0}
    jac = SymbolicQgsTensor.jacobian_from_dict(upp)
    assert jac == {(1, 1, 2): 4.0, (1, 2, 1): 4.0}
    # identity swaps accumulate (same convention as the reference add_to_dict)
    assert SymbolicQgsTensor.jacobian_from_dict({(1, 1, 1): 2.0}) == {(1, 1, 1): 4.0}


def test_meridional_gradient_alias(rp_traj):
    """The 500hPa meridional-gradient diagnostic equals the generic one
    (it is the same thermal-wind field, ref temperatures.py:635-705)."""
    from qgs_jax.diagnostics.temperatures import (
        AtmosphericTemperatureMeridionalGradientDiagnostic,
        MiddleAtmosphericTemperatureMeridionalGradientDiagnostic,
    )
    pars, t, traj = rp_traj
    g1 = AtmosphericTemperatureMeridionalGradientDiagnostic(pars)(t, traj)
    g2 = MiddleAtmosphericTemperatureMeridionalGradientDiagnostic(pars)(t, traj)
    assert np.allclose(g1, g2)
    assert np.any(g2 != 0)
