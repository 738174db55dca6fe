"""
Tendencies factory
==================

``create_tendencies(params)`` orchestrates the full compile pipeline
(ref ``/root/reference/qgs/functions/tendencies.py:20-211``): select
analytic vs symbolic inner products from the configuration, connect the
components, build the tendency tensor, and close its values over
jit-compiled JAX contraction kernels.

Returned callables follow the reference's central API contract — plain
functions ``f(t, x)`` and ``Df(t, x)`` on single states — plus their
batched counterparts for ensemble integration (exposed on the returned
functions as ``.batched``).
"""

from __future__ import annotations

from qgs_jax.inner_products.analytic import (
    AtmosphericAnalyticInnerProducts, OceanicAnalyticInnerProducts,
    GroundAnalyticInnerProducts,
)
from qgs_jax.tensors.qgtensor import QgsTensor, QgsTensorDynamicT, QgsTensorT4
from qgs_jax.tensors.atmo_thermo import (
    AtmoThermoTensor, AtmoThermoTensorDynamicT, AtmoThermoTensorT4,
)
from qgs_jax.ops.contraction import (jit_contraction, make_tendency_fns,
                                     single_state)


def _build_inner_products(params):
    """Pick analytic or symbolic inner products from the configuration."""
    if params.T4 or params.dynamic_T:
        # the analytic closed forms do not provide the quartic z/v
        # coefficients over the extended (constant-mode) basis — same
        # limitation as the reference, where the analytic accessors are
        # no-ops (ref ``qgs/inner_products/analytic.py:432-436``), but
        # fail loudly here instead of with a shape error deep in assembly
        blocks = [("atmospheric", params.ablocks),
                  ("oceanic", params.oblocks), ("ground", params.gblocks)]
        used = [name for name, b in blocks if b is not None]
        if used:
            raise ValueError(
                "dynamic_T/T4 configurations need symbolic inner products: "
                f"set the {'/'.join(used)} modes with mode='symbolic' "
                "(analytic inner products have no quartic coefficients)")
    aip = oip = gip = None
    if params.ablocks is not None:
        aip = AtmosphericAnalyticInnerProducts(params)
    elif params.atmospheric_basis is not None:
        from qgs_jax.inner_products.symbolic import AtmosphericSymbolicInnerProducts
        aip = AtmosphericSymbolicInnerProducts(params)

    if params.oblocks is not None:
        oip = OceanicAnalyticInnerProducts(params)
    elif params.oceanic_basis is not None:
        from qgs_jax.inner_products.symbolic import OceanicSymbolicInnerProducts
        oip = OceanicSymbolicInnerProducts(params)

    if params.gblocks is not None:
        gip = GroundAnalyticInnerProducts(params)
    elif params.ground_basis is not None:
        from qgs_jax.inner_products.symbolic import GroundSymbolicInnerProducts
        gip = GroundSymbolicInnerProducts(params)

    if aip is not None and oip is not None:
        if not aip.connected_to_ocean:
            aip.connect_to_ocean(oip)
    elif aip is not None and gip is not None:
        if not aip.connected_to_ground:
            aip.connect_to_ground(gip)
    return aip, oip, gip


def build_tensor(params, aip, oip, gip):
    if params.T4:
        return QgsTensorT4(params, aip, oip, gip)
    if params.dynamic_T:
        return QgsTensorDynamicT(params, aip, oip, gip)
    return QgsTensor(params, aip, oip, gip)


def create_tendencies(params, return_inner_products=False, return_qgtensor=False,
                      mode="auto", dtype=None, precision=None):
    """Build the jit-compiled tendencies ``f(t, x)`` and Jacobian ``Df(t, x)``.

    Both returned callables operate on single states (shape (ndim,)) like the
    reference; batched versions over a leading ensemble axis are attached as
    ``f.batched`` / ``Df.batched``.
    """
    aip, oip, gip = _build_inner_products(params)
    agotensor = build_tensor(params, aip, oip, gip)

    f_b, jac_b = make_tendency_fns(agotensor.tensor, agotensor.jacobian_tensor,
                                   mode=mode, dtype=dtype, precision=precision)

    # jit with the tensor buffers threaded as arguments (shared executables
    # across same-shape models — see contraction.Contraction)
    f_batched = jit_contraction(f_b)
    Df_batched = jit_contraction(jac_b)
    f = jit_contraction(single_state(f_b))
    Df = jit_contraction(single_state(jac_b))
    f.batched = f_batched
    Df.batched = Df_batched
    # the compile artifact rides along: integrators use it for the fused
    # double-float tier, diagnostics for the omega computation
    f.qgtensor = agotensor
    Df.qgtensor = agotensor

    ret = [f, Df]
    if return_inner_products:
        ret.append((aip, oip, gip))
    if return_qgtensor:
        ret.append(agotensor)
    return ret


def create_atmo_thermo_tendencies(params, return_atmo_thermo_tensor=False,
                                  mode="auto", dtype=None, precision=None):
    """Thermodynamic-only atmospheric tendencies (used to diagnose the
    vertical velocity omega as f - f_thermo)."""
    aip, oip, gip = _build_inner_products(params)

    if params.T4:
        tensor = AtmoThermoTensorT4(params, aip, oip, gip)
    elif params.dynamic_T:
        tensor = AtmoThermoTensorDynamicT(params, aip, oip, gip)
    else:
        tensor = AtmoThermoTensor(params, aip, oip, gip)

    f_b, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor,
                               mode=mode, dtype=dtype, precision=precision)
    f = jit_contraction(single_state(f_b))
    f.batched = jit_contraction(f_b)

    if return_atmo_thermo_tensor:
        return [f, tensor]
    return f
