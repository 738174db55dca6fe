#!/usr/bin/env python
"""User-defined symbolic basis and custom (weighted) inner product — the
extensibility path of the framework (ref user_guide.rst §5.3/§5.4)."""

import sys as _sys
import pathlib as _pathlib

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parents[1]))


import numpy as np
from sympy import symbols, sin, exp, pi, diff, integrate

from qgs_jax.params.params import QgParams
from qgs_jax.basis.base import SymbolicBasis
from qgs_jax.inner_products.definition import StandardSymbolicInnerProductDefinition
from qgs_jax.inner_products.symbolic import (
    AtmosphericSymbolicInnerProducts, GroundSymbolicInnerProducts,
)
from qgs_jax.tensors.qgtensor import QgsTensor
from qgs_jax.ops.contraction import make_tendency_fns

x, y = symbols('x y')
n = symbols('n', positive=True)

# A hand-rolled basis: any list of SymPy expressions in (x, y) satisfying
# the boundary conditions works; substitutions pin free symbols (here the
# aspect ratio n).
basis = SymbolicBasis()
for i in (1, 2):
    for j in (1, 2):
        basis.append(2 * sin(j * n * x / 2) * sin(i * y))
basis.substitutions = [(n, 1.5)]


# A custom inner product: weight the integrand by exp(-y/2) (the
# user-guide example of the reference).  Both the quadrature engine and
# the exact SymPy engine consume the definition through the same
# interface -- the quadrature engine reads .weight / .normalization, the
# exact engine calls symbolic_inner_product.
class ExponentiallyWeightedIP(StandardSymbolicInnerProductDefinition):
    """Inner product weighted by exp(-a y) (the user-guide example)."""

    weight = exp(-y / 2)

    @staticmethod
    def normalization(nv):
        return float(nv) / (2 * np.pi ** 2)

    def symbolic_inner_product(self, S, G, symbolic_expr=False, integrand=False):
        expr = (n / (2 * pi ** 2)) * exp(-y / 2) * S * G
        if integrand:
            return expr, (x, 0, 2 * pi / n), (y, 0, pi)
        return self.integrate_over_domain(self.optimizer(expr),
                                          symbolic_expr=symbolic_expr)


# Wire the basis into the parameter object and compute the weighted inner
# products; with a non-trivial weight the mass matrix u is no longer the
# identity and the mass-matrix inversions in the tensor assembly matter.
pars = QgParams({'phi0_npi': np.deg2rad(50.) / np.pi, 'hd': 0.1})
pars.set_atmospheric_modes(basis, auto=True)

ip_def = ExponentiallyWeightedIP()
aip = AtmosphericSymbolicInnerProducts(pars, inner_product_definition=ip_def,
                                       quadrature=True)
print("custom-weighted mass matrix u (no longer the identity):")
print(np.array2string(np.asarray(aip._u), precision=4, suppress_small=True))

tensor = QgsTensor(pars, aip, None, None)
f_b, _ = make_tendency_fns(tensor.tensor, tensor.jacobian_tensor)
xs = np.random.default_rng(0).random((1, pars.ndim)) * 0.1
print("tendencies at a random state:", np.asarray(f_b(0., xs))[0][:4], "...")
