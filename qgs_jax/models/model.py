"""
High-level model object + compile-artifact checkpointing
========================================================

Convenience wrapper tying the whole pipeline together, plus persistence of
the expensive compile artifacts (params + tendency tensors), mirroring the
reference's recommended workflow of pickling ``{f, Df, parameters}``
(ref ``user_guide.rst`` §2.5 — here the *tensor* is pickled instead of the
closures, which is robust across machines and jax versions).
"""

from __future__ import annotations

import pickle

import numpy as np

from qgs_jax.models.tendencies import create_tendencies, _build_inner_products, build_tensor
from qgs_jax.ops.contraction import (jit_contraction, make_tendency_fns,
                                     single_state)


class QgsModel:
    """A configured model: parameters + tendency tensor + compiled callables.

    Parameters
    ----------
    params: QgParams
        Fully specified model configuration.
    mode: str
        Contraction mode ('auto' | 'dense' | 'coo').
    dtype: jnp dtype, optional
        Device compute dtype (default: f64 when x64 is enabled).
    """

    def __init__(self, params, mode="auto", dtype=None, _tensor=None):
        self.params = params
        if _tensor is None:
            aip, oip, gip = _build_inner_products(params)
            self.inner_products = (aip, oip, gip)
            self.tensor = build_tensor(params, aip, oip, gip)
        else:
            self.inner_products = None
            self.tensor = _tensor
        self._compile(mode, dtype)

    def _compile(self, mode="auto", dtype=None):
        f_b, jac_b = make_tendency_fns(self.tensor.tensor,
                                       self.tensor.jacobian_tensor,
                                       mode=mode, dtype=dtype)
        self.f_batched = jit_contraction(f_b)
        self.Df_batched = jit_contraction(jac_b)
        self.f = jit_contraction(single_state(f_b))
        self.Df = jit_contraction(single_state(jac_b))
        self.f.batched = self.f_batched
        self.Df.batched = self.Df_batched

    @property
    def ndim(self):
        return self.params.ndim

    # -- persistence of compile artifacts ----------------------------------

    def save(self, filename):
        """Pickle the configuration and the precomputed tensors."""
        with open(filename, "wb") as fh:
            pickle.dump({"params": self.params, "tensor": self.tensor}, fh)

    @classmethod
    def load(cls, filename, mode="auto", dtype=None):
        """Restore a model from :meth:`save` output (skips the inner-product
        and tensor recomputation entirely)."""
        with open(filename, "rb") as fh:
            state = pickle.load(fh)
        return cls(state["params"], mode=mode, dtype=dtype,
                   _tensor=state["tensor"])


def save_trajectory_checkpoint(filename, t, state, **extra):
    """Checkpoint an integration: time + state arrays (+ extras).

    Restart by feeding ``state`` back as the initial condition."""
    np.savez(filename, t=np.asarray(t), state=np.asarray(state), **extra)


def load_trajectory_checkpoint(filename):
    data = np.load(filename, allow_pickle=False)
    return data["t"], data["state"], {k: data[k] for k in data.files
                                      if k not in ("t", "state")}
