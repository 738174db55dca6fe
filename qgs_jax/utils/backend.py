"""
Per-platform numerical policy
=============================

The few choices the device path makes from the backend it runs on, kept in
one table keyed by ``jax.default_backend()``.  Only the platforms the
policy was measured on are supported; any other platform raises instead of
inheriting a guess.

``accumulate``
    Double-float accumulation in the tendency contractions and in the
    Gram/residual products of :func:`qgs_jax.ops.twofloat.cholqr_df`.
    ``'fast'`` skips the intermediate renormalisations and relies on the
    ``optimization_barrier`` around every error-free transformation
    surviving compilation; ``'strict'`` renormalises after every
    double-float operation and degrades gracefully when the compiler strips
    the barriers.  XLA:CPU strips them ('fast' then loses the two-sum error
    terms, ~1e-8 relative), so the CPU runs 'strict'.  On an NVIDIA H100
    (700 W limit, ``chip_smoke.py`` phase 3) both modes tracked native
    float64 to 6.0e-16 absolute over 100 MAOOAM RK4 steps at B=4096, and
    1000 steps at B=16384 took 0.80 s with 'fast' against 1.03 s with
    'strict', so the GPU runs 'fast'.

``qr_method``
    The per-window QR of the double-float Benettin windows
    (:func:`qgs_jax.toolbox.lyapunov.make_window_step_df`): 'householder'
    (float64 Householder) or 'mixed' (the float64-free CholeskyQR
    :func:`qgs_jax.ops.twofloat.cholqr_df`).  The CPU runs 'householder'.
    On the H100 above (``chip_smoke.py`` phase 4: 20 MAOOAM windows at
    B=64) 'mixed' took 0.027 s against 'householder''s 0.074 s, and their
    window-mean exponents agreed to 4.1e-14, so the GPU runs 'mixed'.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class BackendPolicy:
    accumulate: str          # 'fast' | 'strict'
    qr_method: str           # 'householder' | 'mixed'


POLICIES = {
    "cpu": BackendPolicy(accumulate="strict", qr_method="householder"),
    "gpu": BackendPolicy(accumulate="fast", qr_method="mixed"),
}


def backend_policy(platform=None):
    """The :class:`BackendPolicy` of ``platform`` (default: JAX's default
    backend).  Raises ``ValueError`` for a platform without a measured
    policy."""
    if platform is None:
        platform = jax.default_backend()
    try:
        return POLICIES[platform]
    except KeyError:
        raise ValueError(
            f"no numerical policy for platform {platform!r}; supported "
            f"platforms: {', '.join(sorted(POLICIES))}") from None
