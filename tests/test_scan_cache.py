"""Regression tests for the compiled-scan cache in qgs_jax.integrators.rk.

Round-1 review finding: keying the cache on ``id(f)`` let a garbage-
collected tendency function's address be reused by a new function, which
then silently received the stale compiled scan.  The cache now holds
strong references to the functions in its keys and is size-bounded.
"""

import gc

import jax.numpy as jnp
import numpy as np

from qgs_jax.integrators import rk


def _make_linear_tendency(rate):
    def f(t, y):
        return rate * y

    return f


def test_no_stale_scan_after_gc():
    """A new tendency function allocated after the old one is collected must
    never observe the old one's compiled scan (id-reuse hazard)."""
    y0 = np.ones((2, 3))

    # id()-reuse is nondeterministic, so force many allocate/collect cycles:
    # with the fixed cache every single one must produce its own result.
    for k in range(1, 30):
        rate = float(k)
        f = _make_linear_tendency(rate)
        _, y1 = rk.integrate_runge_kutta(f, 0.0, 0.1, 0.1, y0, write_steps=0)
        # exact single-RK4-step amplification for dy/dt = rate*y
        h = rate * 0.1
        expected = 1 + h + h**2 / 2 + h**3 / 6 + h**4 / 24
        assert np.allclose(np.asarray(y1), expected, rtol=1e-12), k
        del f
        gc.collect()


def test_cache_keys_hold_strong_refs_and_are_bounded():
    f = _make_linear_tendency(0.5)
    y0 = np.ones((1, 2))
    rk.integrate_runge_kutta(f, 0.0, 0.1, 0.1, y0, write_steps=0)
    assert any(key[0] is f for key in rk._SCAN_CACHE), \
        "cache key must reference the function object itself, not its id"

    # fill way past the bound; the cache must evict rather than grow
    for k in range(rk._SCAN_CACHE_MAX + 16):
        g = _make_linear_tendency(1.0 + k * 1e-6)
        rk.integrate_runge_kutta(g, 0.0, 0.1, 0.1, y0, write_steps=0)
    assert len(rk._SCAN_CACHE) <= rk._SCAN_CACHE_MAX
