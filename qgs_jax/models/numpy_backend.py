"""
NumPy reference-semantics backend
=================================

A host-side (CPU, NumPy) evaluation path that reproduces the *exact
arithmetic order* of the reference implementation's Numba kernels
(ref ``qgs/functions/sparse_mul.py:49-120`` and
``qgs/integrators/integrate.py:183-223``): the COO scalar accumulation over
nonzero entries and the ``y + dt * a[i] @ k`` stage updates.

Purpose:

* trajectory-fidelity gates: the JAX integrators are validated
  ``allclose`` against this backend over N RK4 steps;
* the benchmark baseline on this machine (the reference itself depends on
  Numba, which is not installed here; this path is its faithful
  single-thread stand-in).
"""

from __future__ import annotations

import numpy as np

from qgs_jax.utils.sparse import COO


def sparse_mul3(coords, data, vec1, vec2):
    """res_i = sum_e data[e] vec1[j_e] vec2[k_e]  (reference summation order)."""
    n = vec1.shape[0]
    res = np.zeros(n)
    for e in range(data.shape[0]):
        i, j, k = coords[0, e], coords[1, e], coords[2, e]
        res[i] += data[e] * vec1[j] * vec2[k]
    return res


def sparse_mul2(coords, data, vec):
    """mat_{ij} = sum_k T_{ijk} vec_k (column at axis 1, ref convention)."""
    n = vec.shape[0]
    res = np.zeros((n, n))
    for e in range(data.shape[0]):
        i, j, k = coords[0, e], coords[1, e], coords[2, e]
        res[i, j] += data[e] * vec[k]
    return res


def sparse_mul5(coords, data, v1, v2, v3, v4):
    n = v1.shape[0]
    res = np.zeros(n)
    for e in range(data.shape[0]):
        i, j, k, l, m = coords[:, e]
        res[i] += data[e] * v1[j] * v2[k] * v3[l] * v4[m]
    return res


def sparse_mul4(coords, data, v1, v2, v3):
    """mat_{ij} = sum_klm T_{ijklm} v1_k v2_l v3_m (ref convention)."""
    n = v1.shape[0]
    res = np.zeros((n, n))
    for e in range(data.shape[0]):
        i, j, k, l, m = coords[:, e]
        res[i, j] += data[e] * v1[k] * v2[l] * v3[m]
    return res


def make_numpy_tendencies(tensor: COO, jtensor: COO):
    """Reference-semantics f(t, x) / Df(t, x) closures from a COO tensor."""
    coords, data = tensor.coords, tensor.data
    jcoords, jdata = jtensor.coords, jtensor.data
    rank = tensor.rank

    if rank == 3:
        def f(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return sparse_mul3(coords, data, xx, xx)[1:]

        def Df(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return sparse_mul2(jcoords, jdata, xx)[1:, 1:]
    else:
        def f(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return sparse_mul5(coords, data, xx, xx, xx, xx)[1:]

        def Df(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return sparse_mul4(jcoords, jdata, xx, xx, xx)[1:, 1:]

    return f, Df


def make_numpy_tendencies_fast(tensor: COO, jtensor: COO):
    """Vectorized-NumPy tendencies (same math, gather/bincount instead of a
    scalar loop) — the throughput baseline proxy for the reference's Numba
    kernels on CPU."""
    coords, data = tensor.coords, tensor.data
    jcoords, jdata = jtensor.coords, jtensor.data
    rank = tensor.rank
    n1 = tensor.shape[0]

    if rank == 3:
        i_, j_, k_ = coords

        def f(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return np.bincount(i_, weights=data * xx[j_] * xx[k_], minlength=n1)[1:]

        ji_, jj_, jk_ = jcoords

        def Df(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            flat = np.bincount(ji_ * n1 + jj_, weights=jdata * xx[jk_],
                               minlength=n1 * n1)
            return flat.reshape(n1, n1)[1:, 1:]
    else:
        i_, j_, k_, l_, m_ = coords

        def f(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            return np.bincount(i_, weights=data * xx[j_] * xx[k_] * xx[l_] * xx[m_],
                               minlength=n1)[1:]

        ji_, jj_, jk_, jl_, jm_ = jcoords

        def Df(t, x):
            xx = np.concatenate((np.full((1,), 1.), x))
            flat = np.bincount(ji_ * n1 + jj_, weights=jdata * xx[jk_] * xx[jl_] * xx[jm_],
                               minlength=n1 * n1)
            return flat.reshape(n1, n1)[1:, 1:]

    return f, Df


def integrate_runge_kutta_numpy(f, t0, t, dt, ic, write_steps=1, b=None, c=None, a=None):
    """Reference-semantics RK integrator (single trajectory or batch loop)."""
    ic = np.atleast_2d(np.asarray(ic, dtype=np.float64))
    if a is None and b is None and c is None:
        c = np.array([0., 0.5, 0.5, 1.])
        b = np.array([1. / 6, 1. / 3, 1. / 3, 1. / 6])
        a = np.zeros((4, 4))
        a[1, 0], a[2, 1], a[3, 2] = 0.5, 0.5, 1.

    time = np.concatenate((np.arange(t0, t, dt), np.full((1,), t)))
    n_traj, n_dim = ic.shape
    s = len(b)

    if write_steps == 0:
        n_records = 1
    else:
        tot = time[::write_steps]
        n_records = len(tot) + (0 if tot[-1] == time[-1] else 1)

    recorded = np.zeros((n_traj, n_dim, n_records))
    for i_traj in range(n_traj):
        y = ic[i_traj].copy()
        k = np.zeros((s, n_dim))
        iw = 0
        for ti, (tt, dtt) in enumerate(zip(time[:-1], np.diff(time))):
            if write_steps > 0 and ti % write_steps == 0:
                recorded[i_traj, :, iw] = y
                iw += 1
            k.fill(0.)
            for i in range(s):
                y_s = y + dtt * a[i] @ k
                k[i] = f(tt + c[i] * dtt, y_s)
            y = y + dtt * b @ k
        recorded[i_traj, :, -1] = y

    if write_steps > 0:
        if time[::write_steps][-1] == time[-1]:
            return time[::write_steps], np.squeeze(recorded)
        return np.concatenate((time[::write_steps], [t])), np.squeeze(recorded)
    return time[-1], np.squeeze(recorded)
