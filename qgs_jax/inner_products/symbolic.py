"""
Symbolic inner products
=======================

Inner products of arbitrary symbolic (SymPy) bases, for model
configurations beyond the analytic closed forms: custom bases, custom
(e.g. weighted) inner-product definitions, non-atmospheric orographic
bases, and the dynamic-temperature / T^4 quartic coefficients
(ref ``/root/reference/qgs/inner_products/symbolic.py:40-1697``).

Two computation engines:

* ``quadrature=True`` (default): the vectorized Gauss-Legendre engine
  (:mod:`qgs_jax.inner_products.quadrature`) — all coefficients of a family
  in one einsum, exact to machine precision for trigonometric bases.
* ``quadrature=False`` / ``return_symbolic=True``: exact SymPy integration
  per coefficient (needed for the symbolic-export branch, where the results
  stay symbolic expressions).

The quartic T^4 coefficients are computed on the sorted-index simplex and
scattered to all multiset permutations, exactly like the reference
(``symbolic.py:284-299``); with ``dynamic_T`` only the ``(i,0,0,0,m)``
pattern exists.
"""

from __future__ import annotations

import os
import signal
import threading
import warnings

import numpy as np
from sympy import (Float, lambdify, symbols, ImmutableSparseMatrix,
                   ImmutableSparseNDimArray)
from sympy.utilities.iterables import multiset_permutations

from qgs_jax.inner_products.base import (
    AtmosphericInnerProducts, OceanicInnerProducts, GroundInnerProducts,
)
from qgs_jax.inner_products.definition import StandardSymbolicInnerProductDefinition
from qgs_jax.inner_products.quadrature import DomainQuadrature, _max_freqs, prune_small
from qgs_jax.utils.sparse import COO

_x, _y = symbols('x y')


def _subs_basis(basis):
    return basis.subs_functions()


def _quartic_coo(quad, A, Bgrid, n_left, n_right, dynamic_T, T4):
    """Quartic coefficients (A_i, B_j B_k B_l B_m) as a rank-5 COO.

    T4: computed on the simplex j<=k<=l<=m then scattered to all multiset
    permutations.  dynamic_T only: the (i,0,0,0,m) pattern (+ permutations).
    """
    entries = {}
    W = quad.W
    if T4:
        # full quartic over the sorted-index simplex, fully vectorized:
        # one big product grid (n_patterns, G) and a single matmul with the
        # weighted left basis, then scatter to all multiset permutations
        nb = n_right
        AW = A * W[None, :]
        patterns = np.array([(j, k, l, m)
                             for j in range(nb) for k in range(j, nb)
                             for l in range(k, nb) for m in range(l, nb)])
        G = Bgrid.shape[1]
        block = np.empty((A.shape[0], len(patterns)))
        chunk = max(1, int(2e7 // G))
        for lo in range(0, len(patterns), chunk):
            pc = patterns[lo:lo + chunk]
            prod = (Bgrid[pc[:, 0]] * Bgrid[pc[:, 1]]
                    * Bgrid[pc[:, 2]] * Bgrid[pc[:, 3]])
            block[:, lo:lo + chunk] = AW @ prod.T
        block = prune_small(block)
        nz_i, nz_p = np.nonzero(block)
        for p in np.unique(nz_p):
            rows = nz_i[nz_p == p]
            vals = block[rows, p]
            for perm in multiset_permutations(list(patterns[p])):
                for i, v in zip(rows, vals):
                    entries[(int(i), *perm)] = v
    elif dynamic_T:
        B0cubed = Bgrid[0] ** 3
        block = (A * W[None, :]) @ (B0cubed[None, :] * Bgrid).T   # (n_left, nb)
        block = prune_small(block)
        for m in range(n_right):
            v = block[:, m]
            nz = np.nonzero(v)[0]
            if nz.size == 0:
                continue
            for perm in multiset_permutations([0, 0, 0, m]):
                for i in nz:
                    entries[(i, *perm)] = v[i]
    shape = (n_left,) + (n_right,) * 4
    return COO.from_dict(entries, shape)


class _IntegrationTimeout(Exception):
    """A single exact-SymPy integral exceeded the wall-clock budget."""


def _pool_integrate(payload):
    """One exact integral inside a pool worker process.

    The per-integral timeout runs IN the worker via SIGALRM (each worker is
    its own process's main thread, so the alarm interrupts the SymPy loop
    cleanly); a timeout is reported back instead of raising so the parent
    can apply its quadrature fallback — the same semantics as the
    reference's pebble ProcessPool with per-task timeout (ref
    ``qgs/inner_products/symbolic.py:1636-1697``)."""
    import signal as _signal

    defn, name, fns, timeout = payload
    method = getattr(defn, name)
    if timeout is not None:
        def _alarm(signum, frame):
            raise _IntegrationTimeout

        _signal.signal(_signal.SIGALRM, _alarm)
        _signal.setitimer(_signal.ITIMER_REAL, float(timeout))
    try:
        return True, method(*fns, symbolic_expr=False)
    except _IntegrationTimeout:
        return False, None
    finally:
        if timeout is not None:
            _signal.setitimer(_signal.ITIMER_REAL, 0.0)


class _SymbolicIPBase:
    """Shared engine setup for the symbolic inner-product classes."""

    def _setup_engine(self, n, inner_product_definition,
                      interaction_inner_product_definition, quadrature,
                      return_symbolic, make_substitution, timeout=None,
                      num_threads=None):
        self.n = n
        self.quadrature = quadrature
        self.return_symbolic = return_symbolic
        self.timeout = timeout
        self.num_threads = num_threads
        self.mk_subs = make_substitution if return_symbolic else True
        nsym = symbols('n', positive=True)
        self.subs = [(nsym, float(n))] if self.mk_subs else None

        self.ip = (inner_product_definition
                   if inner_product_definition is not None
                   else StandardSymbolicInnerProductDefinition())
        self.iip = (interaction_inner_product_definition
                    if interaction_inner_product_definition is not None
                    else self.ip)
        self._quad_cache = {}

    def _quad(self, definition, *bases):
        """A DomainQuadrature resolved for the frequency content of the
        participating bases (cached)."""
        key = tuple(id(b) for b in bases) + (id(definition),)
        if key not in self._quad_cache:
            exprs = []
            for b in bases:
                exprs.extend(_subs_basis(b))
            fx, fy = _max_freqs(exprs)
            norm = getattr(definition, 'normalization', None)
            weight = getattr(definition, 'weight', None)
            self._quad_cache[key] = DomainQuadrature(
                self.n, max_fx=5 * fx, max_fy=5 * fy,
                normalization=norm, weight_expr=weight)
        return self._quad_cache[key]

    def _exact_ip(self, method, *fns):
        """Exact SymPy integration of one coefficient (symbolic or float).

        With ``self.timeout`` set, each integral runs under a per-integral
        wall-clock budget; a timed-out integral falls back to adaptive
        numerical quadrature of its integrand — the same semantics as the
        reference's pebble-pool timeout path (ref
        ``qgs/inner_products/symbolic.py:1636-1697``)."""
        try:
            res = self._run_with_timeout(method, fns)
        except _IntegrationTimeout:
            val = self._quadrature_fallback(method, fns)
            warnings.warn(
                f"exact SymPy integration ({method.__name__}) exceeded the "
                f"{self.timeout}s per-integral budget; fell back to "
                f"numerical quadrature (value {val:.6e})", stacklevel=3)
            if self.return_symbolic:
                return Float(val)
            return val
        if self.return_symbolic:
            return res
        return float(res.subs(self.subs)) if self.subs else float(res)

    def _exact_ip_batch(self, method, tasks):
        """Evaluate a batch of exact integrals ``[self._exact_ip(method,
        *fns) for fns in tasks]``, fanned out over a process pool when
        ``self.num_threads > 1`` — the parallel counterpart of the
        reference's pebble-pool setup compute (ref
        ``qgs/inner_products/symbolic.py:26,1636-1697``).  Timed-out
        integrals fall back to quadrature in the parent, exactly as the
        serial path does."""
        n_jobs = getattr(self, "num_threads", None) or 1
        n_jobs = min(n_jobs, os.cpu_count() or 1)
        if n_jobs <= 1 or len(tasks) < 2 * n_jobs:
            return [self._exact_ip(method, *fns) for fns in tasks]

        from concurrent.futures import ProcessPoolExecutor

        # A plain fork pool would fork the parent AFTER JAX has spun up
        # its threads — the classic fork-with-threads deadlock hazard.  A
        # FORKSERVER context avoids it: the server is a fresh spawned
        # interpreter (no inherited threads) and workers fork from IT.  The
        # server starts with JAX_PLATFORMS=cpu, so neither it nor its forks
        # ever open an accelerator (a second process on a card would fail
        # for want of the memory the parent reserved), and the worker
        # module is preloaded into it once so each forked worker inherits
        # the imports instead of re-running them.
        defn, name = method.__self__, method.__name__
        payloads = [(defn, name, fns, self.timeout) for fns in tasks]
        out = []
        import multiprocessing as _mp
        from multiprocessing import forkserver as _fs
        ctx = _mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__ if __name__ != "__main__"
                                    else "qgs_jax.inner_products.symbolic"])
        # the server inherits os.environ when it starts: start it inside
        # the window, then restore the parent's value
        saved = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            _fs.ensure_running()
        finally:
            if saved is None:
                os.environ.pop("JAX_PLATFORMS", None)
            else:
                os.environ["JAX_PLATFORMS"] = saved
        with ProcessPoolExecutor(max_workers=n_jobs, mp_context=ctx) as ex:
            for (ok, res), fns in zip(ex.map(_pool_integrate, payloads,
                                             chunksize=4), tasks):
                if not ok:
                    val = self._quadrature_fallback(method, fns)
                    warnings.warn(
                        f"exact SymPy integration ({name}) exceeded the "
                        f"{self.timeout}s per-integral budget; fell back "
                        f"to numerical quadrature (value {val:.6e})",
                        stacklevel=3)
                    out.append(Float(val) if self.return_symbolic else val)
                elif self.return_symbolic:
                    out.append(res)
                else:
                    out.append(float(res.subs(self.subs))
                               if self.subs else float(res))
        return out

    def _run_with_timeout(self, method, fns):
        """Run one exact integration, bounded by ``self.timeout`` seconds.

        Uses ``SIGALRM`` (SymPy integration is a pure-Python loop, so the
        alarm interrupts it cleanly); on non-main threads — where signals
        cannot be delivered — the integral runs unbounded, as before."""
        if (self.timeout is None
                or threading.current_thread() is not threading.main_thread()):
            return method(*fns, symbolic_expr=False)

        def _alarm(signum, frame):
            raise _IntegrationTimeout

        old = signal.signal(signal.SIGALRM, _alarm)
        signal.setitimer(signal.ITIMER_REAL, float(self.timeout))
        try:
            return method(*fns, symbolic_expr=False)
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0.0)
            signal.signal(signal.SIGALRM, old)

    def _quadrature_fallback(self, method, fns):
        """Adaptive scipy quadrature of one coefficient's integrand, results
        below the quadrature error zeroed (ref ``symbolic.py:1585-1633``)."""
        from scipy.integrate import dblquad

        if self.n is None:
            raise RuntimeError(
                "integration timed out and no aspect ratio n is available "
                "for the numerical fallback")
        from sympy import sympify

        expr, xb, yb = method(*fns, integrand=True)
        nsym = symbols('n', positive=True)
        expr = expr.subs(nsym, float(self.n))
        x_lo, x_hi = (float(sympify(b).subs(nsym, float(self.n)))
                      for b in xb[1:])
        y_lo, y_hi = (float(sympify(b).subs(nsym, float(self.n)))
                      for b in yb[1:])
        f = lambdify((_x, _y), expr, 'numpy')
        # dblquad integrates func(y, x) over y in [gfun, hfun], x in [a, b]
        val, err = dblquad(lambda yy, xx: f(xx, yy), x_lo, x_hi, y_lo, y_hi)
        if abs(val) <= max(err, 5e-11):
            return 0.0
        return val

    def _standard_fastpath(self, definition):
        return (type(definition) is StandardSymbolicInnerProductDefinition
                or (getattr(definition, 'weight', None) is None
                    and hasattr(definition, 'normalization')))


class AtmosphericSymbolicInnerProducts(AtmosphericInnerProducts, _SymbolicIPBase):
    """Atmospheric inner products for an arbitrary symbolic basis."""

    def __init__(self, params=None, stored=True, inner_product_definition=None,
                 interaction_inner_product_definition=None, num_threads=None,
                 quadrature=True, timeout=None, dynTinnerproducts=None,
                 T4innerproducts=None, return_symbolic=False,
                 make_substitution=True):
        AtmosphericInnerProducts.__init__(self)

        goc_basis, oog, oro_basis = None, "", "atmospheric"
        if params is not None:
            if hasattr(params, 'scale_params'):
                n = float(params.scale_params.n)
                self.atmospheric_basis = params.atmospheric_basis
                if params.oceanic_basis is not None:
                    goc_basis, oog = params.oceanic_basis, "ocean"
                elif params.ground_basis is not None:
                    goc_basis, oog = params.ground_basis, "ground"
                    oro_basis = params.ground_params.orographic_basis
                elif params.ground_params is not None:
                    oro_basis = params.ground_params.orographic_basis
                self._T4 = params.T4 if T4innerproducts is None else T4innerproducts
                self._dynamic_T = (params.dynamic_T if dynTinnerproducts is None
                                   else dynTinnerproducts)
            else:
                n = float(params[0])
                self.atmospheric_basis = params[1]
                goc_basis, oog, oro_basis = params[2], params[3], params[4]
                self._T4 = bool(T4innerproducts)
                self._dynamic_T = bool(dynTinnerproducts)
        else:
            n = None
            self.atmospheric_basis = None
            self._T4 = bool(T4innerproducts)
            self._dynamic_T = bool(dynTinnerproducts)
            stored = False

        self.oceanic_basis = None
        self.connected_to_ocean = False
        self.ground_basis = None
        self.connected_to_ground = False

        self._setup_engine(n, inner_product_definition,
                           interaction_inner_product_definition, quadrature,
                           return_symbolic, make_substitution, timeout=timeout,
                           num_threads=num_threads)
        self.stored = stored
        if stored and self.atmospheric_basis is not None:
            self.compute_inner_products()
        if goc_basis is not None:
            if oog == "ocean":
                self.connect_to_ocean(goc_basis)
            else:
                self.connect_to_ground(goc_basis, oro_basis)

    @property
    def natm(self):
        return len(self.atmospheric_basis.functions)

    def _F(self, i):
        return self.atmospheric_basis.functions[i]

    def _phi(self, i):
        basis = self.oceanic_basis or self.ground_basis
        return basis.functions[i]

    # -- bulk computation ---------------------------------------------------

    def compute_inner_products(self, num_threads=None, timeout=None):
        if timeout is not None:
            self.timeout = timeout
        if num_threads is not None:
            self.num_threads = num_threads
        if self.return_symbolic or not self.quadrature:
            self._compute_exact()
        else:
            self._compute_quadrature()

    def _compute_quadrature(self):
        exprs = _subs_basis(self.atmospheric_basis)
        quad = self._quad(self.ip, self.atmospheric_basis)
        g = quad.field_grids(exprs, lap_grad=True)

        self._u = prune_small(quad.pair(g['F'], g['F']))
        self._a = prune_small(quad.pair(g['F'], g['lapF']))
        self._c = prune_small(quad.pair(g['F'], g['Fx']))
        self._g = prune_small(quad.jacobian_triple(g['F'], g, g))
        self._b = prune_small(quad.jacobian_triple(g['F'], g, g, Ck='lapF'))

        if self._T4 or self._dynamic_T:
            self._z = _quartic_coo(quad, g['F'], g['F'], self.natm, self.natm,
                                   self._dynamic_T and not self._T4, self._T4)

    def _compute_exact(self):
        na = self.natm
        F = [self._F(i) for i in range(na)]
        if self.mk_subs:
            F = [f.subs(self.subs) for f in F] if not self.return_symbolic else F

        def fill2(method):
            idx = [(i, j) for i in range(na) for j in range(na)]
            vals = self._exact_ip_batch(method, [(F[i], F[j])
                                                 for i, j in idx])
            return {ij: v for ij, v in zip(idx, vals) if v != 0}

        def fill3(method):
            idx = [(i, j, k) for i in range(na) for j in range(na)
                   for k in range(na)]
            vals = self._exact_ip_batch(method, [(F[i], F[j], F[k])
                                                 for i, j, k in idx])
            return {ijk: v for ijk, v in zip(idx, vals) if v != 0}

        u = fill2(self.ip.symbolic_inner_product)
        a = fill2(self.ip.ip_lap)
        c = fill2(self.ip.ip_diff_x)
        gg = fill3(self.ip.ip_jac)
        bb = fill3(self.ip.ip_jac_lap)
        if self.return_symbolic:
            self._u = ImmutableSparseMatrix(na, na, u)
            self._a = ImmutableSparseMatrix(na, na, a)
            self._c = ImmutableSparseMatrix(na, na, c)
            self._g = ImmutableSparseNDimArray(gg, shape=(na, na, na))
            self._b = ImmutableSparseNDimArray(bb, shape=(na, na, na))
        else:
            self._u = COO.from_dict(u, (na, na)).todense()
            self._a = COO.from_dict(a, (na, na)).todense()
            self._c = COO.from_dict(c, (na, na)).todense()
            self._g = COO.from_dict(gg, (na, na, na)).todense()
            self._b = COO.from_dict(bb, (na, na, na)).todense()
        if self._T4 or self._dynamic_T:
            self._z = self._exact_quartic(F, F, self._theta_pairs(na))

    def _theta_pairs(self, nb):
        if self._T4:
            idx = [(j, k, l, m) for j in range(nb) for k in range(j, nb)
                   for l in range(k, nb) for m in range(l, nb)]
        else:
            idx = [(0, 0, 0, m) for m in range(nb)]
        return idx

    def _exact_quartic(self, left, right, idx_list):
        entries = {}
        na = len(left)
        tasks, keys = [], []
        for (j, k, l, m) in idx_list:
            prod = right[j] * right[k] * right[l] * right[m]
            for i in range(na):
                tasks.append((left[i], prod))
                keys.append((i, j, k, l, m))
        vals = self._exact_ip_batch(self.ip.symbolic_inner_product, tasks)
        for (i, j, k, l, m), v in zip(keys, vals):
            if v != 0:
                for perm in multiset_permutations([j, k, l, m]):
                    entries[(i, *perm)] = v
        if self.return_symbolic:
            return ImmutableSparseNDimArray(entries, shape=(na,) + (len(right),) * 4)
        return COO.from_dict(entries, (na,) + (len(right),) * 4)

    # -- couplings ----------------------------------------------------------

    def connect_to_ocean(self, ocean_basis, num_threads=None, timeout=None):
        """Compute s, d (and the quartic v) against an oceanic basis."""
        if timeout is not None:
            self.timeout = timeout
        if hasattr(ocean_basis, 'oceanic_basis'):   # accept an IP object too
            ocean_basis = ocean_basis.oceanic_basis
        self.ground_basis = None
        self.connected_to_ground = False
        self.oceanic_basis = ocean_basis
        self.connected_to_ocean = True
        self._connect_goc(ocean_basis, gh=False)

    def connect_to_ground(self, ground_basis, orographic_basis="atmospheric",
                          num_threads=None, timeout=None):
        """Compute s (and gh for a ground orographic basis)."""
        if timeout is not None:
            self.timeout = timeout
        if hasattr(ground_basis, 'ground_basis'):
            ground_basis = ground_basis.ground_basis
        self.oceanic_basis = None
        self.connected_to_ocean = False
        self.ground_basis = ground_basis
        self.connected_to_ground = True
        self._connect_goc(ground_basis, gh=(orographic_basis != "atmospheric"))

    def _connect_goc(self, basis, gh):
        if self.return_symbolic or not self.quadrature:
            self._connect_exact(basis, gh)
        else:
            self._connect_quadrature(basis, gh)

    def _connect_quadrature(self, basis, gh):
        a_exprs = _subs_basis(self.atmospheric_basis)
        p_exprs = _subs_basis(basis)
        quad = self._quad(self.iip, self.atmospheric_basis, basis)
        ga = quad.field_grids(a_exprs)
        gp = quad.field_grids(p_exprs)
        self._s = prune_small(quad.pair(ga['F'], gp['F']))
        self._d = prune_small(quad.pair(ga['F'], gp['lapF']))
        if gh:
            self._gh = prune_small(quad.jacobian_triple(ga['F'], ga, gp))
        if self._T4 or self._dynamic_T:
            self._v = _quartic_coo(quad, ga['F'], gp['F'], self.natm,
                                   len(p_exprs),
                                   self._dynamic_T and not self._T4, self._T4)

    def _connect_exact(self, basis, gh):
        na = self.natm
        nb = len(basis.functions)
        F = [self._F(i) for i in range(na)]
        P = list(basis.functions)
        s, d, ghd = {}, {}, {}
        idx = [(i, j) for i in range(na) for j in range(nb)]
        tasks = [(F[i], P[j]) for i, j in idx]
        for ij, v in zip(idx, self._exact_ip_batch(
                self.iip.symbolic_inner_product, tasks)):
            if v != 0:
                s[ij] = v
        for ij, v in zip(idx, self._exact_ip_batch(self.iip.ip_lap, tasks)):
            if v != 0:
                d[ij] = v
        if gh:
            idx3 = [(i, j, k) for i in range(na) for j in range(na)
                    for k in range(nb)]
            for ijk, v in zip(idx3, self._exact_ip_batch(
                    self.iip.ip_jac,
                    [(F[i], F[j], P[k]) for i, j, k in idx3])):
                if v != 0:
                    ghd[ijk] = v
        if self.return_symbolic:
            self._s = ImmutableSparseMatrix(na, nb, s)
            self._d = ImmutableSparseMatrix(na, nb, d)
            if gh:
                self._gh = ImmutableSparseNDimArray(ghd, shape=(na, na, nb))
        else:
            self._s = COO.from_dict(s, (na, nb)).todense()
            self._d = COO.from_dict(d, (na, nb)).todense()
            if gh:
                self._gh = COO.from_dict(ghd, (na, na, nb)).todense()
        if self._T4 or self._dynamic_T:
            self._v = self._exact_quartic(F, P, self._theta_pairs(nb))

    # -- accessors ----------------------------------------------------------

    def a(self, i, j):
        return self._a[i, j]

    def u(self, i, j):
        return self._u[i, j]

    def b(self, i, j, k):
        return self._b[i, j, k]

    def c(self, i, j):
        return self._c[i, j]

    def g(self, i, j, k):
        return self._g[i, j, k]

    def gh(self, i, j, k):
        return self._gh[i, j, k] if self._gh is not None else 0

    def s(self, i, j):
        return self._s[i, j] if self._s is not None else 0

    def d(self, i, j):
        return self._d[i, j] if self._d is not None else 0

    def z(self, i, j, k, l, m):
        return None if self._z is None else self._z_lookup(self._z, (i, j, k, l, m))

    def v(self, i, j, k, l, m):
        return None if self._v is None else self._z_lookup(self._v, (i, j, k, l, m))

    @staticmethod
    def _z_lookup(coo, idx):
        if isinstance(coo, COO):
            mask = np.all(coo.coords.T == np.asarray(idx), axis=1)
            hits = np.nonzero(mask)[0]
            return float(coo.data[hits[0]]) if hits.size else 0.0
        return coo[idx]


class OceanicSymbolicInnerProducts(OceanicInnerProducts, _SymbolicIPBase):
    """Oceanic inner products for an arbitrary symbolic basis."""

    def __init__(self, params=None, stored=True, inner_product_definition=None,
                 interaction_inner_product_definition=None, num_threads=None,
                 quadrature=True, timeout=None, dynTinnerproducts=None,
                 T4innerproducts=None, return_symbolic=False,
                 make_substitution=True):
        OceanicInnerProducts.__init__(self)

        atm_basis = None
        if params is not None:
            if hasattr(params, 'scale_params'):
                n = float(params.scale_params.n)
                self.oceanic_basis = params.oceanic_basis
                atm_basis = params.atmospheric_basis
                self._T4 = params.T4 if T4innerproducts is None else T4innerproducts
                self._dynamic_T = (params.dynamic_T if dynTinnerproducts is None
                                   else dynTinnerproducts)
            else:
                n = float(params[0])
                self.oceanic_basis = params[1]
                atm_basis = params[2] if len(params) > 2 else None
                self._T4 = bool(T4innerproducts)
                self._dynamic_T = bool(dynTinnerproducts)
        else:
            n = None
            self.oceanic_basis = None
            self._T4 = bool(T4innerproducts)
            self._dynamic_T = bool(dynTinnerproducts)
            stored = False

        self.atmosphere_basis = None
        self.connected_to_atmosphere = False

        self._setup_engine(n, inner_product_definition,
                           interaction_inner_product_definition, quadrature,
                           return_symbolic, make_substitution, timeout=timeout,
                           num_threads=num_threads)
        self.stored = stored
        if stored and self.oceanic_basis is not None:
            self.compute_inner_products()
        if atm_basis is not None:
            self.connect_to_atmosphere(atm_basis)

    @property
    def noc(self):
        return len(self.oceanic_basis.functions)

    def compute_inner_products(self, num_threads=None, timeout=None):
        if timeout is not None:
            self.timeout = timeout
        exprs = _subs_basis(self.oceanic_basis)
        quad = self._quad(self.ip, self.oceanic_basis)
        g = quad.field_grids(exprs, lap_grad=True)

        if self.return_symbolic or not self.quadrature:
            self._compute_exact()
            return

        self._U = prune_small(quad.pair(g['F'], g['F']))
        self._M = prune_small(quad.pair(g['F'], g['lapF']))
        self._N = prune_small(quad.pair(g['F'], g['Fx']))
        self._O = prune_small(quad.jacobian_triple(g['F'], g, g))
        self._C = prune_small(quad.jacobian_triple(g['F'], g, g, Ck='lapF'))
        if self._T4 or self._dynamic_T:
            self._V = _quartic_coo(quad, g['F'], g['F'], self.noc, self.noc,
                                   self._dynamic_T and not self._T4, self._T4)

    def _compute_exact(self):
        no = self.noc
        P = list(self.oceanic_basis.functions)

        def fill2(method):
            idx = [(i, j) for i in range(no) for j in range(no)]
            vals = self._exact_ip_batch(method, [(P[i], P[j])
                                                 for i, j in idx])
            return {ij: v for ij, v in zip(idx, vals) if v != 0}

        def fill3(method):
            idx = [(i, j, k) for i in range(no) for j in range(no)
                   for k in range(no)]
            vals = self._exact_ip_batch(method, [(P[i], P[j], P[k])
                                                 for i, j, k in idx])
            return {ijk: v for ijk, v in zip(idx, vals) if v != 0}

        U = fill2(self.ip.symbolic_inner_product)
        M = fill2(self.ip.ip_lap)
        N = fill2(self.ip.ip_diff_x)
        O = fill3(self.ip.ip_jac)
        C = fill3(self.ip.ip_jac_lap)
        if self.return_symbolic:
            self._U = ImmutableSparseMatrix(no, no, U)
            self._M = ImmutableSparseMatrix(no, no, M)
            self._N = ImmutableSparseMatrix(no, no, N)
            self._O = ImmutableSparseNDimArray(O, shape=(no, no, no))
            self._C = ImmutableSparseNDimArray(C, shape=(no, no, no))
        else:
            self._U = COO.from_dict(U, (no, no)).todense()
            self._M = COO.from_dict(M, (no, no)).todense()
            self._N = COO.from_dict(N, (no, no)).todense()
            self._O = COO.from_dict(O, (no, no, no)).todense()
            self._C = COO.from_dict(C, (no, no, no)).todense()

    def connect_to_atmosphere(self, atmosphere_basis, num_threads=None, timeout=None):
        if timeout is not None:
            self.timeout = timeout
        if hasattr(atmosphere_basis, 'atmospheric_basis'):
            atmosphere_basis = atmosphere_basis.atmospheric_basis
        self.atmosphere_basis = atmosphere_basis
        self.connected_to_atmosphere = True

        if self.return_symbolic or not self.quadrature:
            na = len(atmosphere_basis.functions)
            no = self.noc
            P = list(self.oceanic_basis.functions)
            F = list(atmosphere_basis.functions)
            K, W = {}, {}
            idx = [(i, j) for i in range(no) for j in range(na)]
            tasks = [(P[i], F[j]) for i, j in idx]
            for ij, v in zip(idx, self._exact_ip_batch(self.iip.ip_lap,
                                                       tasks)):
                if v != 0:
                    K[ij] = v
            for ij, v in zip(idx, self._exact_ip_batch(
                    self.iip.symbolic_inner_product, tasks)):
                if v != 0:
                    W[ij] = v
            if self.return_symbolic:
                self._K = ImmutableSparseMatrix(no, na, K)
                self._W = ImmutableSparseMatrix(no, na, W)
            else:
                self._K = COO.from_dict(K, (no, na)).todense()
                self._W = COO.from_dict(W, (no, na)).todense()
            if self._T4 or self._dynamic_T:
                idx = AtmosphericSymbolicInnerProducts._theta_pairs(self, na)
                self._Z = self._exact_quartic_oc(P, F, idx)
            return

        o_exprs = _subs_basis(self.oceanic_basis)
        a_exprs = _subs_basis(atmosphere_basis)
        quad = self._quad(self.iip, self.oceanic_basis, atmosphere_basis)
        go = quad.field_grids(o_exprs)
        ga = quad.field_grids(a_exprs)
        self._W = prune_small(quad.pair(go['F'], ga['F']))
        self._K = prune_small(quad.pair(go['F'], ga['lapF']))
        if self._T4 or self._dynamic_T:
            self._Z = _quartic_coo(quad, go['F'], ga['F'], self.noc,
                                   len(a_exprs),
                                   self._dynamic_T and not self._T4, self._T4)

    def _exact_quartic_oc(self, left, right, idx_list):
        entries = {}
        no = len(left)
        tasks, keys = [], []
        for (j, k, l, m) in idx_list:
            prod = right[j] * right[k] * right[l] * right[m]
            for i in range(no):
                tasks.append((left[i], prod))
                keys.append((i, j, k, l, m))
        vals = self._exact_ip_batch(self.ip.symbolic_inner_product, tasks)
        for (i, j, k, l, m), v in zip(keys, vals):
            if v != 0:
                for perm in multiset_permutations([j, k, l, m]):
                    entries[(i, *perm)] = v
        if self.return_symbolic:
            return ImmutableSparseNDimArray(entries, shape=(no,) + (len(right),) * 4)
        return COO.from_dict(entries, (no,) + (len(right),) * 4)

    # -- accessors ----------------------------------------------------------

    def M(self, i, j):
        return self._M[i, j]

    def U(self, i, j):
        return self._U[i, j]

    def N(self, i, j):
        return self._N[i, j]

    def O(self, i, j, k):
        return self._O[i, j, k]

    def C(self, i, j, k):
        return self._C[i, j, k]

    def K(self, i, j):
        return self._K[i, j] if self._K is not None else 0

    def W(self, i, j):
        return self._W[i, j] if self._W is not None else 0

    def Z(self, i, j, k, l, m):
        return (None if self._Z is None
                else AtmosphericSymbolicInnerProducts._z_lookup(self._Z, (i, j, k, l, m)))

    def V(self, i, j, k, l, m):
        return (None if self._V is None
                else AtmosphericSymbolicInnerProducts._z_lookup(self._V, (i, j, k, l, m)))


class GroundSymbolicInnerProducts(GroundInnerProducts, _SymbolicIPBase):
    """Ground inner products for an arbitrary symbolic basis."""

    def __init__(self, params=None, stored=True, inner_product_definition=None,
                 interaction_inner_product_definition=None, num_threads=None,
                 quadrature=True, timeout=None, dynTinnerproducts=None,
                 T4innerproducts=None, return_symbolic=False,
                 make_substitution=True):
        GroundInnerProducts.__init__(self)

        atm_basis = None
        if params is not None:
            if hasattr(params, 'scale_params'):
                n = float(params.scale_params.n)
                self.ground_basis = params.ground_basis
                atm_basis = params.atmospheric_basis
                self._T4 = params.T4 if T4innerproducts is None else T4innerproducts
                self._dynamic_T = (params.dynamic_T if dynTinnerproducts is None
                                   else dynTinnerproducts)
            else:
                n = float(params[0])
                self.ground_basis = params[1]
                atm_basis = params[2] if len(params) > 2 else None
                self._T4 = bool(T4innerproducts)
                self._dynamic_T = bool(dynTinnerproducts)
        else:
            n = None
            self.ground_basis = None
            self._T4 = bool(T4innerproducts)
            self._dynamic_T = bool(dynTinnerproducts)
            stored = False

        self.atmosphere_basis = None
        self.connected_to_atmosphere = False

        self._setup_engine(n, inner_product_definition,
                           interaction_inner_product_definition, quadrature,
                           return_symbolic, make_substitution, timeout=timeout,
                           num_threads=num_threads)
        self.stored = stored
        if stored and self.ground_basis is not None:
            self.compute_inner_products()
        if atm_basis is not None:
            self.connect_to_atmosphere(atm_basis)

    @property
    def ngr(self):
        return len(self.ground_basis.functions)

    def compute_inner_products(self, num_threads=None, timeout=None):
        exprs = _subs_basis(self.ground_basis)
        quad = self._quad(self.ip, self.ground_basis)
        F = quad.evaluate(exprs)
        self._U = prune_small(quad.pair(F, F))
        if self._T4 or self._dynamic_T:
            self._V = _quartic_coo(quad, F, F, self.ngr, self.ngr,
                                   self._dynamic_T and not self._T4, self._T4)

    def connect_to_atmosphere(self, atmosphere_basis, num_threads=None, timeout=None):
        if timeout is not None:
            self.timeout = timeout
        if hasattr(atmosphere_basis, 'atmospheric_basis'):
            atmosphere_basis = atmosphere_basis.atmospheric_basis
        self.atmosphere_basis = atmosphere_basis
        self.connected_to_atmosphere = True
        g_exprs = _subs_basis(self.ground_basis)
        a_exprs = _subs_basis(atmosphere_basis)
        quad = self._quad(self.iip, self.ground_basis, atmosphere_basis)
        Fg = quad.evaluate(g_exprs)
        Fa = quad.evaluate(a_exprs)
        self._W = prune_small(quad.pair(Fg, Fa))
        if self._T4 or self._dynamic_T:
            self._Z = _quartic_coo(quad, Fg, Fa, self.ngr, len(a_exprs),
                                   self._dynamic_T and not self._T4, self._T4)

    def U(self, i, j):
        return self._U[i, j]

    def W(self, i, j):
        return self._W[i, j] if self._W is not None else 0

    def Z(self, i, j, k, l, m):
        return (None if self._Z is None
                else AtmosphericSymbolicInnerProducts._z_lookup(self._Z, (i, j, k, l, m)))

    def V(self, i, j, k, l, m):
        return (None if self._V is None
                else AtmosphericSymbolicInnerProducts._z_lookup(self._V, (i, j, k, l, m)))
