"""
Analytic inner products
=======================

Closed-form (Kronecker-delta / parity) inner products of the Fourier basis
functions, following the MAOOAM and Cehelsky & Tung (1987) formulas
(ref ``/root/reference/qgs/inner_products/analytic.py:48-945``).

Unlike the reference's per-element Python loops, every coefficient family is
computed **vectorized** over the whole (i, j[, k]) index grid with NumPy
broadcasting — the only scalable approach when mode counts grow into the
hundreds (the rank-3 Jacobian tensors are O(natm^3) elements).

Inner product definition:  (S, G) = n/(2 pi^2) * int_0^pi int_0^{2pi/n} S G dx dy
"""

from __future__ import annotations

import numpy as np

from qgs_jax.basis.fourier import channel_wavenumbers, basin_wavenumbers, TYPE_A, TYPE_K, TYPE_L
from qgs_jax.inner_products.base import (
    AtmosphericInnerProducts, OceanicInnerProducts, GroundInnerProducts,
)

_SQ2 = np.sqrt(2.0)
_PI = np.pi


def _delta(x):
    """Vectorized Kronecker delta."""
    return (np.asarray(x) == 0).astype(np.float64)


def _flambda(x):
    """Vectorized parity indicator: 1 if odd, 0 if even."""
    return (np.asarray(x) % 2 != 0).astype(np.float64)


def _sort3(I, J, K):
    """Elementwise sort of three integer arrays + permutation parity
    (ties contribute no swap, matching insertion-sort parity)."""
    lo = np.minimum(np.minimum(I, J), K)
    hi = np.maximum(np.maximum(I, J), K)
    mid = I + J + K - lo - hi
    inv = (I > J).astype(np.int64) + (I > K) + (J > K)
    par = 1 - 2 * (inv % 2)
    return lo, mid, hi, par.astype(np.float64)


def _lll_value(Pi, Pj, Pk, Hi, Hj, Hk):
    """The triple-L Jacobian inner-product kernel, evaluated on the
    *index-sorted* triple (ref ``analytic.py:308-329`` / ``:638-665``)."""
    vs3 = (Pk * Hj + Pj * Hk) / 2.0
    vs4 = (Pk * Hj - Pj * Hk) / 2.0
    val = vs3 * ((_delta(Hk - Hj - Hi) - _delta(Hk - Hj + Hi)) * _delta(Pk + Pj - Pi)
                 + _delta(Hk + Hj - Hi) * (_delta(Pk - Pj + Pi) - _delta(Pk - Pj - Pi))) \
        + vs4 * (_delta(Hk + Hj - Hi) * _delta(Pk - Pj - Pi)
                 + (_delta(Hk - Hj + Hi) - _delta(Hk - Hj - Hi))
                 * (_delta(Pk - Pj - Pi) - _delta(Pk - Pj + Pi)))
    return val


def _choose3(pos, a0, a1, a2):
    """Select elementwise among three arrays according to position array
    ``pos`` in {0, 1, 2}."""
    return np.where(pos == 0, a0, np.where(pos == 1, a1, a2))


class AtmosphericAnalyticInnerProducts(AtmosphericInnerProducts):
    """Atmospheric analytic inner products on the channel Fourier basis.

    Parameters may be a ``QgParams``-like object (with ``scale_params.n``,
    ``nmod`` and ``ablocks``) or a list ``[aspect_ratio, ablocks, natm]``.
    """

    def __init__(self, params=None, stored=True):
        AtmosphericInnerProducts.__init__(self)

        if params is not None:
            if hasattr(params, 'scale_params'):
                self.n = float(params.scale_params.n)
                self._natm = params.nmod[0]
                ams = params.ablocks
            else:
                self.n = float(params[0])
                self._natm = params[2]
                ams = params[1]
        else:
            self.n = None
            stored = False
            ams = None

        self.ocean_inner_products = None
        self.connected_to_ocean = False
        self.ground_inner_products = None
        self.connected_to_ground = False

        self.atmospheric_wavenumbers = channel_wavenumbers(ams) if ams is not None else None

        self.stored = stored
        if stored and ams is not None:
            self.compute_inner_products()

    @property
    def natm(self):
        return self._natm

    # ------------------------------------------------------------------
    # bulk computation (vectorized)
    # ------------------------------------------------------------------

    def compute_inner_products(self):
        """Compute and store all pure-atmosphere coefficient families."""
        wn = self.atmospheric_wavenumbers
        n = self.n
        N = self._natm
        typ, P, M, H = wn.typ, wn.P, wn.M, wn.H
        nx, ny = wn.nx, wn.ny

        # a_{ij} = (F_i, lap F_j) — diagonal Laplacian eigenvalues
        self._a = np.diag(-(n ** 2) * nx ** 2 - ny ** 2)

        # u_{ij} = (F_i, F_j) — orthonormal basis
        self._u = np.eye(N)

        # c_{ij} = (F_i, dx F_j) — beta-term coupling between K and L modes
        ti, tj = typ[:, None], typ[None, :]
        Pi, Pj = P[:, None], P[None, :]
        Mi, Hj = M[:, None], H[None, :]
        Hi, Mj = H[:, None], M[None, :]
        c = np.where((ti == TYPE_K) & (tj == TYPE_L),
                     n * Mi * _delta(Mi - Hj) * _delta(Pi - Pj), 0.0)
        c = np.where((ti == TYPE_L) & (tj == TYPE_K),
                     -n * Mj * _delta(Mj - Hi) * _delta(Pj - Pi), c)
        self._c = c.astype(np.float64)

        # g_{ijk} = (F_i, J(F_j, F_k)) and b_{ijk} = g_{ijk} * a_{kk}
        self._g = self._g_tensor()
        self._b = self._g * np.diag(self._a)[None, None, :]

    def _g_tensor(self):
        """Vectorized triple-Jacobian tensor over the full (i, j, k) grid."""
        wn = self.atmospheric_wavenumbers
        n = self.n
        N = self._natm
        typ, P, M, H = wn.typ, wn.P, wn.M, wn.H

        I = np.arange(N)
        Ii, Jj, Kk = np.meshgrid(I, I, I, indexing='ij')
        ti, tj, tk = typ[Ii], typ[Jj], typ[Kk]

        g = np.zeros((N, N, N), dtype=np.float64)

        # --- case LLL: index-sorted antisymmetric kernel -----------------
        mask_lll = (ti == TYPE_L) & (tj == TYPE_L) & (tk == TYPE_L)
        lo, mid, hi, par_idx = _sort3(Ii, Jj, Kk)
        val_lll = _lll_value(P[lo], P[mid], P[hi], H[lo], H[mid], H[hi])
        g = np.where(mask_lll, par_idx * val_lll, g)

        # type-sort parity (used by the AKL and KKL cases)
        inv_t = (ti > tj).astype(np.int64) + (ti > tk) + (tj > tk)
        par_typ = (1 - 2 * (inv_t % 2)).astype(np.float64)

        # --- case AKL: one mode of each type -----------------------------
        hasA = (ti == TYPE_A) | (tj == TYPE_A) | (tk == TYPE_A)
        hasK = (ti == TYPE_K) | (tj == TYPE_K) | (tk == TYPE_K)
        hasL = (ti == TYPE_L) | (tj == TYPE_L) | (tk == TYPE_L)
        mask_akl = hasA & hasK & hasL

        posA = _choose3(np.where(ti == TYPE_A, 0, np.where(tj == TYPE_A, 1, 2)),
                        Ii, Jj, Kk)
        posK = _choose3(np.where(ti == TYPE_K, 0, np.where(tj == TYPE_K, 1, 2)),
                        Ii, Jj, Kk)
        posL = _choose3(np.where(ti == TYPE_L, 0, np.where(tj == TYPE_L, 1, 2)),
                        Ii, Jj, Kk)
        PA, PK, PL = P[posA], P[posK], P[posL]
        MK, HL = M[posK], H[posL]

        sel = _flambda(PA + PK + PL) * _delta(MK - HL)
        with np.errstate(divide='ignore', invalid='ignore'):
            B1 = (PL + PK) / PA.astype(np.float64)
            B2 = (PL - PK) / PA.astype(np.float64)
            factor = (B1 ** 2) / (B1 ** 2 - 1.0) - (B2 ** 2) / (B2 ** 2 - 1.0)
        val_akl = np.where(sel != 0.0,
                           -2.0 * (_SQ2 / _PI) * MK * sel * np.where(np.isfinite(factor), factor, 0.0),
                           0.0)
        g = np.where(mask_akl, par_typ * val_akl, g)

        # --- case KKL: no A, exactly two K -------------------------------
        nK = (ti == TYPE_K).astype(np.int64) + (tj == TYPE_K) + (tk == TYPE_K)
        mask_kkl = (~hasA) & (nK == 2)

        fK = np.where(ti == TYPE_K, 0, 1)            # position of first K
        sK = np.where(tk == TYPE_K, 2, 1)            # position of second K
        pL = 3 - fK - sK                             # position of the L mode
        i1 = _choose3(fK, Ii, Jj, Kk)                # first-K mode index
        i2 = _choose3(sK, Ii, Jj, Kk)                # second-K mode index
        iL = _choose3(pL, Ii, Jj, Kk)                # L mode index
        P1, M1 = P[i1], M[i1]
        P2, M2 = P[i2], M[i2]
        PLL, HLL = P[iL], H[iL]

        vs1 = -(PLL * M2 + P2 * HLL) / 2.0
        vs2 = (PLL * M2 - P2 * HLL) / 2.0
        val_kkl = vs1 * (_delta(M1 - HLL - M2) * _delta(P1 - PLL + P2)
                         - _delta(M1 - HLL - M2) * _delta(P1 + PLL - P2)
                         + (_delta(HLL - M2 + M1) + _delta(HLL - M2 - M1))
                         * _delta(PLL + P2 - P1)) \
            + vs2 * (_delta(M1 - HLL - M2) * _delta(P1 - PLL - P2)
                     + (_delta(HLL - M2 - M1) + _delta(M1 + HLL - M2))
                     * (_delta(P1 - PLL + P2) - _delta(PLL - P2 + P1)))
        g = np.where(mask_kkl, par_typ * val_kkl, g)

        return n * g

    # ------------------------------------------------------------------
    # couplings to the other components
    # ------------------------------------------------------------------

    def _s_matrix(self, own):
        """s_{ij} = (F_i, phi_j): thermal forcing of the ocean on the
        atmosphere (ref ``analytic.py:386-417``)."""
        wn = self.atmospheric_wavenumbers
        ti = wn.typ[:, None]
        Pi = wn.P[:, None]
        Mi = wn.M[:, None]
        Hi = wn.H[:, None]
        Pj = own.P[None, :]
        Hj = own.H[None, :]

        # A-type rows
        selA = _flambda(Hj) * _flambda(Pj + Pi)
        with np.errstate(divide='ignore', invalid='ignore'):
            vA = 8 * _SQ2 * Pj / (_PI ** 2 * (Pj ** 2 - Pi ** 2) * Hj)
        sA = np.where(selA != 0.0, selA * np.where(np.isfinite(vA), vA, 0.0), 0.0)

        # K-type rows
        selK = _flambda(2 * Mi + Hj) * _delta(Pj - Pi)
        with np.errstate(divide='ignore', invalid='ignore'):
            vK = 4.0 * Hj / (_PI * (-4 * Mi ** 2 + Hj ** 2))
        sK = np.where(selK != 0.0, selK * np.where(np.isfinite(vK), vK, 0.0), 0.0)

        # L-type rows
        sL = _delta(Pj - Pi) * _delta(2 * Hi - Hj)

        return np.where(ti == TYPE_A, sA, np.where(ti == TYPE_K, sK, sL))

    def connect_to_ocean(self, ocean_inner_products):
        """Compute the atmosphere-ocean coupling coefficients ``s`` and ``d``
        and trigger the reciprocal ocean-side ``K``/``W`` computation."""
        self.ground_inner_products = None
        self.connected_to_ground = False
        self.ocean_inner_products = ocean_inner_products
        self.connected_to_ocean = True

        own = ocean_inner_products.oceanic_wavenumbers
        self._s = self._s_matrix(own)
        # d_{ij} = s_{ij} * M_{jj} (ocean Laplacian eigenvalues)
        oM = np.diag(ocean_inner_products._M)
        self._d = self._s * oM[None, :]

        if not ocean_inner_products.connected_to_atmosphere:
            ocean_inner_products.connect_to_atmosphere(self)

    def connect_to_ground(self, ground_inner_products):
        """Ground coupling: with a shared channel basis, s is the identity."""
        self.ocean_inner_products = None
        self.connected_to_ocean = False
        self.ground_inner_products = ground_inner_products
        self.connected_to_ground = True

        ngr = ground_inner_products.ngr
        self._s = np.eye(self._natm, ngr)

        if not ground_inner_products.connected_to_atmosphere:
            ground_inner_products.connect_to_atmosphere(self)

    # ------------------------------------------------------------------
    # per-element accessors
    # ------------------------------------------------------------------

    def _ensure(self):
        if self._a is None:
            self.compute_inner_products()

    def a(self, i, j):
        self._ensure()
        return self._a[i, j]

    def u(self, i, j):
        self._ensure()
        return self._u[i, j]

    def b(self, i, j, k):
        self._ensure()
        return self._b[i, j, k]

    def c(self, i, j):
        self._ensure()
        return self._c[i, j]

    def g(self, i, j, k):
        self._ensure()
        return self._g[i, j, k]

    def s(self, i, j):
        return self._s[i, j] if self._s is not None else 0.0

    def d(self, i, j):
        return self._d[i, j] if self._d is not None else 0.0

    def z(self, i, j, k, l, m):
        """T^4 coefficients are not available analytically (symbolic only)."""
        return None

    def v(self, i, j, k, l, m):
        return None


class OceanicAnalyticInnerProducts(OceanicInnerProducts):
    """Oceanic analytic inner products on the closed-basin Fourier basis."""

    def __init__(self, params=None, stored=True):
        OceanicInnerProducts.__init__(self)

        if params is not None:
            if hasattr(params, 'scale_params'):
                self.n = float(params.scale_params.n)
                self._noc = params.nmod[1]
                oms = params.oblocks
            else:
                self.n = float(params[0])
                self._noc = params[2]
                oms = params[1]
        else:
            self.n = None
            stored = False
            oms = None

        self.connected_to_atmosphere = False
        self.atmosphere_inner_products = None

        self.oceanic_wavenumbers = basin_wavenumbers(oms) if oms is not None else None

        self.stored = stored
        if stored and oms is not None:
            self.compute_inner_products()

    @property
    def noc(self):
        return self._noc

    def compute_inner_products(self):
        """Compute and store all pure-ocean coefficient families."""
        wn = self.oceanic_wavenumbers
        n = self.n
        N = self._noc
        P, H = wn.P, wn.H
        nx, ny = wn.nx, wn.ny

        # M_{ij} = (phi_i, lap phi_j)
        self._M = np.diag(-(n ** 2) * nx ** 2 - ny ** 2)
        # U_{ij} = (phi_i, phi_j)
        self._U = np.eye(N)

        # N_{ij} = (phi_i, dx phi_j) — beta term on the basin
        Pi, Pj = P[:, None], P[None, :]
        Hi, Hj = H[:, None], H[None, :]
        sel = _delta(Pi - Pj) * _flambda(Hi + Hj)
        with np.errstate(divide='ignore', invalid='ignore'):
            v = (-2.0) * Hj * Hi * n / ((Hj ** 2 - Hi ** 2) * _PI)
        self._N = np.where(sel != 0.0, sel * np.where(np.isfinite(v), v, 0.0), 0.0)

        # O_{ijk} = (phi_i, J(phi_j, phi_k)) — all-L kernel, n/2 normalization
        I = np.arange(N)
        Ii, Jj, Kk = np.meshgrid(I, I, I, indexing='ij')
        lo, mid, hi, par = _sort3(Ii, Jj, Kk)
        self._O = par * _lll_value(P[lo], P[mid], P[hi], H[lo], H[mid], H[hi]) * n / 2.0
        # C_{ijk} = O_{ijk} * M_{kk}
        self._C = self._O * np.diag(self._M)[None, None, :]

    def connect_to_atmosphere(self, atmosphere_inner_products):
        """Reciprocal coupling: K_{ij} = s_{ji} a_{jj},  W_{ij} = s_{ji}."""
        self.atmosphere_inner_products = atmosphere_inner_products
        self.connected_to_atmosphere = True
        s = atmosphere_inner_products._s_matrix(self.oceanic_wavenumbers)
        a_diag = np.diag(atmosphere_inner_products._a)
        self._W = s.T.copy()
        self._K = s.T * a_diag[None, :]

    # -- accessors ---------------------------------------------------------
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
        return self._K[i, j] if self._K is not None else 0.0

    def W(self, i, j):
        return self._W[i, j] if self._W is not None else 0.0

    def Z(self, i, j, k, l, m):
        return None

    def V(self, i, j, k, l, m):
        return None


class GroundAnalyticInnerProducts(GroundInnerProducts):
    """Ground analytic inner products (channel basis shared with the
    atmosphere; only ``U`` and ``W`` are nontrivial)."""

    def __init__(self, params=None, stored=True):
        GroundInnerProducts.__init__(self)

        if params is not None:
            if hasattr(params, 'scale_params'):
                self.n = float(params.scale_params.n)
                self._ngr = params.nmod[1]
                gms = params.gblocks if params.gblocks is not None else params.oblocks
            else:
                self.n = float(params[0])
                self._ngr = params[2]
                gms = params[1]
        else:
            self.n = None
            stored = False
            gms = None

        self.connected_to_atmosphere = False
        self.atmosphere_inner_products = None
        self.ground_wavenumbers = channel_wavenumbers(gms) if gms is not None else None

        self.stored = stored
        if stored and gms is not None:
            self.compute_inner_products()

    @property
    def ngr(self):
        return self._ngr

    def compute_inner_products(self):
        self._U = np.eye(self._ngr)

    def connect_to_atmosphere(self, atmosphere_inner_products):
        """W_{ij} = s_{ji} — identity when the bases coincide."""
        self.atmosphere_inner_products = atmosphere_inner_products
        self.connected_to_atmosphere = True
        natm = atmosphere_inner_products.natm
        self._W = np.eye(self._ngr, natm)

    def U(self, i, j):
        return self._U[i, j]

    def W(self, i, j):
        return self._W[i, j] if self._W is not None else 0.0
