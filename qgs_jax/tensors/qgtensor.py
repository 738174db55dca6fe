"""
Tendency tensor assembly
========================

Builds the sparse tendency tensor ``T[i, j, k]`` (rank-5 ``T[i, j, k, l, m]``
for the dynamic-temperature / T^4 schemes) such that the model's ODEs read

    dx_i/dt = sum_{jk} T[i, j, k] x_j x_k,      x_0 = 1 (dummy constant)

from the inner products and the model parameters
(ref ``/root/reference/qgs/tensors/qgtensor.py:19-1371``).

The assembly is fully vectorized: each equation block (psi_a, theta_a,
psi_o, deltaT_o, deltaT_g) is one or two matrix products / einsums over the
dense inner-product arrays, written into a dense host tensor which is then
sparsified.  Mass-matrix inversions: ``a^-1``, ``(sig0 a - u)^-1``,
``U^-1`` and ``(M + G U)^-1``.
"""

from __future__ import annotations

import pickle

import numpy as np

from qgs_jax.utils.sparse import COO

real_eps = np.finfo(np.float64).eps


class QgsTensor:
    """The rank-3 (bilinear) tendency tensor and its Jacobian tensor.

    Attributes
    ----------
    tensor: COO
        Upper-triangularized (in the trailing indices) tendency tensor.
    jacobian_tensor: COO
        ``T + T.swapaxes(1, 2)`` — contracted once with the state it yields
        the Jacobian matrix of the tendencies.
    """

    def __init__(self, params=None, atmospheric_inner_products=None,
                 oceanic_inner_products=None, ground_inner_products=None):
        self.params = params
        self.atmospheric_inner_products = atmospheric_inner_products
        self.oceanic_inner_products = oceanic_inner_products
        self.ground_inner_products = ground_inner_products

        self.tensor = None
        self.jacobian_tensor = None

        self.compute_tensor()

    # -- variable index mapping (dummy-1 variable at index 0) --------------

    def _psi_a(self, i):
        return i + 1

    def _theta_a(self, i):
        return i + self.params.variables_range[0] + 1

    def _psi_o(self, i):
        return i + self.params.variables_range[1] + 1

    def _deltaT_o(self, i):
        return i + self.params.variables_range[2] + 1

    def _deltaT_g(self, i):
        return i + self.params.variables_range[1] + 1

    # -- numeric/symbolic dispatch helpers ----------------------------------
    #
    # The same block assembly serves the numeric tensors (float64 arrays) and
    # the fully symbolic tensors (object arrays of SymPy expressions): NumPy
    # matmul/einsum operate elementwise through the Python operators, so only
    # array construction, parameter access and matrix inversion dispatch.

    _symbolic = False

    def _arr(self, x):
        """Inner-product storage -> ndarray (float64 or object)."""
        if self._symbolic:
            import sympy
            if isinstance(x, sympy.MatrixBase):
                return np.array(x.tolist(), dtype=object)
            if isinstance(x, sympy.NDimArray):
                return np.array(x.tolist(), dtype=object)
            return np.asarray(x, dtype=object)
        return np.asarray(x, dtype=np.float64)

    def _p(self, param):
        """Parameter -> float, or its SymPy expression in symbolic mode."""
        if self._symbolic:
            expr = getattr(param, 'symbolic_expression', None)
            return expr if expr is not None else float(param)
        return float(param)

    def _vec(self, params_array):
        """ParametersArray -> float vector, or object vector of expressions."""
        if self._symbolic:
            return np.array([self._p(v) for v in params_array], dtype=object)
        return params_array.values

    def _zeros(self, shape):
        if self._symbolic:
            z = np.empty(shape, dtype=object)
            z.fill(0)
            return z
        return np.zeros(shape, dtype=np.float64)

    def _inv(self, mat):
        if self._symbolic:
            import sympy
            return np.array(sympy.Matrix(mat.tolist()).inv().tolist(), dtype=object)
        return np.linalg.inv(np.asarray(mat, dtype=np.float64))

    # -- mass matrices ------------------------------------------------------

    def _mass_matrices(self):
        par = self.params
        aips = self.atmospheric_inner_products
        bips = self.oceanic_inner_products or self.ground_inner_products
        ocean = self.oceanic_inner_products is not None
        nvar = par.number_of_variables
        offset = 1 if par.dynamic_T else 0

        a_inv = a_theta = U_inv = M_psio = None
        if aips is not None:
            ap = par.atmospheric_params
            a = self._arr(aips._a)
            u = self._arr(aips._u)
            a_inv = self._inv(a[offset:, offset:])
            a_theta = self._inv(self._p(ap.sig0) * a - u)
        if bips is not None:
            if ocean:
                U = self._arr(bips._U)
                M = self._arr(bips._M)
                U_inv = self._inv(U)
                M_psio = self._inv(M[offset:, offset:]
                                   + self._p(par.G) * U[offset:, offset:])
            else:
                U = self._arr(bips._U)
                U_inv = self._inv(U)
        return a_inv, a_theta, U_inv, M_psio

    # -- dense rank-3 assembly ----------------------------------------------

    def _assemble_dense(self):
        """Assemble the rank-3 tensor as a dense (ndim+1)^3 host array."""
        par = self.params
        aips = self.atmospheric_inner_products
        if par is None or (aips is None and self.oceanic_inner_products is None
                           and self.ground_inner_products is None):
            return None

        atp = par.atemperature_params
        ap = par.atmospheric_params
        op = par.oceanic_params
        scp = par.scale_params
        gp = par.ground_params
        nvar = par.number_of_variables
        ndim = par.ndim
        offset = 1 if par.dynamic_T else 0
        o = offset

        bips = self.oceanic_inner_products or self.ground_inner_products
        ocean = self.oceanic_inner_products is not None
        ground_temp = self.ground_inner_products is not None

        a_inv, a_theta, U_inv, M_psio = self._mass_matrices()

        T = self._zeros((ndim + 1, ndim + 1, ndim + 1))

        # index ranges of each variable group inside [0, ndim]
        ia = self._psi_a(np.arange(nvar[0]))
        ith_full = self._theta_a(np.arange(nvar[1]))
        ith = self._theta_a(np.arange(nvar[0]) + o)          # skip T_a0

        beta = self._p(scp.beta)
        kd, kdp, sig0 = self._p(ap.kd), self._p(ap.kdp), self._p(ap.sig0)

        g_full = self._arr(aips._g)
        b_full = self._arr(aips._b)
        c_full = self._arr(aips._c)
        a_full = self._arr(aips._a)
        u_full = self._arr(aips._u)

        hk = None
        if gp is not None and gp.hk is not None:
            hk = self._vec(gp.hk)
            if gp.orographic_basis == "atmospheric":
                g_oro = g_full
            else:
                g_oro = self._arr(aips._gh)

        # =============================== psi_a ===========================
        # beta advection:  -(a^-1 c)  on (psi_a_j, 0)
        T[np.ix_(ia, ia, [0])] -= (a_inv @ c_full[o:, o:])[:, :, None] * beta
        # bottom friction
        T[ia, ia, 0] -= kd / 2
        T[ia, ith, 0] += kd / 2
        if hk is not None:
            oro = np.einsum('im,mjk,k->ij', a_inv, g_oro[o:, o:, o:], hk)
            T[np.ix_(ia, ia, [0])] -= oro[:, :, None] / 2
            T[np.ix_(ia, ith, [0])] += oro[:, :, None] / 2
        # advection of vorticity (bilinear)
        B3 = np.einsum('im,mjk->ijk', a_inv, b_full[o:, o:, o:])
        T[np.ix_(ia, ia, ia)] -= B3
        T[np.ix_(ia, ith, ith)] -= B3
        if ocean:
            ipo = self._psi_o(np.arange(nvar[2]))
            d_mat = self._arr(aips._d)
            T[np.ix_(ia, ipo, [0])] += (a_inv @ d_mat[o:, o:])[:, :, None] * kd / 2

        # =============================== theta_a =========================
        ithr = ith_full                                      # equation rows
        if par.Cpa is not None:
            Cpa = self._vec(par.Cpa)
            T[ithr, 0, 0] -= a_theta @ u_full @ Cpa
        if atp is not None and atp.hd is not None and atp.thetas is not None:
            T[ithr, 0, 0] += self._p(atp.hd) * (-(a_theta @ u_full @ self._vec(atp.thetas)))

        A2 = a_theta @ a_full[:, o:]
        T[np.ix_(ithr, ia, [0])] += A2[:, :, None] * (kd * sig0 / 2)
        T[np.ix_(ithr, ith, [0])] -= A2[:, :, None] * ((kd / 2 + 2 * kdp) * sig0)

        C2 = a_theta @ c_full[:, o:]
        T[np.ix_(ithr, ith, [0])] += (-C2)[:, :, None] * (beta * sig0)

        if hk is not None:
            oroT = np.einsum('im,mjk,k->ij', a_theta, g_oro[:, o:, o:], hk)
            T[np.ix_(ithr, ith, [0])] -= oroT[:, :, None] * sig0 / 2
            T[np.ix_(ithr, ia, [0])] += oroT[:, :, None] * sig0 / 2

        BT = np.einsum('im,mjk->ijk', a_theta, b_full[:, o:, o:])
        GT = np.einsum('im,mjk->ijk', a_theta, g_full[:, o:, o:])
        T[np.ix_(ithr, ia, ith)] += -BT * sig0 + GT
        T[np.ix_(ithr, ith, ia)] -= BT * sig0

        U2 = a_theta @ u_full
        heat = 0.0
        if par.Lpa is not None:
            heat = heat + self._p(atp.sc) * self._p(par.Lpa)
        if par.LSBpa is not None:
            heat = heat + self._p(par.LSBpa)
        if atp is not None and atp.hd is not None:
            heat = heat + self._p(atp.hd)
        if np.any(heat != 0.0):
            T[np.ix_(ithr, ith_full, [0])] += U2[:, :, None] * heat

        if ocean:
            ipo = self._psi_o(np.arange(nvar[2]))
            ido_full = self._deltaT_o(np.arange(nvar[3]))
            d_mat = self._arr(aips._d)
            D2 = a_theta @ d_mat[:, o:]
            T[np.ix_(ithr, ipo, [0])] += (-D2)[:, :, None] * (sig0 * kd / 2)
            if par.Lpa is not None:
                s_mat = self._arr(aips._s)
                S2 = -(a_theta @ s_mat)
                fac = self._p(par.Lpa) / 2
                if par.LSBpgo is not None:
                    fac = fac + self._p(par.LSBpgo)
                T[np.ix_(ithr, ido_full, [0])] += S2[:, :, None] * fac

        if ground_temp:
            idg = self._deltaT_g(np.arange(nvar[2]))
            if par.Lpa is not None:
                s_mat = self._arr(aips._s)
                S2 = -(a_theta @ s_mat)
                fac = self._p(par.Lpa) / 2
                if par.LSBpgo is not None:
                    fac = fac + self._p(par.LSBpgo)
                T[np.ix_(ithr, idg, [0])] += S2[:, :, None] * fac

        # =============================== psi_o ===========================
        if ocean:
            ipo = self._psi_o(np.arange(nvar[2]))
            ido = self._deltaT_o(np.arange(nvar[2]) + o)     # skip T_o0
            ido_full = self._deltaT_o(np.arange(nvar[3]))
            K_mat = self._arr(bips._K)
            N_mat = self._arr(bips._N)
            M_mat = self._arr(bips._M)
            C_mat = self._arr(bips._C)
            O_mat = self._arr(bips._O)
            W_mat = self._arr(bips._W)
            d_op, r_op = self._p(op.d), self._p(op.r)

            K2 = (M_psio @ K_mat[o:, o:]) * d_op
            T[np.ix_(ipo, ia, [0])] += K2[:, :, None]
            T[np.ix_(ipo, ith, [0])] -= K2[:, :, None]

            N2 = M_psio @ N_mat[o:, o:]
            M2 = M_psio @ M_mat[o:, o:]
            T[np.ix_(ipo, ipo, [0])] += (-N2 * beta - M2 * (r_op + d_op))[:, :, None]

            C3 = np.einsum('im,mjk->ijk', M_psio, C_mat[o:, o:, o:])
            T[np.ix_(ipo, ipo, ipo)] -= C3

            # ============================ deltaT_o =======================
            if par.Cpgo is not None:
                T[ido_full, 0, 0] += U_inv @ W_mat @ self._vec(par.Cpgo)
            W2 = U_inv @ W_mat
            wfac = 2 * self._p(atp.sc) * self._p(par.Lpgo) if par.Lpgo is not None else 0.0
            if par.sbpa is not None:
                wfac = wfac + self._p(par.sbpa)
            T[np.ix_(ido_full, ith_full, [0])] += W2[:, :, None] * wfac

            dfac = -self._p(par.Lpgo) if par.Lpgo is not None else 0.0
            if par.sbpgo is not None:
                dfac = dfac - self._p(par.sbpgo)
            T[ido_full, ido_full, 0] += dfac

            O3 = np.einsum('im,mjk->ijk', U_inv, O_mat[:, o:, o:])
            T[np.ix_(ido_full, ipo, ido)] -= O3

        # =============================== deltaT_g ========================
        if ground_temp:
            idg = self._deltaT_g(np.arange(nvar[2]))
            W_mat = self._arr(bips._W)
            if par.Cpgo is not None:
                T[idg, 0, 0] += U_inv @ W_mat @ self._vec(par.Cpgo)
            W2 = U_inv @ W_mat
            wfac = 2 * self._p(atp.sc) * self._p(par.Lpgo) if par.Lpgo is not None else 0.0
            if par.sbpa is not None:
                wfac = wfac + self._p(par.sbpa)
            T[np.ix_(idg, ith_full, [0])] += W2[:, :, None] * wfac

            dfac = -self._p(par.Lpgo) if par.Lpgo is not None else 0.0
            if par.sbpgo is not None:
                dfac = dfac - self._p(par.sbpgo)
            T[idg, idg, 0] += dfac

        return T

    # -- public API ---------------------------------------------------------

    #: entries smaller than this fraction of the tensor's largest entry are
    #: treated as exact-cancellation float noise from the vectorized matrix
    #: products and pruned (the reference's scalar loops cancel them exactly)
    _prune_rtol = 1e-13

    def compute_tensor(self):
        """Build ``tensor`` and ``jacobian_tensor``."""
        dense = self._assemble_dense()
        if dense is None:
            ndim = self.params.ndim if self.params is not None else 0
            coo = COO.empty((ndim + 1,) * 3)
        else:
            amax = np.abs(dense).max()
            if amax > 0:
                dense[np.abs(dense) < self._prune_rtol * amax] = 0.0
            coo = COO.from_dense(dense)
        self._set_tensor(coo)

    def _set_tensor(self, coo):
        self.jacobian_tensor = self._prune(self.jacobian_from_tensor(coo))
        self.tensor = self._prune(self.simplify_tensor(coo))

    def _prune(self, coo):
        """Drop entries that are float noise relative to the largest entry
        (exact cancellations in the reference's scalar arithmetic show up
        here as O(eps * |value|) residues after merging symmetric duplicates)."""
        if coo.nnz == 0:
            return coo
        thr = self._prune_rtol * np.abs(coo.data).max()
        mask = np.abs(coo.data) >= thr
        return COO(coo.coords[:, mask], coo.data[mask], coo.shape, sum_duplicates=False)

    @staticmethod
    def jacobian_from_tensor(tensor: COO) -> COO:
        """Sum of the tensor over all swaps of axis 1 with each trailing axis."""
        n_perm = tensor.rank - 2
        jac = tensor
        for i in range(1, n_perm + 1):
            jac = jac + tensor.swapaxes(1, i + 1)
        return jac

    @staticmethod
    def simplify_tensor(tensor: COO) -> COO:
        """Upper-triangularize the trailing indices (merge symmetric entries)."""
        return tensor.upper_triangularize_trailing()

    # -- persistence / printing --------------------------------------------

    def save_to_file(self, filename, **kwargs):
        with open(filename, 'wb') as f:
            pickle.dump(self.__dict__, f, **kwargs)

    def load_from_file(self, filename, **kwargs):
        with open(filename, 'rb') as f:
            tmp = pickle.load(f, **kwargs)
        self.__dict__.clear()
        self.__dict__.update(tmp)

    @staticmethod
    def _string_format(func, symbol, indices, value):
        if abs(value) >= real_eps:
            s = symbol + "".join(f"[{i}]" for i in indices)
            func(s + " = % .5E" % value)

    def entries(self, jacobian=False):
        """Formatted nonzero entries (the reference's print/print-to-file dump
        format, used directly by the golden-file tests)."""
        t = self.jacobian_tensor if jacobian else self.tensor
        name = 'QgsTensorJacobian' if jacobian else 'QgsTensor'
        out = []
        for coo, val in zip(t.coords.T, t.data):
            self._string_format(out.append, name, coo, val)
        return out

    def print_tensor(self, tensor_name="QgsTensor"):
        for coo, val in zip(self.tensor.coords.T, self.tensor.data):
            self._string_format(print, tensor_name, coo, val)

    def print_tensor_to_file(self, filename, tensor_name="QgsTensor"):
        with open(filename, 'w') as f:
            for coo, val in zip(self.tensor.coords.T, self.tensor.data):
                self._string_format(lambda s: f.write(s + "\n"), tensor_name, coo, val)

    def print_jacobian_tensor(self, tensor_name="QgsTensorJacobian"):
        for coo, val in zip(self.jacobian_tensor.coords.T, self.jacobian_tensor.data):
            self._string_format(print, tensor_name, coo, val)

    def print_jacobian_tensor_to_file(self, filename, tensor_name="QgsTensorJacobian"):
        with open(filename, 'w') as f:
            for coo, val in zip(self.jacobian_tensor.coords.T, self.jacobian_tensor.data):
                self._string_format(lambda s: f.write(s + "\n"), tensor_name, coo, val)


class QgsTensorDynamicT(QgsTensor):
    """Rank-5 tendency tensor with a dynamical 0-th order temperature:
    linear (first-order) T^4 radiation terms only
    (ref ``qgtensor.py:843-1170``)."""

    def _quartic_coos(self):
        """The quartic (rank-5) radiation blocks as a list of COO tensors in
        the full (ndim+1)^5 index space."""
        par = self.params
        aips = self.atmospheric_inner_products
        nvar = par.number_of_variables
        ndim = par.ndim
        shape5 = (ndim + 1,) * 5

        bips = self.oceanic_inner_products or self.ground_inner_products
        ocean = self.oceanic_inner_products is not None
        ground_temp = self.ground_inner_products is not None

        _, a_theta, U_inv, _ = self._mass_matrices()

        out = []

        def contract_scatter(mat, coo5, row_map, col_shift, factor):
            """rows_out = mat @ coo5 along axis 0; result entries shifted."""
            if coo5 is None or coo5.nnz == 0:
                return
            m_idx = coo5.coords[0]
            trailing = coo5.coords[1:]
            nrows = mat.shape[0]
            weights = mat[:, m_idx] * coo5.data[None, :]          # (nrows, nnz)
            rows = np.repeat(row_map(np.arange(nrows)), coo5.nnz)
            trail = np.tile(trailing + col_shift, (1, nrows))
            coords = np.concatenate([rows[None, :], trail], axis=0)
            out.append(COO(coords, factor * weights.ravel(), shape5))

        # theta_a equations
        if par.T4LSBpa is not None and aips._z is not None:
            contract_scatter(a_theta, aips._z, self._theta_a, self._theta_a(0),
                             float(par.T4LSBpa))
        if ocean and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._theta_a, self._deltaT_o(0),
                             -float(par.T4LSBpgo))
        if ground_temp and par.T4LSBpgo is not None and aips._v is not None:
            contract_scatter(a_theta, aips._v, self._theta_a, self._deltaT_g(0),
                             -float(par.T4LSBpgo))

        # deltaT_o equations
        if ocean:
            if bips._Z is not None:
                contract_scatter(U_inv, bips._Z, self._deltaT_o, self._theta_a(0),
                                 float(par.T4sbpa))
            if bips._V is not None:
                contract_scatter(U_inv, bips._V, self._deltaT_o, self._deltaT_o(0),
                                 -float(par.T4sbpgo))

        # deltaT_g equations
        if ground_temp:
            if bips._Z is not None:
                contract_scatter(U_inv, bips._Z, self._deltaT_g, self._theta_a(0),
                                 float(par.T4sbpa))
            if bips._V is not None:
                contract_scatter(U_inv, bips._V, self._deltaT_g, self._deltaT_g(0),
                                 -float(par.T4sbpgo))

        return out

    def compute_tensor(self):
        par = self.params
        ndim = par.ndim
        shape5 = (ndim + 1,) * 5

        dense3 = self._assemble_dense()
        parts = []
        if dense3 is not None:
            coo3 = COO.from_dense(dense3)
            # embed rank-3 entries into the rank-5 index space (trailing zeros)
            pad = np.zeros((2, coo3.nnz), dtype=np.int64)
            parts.append(COO(np.concatenate([coo3.coords, pad], axis=0),
                             coo3.data, shape5, sum_duplicates=False))
        parts.extend(self._quartic_coos())

        total = COO.empty(shape5)
        for p in parts:
            total = total + p
        self._set_tensor(total)


class QgsTensorT4(QgsTensorDynamicT):
    """Rank-5 tendency tensor with the full (quartic) T^4 radiation scheme.

    The quartic structure is identical to :class:`QgsTensorDynamicT` — the
    difference is in the inner products (``z``/``v``/``Z``/``V`` computed on
    the full quartic simplex instead of the 0-index pattern), so the same
    contraction/scatter machinery applies (ref ``qgtensor.py:1173-1362``).
    """
