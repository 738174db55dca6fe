"""
Ensemble integrator classes
===========================

High-level, stateful integrator objects with the reference API surface
(``set_func`` / ``set_bca`` / ``initialize`` / ``integrate`` /
``get_trajectories``, ref ``qgs/integrators/integrator.py:27-1296``) —
re-implemented for an accelerator: instead of a pool of OS processes fed
by queues, ensembles are batched arrays sharded across the device mesh and
the whole time loop runs as one compiled ``lax.scan`` per device
(see :mod:`qgs_jax.integrators.rk`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qgs_jax.integrators.rk import (
    integrate_runge_kutta, integrate_runge_kutta_df, integrate_runge_kutta_tgls,
    integrate_runge_kutta_tgls_df, merge_tableau, rk4_tableau,
)
from qgs_jax.parallel.mesh import ensemble_mesh, ensemble_size, shard_ensemble
from qgs_jax.parallel.distributed import gather_to_host


def _batched(func):
    """Accept either a reference-style single-state ``f(t, x)`` (with an
    attached ``.batched``) or an already-batched function."""
    return getattr(func, "batched", func)


def _same_model_jacobian(fjac, qgt):
    """True when ``fjac`` derives from the same model as the tensor object
    ``qgt`` — same object, or value-equal jacobian tensors (a rebuild from
    identical parameters).  A plain callable (no ``.qgtensor``) is treated
    as custom."""
    other = getattr(fjac, "qgtensor", None)
    if other is qgt:
        return True
    if other is None:
        return False
    a, b = other.jacobian_tensor, qgt.jacobian_tensor
    return (a.shape == b.shape and np.array_equal(a.coords, b.coords)
            and np.array_equal(a.data, b.data))


class RungeKuttaIntegrator:
    """Ensemble Runge-Kutta integrator.

    Parameters
    ----------
    num_threads: int, optional
        Kept for API compatibility; parallelism is the device mesh, so this
        is ignored (a warning-free no-op).
    b, c, a: arrays, optional
        Butcher tableau (default RK4).
    number_of_dimensions: int, optional
        State dimension (inferred from the first integration otherwise).
    mesh: jax.sharding.Mesh, optional
        Device mesh to shard the ensemble axis over (default: all devices).
    precision: str, optional
        'float64' (default) integrates with the configured tableau in the
        ambient dtype; 'twofloat' uses the fused double-float (2x float32)
        RK4 step (:mod:`qgs_jax.ops.twofloat`) — ~48-bit-mantissa
        trajectories from float32 arithmetic.  'twofloat' requires the
        default RK4 tableau and a tendency function created by
        :func:`qgs_jax.models.tendencies.create_tendencies` (it carries the
        tendency tensor the fused step is compiled from).
    """

    def __init__(self, num_threads=None, b=None, c=None, a=None,
                 number_of_dimensions=None, mesh=None, precision="float64"):
        if precision not in ("float64", "twofloat"):
            # 'float32' is an AMBIENT-dtype choice, not an integrator mode:
            # build the tendencies at float32 (make_tendency_fns(dtype=...))
            # and pass float32 ICs, as bench.py's f32 tier does — silently
            # accepting the string here would integrate at the ambient
            # dtype while claiming otherwise
            raise ValueError(
                f"unknown precision {precision!r}: expected 'float64' "
                "(ambient dtype) or 'twofloat'; for a float32 run, build "
                "the tendency functions with dtype=jnp.float32 and use "
                "float32 initial conditions")
        tab = merge_tableau(a, b, c)
        self.a, self.b, self.c = tab if tab is not None else rk4_tableau()
        self.func = None
        self.n_dim = number_of_dimensions
        self.ic = None
        self._mesh = mesh
        self._time = None
        self._recorded_traj = None
        self._write_steps = 1
        self.precision = precision
        self._qgtensor = None

    # -- configuration -----------------------------------------------------

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = ensemble_mesh()
        return self._mesh

    def set_func(self, f, ic_init=True):
        """Set the tendency function (single-state or batched)."""
        self.func = _batched(f)
        self._qgtensor = getattr(f, "qgtensor", None)
        if ic_init:
            self.ic = None

    def set_bca(self, b=None, c=None, a=None, ic_init=True):
        """Change the Butcher tableau (partial updates keep the other
        coefficients, ref ``qgs/integrators/integrator.py:167-196``)."""
        self.a, self.b, self.c = merge_tableau(
            a, b, c, current=(self.a, self.b, self.c))
        if ic_init:
            self.ic = None

    def start(self):
        """No-op (kept for API compatibility: there is no worker pool)."""

    def terminate(self):
        """No-op (kept for API compatibility)."""

    stop = terminate

    def _check_twofloat(self, boundary=None):
        """Shared twofloat-tier preconditions (tensor-carrying tendency
        function, no boundary term).  Any *explicit* Butcher tableau is
        supported (validated by the double-float step builders); the
        default RK4 tableau uses the hand-fused fast path."""
        if self._qgtensor is None:
            raise RuntimeError(
                "precision='twofloat' needs a tendency function from "
                "create_tendencies (carrying its .qgtensor), and — for the "
                "TGLS integrator — a Jacobian derived from the SAME model "
                "(a custom fjac would be silently ignored by the fused "
                "double-float step)")
        if boundary is not None:
            raise ValueError("precision='twofloat' does not support a "
                             "boundary term")

    # -- attractor initialization ------------------------------------------

    def initialize(self, convergence_time, dt, pert_size=0.01,
                   reconvergence_time=None, forward=True,
                   number_of_trajectories=1, ic=None, reconverge=False):
        """Spin an ensemble of initial conditions onto the attractor.

        With ``reconverge``, one long transient produces a converged state
        which is then perturbed into the full ensemble and re-converged for
        a (much) shorter ``reconvergence_time`` — same semantics as the
        reference, but the reconvergence happens for the whole ensemble in
        one batched integration instead of staged pool rounds.
        """
        if ic is None:
            if self.n_dim is None:
                # reference-parity dimension auto-probe
                # (ref ``qgs/integrators/integrate.py:131-143``)
                from qgs_jax.integrators.rk import infer_ndim
                self.n_dim = infer_ndim(self.func)
            rng = np.random.default_rng()
            if reconverge and reconvergence_time is not None and number_of_trajectories > 1:
                seed_ic = rng.standard_normal(self.n_dim)
                self.integrate(0., convergence_time, dt, ic=seed_ic,
                               write_steps=0, forward=forward)
                _, x0 = self.get_trajectories()
                perts = pert_size * rng.standard_normal(
                    (number_of_trajectories, self.n_dim))
                ics = np.asarray(x0)[None, :] + perts
                self.integrate(0., reconvergence_time, dt, ic=ics,
                               write_steps=0, forward=forward)
                _, x = self.get_trajectories()
                self.ic = np.atleast_2d(np.asarray(x))
                return
            tmp_ic = rng.standard_normal((number_of_trajectories, self.n_dim))
        else:
            tmp_ic = np.atleast_2d(np.asarray(ic))

        self.integrate(0., convergence_time, dt, ic=tmp_ic, write_steps=0,
                       forward=forward)
        _, x = self.get_trajectories()
        self.ic = np.atleast_2d(np.asarray(x))

    # -- integration -------------------------------------------------------

    def integrate(self, t0, t, dt, ic=None, forward=True, write_steps=1):
        """Integrate the ensemble; results retrieved via
        :meth:`get_trajectories`."""
        if self.func is None:
            raise RuntimeError("set_func must be called first")
        if ic is None:
            ic = self.ic
        if ic is None:
            raise ValueError("no initial conditions available")
        ic = np.asarray(ic)
        if ic.dtype != np.float32:       # float32 ICs select the f32 tier
            ic = ic.astype(np.float64)
        single = ic.ndim == 1
        ic2 = np.atleast_2d(ic)
        self.n_dim = ic2.shape[1]

        # shard the ensemble across the mesh when it is worth it
        if ic2.shape[0] >= ensemble_size(self.mesh) > 1:
            ic_dev, n_orig = shard_ensemble(ic2, self.mesh)
            batch_devices = ensemble_size(self.mesh)
        else:
            ic_dev, n_orig = jnp.asarray(ic2), ic2.shape[0]
            batch_devices = 1

        if self.precision == "twofloat":
            self._check_twofloat()
            time, traj = integrate_runge_kutta_df(
                self._qgtensor.tensor, t0, t, dt, ic_dev, forward=forward,
                write_steps=write_steps, squeeze=False,
                a=self.a, b=self.b, c=self.c, batch_devices=batch_devices)
        else:
            time, traj = integrate_runge_kutta(self.func, t0, t, dt, ic_dev,
                                               forward=forward, write_steps=write_steps,
                                               b=self.b, c=self.c, a=self.a,
                                               squeeze=False,
                                               batch_devices=batch_devices)
        # un-pad, then squeeze to the reference output shape conventions
        traj = traj[:n_orig]
        self._time = time
        self._recorded_traj = jnp.squeeze(traj)
        self._write_steps = write_steps

    def get_trajectories(self):
        """Return ``(time, trajectories)`` of the last integration.  In a
        multi-process run the ensemble shards living on other hosts are
        all-gathered first (every process must call this — SPMD)."""
        return self._time, gather_to_host(self._recorded_traj)

    def get_ic(self):
        """Return the stored initial conditions (set by :meth:`initialize`)."""
        return self.ic

    def set_ic(self, ic):
        self.ic = np.atleast_2d(np.asarray(ic))


class RungeKuttaTglsIntegrator(RungeKuttaIntegrator):
    """Ensemble integrator of the coupled (trajectory, tangent) system, with
    adjoint / inverse / boundary options (ref ``integrator.py:515-1296``)."""

    def __init__(self, *args, **kwargs):
        RungeKuttaIntegrator.__init__(self, *args, **kwargs)
        self.func_jac = None
        self.tg_ic = None
        self._recorded_fmatrix = None

    def set_func(self, f, fjac=None, ic_init=True):
        self.func = _batched(f)
        qgt = getattr(f, "qgtensor", None)
        if fjac is not None:
            self.func_jac = _batched(fjac)
            # keep the model tensors (fused twofloat path) only when fjac
            # is the tensor-derived Jacobian of the SAME model: the fused
            # step contracts f.qgtensor.jacobian_tensor, so a custom fjac
            # would be silently ignored — _check_twofloat raises instead
            # (the estimator classes apply the same guard).  "Same model"
            # is decided by tensor VALUE equality, not object identity: a
            # Jacobian rebuilt from the same parameters (a second
            # create_tendencies call) is numerically the same model.
            if qgt is not None and not _same_model_jacobian(fjac, qgt):
                qgt = None
        self._qgtensor = qgt
        if ic_init:
            self.ic = None

    def integrate(self, t0, t, dt, ic=None, tg_ic=None, forward=True,
                  adjoint=False, inverse=False, boundary=None, write_steps=1):
        if self.func is None or self.func_jac is None:
            raise RuntimeError("set_func(f, fjac) must be called first")
        if ic is None:
            ic = self.ic
        ic = np.asarray(ic, dtype=np.float64)
        single = ic.ndim == 1
        ic2 = np.atleast_2d(ic)
        self.n_dim = ic2.shape[1]
        if tg_ic is None:
            tg_ic = self.tg_ic if self.tg_ic is not None else np.eye(self.n_dim)

        if self.precision == "twofloat":
            self._check_twofloat(boundary)
            time, traj, fmat = integrate_runge_kutta_tgls_df(
                self._qgtensor.tensor, self._qgtensor.jacobian_tensor,
                t0, t, dt, jnp.asarray(ic2), tg_ic, forward=forward,
                adjoint=adjoint, inverse=inverse, write_steps=write_steps,
                mesh=self.mesh, a=self.a, b=self.b, c=self.c)
        else:
            time, traj, fmat = integrate_runge_kutta_tgls(
                self.func, self.func_jac, t0, t, dt, jnp.asarray(ic2), tg_ic,
                forward=forward, adjoint=adjoint, inverse=inverse, boundary=boundary,
                write_steps=write_steps, b=self.b, c=self.c, a=self.a,
                mesh=self.mesh)

        self._time = time
        self._recorded_traj = jnp.squeeze(traj) if single else traj
        self._recorded_fmatrix = jnp.squeeze(fmat) if single else fmat
        self._write_steps = write_steps

    def get_tg_ic(self):
        """Return the stored tangent-linear initial conditions
        (ref ``integrator.py:1068-1076``)."""
        return self.tg_ic

    def set_tg_ic(self, tg_ic):
        """Direct setter for the tangent-linear initial conditions: 1-D (one
        perturbation, broadcast over the ensemble), 2-D (per-trajectory or a
        matrix of perturbations) or 3-D (per-trajectory matrices)
        (ref ``integrator.py:1078-1101``)."""
        self.tg_ic = np.asarray(tg_ic, dtype=np.float64)

    def get_trajectories(self):
        """Return ``(time, trajectories, fundamental_matrices)``."""
        return (self._time, gather_to_host(self._recorded_traj),
                gather_to_host(self._recorded_fmatrix))
