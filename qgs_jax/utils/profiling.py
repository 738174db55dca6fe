"""
Profiling and throughput observability
======================================

The reference has no tracing/profiling beyond wall-clock prints
(SURVEY.md §5).  This module adds device-side equivalents:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-compatible trace of the device execution;
* :class:`ThroughputMeter` — steps/s and mode-updates/s counters (the
  north-star metrics of BASELINE.json).
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(logdir="/tmp/qgs_jax_trace"):
    """Capture a device trace (view with TensorBoard's profile plugin)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Accumulate integration-throughput statistics.

    ``mode-updates/s`` counts (ensemble x steps x ndim) state-component
    updates per second — the resolution-independent throughput metric.
    """

    def __init__(self, ndim, ensemble=1):
        self.ndim = ndim
        self.ensemble = ensemble
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self._t0 = None
        return False

    def add_steps(self, n):
        self.steps += n

    @property
    def steps_per_s(self):
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def traj_steps_per_s(self):
        return self.steps_per_s * self.ensemble

    @property
    def mode_updates_per_s(self):
        return self.traj_steps_per_s * self.ndim

    def report(self):
        return {
            "steps_per_s": self.steps_per_s,
            "traj_steps_per_s": self.traj_steps_per_s,
            "mode_updates_per_s": self.mode_updates_per_s,
            "ensemble": self.ensemble,
            "ndim": self.ndim,
        }
