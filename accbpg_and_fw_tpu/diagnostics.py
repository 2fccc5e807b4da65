"""Debugging and profiling utilities (SURVEY.md §5).

The reference's only observability is wall-clock arrays and inline asserts
(algorithms.py:39-48; functions.py:243 etc).  Those asserts cannot run
inside jit; this module provides the jit-compatible equivalents:

* ``debug_mode()``: context manager enabling NaN/Inf detection inside
  compiled code (jax_debug_nans/jax_debug_infs) so a domain exit fails
  loudly at the faulting primitive instead of silently propagating;
* ``check_domain(h, x)``: eager validation of an iterate against a kernel's
  domain (the reference's assert semantics, usable at chunk boundaries);
* ``profile_trace(logdir)``: wraps ``jax.profiler.trace`` so a solver run
  can be captured for TensorBoard/Perfetto;
* ``iteration_rate(T)``: iterations/second summary from a driver's T array;
* ``dopt_certificate(V, x)``: host float64 optimality certificate of a
  D-optimal design point, independent of every solver in the package.
"""

from __future__ import annotations

import contextlib

import numpy as np

import jax
import jax.numpy as jnp


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False):
    """Enable NaN (and optionally Inf) detection inside jitted solvers."""
    old_nan = jax.config.jax_debug_nans
    old_inf = jax.config.jax_debug_infs
    try:
        jax.config.update("jax_debug_nans", nans)
        jax.config.update("jax_debug_infs", infs)
        yield
    finally:
        jax.config.update("jax_debug_nans", old_nan)
        jax.config.update("jax_debug_infs", old_inf)


def check_domain(h, x):
    """Eagerly validate iterate ``x`` against kernel ``h``'s domain,
    mirroring the reference's inline asserts (functions.py:243,252,260-261).

    Raises ValueError with a descriptive message on violation."""
    x = np.asarray(x)
    name = type(h).__name__
    if not np.isfinite(x).all():
        raise ValueError(f"{name}: iterate contains NaN/Inf")
    if name.startswith("Burg") or name == "PowerNeg1":
        if x.min() <= 0:
            raise ValueError(f"{name} only takes positive arguments.")
    if name.startswith("Shannon"):
        if x.min() < 0:
            raise ValueError(f"{name} only takes nonnegative arguments.")
    if "Simplex" in name:
        s = float(x.sum())
        if abs(s - 1.0) > 1e-6 * max(1.0, abs(s)):
            raise ValueError(f"{name}: iterate off the simplex (sum={s!r})")
    return True


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a device profile of the enclosed solver run."""
    with jax.profiler.trace(logdir):
        yield


def iteration_rate(T):
    """(iters/s, total_s) summary of a driver wall-time array."""
    T = np.asarray(T)
    if len(T) < 2 or T[-1] <= 0:
        return float("nan"), float(T[-1] if len(T) else 0.0)
    return float((len(T) - 1) / T[-1]), float(T[-1])


def dopt_certificate(V, x):
    """Fresh float64 certificate of ``x`` for min -logdet(V diag(x) V^T)
    over the unit simplex, computed with NumPy on the host.

    ``x`` is first normalised to the simplex.  Returns a dict with
    ``F = -logdet(V diag(x) V^T)``, ``w_j = v_j^T (V diag(x) V^T)^-1 v_j``,
    the positive slack ``max_j w_j / m - 1`` and the duality-gap bound
    ``m log(max_j w_j / m)`` on ``F - F*``, valid at any simplex point."""
    V = np.asarray(V, np.float64)
    x = np.asarray(x, np.float64)
    x = x / x.sum()
    m = V.shape[0]
    R = np.linalg.cholesky((V * x) @ V.T)
    logdet = 2.0 * np.sum(np.log(np.diag(R)))
    W = np.linalg.solve(R, V)
    w = np.einsum("ij,ij->j", W, W)
    wmax = float(w.max())
    return dict(F=float(-logdet), w=w, slack=wmax / m - 1.0,
                gap_bound=m * float(np.log(wmax / m)))


def divergence_is_valid(h, x, y, atol=0.0):
    """Jit-compatible check D_h(x,y) >= 0 and finite (returns bool array)."""
    d = h.divergence(x, y)
    return jnp.isfinite(d) & (d >= -atol)
