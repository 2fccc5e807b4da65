"""Oracle interfaces: relatively-smooth f-oracles and Legendre h-oracles.

The reference defines these as abstract Python classes with a ``flag``-based
``func_grad`` protocol (the reference's accbpg/functions.py:10-24 for
``RSmoothFunction`` and :199-235 for ``LegendreFunction``).  Here they are
redesigned for compilation:

* every concrete oracle is a frozen pytree dataclass (see ``struct.py``) so
  it flows through ``jit`` / ``lax.scan`` / meshes without re-tracing;
* the primary API is *fused*: ``value_and_grad`` computes f and grad sharing
  the expensive factorization / GEMM (one Cholesky for D-optimal design
  instead of the reference's slogdet + solve pair);
* reference-compatible aliases (``__call__``, ``gradient``, ``extra_Psi``,
  ``func_grad(x, flag)``) are provided so code written against the reference
  API ports with an import change only.

Stochastic (inexact) oracles take an optional PRNG ``key`` argument; the
class attribute ``stochastic`` tells drivers to thread a key per iteration.
"""

from __future__ import annotations

import jax.numpy as jnp


class SmoothOracle:
    """f-oracle for min f(x) + Psi(x): query value / gradient / both."""

    #: drivers split and pass a PRNG key per iteration when True
    stochastic: bool = False

    # --- primary API -----------------------------------------------------
    def value(self, x, key=None):
        raise NotImplementedError(type(self).__name__ + ".value")

    def grad(self, x, key=None):
        return self.value_and_grad(x, key=key)[1]

    def value_and_grad(self, x, key=None):
        """Fused (f(x), grad f(x)); override to share the heavy compute."""
        return self.value(x, key=key), self.grad(x, key=key)

    # --- reference-compatible aliases -------------------------------------
    def __call__(self, x):
        return self.value(x)

    def gradient(self, x):
        return self.grad(x)

    def func_grad(self, x, flag=2):
        """Reference protocol: flag=0 value, 1 gradient, 2 both."""
        if flag == 0:
            return self.value(x)
        if flag == 1:
            return self.grad(x)
        return self.value_and_grad(x)


class LegendreOracle:
    """h-oracle: Legendre kernel h + simple convex regularizer Psi.

    Defines the Bregman divergence D(x,y) = h(x) - h(y) - <h'(y), x-y> and
    the two proximal maps

        prox_map(g, L)        = argmin_{x in C} { Psi(x) + <g,x> + L*h(x) }
        div_prox_map(y, g, L) = argmin_{x in C} { Psi(x) + <g,x> + L*D(x,y) }

    with the default reduction div_prox_map = prox_map(g - L*h'(y), L)
    (reference: functions.py:227-235).
    """

    # --- primary API -----------------------------------------------------
    def value(self, x):
        raise NotImplementedError(type(self).__name__ + ".value")

    def extra_psi(self, x):
        """Psi(x); zero by default."""
        return jnp.zeros((), jnp.result_type(x))

    def grad(self, x):
        raise NotImplementedError(type(self).__name__ + ".grad")

    def divergence(self, x, y):
        gy = self.grad(y)
        return self.value(x) - self.value(y) - jnp.vdot(gy, x - y)

    def prox_map(self, g, L):
        raise NotImplementedError(type(self).__name__ + ".prox_map")

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * self.grad(y), L)

    # --- reference-compatible aliases -------------------------------------
    def __call__(self, x):
        return self.value(x)

    def extra_Psi(self, x):
        return self.extra_psi(x)

    def gradient(self, x):
        return self.grad(x)


# Reference base-class names (functions.py:10 `RSmoothFunction`, :199
# `LegendreFunction`): user code subclasses these to define custom oracles —
# the library's key extension point (reference README.md:59).  Plain-class
# subclasses work with every driver (the engine falls back to closure
# compilation when an oracle is not a pytree of arrays).
RSmoothFunction = SmoothOracle
LegendreFunction = LegendreOracle
