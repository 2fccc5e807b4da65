"""Inexact-oracle and constrained methods: AIBM, AdaptFGM, UniversalGM,
PrimalDualSwitchingGradientMethod.

JAX re-designs of the reference's accbpg/algorithms.py:593-968.  The
inexact-oracle noise (reference: uniform draws from the global numpy RNG via
``get_random_float``, utils.py:278-285) is PRNG-keyed: each driver takes a
``seed`` kwarg and folds a fresh subkey into every iteration, so noisy runs
are reproducible and device-resident.

Steps are module-level with the problem (oracles, noise level, scalars) as
a traced argument (driver.py caching contract).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .driver import run_driver

_LS_MAX = 64  # doubling line searches multiply L by 2^t; 2^64 is past overflow


# ---------------------------------------------------------------------------
# AIBM
# ---------------------------------------------------------------------------


class _AIBMCfg(NamedTuple):
    stochastic: bool = False


def _aibm_init_impl(prob, c):
    """AIBM k=0 initialization (reference: algorithms.py:608-624), run ONCE
    outside the scan — a ``lax.cond(k == 0, ...)`` inside the scan would
    materialize both branches' x-sized carries every iteration."""
    f, h = prob["f"], prob["h"]
    eps, noise = prob["eps"], prob["noise"]
    dt = c["x"].dtype
    one = jnp.asarray(1.0, dt)

    key, sub = jax.random.split(c["key"])
    delta = noise * jax.random.uniform(sub, dtype=dt)
    zero = jnp.zeros_like(c["x"])

    x = h.prox_map(zero, one)
    fx, g = f.value_and_grad(x)
    y = h.prox_map(g, one)
    ref = fx + jnp.vdot(g, y - x) + eps + delta

    def cond(s):
        Lc, t = s
        return ~(f.value(y) <= ref + Lc * h.divergence(y, x)) & (t < _LS_MAX)

    Lc, _ = lax.while_loop(cond, lambda s: (s[0] * 2.0, s[1] + 1),
                           (c["L"], 0))
    alpha = 1.0 / Lc
    F0 = fx + h.extra_psi(x)
    c2 = dict(done=c["done"], key=key, x=x, y=y, z=x, L=Lc,
              A=alpha, xi=alpha * g, F_prev=F0)
    return c2, F0, Lc


_aibm_init = jax.jit(_aibm_init_impl)


def _aibm_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, eps, noise = prob["gamma"], prob["eps"], prob["noise"]
    dt = c["x"].dtype
    one = jnp.asarray(1.0, dt)
    p = 2.0

    key, sub = jax.random.split(c["key"])
    delta = noise * jax.random.uniform(sub, dtype=dt)

    def main(c):
        y, z, xi, A = c["y"], c["z"], c["xi"], c["A"]
        kf = k.astype(dt)

        def trial(Lt, t, tkey):
            alpha = (1.0 / Lt) * (1.0 + kf / (2.0 * p)) ** ((p - 1.0) * (gamma - 1.0))
            B = (Lt * alpha**gamma) ** (1.0 / (gamma - 1.0))
            r = alpha / B
            x_t = r * z + (1.0 - r) * y
            if cfg.stochastic:
                # stochastic f-oracle: fresh noise per gradient call, like
                # the reference's global-RNG draws (functions.py:957-960)
                tkey, osub = jax.random.split(tkey)
                fx_t, grad_x = f.value_and_grad(x_t, key=osub)
            else:
                fx_t, grad_x = f.value_and_grad(x_t)
            xi_t = xi + alpha * grad_x
            z_k = h.prox_map(xi_t, one)
            w = r * z_k + (1.0 - r) * y
            fail = ~(f.value(w) <= fx_t + jnp.vdot(grad_x, w - x_t) + Lt * h.divergence(w, x_t) + delta)
            fail = fail & (t < _LS_MAX)
            out = dict(L=Lt, alpha=alpha, B=B, x=x_t, fx=fx_t, xi=xi_t,
                       z_k=z_k, w=w, fail=fail, t=t)
            if cfg.stochastic:
                out["key"] = tkey
            return out

        s = trial(c["L"] / 2.0, 0, key if cfg.stochastic else None)
        s = lax.while_loop(lambda s: s["fail"],
                           lambda s: trial(s["L"] * 2.0, s["t"] + 1,
                                           s.get("key")), s)

        Fk = s["fx"] + h.extra_psi(s["x"])
        A_new = A + s["alpha"]
        y_new = (s["B"] / A_new) * s["w"] + (1.0 - s["B"] / A_new) * y
        stop = jnp.abs(Fk - c["F_prev"]) < 1e-9
        c2 = dict(done=c["done"], key=s.get("key", key), x=s["x"],
                  y=y_new, z=s["z_k"], L=s["L"], A=A_new, xi=s["xi"],
                  F_prev=Fk)
        return c2, dict(F=Fk, G=jnp.asarray(0.0, dt), _stop=stop)

    return main(c)


def AIBM(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, verbose=True, noise=0,
         verbskip=1, seed=0, chunk=None, checkpoint=None):
    """Adaptive Intermediate Bregman Method with inexact oracle noise delta:
    doubling-L inner loop with certificate
    f(w) <= f(x) + <grad f(x), w-x> + L D(w,x) + delta, interpolation p=2
    (reference: algorithms.py:593-658).  Returns ``(x, F, G, T)``; as in the
    reference G is zero except G[0] which records the initial adapted L.
    """
    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, gamma=jnp.asarray(gamma, dt),
                eps=jnp.asarray(epsilon, dt), noise=jnp.asarray(noise, dt))
    carry = dict(done=jnp.asarray(False), key=jax.random.PRNGKey(seed),
                 x=x0, y=x0, z=x0, L=jnp.asarray(L, dt),
                 A=jnp.asarray(0.0, dt), xi=jnp.zeros_like(x0),
                 F_prev=jnp.asarray(jnp.inf, dt))
    header = ("\nAIBM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["G"], t))

    try:
        carry, F0, G0 = _aibm_init(prob, carry)
    except (TypeError, ValueError):
        # non-pytree user oracles (reference subclass style) can't cross jit
        carry, F0, G0 = _aibm_init_impl(prob, carry)
    F0, G0 = np.asarray(F0), np.asarray(G0)
    if verbose:
        print(header)
        row(0, {"F": F0, "G": G0}, 0.0)
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.array([G0]), np.zeros(1)
    carry, hist, T = run_driver(_aibm_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=None,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_AIBMCfg(stochastic=bool(
                                    getattr(f, "stochastic", False))),
                                k_start=1)
    F = np.concatenate([[F0], hist["F"]])
    G = np.concatenate([[G0], hist["G"]])
    T = np.concatenate([[0.0], T])
    return carry["x"], F, G, T


# ---------------------------------------------------------------------------
# AdaptFGM / UniversalGM
# ---------------------------------------------------------------------------


class _FGMCfg(NamedTuple):
    universal: bool
    stochastic: bool = False


def _fgm_step(cfg, prob, c, k):
    """Shared engine for AdaptFGM (reference: algorithms.py:661-714) and
    UniversalGM (:717-777).  They differ in initialization (AdaptFGM starts
    every sequence at the all-ones vector; UniversalGM starts x at x0), in
    where the noise enters (certificate slack vs. perturbing g_y and f(y)),
    and in the acceptance condition's left anchor (f(x_k) vs f(y))."""
    f, h = prob["f"], prob["h"]
    eps, noise = prob["eps"], prob["noise"]
    dt = c["x"].dtype
    one = jnp.asarray(1.0, dt)

    key, sub = jax.random.split(c["key"])
    nz = noise * jax.random.uniform(sub, dtype=dt)

    def main(c):
        x_k, u_k, A_k = c["x"], c["u"], c["A"]

        def trial(Lt, t, tkey):
            alpha = (1.0 + jnp.sqrt(1.0 + 4.0 * Lt * A_k)) / (2.0 * Lt)
            A = Lt * alpha**2
            y = (alpha * u_k + A_k * x_k) / A
            if cfg.stochastic:
                tkey, osub = jax.random.split(tkey)
                g_y = f.grad(y, key=osub)
            else:
                g_y = f.grad(y)
            if cfg.universal:
                g_y = g_y + nz
            u = h.div_prox_map(u_k, g_y * alpha, one)
            x = (alpha * u + A_k * x_k) / A
            if cfg.universal:
                anchor = f.value(y) + nz
                slack = jnp.asarray(0.0, dt)
            else:
                anchor = f.value(x_k)
                slack = nz
            fail = ~(f.value(x) <= anchor + jnp.vdot(g_y, x - y) + Lt * h.divergence(x, y) + slack)
            fail = fail & (t < _LS_MAX)
            out = dict(L=Lt, A=A, u=u, x=x, fail=fail, t=t)
            if cfg.stochastic:
                out["key"] = tkey
            return out

        s = trial(c["L"] / 2.0, 0, key if cfg.stochastic else None)
        s = lax.while_loop(lambda s: s["fail"],
                           lambda s: trial(s["L"] * 2.0, s["t"] + 1,
                                           s.get("key")), s)

        Fk = f.value(s["x"]) + h.extra_psi(s["x"])
        stop = jnp.abs(Fk - c["F_prev"]) < eps
        c2 = dict(done=c["done"], key=s.get("key", key), x=s["x"], u=s["u"],
                  A=s["A"], L=s["L"], F_prev=Fk)
        return c2, dict(F=Fk, G=s["L"], _stop=stop)

    return main(c)


def _fgm_init_impl(prob, c):
    """AdaptFGM/UniversalGM k=0 row (reference: algorithms.py:680-684), run
    once outside the scan (same rationale as ``_aibm_init_impl``).  The
    reference's k=0 iteration consumes one noise draw without using it —
    replicated here so noisy trajectories stay bit-identical."""
    f, h = prob["f"], prob["h"]
    key, _sub = jax.random.split(c["key"])
    fx = f.value(c["x"])
    F0 = fx + h.extra_psi(c["x"])
    c2 = dict(c, key=key, F_prev=F0)
    return c2, F0, c["L"]


_fgm_init = jax.jit(_fgm_init_impl)


def _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise, verbskip, seed,
              chunk, universal, header, checkpoint=None):
    x0 = jnp.asarray(x0)
    dt = x0.dtype
    ones = jnp.ones_like(x0)
    prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, dt),
                noise=jnp.asarray(noise, dt))
    x_init = x0 if universal else ones
    carry = dict(done=jnp.asarray(False), key=jax.random.PRNGKey(seed),
                 x=x_init, u=ones, A=jnp.asarray(0.0, dt),
                 L=jnp.asarray(L, dt), F_prev=jnp.asarray(jnp.inf, dt))

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["G"], t))

    try:
        carry, F0, G0 = _fgm_init(prob, carry)
    except (TypeError, ValueError):
        carry, F0, G0 = _fgm_init_impl(prob, carry)
    F0, G0 = np.asarray(F0), np.asarray(G0)
    if verbose:
        print(header)
        row(0, {"F": F0, "G": G0}, 0.0)
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.array([G0]), np.zeros(1)
    carry, hist, T = run_driver(_fgm_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=None,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_FGMCfg(universal=bool(universal),
                                            stochastic=bool(
                                                getattr(f, "stochastic",
                                                        False))),
                                k_start=1)
    F = np.concatenate([[F0], hist["F"]])
    G = np.concatenate([[G0], hist["G"]])
    T = np.concatenate([[0.0], T])
    return carry["x"], F, G, T


def AdaptFGM(f, h, L, x0, maxitrs, epsilon=1e-14, verbose=True, noise=0,
             verbskip=1, seed=0, chunk=None, checkpoint=None):
    """Adaptive fast gradient method with halve-L-outer / double-L-inner
    adaptation and inexact-oracle slack (reference: algorithms.py:661-714).
    Returns ``(x, F, G, T)``."""
    header = ("\nAdaptFGM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")
    return _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise, verbskip,
                     seed, chunk, universal=False, header=header,
                     checkpoint=checkpoint)


def UniversalGM(f, h, L, x0, maxitrs, epsilon=1e-14, verbose=True,
                noise_level=0, verbskip=1, seed=0, chunk=None,
                checkpoint=None):
    """Universal gradient method: same alpha/A scheme with additive noise
    injected into g_y and f(y) (reference: algorithms.py:717-777).
    Returns ``(x, F, G, T)``."""
    header = ("\nUniversalGM method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       L       time")
    return _fgm_like(f, h, L, x0, maxitrs, epsilon, verbose, noise_level,
                     verbskip, seed, chunk, universal=True, header=header,
                     checkpoint=checkpoint)


# ---------------------------------------------------------------------------
# Primal-dual switching gradient method
# ---------------------------------------------------------------------------


class _PDCfg(NamedTuple):
    linesearch: bool
    dual_max_inner: int
    exact_dual_grad: bool = False


def _pd_step(cfg, prob, c, k):
    f, h, g_fun = prob["f"], prob["h"], prob["cnstrnt"]
    eps, gap_tol = prob["eps"], prob["gap_tol"]
    dual_tol, dual_lr = prob["dual_tol"], prob["dual_lr"]
    dt = c["x"].dtype

    def compute_dual_value(z, y0):
        # Reference-exact ascent direction (algorithms.py:833-841).  For a
        # scalar constraint this is -f' - z*g'; for a vector constraint the
        # reference broadcasts z_vec[:, None] * g.gradient(y) and sums over
        # axis 0 — with an AX_b-style oracle whose gradient is the constant
        # A (shape (r,)), that evaluates to len(g(y)) * z * A, NOT the true
        # gradient of z*sum(g).  We reproduce the reference arithmetic
        # verbatim (the branch is static: constraint shape is trace-known)
        # so the duality-gap histories are golden-comparable.
        scalar_cnstrnt = jnp.ndim(g_fun.value(y0)) == 0

        def ascent_dir(y):
            if cfg.exact_dual_grad and not scalar_cnstrnt:
                # opt-in mathematically-correct direction: the true
                # gradient of z * sum(g) via autodiff (ADVICE r4)
                g_sum_grad = jax.grad(lambda yy: jnp.sum(g_fun.value(yy)))(y)
                return -f.grad(y) - z * g_sum_grad
            gg = g_fun.grad(y)
            if scalar_cnstrnt:
                return -f.grad(y) - z * gg
            z_vec = z * jnp.ones_like(g_fun.value(y))
            return -f.grad(y) - jnp.sum(z_vec[:, None] * gg, axis=0)

        def body(s):
            y, _, it = s
            grad_dual = ascent_dir(y)
            y_next = jnp.maximum(y + dual_lr * grad_dual, 1e-6)
            diff = jnp.linalg.norm((y_next - y).ravel())
            return y_next, diff, it + 1

        def cond(s):
            _, diff, it = s
            return (diff >= dual_tol) & (it < cfg.dual_max_inner)

        y, _, _ = lax.while_loop(cond, body, (y0, jnp.asarray(jnp.inf, dt), 0))
        return -f.value(y) - z * jnp.sum(g_fun.value(y))

    x = c["x"]
    fx, grad_fx = f.value_and_grad(x)
    cval = g_fun.value(x)
    productive = jnp.all(cval <= eps)

    def prod_branch(c):
        if cfg.linesearch:
            def trial(Lt, t):
                x_new = h.div_prox_map(x, grad_fx, Lt)
                fail = ~(f.value(x_new) <= fx + jnp.vdot(grad_fx, x_new - x) + Lt * h.divergence(x_new, x))
                bad = jnp.any(jnp.isnan(x_new)) | jnp.any(jnp.isinf(x_new))
                return dict(L=Lt, x=x_new, fail=(fail | bad) & (t < _LS_MAX), t=t)

            s = trial(c["L"] / 2.0, 0)
            s = lax.while_loop(lambda s: s["fail"],
                               lambda s: trial(s["L"] * 2.0, s["t"] + 1), s)
            L_new, x_new = s["L"], s["x"]
        else:
            L_new = c["L"]
            x_new = h.div_prox_map(x, grad_fx, L_new)
        step_size = 1.0 / L_new
        return dict(done=c["done"], x=x_new, L=L_new,
                    prod_sum=c["prod_sum"] + step_size,
                    unprod_sum=c["unprod_sum"]), step_size

    def unprod_branch(c):
        grad_g = g_fun.grad(x)
        sz = 0.1 / jnp.vdot(grad_g, grad_g)
        x_new = jnp.maximum(x - grad_g * sz, 1e-6)
        return dict(done=c["done"], x=x_new, L=c["L"],
                    prod_sum=c["prod_sum"],
                    unprod_sum=c["unprod_sum"] + sz), jnp.asarray(0.0, dt)

    # BOTH branches run and a per-leaf where selects: a lax.cond threading
    # the x-sized carry materializes both branch results through the
    # conditional every scan iteration; the unproductive branch is one cheap gradient step, so
    # computing it unconditionally costs less than the cond's double
    # materialization
    c_prod, Lk_prod = prod_branch(c)
    c_unprod, Lk_unprod = unprod_branch(c)
    c2 = jax.tree_util.tree_map(
        lambda a, b: jnp.where(productive, a, b), c_prod, c_unprod)
    Lk = jnp.where(productive, Lk_prod, Lk_unprod)

    lam = jnp.where((c2["prod_sum"] > 0) & (c2["unprod_sum"] > 0),
                    c2["unprod_sum"] / c2["prod_sum"],
                    jnp.asarray(1.0, dt))
    gap = fx + compute_dual_value(lam, c2["x"])
    stop = (k > 0) & (jnp.abs(gap) < gap_tol)

    Fk = fx + h.extra_psi(x)
    return c2, dict(F=Fk, productive=productive, gap=gap, Ls=Lk, _stop=stop)


def PrimalDualSwitchingGradientMethod(f, h, L_init, cnstrnt_fun, x0, maxitrs,
                                      epsilon=1e-14, linesearch=True,
                                      verbose=True, verbskip=100, chunk=None,
                                      dual_max_inner=100, dual_tol=1e-9,
                                      dual_lr=1e-3, gap_tol=1e-6,
                                      checkpoint=None, exact_dual_grad=False):
    """Constrained min f(x) s.t. cnstrnt_fun(x) <= epsilon via switching
    between productive (objective) and unproductive (constraint-gradient)
    steps, with a Lagrange-multiplier estimate and a duality gap from an
    inner gradient-ascent solve (reference: algorithms.py:780-968).

    Returns ``(F, duality_gaps, Ls)`` — F holds objective values of the
    *productive* iterations only, the other two are per-iteration, all
    truncated at the |gap| < 1e-6 stopping iteration (inclusive).

    The inner dual ascent reproduces the reference's arithmetic verbatim
    (algorithms.py:833-841), including its ``z_vec[:, None] * g_grad``
    broadcast for vector constraints — with an AX_b constraint (gradient =
    constant A) that term is ``len(g(x)) * z * A`` rather than the true
    gradient of ``z * sum(g)``; golden-trajectory parity against the
    unmodified reference driver is asserted in
    tests/test_reference_parity.py (TestPrimalDualGolden).  Pass
    ``exact_dual_grad=True`` to instead use the mathematically correct
    ascent direction (autodiff gradient of ``z * sum(g)``) for vector
    constraints — golden parity with the reference is then forfeited.
    The only remaining semantic difference: the reference raises on
    NaN/Inf inside the ascent, which a jitted loop cannot — NaN iterates
    instead propagate to the gap history.
    """
    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, cnstrnt=cnstrnt_fun, eps=jnp.asarray(epsilon, dt),
                gap_tol=jnp.asarray(gap_tol, dt),
                dual_tol=jnp.asarray(dual_tol, dt),
                dual_lr=jnp.asarray(dual_lr, dt))
    carry = dict(done=jnp.asarray(False), x=x0, L=jnp.asarray(L_init, dt),
                 prod_sum=jnp.asarray(0.0, dt), unprod_sum=jnp.asarray(0.0, dt))
    header = ("\n Primal-Dual method\n"
              "     k       F(x)         L_k       duality_gap     time")

    def row(k, r, t):
        if not bool(r["productive"]):
            return
        print(f"{k:6d}  {r['F']:.3e}  {r['Ls']:.3e}  {r['gap']:.3e}  {t:.2f}s")

    cfg = _PDCfg(linesearch=bool(linesearch),
                 dual_max_inner=int(dual_max_inner),
                 exact_dual_grad=bool(exact_dual_grad))
    carry, hist, T = run_driver(_pd_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg)
    F = hist["F"][hist["productive"].astype(bool)]
    return np.asarray(F), hist["gap"], hist["Ls"]
