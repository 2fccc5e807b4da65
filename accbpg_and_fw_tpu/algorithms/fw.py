"""Frank-Wolfe family: Bregman-divergence steps and (L0,L1)-smooth step rules.

JAX re-designs of the reference's accbpg/algorithms_fw.py.  Each
driver is a jitted scan step (see ``driver.py``); the L/L0/L1 backtracking
line searches are bounded ``lax.while_loop``s; the LMO is a jittable closure
``g -> s`` from ``ops/lmo.py`` whose arg-reductions shard over a mesh.

The reference raises ValueError when the LMO returns a non-descent direction
(<g, d> > delta, algorithms_fw.py:43-44).  Inside jit we record a ``bad``
flag instead, halt the scan, and re-raise the same error on host after the
run — identical observable behavior, one compiled kernel.

Steps are module-level with the problem as a traced argument (driver.py
caching contract); the LMO closure is static config, so reusing the same
LMO instance across solves reuses the compiled executable.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .bpg import _accept_delta, _oracle_key, _stoch_carry
from .driver import run_driver

_LS_MAX = 200


def _gdp_banded(g, d, delta):
    """<g,d> with the reference's band-zeroing: values in (0, delta] -> 0."""
    gdp = jnp.vdot(g, d)
    gdp = jnp.where((gdp > 0) & (gdp <= delta), jnp.zeros_like(gdp), gdp)
    return gdp, gdp > 0


def _raise_if_bad(hist):
    if len(hist["bad"]) and bool(np.asarray(hist["bad"]).any()):
        raise ValueError("grad_d_prod must be non-positive (LMO issue).")


# ---------------------------------------------------------------------------
# FW with Bregman divergence step
# ---------------------------------------------------------------------------


class _FWDivCfg(NamedTuple):
    lmo: Any
    linesearch: bool
    stochastic: bool = False


def _fw_div_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, eps, delta = prob["gamma"], prob["eps"], prob["delta"]
    ls_ratio = prob["ls_ratio"]
    x, Lk = c["x"], c["L"]
    key, sub = _oracle_key(cfg, c)
    fx, g = (f.value_and_grad(x, key=sub) if sub is not None
             else f.value_and_grad(x))
    Fk = fx + h.extra_psi(x)

    s = cfg.lmo(g)
    d = s - x
    div = h.divergence(s, x)
    div = jnp.where(div == 0, delta, div)
    gdp, bad = _gdp_banded(g, d, delta)

    def alpha_of(Lt):
        return jnp.minimum((-gdp / (2.0 * Lt * div)) ** (1.0 / (gamma - 1.0)), 1.0)

    if cfg.linesearch:
        def trial(Lt):
            a = alpha_of(Lt)
            x1 = x + a * d
            # NaN-robust acceptance (see bpg.py): NaN trial => back off L
            fail = ~(f.value(x1) <= fx + a * gdp + a**gamma * Lt * div
                     + _accept_delta(f, fx))
            return x1, fail

        L1 = Lk / ls_ratio
        x1, fail = trial(L1)

        def cond(st):
            return st[2] & (st[3] < _LS_MAX)

        def body(st):
            Lt = st[0] * ls_ratio
            x1t, failt = trial(Lt)
            return (Lt, x1t, failt, st[3] + 1)

        Lk, x_new, _, _ = lax.while_loop(cond, body, (L1, x1, fail, 0))
    else:
        x_new = x + alpha_of(Lk) * d

    stop = ((k > 0) & (jnp.abs(Fk - c["F_prev"]) < eps)) | bad
    c2 = dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, Ls=Lk, bad=bad, _stop=stop)


def FW_alg_div_step(f, h, L, x0, maxitrs, gamma, lmo, epsilon=1e-14,
                    linesearch=True, ls_ratio=2, verbose=True, verbskip=1,
                    chunk=None, checkpoint=None, seed=None):
    """Frank-Wolfe with Bregman divergence step size

        alpha_k = min( (-<g,d> / (2 L D_h(s,x)))^{1/(gamma-1)}, 1 )

    and backtracking on L with acceptance
    f(x+ad) <= f(x) + a<g,d> + a^gamma L D  (reference: algorithms_fw.py:6-75).
    Returns ``(x, F, Ls, T)``.
    """
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L <= 0:
        raise ValueError("Initial L must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, gamma=jnp.asarray(gamma, dt),
                eps=jnp.asarray(epsilon, dt), delta=jnp.asarray(1e-6, dt),
                ls_ratio=jnp.asarray(ls_ratio, dt))
    carry = dict(done=jnp.asarray(False), x=x0, L=jnp.asarray(L, dt),
                 F_prev=jnp.asarray(jnp.inf, dt))
    header = "\nFW adaptive algorithm\n     k      F(x)         Lk       time"

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["Ls"], t))

    stoch = _stoch_carry(f, carry, seed)
    carry, hist, T = run_driver(_fw_div_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_FWDivCfg(lmo=lmo,
                                              linesearch=bool(linesearch),
                                              stochastic=stoch))
    _raise_if_bad(hist)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# Classic descent-step FW
# ---------------------------------------------------------------------------


class _FWDescentCfg(NamedTuple):
    lmo: Any
    stochastic: bool = False


def _fw_descent_init_impl(prob, c):
    """k=0 gradient seeding (reference: algorithms_fw.py:224-228), run once
    outside the scan — a ``lax.cond(k == 0, ...)`` in the scan body would
    materialize both branches' x-sized carries every iteration."""
    f, h = prob["f"], prob["h"]
    fx, g = f.value_and_grad(c["x"])
    Fk = fx + h.extra_psi(c["x"])
    return dict(done=c["done"], x=c["x"], g=g, F_prev=Fk), Fk


_fw_descent_init = jax.jit(_fw_descent_init_impl)


def _fw_descent_step(cfg, prob, c, k):
    f, h, eps = prob["f"], prob["h"], prob["eps"]
    dt = c["x"].dtype

    s = cfg.lmo(c["g"])
    d = s - c["x"]
    alpha = 2.0 / (k.astype(dt) + 2.0)
    x = c["x"] + alpha * d
    key, sub = _oracle_key(cfg, c)
    fx, g = (f.value_and_grad(x, key=sub) if sub is not None
             else f.value_and_grad(x))
    Fk = fx + h.extra_psi(x)
    stop = (jnp.abs(Fk - c["F_prev"]) < eps) | (jnp.linalg.norm(g.ravel()) < eps)
    c2 = dict(done=c["done"], x=x, g=g, F_prev=Fk)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, alpha=alpha, _stop=stop)


def FW_alg_descent_step(f, h, x0, maxitrs, lmo, epsilon=1e-14, verbose=True,
                        verbskip=1, chunk=None, checkpoint=None, seed=None):
    """Classic Frank-Wolfe with the parameter-free step alpha_k = 2/(k+2)
    (reference: algorithms_fw.py:210-247).  Returns ``(x, F, T, G)`` — the
    reference's (unusual) return order, with G an all-zeros placeholder.
    """
    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, dt))
    carry = dict(done=jnp.asarray(False), x=x0, g=jnp.zeros_like(x0),
                 F_prev=jnp.asarray(jnp.inf, dt))
    header = ("\nFW descent step size algorithm\n"
              "     k      F(x)         alpha_k       time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["alpha"], t))

    try:
        carry, F0 = _fw_descent_init(prob, carry)
    except (TypeError, ValueError):
        carry, F0 = _fw_descent_init_impl(prob, carry)
    F0 = np.asarray(F0)
    if verbose:
        print(header)  # the reference prints no k=0 row for this driver
    if maxitrs <= 1:
        return carry["x"], np.array([F0]), np.zeros(1), np.zeros(1)
    stoch = _stoch_carry(f, carry, seed)
    carry, hist, T = run_driver(_fw_descent_step, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=None, print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_FWDescentCfg(lmo=lmo, stochastic=stoch),
                                k_start=1)
    F = np.concatenate([[F0], hist["F"]])
    T = np.concatenate([[0.0], T])
    G = np.zeros_like(F)
    return carry["x"], F, T, G


# ---------------------------------------------------------------------------
# (L0,L1)-smooth shortest-step FW
# ---------------------------------------------------------------------------


class _FWL0L1Cfg(NamedTuple):
    lmo: Any
    linesearch: bool


def _fw_l0l1_shortest_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    gamma, eps, delta = prob["gamma"], prob["eps"], prob["delta"]
    ls_ratio, e_const = prob["ls_ratio"], prob["e_const"]
    x, L0k, L1k, toggle = c["x"], c["L0"], c["L1"], c["toggle"]
    fx, g = f.value_and_grad(x)
    Fk = fx + h.extra_psi(x)

    s = cfg.lmo(g)
    d = s - x
    div = h.divergence(s, x)
    div = jnp.where(div == 0, delta, div)
    gdp, bad = _gdp_banded(g, d, delta)
    g_norm = jnp.linalg.norm(g.ravel())

    a_k0 = L0k + L1k * g_norm
    if cfg.linesearch:
        L0k = L0k / (ls_ratio + L0k / a_k0)
        L1k = L1k / (ls_ratio + (L1k * g_norm) / a_k0)

    def trial(L0t, L1t, tog, t):
        a_k = L0t + L1t * g_norm
        alpha = jnp.minimum(
            (-gdp / (a_k * div * e_const)) ** (1.0 / (gamma - 1.0)), 1.0
        )
        x1 = x + alpha * d
        if cfg.linesearch:
            fail = ~(f.value(x1) <= fx + alpha * gdp
                     + alpha**gamma * (a_k / 2.0) * e_const * div
                     + _accept_delta(f, fx))
        else:
            fail = jnp.asarray(False)
        fail = fail & (t < _LS_MAX)
        return dict(L0=L0t, L1=L1t, toggle=tog, a_k=a_k, alpha=alpha,
                    x1=x1, fail=fail, t=t)

    st = trial(L0k, L1k, toggle, 0)

    def body(st):
        a_k = st["L0"] + st["L1"] * g_norm
        L0t = jnp.where(st["toggle"] == 0, st["L0"] * (ls_ratio - st["L0"] / a_k), st["L0"])
        L1t = jnp.where(st["toggle"] == 0, st["L1"], st["L1"] * (ls_ratio - (st["L1"] * g_norm) / a_k))
        tog = 1 - st["toggle"]
        return trial(L0t, L1t, tog, st["t"] + 1)

    st = lax.while_loop(lambda st: st["fail"], body, st)

    stop = ((k > 0) & (jnp.abs(Fk - c["F_prev"]) < eps)) | bad
    c2 = dict(done=c["done"], x=st["x1"], L0=st["L0"], L1=st["L1"],
              toggle=st["toggle"], F_prev=Fk)
    return c2, dict(F=Fk, Ls=st["a_k"], L0=st["L0"], L1=st["L1"],
                    alpha=st["alpha"], bad=bad, _stop=stop)


def FW_alg_L0_L1_shortest_step(f, h, L0, L1, x0, maxitrs, gamma, lmo,
                               epsilon=1e-14, linesearch=True, ls_ratio=2,
                               verbose=True, verbskip=1, chunk=None,
                               checkpoint=None):
    """Frank-Wolfe for (L0,L1)-smooth f with the shortest-step rule

        a_k = L0 + L1 ||g||,
        alpha_k = min( (-<g,d> / (a_k D(s,x) e))^{1/(gamma-1)}, 1 )

    and the reference's alternating-toggle line search on (L0, L1)
    (reference: algorithms_fw.py:78-207).  Returns ``(x, F, Ls, T)``.
    """
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L0 < 0 or L1 < 0:
        raise ValueError("Initial L must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, gamma=jnp.asarray(gamma, dt),
                eps=jnp.asarray(epsilon, dt), delta=jnp.asarray(1e-8, dt),
                ls_ratio=jnp.asarray(ls_ratio, dt),
                e_const=jnp.asarray(np.e, dt))
    carry = dict(done=jnp.asarray(False), x=x0, L0=jnp.asarray(L0, dt),
                 L1=jnp.asarray(L1, dt), toggle=jnp.asarray(0, jnp.int32),
                 F_prev=jnp.asarray(jnp.inf, dt))
    header = ("\nFW (L0,L1)-smooth algorithm with shortest-step rule\n"
              "     k        F(x)          a_k           L0            L1        alpha        time")

    def row(k, r, t):
        print("{0:6d}   {1:10.3e}   {2:10.3e}   {3:10.3e}   {4:10.3e}   {5:10.3e}   {6:6.1f}".format(
            k, r["F"], r["Ls"], r["L0"], r["L1"], r["alpha"], t))

    carry, hist, T = run_driver(_fw_l0l1_shortest_step, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=header, print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_FWL0L1Cfg(lmo=lmo, linesearch=bool(linesearch)))
    _raise_if_bad(hist)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# (L0,L1)-smooth log / log+linear step FW
# ---------------------------------------------------------------------------


class _FWLogCfg(NamedTuple):
    lmo: Any
    linesearch: bool
    log_only: bool


def _fw_l0l1_log_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    eps, delta, ln2 = prob["eps"], prob["delta"], prob["ln2"]
    ls_ratio, L0cap, L1cap = prob["ls_ratio"], prob["L0cap"], prob["L1cap"]
    x, L0k, L1k = c["x"], c["L0"], c["L1"]
    logsteps, toggle = c["logsteps"], c["toggle"]
    fx, g = f.value_and_grad(x)
    gx_norm = jnp.linalg.norm(g.ravel())
    Fk = fx + h.extra_psi(x)

    s = cfg.lmo(g)
    d = s - x
    d_norm = jnp.linalg.norm(d.ravel())
    gdp, bad = _gdp_banded(g, d, delta)

    if cfg.linesearch:
        L0k = L0k / ls_ratio
        L1k = L1k / ls_ratio
    if cfg.log_only:
        L1k = jnp.maximum(ln2 / d_norm, L1k)

    def trial(L0t, L1t, tog, nlog, t):
        a_k = L0t + L1t * gx_norm
        z1 = L1t * d_norm
        alpha_log = (1.0 / z1) * jnp.log(1.0 - (L1t * gdp) / (a_k * d_norm))
        alpha_lin = L1t * (-gdp) / (a_k * d_norm)
        use_log = jnp.asarray(True) if cfg.log_only else (z1 >= ln2)
        alpha = jnp.where(use_log, alpha_log, alpha_lin)
        nlog = nlog + use_log.astype(jnp.int32)
        x1 = x + alpha * d
        if cfg.linesearch:
            z = L1t * alpha * d_norm
            exp_term = jnp.where(z < 50.0, jnp.expm1(z) - z, 0.5 * z * z)
            rhs = fx + alpha * gdp + (a_k / L1t**2) * exp_term
            fail = ~(f.value(x1) <= rhs + _accept_delta(f, fx))
        else:
            fail = jnp.asarray(False)
        fail = fail & (t < _LS_MAX)
        return dict(L0=L0t, L1=L1t, toggle=tog, a_k=a_k, alpha=alpha,
                    x1=x1, nlog=nlog, fail=fail, t=t)

    st = trial(L0k, L1k, toggle, logsteps, 0)

    def body(st):
        if cfg.log_only:
            L0t = jnp.where(st["toggle"] == 0,
                            jnp.minimum(st["L0"] * ls_ratio, L0cap), st["L0"])
            L1t = jnp.where(st["toggle"] == 0, st["L1"],
                            jnp.minimum(st["L1"] * ls_ratio, L1cap))
            tog = 1 - st["toggle"]
        else:
            L0t = jnp.minimum(st["L0"] * ls_ratio, L0cap)
            L1t = jnp.minimum(st["L1"] * ls_ratio, L1cap)
            tog = st["toggle"]
        return trial(L0t, L1t, tog, st["nlog"], st["t"] + 1)

    st = lax.while_loop(lambda st: st["fail"], body, st)

    stop = ((k > 0) & (jnp.abs(Fk - c["F_prev"]) < eps)) | bad
    c2 = dict(done=c["done"], x=st["x1"], L0=st["L0"], L1=st["L1"],
              logsteps=st["nlog"], toggle=st["toggle"], F_prev=Fk)
    return c2, dict(F=Fk, Ls=st["a_k"], L0=st["L0"], L1=st["L1"],
                    LOG_STEPS=st["nlog"], bad=bad, _stop=stop)


def _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                     L0_max, L1_max, linesearch, verbose, verbskip, chunk,
                     checkpoint, log_only, header):
    """Shared wrapper for FW_l0l1_log_and_linear_step / FW_l0l1_log_only
    (reference: algorithms_fw.py:250-349 and :352-453)."""
    if ls_ratio < 1:
        raise ValueError("ls_ratio must be >= 1")
    if L0 <= 0 or L1 <= 0:
        raise ValueError("Initial L0 and L1 must be positive")
    if epsilon <= 0:
        raise ValueError("epsilon must be positive")

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    big = jnp.asarray(jnp.inf, dt)
    prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, dt),
                delta=jnp.asarray(1e-8, dt),
                ln2=jnp.asarray(np.log(2.0), dt),
                ls_ratio=jnp.asarray(ls_ratio, dt),
                L0cap=big if L0_max is None else jnp.asarray(L0_max, dt),
                L1cap=big if L1_max is None else jnp.asarray(L1_max, dt))
    carry = dict(done=jnp.asarray(False), x=x0, L0=jnp.asarray(L0, dt),
                 L1=jnp.asarray(L1, dt), logsteps=jnp.asarray(0, jnp.int32),
                 toggle=jnp.asarray(0, jnp.int32),
                 F_prev=jnp.asarray(jnp.inf, dt))

    def row(k, r, t):
        print("{0:6d}   {1:10.3e}   {2:10.3e}   {3:10.3e}   {4:10.3e}   {5:6d}      {6:6.1f}".format(
            k, r["F"], r["Ls"], r["L0"], r["L1"], int(r["LOG_STEPS"]), t))

    cfg = _FWLogCfg(lmo=lmo, linesearch=bool(linesearch),
                    log_only=bool(log_only))
    carry, hist, T = run_driver(_fw_l0l1_log_step, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=header, print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg)
    _raise_if_bad(hist)
    return carry["x"], hist["F"], hist["Ls"], hist["LOG_STEPS"], T


def FW_l0l1_log_and_linear_step(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio,
                                epsilon=1e-14, L0_max=None, L1_max=None,
                                linesearch=True, verbose=True, verbskip=50,
                                chunk=None, checkpoint=None):
    """(L0,L1)-smooth FW with a logarithmic step when L1||d|| >= ln 2 and a
    linear step otherwise; acceptance uses the expm1-guarded exponential
    bound (reference: algorithms_fw.py:250-349).  Returns
    ``(x, F, Ls, LOG_STEPS, T)`` with LOG_STEPS the cumulative count of
    log-branch step evaluations, recorded once per iteration.
    """
    header = ("\nFW L0,L1 smooth logarithmic algorithm\n"
              "     k      F(x)         L         L0         L1     log step count       time")
    return _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                            L0_max, L1_max, linesearch, verbose, verbskip,
                            chunk, checkpoint, log_only=False, header=header)


def FW_l0l1_log_only(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon=1e-14,
                     L0_max=None, L1_max=None, linesearch=True, verbose=True,
                     verbskip=50, chunk=None, checkpoint=None):
    """(L0,L1)-smooth FW forcing the log step: L1 is floored at
    ln(2)/||d|| each iteration and (L0,L1) back off with an alternating
    toggle (reference: algorithms_fw.py:352-453).  Returns
    ``(x, F, Ls, LOG_STEPS, T)``.
    """
    header = ("\nFW L0,L1 smooth algorithm with fixed L1\n"
              "     k      F(x)         L         L0         L1     log step count       time")
    return _l0l1_log_driver(f, h, L0, L1, x0, maxitrs, lmo, ls_ratio, epsilon,
                            L0_max, L1_max, linesearch, verbose, verbskip,
                            chunk, checkpoint, log_only=True, header=header)
