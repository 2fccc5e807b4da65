"""Bregman proximal-gradient family: BPG, ABPG, ABPG_expo, ABPG_gain, ABDA.

JAX re-designs of the reference's accbpg/algorithms.py:11-514 (HRX2018,
arXiv:1808.03045).  Same math, same signatures, same return tuples and the
same printed progress tables — but each algorithm is a pure jitted step
function executed as ``lax.scan`` chunks on device (see ``driver.py``), with
the backtracking line searches expressed as bounded ``lax.while_loop``s
carrying ``(L-or-G, trial state)`` so a whole line search compiles into the
iteration kernel instead of re-entering Python per trial.

Steps are module-level functions taking the problem (oracles + scalar
hyperparameters) as a traced argument, so compiled chunk executables are
cached across solver calls with matching shapes (driver.py contract).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import fastgram as _fg
from .driver import run_driver
from .theta import solve_theta, solve_theta_ds

_LS_MAX = 200  # safety bound; backtracking terminates long before this


# -- double-single carry plumbing (fast_gram="ds") ---------------------------
#
# DS values are (hi, lo) f32 pairs; the DRIVER carry must stay a flat dict
# of plain arrays (checkpointing and device routing iterate its items), so
# each DS quantity occupies two keys "<name>__hi"/"<name>__lo".  Inside a
# step the pairs travel as tuples (while_loop states may nest freely).


def _dsg(c, name):
    return (c[name + "__hi"], c[name + "__lo"])


def _dsp(d, name, v):
    d[name + "__hi"], d[name + "__lo"] = v
    return d


def _ds_bc(s, like):
    """Broadcast a DS scalar against a DS array's shape."""
    return (jnp.broadcast_to(s[0], like[0].shape),
            jnp.broadcast_to(s[1], like[1].shape))


def _ds_combine(a, wa, b, wb):
    """(wa * a + wb * b) for DS arrays a, b and DS scalars wa, wb — the
    convex-combination workhorse of the accelerated DS steps."""
    from ..ops import double_single as dsl

    return dsl.add(dsl.mul(a, _ds_bc(wa, a)), dsl.mul(b, _ds_bc(wb, b)))


def _as_ds(x0):
    """Host-split an initial iterate into a DS pair (numpy f64 exact; jnp
    f32 arrays get a zero lo plane; traced f64 needs x64 like from_f64)."""
    import numpy as np

    from ..ops import double_single as dsl

    if isinstance(x0, jax.Array) and x0.dtype == jnp.float32:
        return dsl.from_f32(x0)
    return dsl.from_f64(np.asarray(x0, np.float64))


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(lambda u, v: jnp.where(pred, u, v), a, b)


def _div_pair(h, a1, b1, a2, b2):
    """Two Bregman divergences as ONE fused batched reduction pass.

    In-scan, each ``h.divergence`` call costs a full elementwise+reduce
    round; the accelerated steps always need the (D(x+,y), D(z+,z)) pair,
    so batch them with vmap — XLA fuses the two row-reductions of the
    stacked operands into a single pass.
    """
    d = jax.vmap(h.divergence)(jnp.stack([a1, a2]), jnp.stack([b1, b2]))
    return d[0], d[1]


def _accept_delta(f, scale):
    """AIBM-style inexact-oracle allowance for descent acceptances:
    ``accept_tol * (1 + |f-value scale|)`` for oracles that declare their
    noise (DOptimalObjMixed etc.), exactly 0.0 for exact oracles — adding
    it is then a bitwise no-op.  Without it, a line search whose TRUE
    margin sits below the oracle noise fails forever (the gain G inflates
    until steps stall into a spurious converged stop)."""
    tol = getattr(f, "accept_tol", 0.0)
    if not tol:
        return 0.0
    return tol * (1.0 + jnp.abs(scale))


def _oracle_key(cfg, c):
    """Per-iteration PRNG threading for stochastic (inexact) f-oracles
    (ops/base.py protocol): returns ``(next_carry_key, subkey)`` when the
    config says the oracle draws noise, ``(None, None)`` otherwise.  The
    reference draws fresh numpy noise inside every ``func_grad`` call
    (functions.py:957-960); here every GRADIENT evaluation gets a fresh
    subkey (values are exact in the reference's oracles) and runs are
    reproducible from the driver's ``seed``."""
    if getattr(cfg, "stochastic", False):
        return jax.random.split(c["key"])
    return None, None


def _stoch_carry(f, carry, seed, fast_gram=False):
    """Add the PRNG key to the initial carry when the f-oracle is
    stochastic; returns whether it is.  The fast-gram D-opt paths never
    see stochastic oracles (linear-Gram protocol oracles are exact)."""
    stoch = bool(getattr(f, "stochastic", False)) and not fast_gram
    if stoch:
        carry["key"] = jax.random.PRNGKey(0 if seed is None else seed)
    return stoch


def _warm_prox(h, c, y, g, Lt):
    """div_prox_map with the carried multiplier warm start when the
    h-oracle supports it (fast_gram carries hold 'cpx'); returns
    (x, new multiplier or None)."""
    if "cpx" in c and hasattr(h, "div_prox_map_warm"):
        return h.div_prox_map_warm(y, g, Lt, c["cpx"])
    return h.div_prox_map(y, g, Lt), None


# ---------------------------------------------------------------------------
# BPG
# ---------------------------------------------------------------------------


class _BPGCfg(NamedTuple):
    linesearch: bool
    stochastic: bool = False


def _bpg_step(cfg, prob, c, k):
    f, h = prob["f"], prob["h"]
    x, Lk = c["x"], c["L"]
    key, sub = _oracle_key(cfg, c)
    fx, g = (f.value_and_grad(x, key=sub) if sub is not None
             else f.value_and_grad(x))
    Fk = fx + h.extra_psi(x)
    stop = (k > 0) & (jnp.abs(Fk - c["F_prev"]) < prob["eps"])

    if cfg.linesearch:
        ls_ratio = prob["ls_ratio"]

        delta = _accept_delta(f, fx)

        def trial(Lt):
            x1 = h.div_prox_map(x, g, Lt)
            # NaN-robust acceptance: ~(lhs <= rhs) so a trial that leaves
            # the kernel domain (NaN) counts as a failure and L backs off
            # (the reference would assert-crash there, functions.py:243).
            fail = ~(f.value(x1) <= fx + jnp.vdot(g, x1 - x)
                     + Lt * h.divergence(x1, x) + delta)
            return x1, fail

        L1 = Lk / ls_ratio
        x1, fail = trial(L1)

        def cond(s):
            return s[2] & (s[3] < _LS_MAX)

        def body(s):
            Lt = s[0] * ls_ratio
            x1t, failt = trial(Lt)
            return (Lt, x1t, failt, s[3] + 1)

        Lk, x_new, _, _ = lax.while_loop(cond, body, (L1, x1, fail, 0))
    else:
        x_new = h.div_prox_map(x, g, Lk)

    c2 = dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, Ls=Lk, _stop=stop)


def _bpg_dopt_step(cfg, prob, c, k):
    """BPG specialized to linear-Gram D-opt oracles (fast_gram=True).

    Per iteration: the gradient comes from a warm-started Schulz inverse
    of the CARRIED Gram (the accepted trial of the previous iteration
    already contracted it), and each line-search trial pays one fresh
    Gram plus a trace-series log-det instead of a full oracle value.
    See ``fastgram`` for the machinery and accuracy gates.
    """
    f, h = prob["f"], prob["h"]
    x, Lk = c["x"], c["L"]
    Gx, M_1 = c["Gx"], c["Minv"]
    fx = c["fx"]
    ld_x = -fx
    M = _fg.inv_at(f, Gx, M_1)
    g = f.grad_from_inv(M)
    Fk = fx + h.extra_psi(x)
    stop = (k > 0) & (jnp.abs(Fk - c["F_prev"]) < prob["eps"])

    def trial(Lt):
        x1, cpx = _warm_prox(h, c, x, g, Lt)
        G1 = f.gram(x1)
        ld1, s1 = _fg.anchored_logdet_shift(f, ld_x, 1.0, M, G1, G1)
        f1 = -ld1
        # acceptance on the logdet SHIFT (f1 - fx = -s1): absolutely
        # accurate, immune to O(1) value cancellation (see fastgram)
        fail = ~(-s1 <= jnp.vdot(g, x1 - x) + Lt * h.divergence(x1, x)
                 + _accept_delta(f, fx))
        cpx = jnp.zeros(()) if cpx is None else cpx
        return x1, G1, f1, cpx, fail

    if cfg.linesearch:
        ls_ratio = prob["ls_ratio"]
        L1 = Lk / ls_ratio
        x1, G1, f1, cp1, fail = trial(L1)

        def cond(s):
            return s[5] & (s[6] < _LS_MAX)

        def body(s):
            Lt = s[0] * ls_ratio
            x1t, G1t, f1t, cpt, failt = trial(Lt)
            return (Lt, x1t, G1t, f1t, cpt, failt, s[6] + 1)

        Lk, x_new, G_new, fx_new, cp_new, _, _ = lax.while_loop(
            cond, body, (L1, x1, G1, f1, cp1, fail, 0))
    else:
        x_new, G_new, fx_new, cp_new, _ = trial(Lk)

    c2 = dict(done=c["done"], x=x_new, L=Lk, F_prev=Fk,
              Gx=G_new, Minv=M, fx=fx_new)
    if "cpx" in c:
        c2["cpx"] = cp_new
    return c2, dict(F=Fk, Ls=Lk, _stop=stop)


def _bpg_dopt_step_ds(cfg, prob, c, k):
    """BPG line-search step, DOUBLE-SINGLE engine (fast_gram="ds").

    The same stateful linear-Gram iteration as ``_bpg_dopt_step`` with
    every trajectory-bearing quantity a DS (two-f32) pair: f64-GRADE
    arithmetic from pure f32/int8 ops — no jax_enable_x64 and no f64
    anywhere (the mixed oracle still runs f64 elementwise work).  Gradient from a DS-polished
    Schulz inverse, one int8-Ozaki DS Gram per line-search trial,
    acceptance on the DS trace-series logdet SHIFT (exact to ~1e-13), DS
    Burg-simplex prox with the carried DS multiplier.  h.extra_psi is
    identically 0 on the Burg simplex, so F == f(x).
    """
    from ..ops import double_single as dsl

    f, h = prob["f"], prob["h"]
    x = _dsg(c, "x")
    L = _dsg(c, "L")
    Gx = _dsg(c, "Gx")
    fx = _dsg(c, "fx")
    cpx = _dsg(c, "cpx")
    M32, Mds = _fg.inv_pair_ds(f, Gx, c["Minv"])
    g = f.grad_from_inv_ds(Mds)
    Fk = fx
    ld_x = dsl.neg(fx)
    dF = dsl.sub(Fk, _dsg(c, "F_prev"))
    stop = (k > 0) & (jnp.abs(dF[0] + dF[1]) < prob["eps"])

    # inexact-oracle acceptance allowance at the declared DS noise scale
    # (see _accept_delta / DOptimalObjDS.accept_tol)
    delta = jnp.float32(getattr(f, "accept_tol", 0.0)) * (
        1.0 + jnp.abs(fx[0]))

    def trial(Lt):
        x1, cp1 = h.div_prox_map_ds_warm(x, g, Lt, cpx)
        G1 = f.gram_ds(x1)
        ld1, s1 = _fg.anchored_logdet_shift_ds(f, ld_x, 1.0, Mds, G1, G1)
        # one stacked fold for <g, x1-x> and D(x1, x) (sum_many)
        gd, dv = dsl.sum_many([dsl.mul(g, dsl.sub(x1, x)),
                               h.divergence_terms_ds(x1, x)])
        rhs = dsl.add_f32(dsl.add(gd, dsl.mul(Lt, dv)), delta)
        # NaN-robust: ~(lhs <= rhs) — DS compares are False on NaN planes
        fail = ~dsl.le(dsl.neg(s1), rhs)
        return x1, G1, dsl.neg(ld1), cp1, fail

    if cfg.linesearch:
        lsr = _dsg(prob, "ls_ratio")
        L1 = dsl.div(L, lsr)
        x1, G1, f1, cp1, fail = trial(L1)

        def cond(s):
            return s[5] & (s[6] < _LS_MAX)

        def body(s):
            Lt = dsl.mul(s[0], lsr)
            x1t, G1t, f1t, cpt, failt = trial(Lt)
            return (Lt, x1t, G1t, f1t, cpt, failt, s[6] + 1)

        Lk, x_new, G_new, fx_new, cp_new, _, _ = lax.while_loop(
            cond, body, (L1, x1, G1, f1, cp1, fail, 0))
    else:
        x_new, G_new, fx_new, cp_new, _ = trial(L)
        Lk = L

    c2 = dict(done=c["done"], Minv=M32)
    _dsp(c2, "x", x_new)
    _dsp(c2, "L", Lk)
    _dsp(c2, "F_prev", Fk)
    _dsp(c2, "Gx", G_new)
    _dsp(c2, "fx", fx_new)
    _dsp(c2, "cpx", cp_new)
    return c2, dict(F=Fk[0], F_lo=Fk[1], Ls=Lk[0], _stop=stop)


def _dopt_state_refresh_ds(f, with_z=True):
    """between_chunks hook for the DS engine: recontract Grams / inverse /
    anchor logdet from the exact DS iterates (see fastgram.refresh_state_ds)."""

    def refresh(carry, k_next):
        dev = next(iter(carry["x__hi"].devices()))
        fl = jax.device_put(f, dev)
        x = (carry["x__hi"], carry["x__lo"])
        z = (carry["z__hi"], carry["z__lo"]) if with_z else x
        upd = _fg.refresh_state_ds(fl, x, z, with_z=with_z)
        out = dict(carry)
        _dsp(out, "Gx", upd["Gx"])
        _dsp(out, "fx", upd["fx"])
        out["Minv"] = upd["Minv"]
        if with_z:
            _dsp(out, "Gz", upd["Gz"])
        return out

    return refresh


def _ds_wrap_returns(carry, hist):
    """Final DS -> f64 combination on HOST numpy (no x64 needed): the
    returned iterate and F history carry the full ~49-bit value."""
    import numpy as np

    x = (np.asarray(carry["x__hi"], np.float64)
         + np.asarray(carry["x__lo"], np.float64))
    F = (np.asarray(hist["F"], np.float64)
         + np.asarray(hist["F_lo"], np.float64))
    return x, F


def BPG(f, h, L, x0, maxitrs, epsilon=1e-14, linesearch=True, ls_ratio=1.2,
        verbose=True, verbskip=1, chunk=None, checkpoint=None,
        fast_gram=False, seed=None):
    """Bregman Proximal Gradient method for min_{x in C} f(x) + Psi(x):

        x_{k+1} = argmin_{x in C} { Psi(x) + <f'(x_k), x> + L_k D_h(x, x_k) }

    with optional backtracking on the relative smoothness constant L
    (reference: algorithms.py:11-72).  Returns ``(x, F, Ls, T)``.

    ``fast_gram=True``: stateful linear-Gram step for D-opt oracles
    (see ``ABPG_gain``): one Gram per line-search trial, matmul-only
    inverse, trace-series log-dets.

    ``fast_gram="ds"``: the same engine in DOUBLE-SINGLE (two-f32)
    arithmetic — f64-grade trajectories from pure f32/int8 ops, no
    ``jax_enable_x64`` (oracle: ``DOptimalObjDS.from_design(H)``, h:
    ``BurgEntropySimplex``).  Returns host-f64 ``x`` and ``F``.
    """
    if fast_gram == "ds":
        from ..ops import double_single as dsl

        _fg.require_fast_gram_ds(f, h)
        if chunk is None:
            # DS solves are latency-sensitive: every chunk boundary pays a
            # host round trip (launch + history fetch + state refresh), so
            # chunks are longer than the driver's default 256.  The value
            # has not been measured on the GPU yet (PERF.md).  The DS
            # per-chunk drift is ~1e-13/step, so 1024-step chunks keep
            # the refresh guarantee comfortably.
            chunk = max(int(verbskip), 1024)
        x0_ds = _as_ds(x0)
        st = _fg.init_state_ds(f, x0_ds)
        carry = dict(done=jnp.asarray(False), Minv=st["M0"])
        _dsp(carry, "x", x0_ds)
        _dsp(carry, "L", dsl.from_f64(float(L)))
        _dsp(carry, "F_prev", dsl.from_f32(jnp.asarray(jnp.inf, jnp.float32)))
        _dsp(carry, "Gx", st["G0"])
        _dsp(carry, "fx", dsl.neg(st["ld0"]))
        _dsp(carry, "cpx", dsl.from_f32(jnp.asarray(-jnp.inf, jnp.float32)))
        prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, jnp.float32))
        _dsp(prob, "ls_ratio", dsl.from_f64(float(ls_ratio)))
        header = ("\nBPG_LS method for min_{x in C} F(x) = f(x) + Psi(x)\n"
                  "     k      F(x)         Lk       time")

        def row(k, r, t):
            print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(
                k, r["F"], r["Ls"], t))

        carry, hist, T = run_driver(
            _bpg_dopt_step_ds, carry, maxitrs, verbose=verbose,
            verbskip=verbskip, header=header, print_row=row, chunk=chunk,
            checkpoint=checkpoint, problem=prob,
            cfg=_BPGCfg(linesearch=bool(linesearch)),
            between_chunks=_dopt_state_refresh_ds(f, with_z=False))
        x, F = _ds_wrap_returns(carry, hist)
        return x, F, hist["Ls"], T

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, dt),
                ls_ratio=jnp.asarray(ls_ratio, dt))
    carry = dict(done=jnp.asarray(False), x=x0, L=jnp.asarray(L, dt),
                 F_prev=jnp.asarray(jnp.inf, dt))
    between_chunks = None
    step = _bpg_step
    if fast_gram:
        _fg.require_fast_gram(f)
        st = _fg.init_state(f, x0)
        carry.update(Gx=st["G0"], Minv=st["M0"],
                     fx=jnp.asarray(-st["ld0"], dt))
        if hasattr(h, "div_prox_map_warm"):
            carry["cpx"] = jnp.asarray(-jnp.inf, dt)
        step = _bpg_dopt_step
        between_chunks = _dopt_state_refresh(f, with_z=False)
    stoch = _stoch_carry(f, carry, seed, fast_gram)
    header = ("\nBPG_LS method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)         Lk       time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:6.1f}".format(k, r["F"], r["Ls"], t))

    carry, hist, T = run_driver(step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_BPGCfg(linesearch=bool(linesearch),
                                            stochastic=stoch),
                                between_chunks=between_chunks)
    return carry["x"], hist["F"], hist["Ls"], T


# ---------------------------------------------------------------------------
# ABPG
# ---------------------------------------------------------------------------


class _ABPGCfg(NamedTuple):
    theta_eq: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False
    gamma2: bool = False  # static gamma == 2 (DS engine: sq instead of pow)


def _abpg_theta(cfg, prob, c):
    dt = c["x"].dtype
    kk, gam = c["kk"], prob["gamma"]
    if cfg.theta_eq:
        return jnp.where(kk > 0, solve_theta(c["theta"], gam),
                         jnp.asarray(1.0, dt))
    return gam / (kk.astype(dt) + gam)


def _abpg_restart(cfg, c, k, Fk, g, x_new, z_new, theta, kk,
                  Gx_new=None, Gz_new=None, k_guard=True):
    """Function ('f') / gradient ('g') restart shared by the ABPG family.

    ``k_guard`` replicates plain ABPG's explicit k>0 gate; the gain/expo
    steps rely on F_prev starting at +inf instead.  When carried Grams are
    supplied (fast_gram steps), a restart rewrites Gz alongside z.
    """
    dt = x_new.dtype
    has_gram = Gz_new is not None
    if not cfg.restart:
        return (theta, kk, z_new, Gz_new) if has_gram else (theta, kk, z_new)
    if cfg.restart_rule == 'f':
        trig = Fk > c["F_prev"]
    else:
        trig = jnp.vdot(g, x_new - c["x"]) > 0
    if k_guard:
        trig = (k > 0) & trig
    theta = jnp.where(trig, jnp.asarray(1.0, dt), theta)
    kk = jnp.where(trig, 0, kk)
    z_new = _tree_where(trig, x_new, z_new)
    if has_gram:
        return theta, kk, z_new, _tree_where(trig, Gx_new, Gz_new)
    return theta, kk, z_new


def _abpg_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, kk = c["x"], c["z"], c["kk"]
    key, sub = _oracle_key(cfg, c)
    fx = f.value(x)
    Fk = fx + h.extra_psi(x)

    theta = _abpg_theta(cfg, prob, c)
    y = (1.0 - theta) * x + theta * z
    g = f.grad(y, key=sub) if sub is not None else f.grad(y)
    z_new = h.div_prox_map(z, g, theta ** (gam - 1.0) * L)
    x_new = (1.0 - theta) * x + theta * z_new

    dxy, dzz = _div_pair(h, x_new, y, z_new, z)
    Gdr = dxy / dzz / theta**gam

    theta_c, kk, z_new = _abpg_restart(cfg, c, k, Fk, g, x_new, z_new,
                                       theta, kk + 1)
    stop = dzz < prob["eps"]
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk, F_prev=Fk)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz, _stop=stop)


def _abpg_dopt_step(cfg, prob, c, k):
    """Plain ABPG specialized to linear-Gram D-opt oracles (fast_gram=True):
    no oracle value calls at all — the gradient comes from the Schulz
    inverse of the combined Gram at y, and the F history advances through
    two trace-series log-det shifts anchored at the carried logdet(G(x)).
    """
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, kk = c["x"], c["z"], c["kk"]
    Gx, Gz, M_1 = c["Gx"], c["Gz"], c["Minv"]
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)

    theta = _abpg_theta(cfg, prob, c)
    y = (1.0 - theta) * x + theta * z
    Gy = (1.0 - theta) * Gx + theta * Gz
    M = _fg.inv_at(f, Gy, M_1)
    g = f.grad_from_inv(M)
    z_new, cpx = _warm_prox(h, c, z, g, theta ** (gam - 1.0) * L)
    x_new = (1.0 - theta) * x + theta * z_new
    Gz_new = f.gram(z_new)
    Gx_new = (1.0 - theta) * Gx + theta * Gz_new
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    ld_xn = _fg.anchored_logdet(f, ld_y, 1.0, M, Gx_new, Gx_new)

    dxy, dzz = _div_pair(h, x_new, y, z_new, z)
    Gdr = dxy / dzz / theta**gam

    theta_c, kk, z_new, Gz_new = _abpg_restart(
        cfg, c, k, Fk, g, x_new, z_new, theta, kk + 1,
        Gx_new=Gx_new, Gz_new=Gz_new)
    stop = dzz < prob["eps"]
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              F_prev=Fk, Gx=Gx_new, Gz=Gz_new, Minv=M, fx=-ld_xn)
    if "cpx" in c:
        c2["cpx"] = cpx
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz, _stop=stop)


def ABPG(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, theta_eq=False,
         restart=False, restart_rule='g', verbose=True, verbskip=1,
         chunk=None, checkpoint=None, fast_gram=False, seed=None):
    """Accelerated Bregman Proximal Gradient (reference: algorithms.py:94-180).

    Triple-sequence update with TSE gamma; theta from gamma/(k+gamma) or the
    Newton equality; optional function ('f') / gradient ('g') restart.
    Returns ``(x, F, G, T)`` with G the triangle-scaling gains.

    ``fast_gram=True``: stateful linear-Gram step for D-opt oracles (see
    ``ABPG_gain``) — zero full oracle evaluations per iteration beyond the
    one Gram of the fresh prox point.

    ``fast_gram="ds"``: the DOUBLE-SINGLE engine (see ``BPG``); oracle
    ``DOptimalObjDS.from_design(H)``, h ``BurgEntropySimplex``.
    """
    if fast_gram == "ds":
        from ..ops import double_single as dsl

        _fg.require_fast_gram_ds(f, h)
        if chunk is None:
            # DS solves are latency-sensitive: every chunk boundary pays a
            # host round trip (launch + history fetch + state refresh), so
            # chunks are longer than the driver's default 256.  The value
            # has not been measured on the GPU yet (PERF.md).  The DS
            # per-chunk drift is ~1e-13/step, so 1024-step chunks keep
            # the refresh guarantee comfortably.
            chunk = max(int(verbskip), 1024)
        x0_ds = _as_ds(x0)
        st = _fg.init_state_ds(f, x0_ds)
        carry = dict(done=jnp.asarray(False), Minv=st["M0"],
                     kk=jnp.asarray(0, jnp.int32))
        _dsp(carry, "x", x0_ds)
        _dsp(carry, "z", x0_ds)
        _dsp(carry, "theta", dsl.from_f64(1.0))
        _dsp(carry, "F_prev", dsl.from_f32(jnp.asarray(jnp.inf, jnp.float32)))
        _dsp(carry, "Gx", st["G0"])
        _dsp(carry, "Gz", st["G0"])
        _dsp(carry, "fx", dsl.neg(st["ld0"]))
        _dsp(carry, "cpx", dsl.from_f32(jnp.asarray(-jnp.inf, jnp.float32)))
        prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, jnp.float32))
        _dsp(prob, "L", dsl.from_f64(float(L)))
        _dsp(prob, "gamma", dsl.from_f64(float(gamma)))
        header = ("\nABPG method for minimize_{x in C} F(x) = f(x) + Psi(x)\n"
                  "     k      F(x)       theta        TSG       D(x+,y)     D(z+,z)     time")

        def row(k, r, t):
            print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:6.1f}".format(
                k, r["F"], r["theta"], r["G"], r["dxy"], r["dzz"], t))

        cfg = _ABPGCfg(theta_eq=bool(theta_eq), restart=bool(restart),
                       restart_rule=str(restart_rule),
                       gamma2=(float(gamma) == 2.0))
        carry, hist, T = run_driver(
            _abpg_dopt_step_ds, carry, maxitrs, verbose=verbose,
            verbskip=verbskip, header=header, print_row=row, chunk=chunk,
            checkpoint=checkpoint, problem=prob, cfg=cfg,
            between_chunks=_dopt_state_refresh_ds(f))
        x, F = _ds_wrap_returns(carry, hist)
        return x, F, hist["G"], T

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, L=jnp.asarray(L, dt),
                gamma=jnp.asarray(gamma, dt), eps=jnp.asarray(epsilon, dt))
    carry = dict(done=jnp.asarray(False), x=x0, z=x0,
                 theta=jnp.asarray(1.0, dt), kk=jnp.asarray(0, jnp.int32),
                 F_prev=jnp.asarray(jnp.inf, dt))
    between_chunks = None
    step = _abpg_step
    if fast_gram:
        _fg.require_fast_gram(f)
        st = _fg.init_state(f, x0)
        carry.update(Gx=st["G0"], Gz=st["G0"], Minv=st["M0"],
                     fx=jnp.asarray(-st["ld0"], dt))
        if hasattr(h, "div_prox_map_warm"):
            carry["cpx"] = jnp.asarray(-jnp.inf, dt)
        step = _abpg_dopt_step
        between_chunks = _dopt_state_refresh(f)
    header = ("\nABPG method for minimize_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       theta        TSG       D(x+,y)     D(z+,z)     time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:6.1f}".format(
            k, r["F"], r["theta"], r["G"], r["dxy"], r["dzz"], t))

    stoch = _stoch_carry(f, carry, seed, fast_gram)
    cfg = _ABPGCfg(theta_eq=bool(theta_eq), restart=bool(restart),
                   restart_rule=str(restart_rule), stochastic=stoch)
    carry, hist, T = run_driver(step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg,
                                between_chunks=between_chunks)
    return carry["x"], hist["F"], hist["G"], T


def _abpg_dopt_step_ds(cfg, prob, c, k):
    """Plain ABPG fast-gram step, DOUBLE-SINGLE engine (fast_gram="ds");
    mirrors ``_abpg_dopt_step`` with DS carries (see
    ``_abpg_gain_dopt_step_ds``)."""
    from ..ops import double_single as dsl

    f, h = prob["f"], prob["h"]
    L, gam = _dsg(prob, "L"), _dsg(prob, "gamma")
    eps = prob["eps"]
    x, z, kk = _dsg(c, "x"), _dsg(c, "z"), c["kk"]
    Gx, Gz = _dsg(c, "Gx"), _dsg(c, "Gz")
    fx = _dsg(c, "fx")
    ld_x = dsl.neg(fx)
    Fk = fx
    dt32 = jnp.float32
    one = dsl.from_f32(jnp.ones_like(x[0][0]))
    gm1 = dsl.add_f32(gam, dt32(-1.0))
    if cfg.gamma2:
        pow_gm1 = lambda t: t  # noqa: E731
    else:
        def pow_gm1(t):
            return dsl.exp(dsl.mul(gm1, dsl.log(t)))

    if cfg.theta_eq:
        th = solve_theta_ds(_dsg(c, "theta"), gam, square_gamma=cfg.gamma2)
        theta = dsl.where(kk > 0, th, one)
    else:
        kkf = dsl.from_f32(kk.astype(dt32))
        theta = dsl.div(gam, dsl.add(kkf, gam))

    omt = dsl.sub(one, theta)
    y = _ds_combine(x, omt, z, theta)
    Gy = _ds_combine(Gx, omt, Gz, theta)
    M32, Mds = _fg.inv_pair_ds(f, Gy, c["Minv"])
    g = f.grad_from_inv_ds(Mds)
    Lt = dsl.mul(pow_gm1(theta), L)
    z_new, cpx = h.div_prox_map_ds_warm(z, g, Lt, _dsg(c, "cpx"))
    x_new = _ds_combine(x, omt, z_new, theta)
    Gz_new = f.gram_ds(z_new)
    Gx_new = _ds_combine(Gx, omt, Gz_new, theta)
    ld_y, ld_xn, _ = _fg.anchored_shift_pair_ds(f, ld_x, Mds, Gx, Gy,
                                                Gx_new)

    gd, dxy, dzz = dsl.sum_many([dsl.mul(g, dsl.sub(x_new, x)),
                                 h.divergence_terms_ds(x_new, y),
                                 h.divergence_terms_ds(z_new, z)])
    thg = dsl.sq(theta) if cfg.gamma2 else dsl.exp(dsl.mul(gam,
                                                           dsl.log(theta)))
    Gdr = dsl.div(dsl.div(dxy, dzz), thg)

    kk = kk + 1
    theta_c = theta
    if cfg.restart:
        # gradient rule uses <g, x_new - x> (the fused gd above); the
        # function rule compares against F_prev — both gated k > 0 like
        # the f64 plain-ABPG step (k_guard=True)
        if cfg.restart_rule == 'f':
            trig = dsl.lt(_dsg(c, "F_prev"), Fk)
        else:
            trig = dsl.lt(dsl.from_f32(jnp.zeros_like(Fk[0])), gd)
        trig = (k > 0) & trig
        theta_c = dsl.where(trig, one, theta)
        kk = jnp.where(trig, 0, kk)
        z_new = dsl.where(trig, x_new, z_new)
        Gz_new = dsl.where(trig, Gx_new, Gz_new)

    stop = dzz[0] < eps
    c2 = dict(done=c["done"], kk=kk, Minv=M32)
    _dsp(c2, "x", x_new)
    _dsp(c2, "z", z_new)
    _dsp(c2, "theta", theta_c)
    _dsp(c2, "F_prev", Fk)
    _dsp(c2, "Gx", Gx_new)
    _dsp(c2, "Gz", Gz_new)
    _dsp(c2, "fx", dsl.neg(ld_xn))
    _dsp(c2, "cpx", cpx)
    return c2, dict(F=Fk[0], F_lo=Fk[1], G=Gdr[0], theta=theta[0],
                    dxy=dxy[0] + dxy[1], dzz=dzz[0] + dzz[1], _stop=stop)


# ---------------------------------------------------------------------------
# ABPG_expo
# ---------------------------------------------------------------------------


class _ABPGExpoCfg(NamedTuple):
    theta_eq: bool
    checkdiv: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False


def _abpg_expo_step(cfg, prob, c, k):
    f, h, L = prob["f"], prob["h"], prob["L"]
    delta, Gmargin = prob["delta"], prob["Gmargin"]
    x, z, kk, gamma = c["x"], c["z"], c["kk"], c["gamma"]
    dt = x.dtype
    one = jnp.asarray(1.0, dt)
    # f(x) carried from the previous accepted trial (see _abpg_gain_step)
    fx = c["fx"]
    Fk = fx + h.extra_psi(x)

    if cfg.theta_eq:
        theta = jnp.where(kk > 0, solve_theta(c["theta"], gamma), one)
    else:
        theta = gamma / (kk.astype(dt) + gamma)

    y = (1.0 - theta) * x + theta * z
    key, sub = _oracle_key(cfg, c)
    fy, g = (f.value_and_grad(y, key=sub) if sub is not None
             else f.value_and_grad(y))

    def attempt(gm):
        z_new = h.div_prox_map(z, g, theta ** (gm - 1.0) * L)
        x_new = (1.0 - theta) * x + theta * z_new
        dxy, dzz = _div_pair(h, x_new, y, z_new, z)
        Gdr = dxy / dzz / theta**gm
        if cfg.checkdiv:
            fxn = jnp.asarray(jnp.nan, dt)  # filled in once after the loop
            fail = ~(dxy <= Gmargin * theta**gm * dzz)
        else:
            fxn = f.value(x_new)
            fail = ~(fxn <= fy + jnp.vdot(g, x_new - y)
                     + theta**gm * L * dzz + _accept_delta(f, fy))
        return dict(gamma=gm, z=z_new, x=x_new, dxy=dxy, dzz=dzz, Gdr=Gdr,
                    fxn=fxn, fail=fail)

    s = attempt(gamma)
    s = lax.while_loop(
        lambda s: s["fail"] & (s["gamma"] > 1.0),
        lambda s: attempt(jnp.maximum(s["gamma"] - delta, one)),
        s,
    )
    gamma, z_new, x_new = s["gamma"], s["z"], s["x"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]
    fx_new = f.value(x_new) if cfg.checkdiv else s["fxn"]

    theta_c, kk, z_new = _abpg_restart(cfg, c, k, Fk, g, x_new, z_new,
                                       theta, kk + 1, k_guard=False)

    stop = dzz < prob["eps"]
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              gamma=gamma, F_prev=Fk, fx=fx_new)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, Gamma=gamma, G=Gdr, theta=theta, dxy=dxy,
                    dzz=dzz, _stop=stop)


def _abpg_expo_dopt_step(cfg, prob, c, k):
    """ABPG_expo specialized to linear-Gram D-opt oracles (fast_gram=True):
    the per-iteration gradient comes from the combined-Gram Schulz inverse
    and each gamma-adaption trial pays one fresh Gram + series logdets
    (see fastgram)."""
    f, h, L = prob["f"], prob["h"], prob["L"]
    delta, Gmargin = prob["delta"], prob["Gmargin"]
    x, z, kk, gamma = c["x"], c["z"], c["kk"], c["gamma"]
    Gx, Gz, M_1 = c["Gx"], c["Gz"], c["Minv"]
    dt = x.dtype
    one = jnp.asarray(1.0, dt)
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)

    if cfg.theta_eq:
        theta = jnp.where(kk > 0, solve_theta(c["theta"], gamma), one)
    else:
        theta = gamma / (kk.astype(dt) + gamma)

    y = (1.0 - theta) * x + theta * z
    Gy = (1.0 - theta) * Gx + theta * Gz
    M = _fg.inv_at(f, Gy, M_1)
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    g = f.grad_from_inv(M)

    def attempt(gm):
        z_new, cpx = _warm_prox(h, c, z, g, theta ** (gm - 1.0) * L)
        x_new = (1.0 - theta) * x + theta * z_new
        Gz_new = f.gram(z_new)
        Gx_new = (1.0 - theta) * Gx + theta * Gz_new
        ld_xn, s_xn = _fg.anchored_logdet_shift(f, ld_y, 1.0, M, Gx_new,
                                                Gx_new)
        fxn = -ld_xn
        dxy, dzz = _div_pair(h, x_new, y, z_new, z)
        Gdr = dxy / dzz / theta**gm
        if cfg.checkdiv:
            fail = ~(dxy <= Gmargin * theta**gm * dzz)
        else:
            # acceptance on the logdet SHIFT (see fastgram)
            fail = ~(-s_xn <= jnp.vdot(g, x_new - y) + theta**gm * L * dzz
                     + _accept_delta(f, ld_x))
        out = dict(gamma=gm, z=z_new, x=x_new, Gz=Gz_new, Gx=Gx_new,
                   fxn=fxn, dxy=dxy, dzz=dzz, Gdr=Gdr, fail=fail)
        if cpx is not None:
            out["cpx"] = cpx
        return out

    s = attempt(gamma)
    s = lax.while_loop(
        lambda s: s["fail"] & (s["gamma"] > 1.0),
        lambda s: attempt(jnp.maximum(s["gamma"] - delta, one)),
        s,
    )
    gamma, z_new, x_new = s["gamma"], s["z"], s["x"]
    Gz_new, Gx_new = s["Gz"], s["Gx"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]

    theta_c, kk, z_new, Gz_new = _abpg_restart(
        cfg, c, k, Fk, g, x_new, z_new, theta, kk + 1,
        Gx_new=Gx_new, Gz_new=Gz_new, k_guard=False)

    stop = dzz < prob["eps"]
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              gamma=gamma, F_prev=Fk, Gx=Gx_new, Gz=Gz_new, Minv=M,
              fx=s["fxn"])
    if "cpx" in c:
        c2["cpx"] = s["cpx"]
    return c2, dict(F=Fk, Gamma=gamma, G=Gdr, theta=theta, dxy=dxy,
                    dzz=dzz, _stop=stop)


def _abpg_expo_dopt_step_ds(cfg, prob, c, k):
    """ABPG_expo fast-gram step, DOUBLE-SINGLE engine (fast_gram="ds");
    mirrors ``_abpg_expo_dopt_step``.  gamma ADAPTS at runtime, so powers
    go through the general DS exp/log path (no static gamma-2 shortcut)."""
    from ..ops import double_single as dsl

    f, h = prob["f"], prob["h"]
    L = _dsg(prob, "L")
    delta_g, Gmargin = _dsg(prob, "delta"), _dsg(prob, "Gmargin")
    eps = prob["eps"]
    x, z, kk = _dsg(c, "x"), _dsg(c, "z"), c["kk"]
    gamma = _dsg(c, "gamma")
    Gx, Gz = _dsg(c, "Gx"), _dsg(c, "Gz")
    fx = _dsg(c, "fx")
    ld_x = dsl.neg(fx)
    Fk = fx
    dt32 = jnp.float32
    one = dsl.from_f32(jnp.ones_like(x[0][0]))
    acc_delta = jnp.float32(getattr(f, "accept_tol", 0.0)) * (
        1.0 + jnp.abs(fx[0]))

    def powg(t, g):
        return dsl.exp(dsl.mul(g, dsl.log(t)))

    if cfg.theta_eq:
        th = solve_theta_ds(_dsg(c, "theta"), gamma)
        theta = dsl.where(kk > 0, th, one)
    else:
        kkf = dsl.from_f32(kk.astype(dt32))
        theta = dsl.div(gamma, dsl.add(kkf, gamma))

    omt = dsl.sub(one, theta)
    y = _ds_combine(x, omt, z, theta)
    Gy = _ds_combine(Gx, omt, Gz, theta)
    M32, Mds = _fg.inv_pair_ds(f, Gy, c["Minv"])
    g = f.grad_from_inv_ds(Mds)
    cpx0 = _dsg(c, "cpx")

    def attempt(gm):
        gm1 = dsl.add_f32(gm, dt32(-1.0))
        Lt = dsl.mul(powg(theta, gm1), L)
        z_new, cpx = h.div_prox_map_ds_warm(z, g, Lt, cpx0)
        x_new = _ds_combine(x, omt, z_new, theta)
        Gz_new = f.gram_ds(z_new)
        Gx_new = _ds_combine(Gx, omt, Gz_new, theta)
        _, ld_xn, s_xn = _fg.anchored_shift_pair_ds(f, ld_x, Mds,
                                                    Gx, Gy, Gx_new)
        gd, dxy, dzz = dsl.sum_many([dsl.mul(g, dsl.sub(x_new, y)),
                                     h.divergence_terms_ds(x_new, y),
                                     h.divergence_terms_ds(z_new, z)])
        thg = powg(theta, gm)
        Gdr = dsl.div(dsl.div(dxy, dzz), thg)
        if cfg.checkdiv:
            fail = ~dsl.le(dxy, dsl.mul(dsl.mul(Gmargin, thg), dzz))
        else:
            rhs = dsl.add_f32(
                dsl.add(gd, dsl.mul(dsl.mul(thg, L), dzz)), acc_delta)
            fail = ~dsl.le(dsl.neg(s_xn), rhs)
        return dict(gamma=gm, z=z_new, x=x_new, Gz=Gz_new, Gx=Gx_new,
                    fxn=dsl.neg(ld_xn), dxy=dxy, dzz=dzz, Gdr=Gdr,
                    cpx=cpx, fail=fail)

    s = attempt(gamma)
    s = lax.while_loop(
        lambda s: s["fail"] & (s["gamma"][0] > 1.0),
        lambda s: attempt(dsl.where(
            dsl.lt(dsl.sub(s["gamma"], delta_g), one), one,
            dsl.sub(s["gamma"], delta_g))),
        s,
    )
    gamma, z_new, x_new = s["gamma"], s["z"], s["x"]
    Gz_new, Gx_new = s["Gz"], s["Gx"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]

    kk = kk + 1
    theta_c = theta
    if cfg.restart:
        if cfg.restart_rule == 'f':
            trig = dsl.lt(_dsg(c, "F_prev"), Fk)
        else:
            trig = dsl.lt(dsl.from_f32(jnp.zeros_like(Fk[0])),
                          dsl.dot(g, dsl.sub(x_new, x)))
        theta_c = dsl.where(trig, one, theta)
        kk = jnp.where(trig, 0, kk)
        z_new = dsl.where(trig, x_new, z_new)
        Gz_new = dsl.where(trig, Gx_new, Gz_new)

    stop = dzz[0] < eps
    c2 = dict(done=c["done"], kk=kk, Minv=M32)
    _dsp(c2, "x", x_new)
    _dsp(c2, "z", z_new)
    _dsp(c2, "theta", theta_c)
    _dsp(c2, "gamma", gamma)
    _dsp(c2, "F_prev", Fk)
    _dsp(c2, "Gx", Gx_new)
    _dsp(c2, "Gz", Gz_new)
    _dsp(c2, "fx", s["fxn"])
    _dsp(c2, "cpx", s["cpx"])
    return c2, dict(F=Fk[0], F_lo=Fk[1], Gamma=gamma[0], G=Gdr[0],
                    theta=theta[0], dxy=dxy[0] + dxy[1],
                    dzz=dzz[0] + dzz[1], _stop=stop)


def ABPG_expo(f, h, L, x0, gamma0, maxitrs, epsilon=1e-14, delta=0.2,
              theta_eq=True, checkdiv=False, Gmargin=10, restart=False,
              restart_rule='g', verbose=True, verbskip=1, chunk=None,
              checkpoint=None, fast_gram=False, seed=None):
    """ABPG with exponent adaption: start gamma0 > 2, decrease gamma by
    ``delta`` (floor 1) while the TSE inequality / descent condition fails
    (reference: algorithms.py:183-292).  Returns ``(x, F, Gamma, G, T)``.

    Documented deviation: with ``restart=True, restart_rule='f'`` the
    reference's k=0 iteration compares F[0] against the uninitialized
    history slot F[-1] == 0 (algorithms.py:268), so it restarts at k=0
    whenever F[0] > 0.  Here F_prev starts at +inf and the k=0 comparison
    never triggers — restarts react to actual objective increases only.

    ``fast_gram="ds"``: the DOUBLE-SINGLE engine (see ``BPG``); oracle
    ``DOptimalObjDS.from_design(H)``, h ``BurgEntropySimplex``.
    """
    if fast_gram == "ds":
        from ..ops import double_single as dsl

        _fg.require_fast_gram_ds(f, h)
        if chunk is None:
            # DS solves are latency-sensitive: every chunk boundary pays a
            # host round trip (launch + history fetch + state refresh), so
            # chunks are longer than the driver's default 256.  The value
            # has not been measured on the GPU yet (PERF.md).  The DS
            # per-chunk drift is ~1e-13/step, so 1024-step chunks keep
            # the refresh guarantee comfortably.
            chunk = max(int(verbskip), 1024)
        x0_ds = _as_ds(x0)
        st = _fg.init_state_ds(f, x0_ds)
        carry = dict(done=jnp.asarray(False), Minv=st["M0"],
                     kk=jnp.asarray(0, jnp.int32))
        _dsp(carry, "x", x0_ds)
        _dsp(carry, "z", x0_ds)
        _dsp(carry, "theta", dsl.from_f64(1.0))
        _dsp(carry, "gamma", dsl.from_f64(float(gamma0)))
        _dsp(carry, "F_prev", dsl.from_f32(jnp.asarray(jnp.inf, jnp.float32)))
        _dsp(carry, "Gx", st["G0"])
        _dsp(carry, "Gz", st["G0"])
        _dsp(carry, "fx", dsl.neg(st["ld0"]))
        _dsp(carry, "cpx", dsl.from_f32(jnp.asarray(-jnp.inf, jnp.float32)))
        prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, jnp.float32))
        _dsp(prob, "L", dsl.from_f64(float(L)))
        _dsp(prob, "delta", dsl.from_f64(float(delta)))
        _dsp(prob, "Gmargin", dsl.from_f64(float(Gmargin)))
        header = ("\nABPG_expo method for min_{x in C} F(x) = f(x) + Psi(x)\n"
                  "     k      F(x)       theta       gamma        TSG       D(x+,y)     D(z+,z)     time")

        def row(k, r, t):
            print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:10.3e}  {7:6.1f}".format(
                k, r["F"], r["theta"], r["Gamma"], r["G"], r["dxy"],
                r["dzz"], t))

        cfg = _ABPGExpoCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                           restart=bool(restart),
                           restart_rule=str(restart_rule))
        carry, hist, T = run_driver(
            _abpg_expo_dopt_step_ds, carry, maxitrs, verbose=verbose,
            verbskip=verbskip, header=header, print_row=row, chunk=chunk,
            checkpoint=checkpoint, problem=prob, cfg=cfg,
            between_chunks=_dopt_state_refresh_ds(f))
        x, F = _ds_wrap_returns(carry, hist)
        return x, F, hist["Gamma"], hist["G"], T

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, L=jnp.asarray(L, dt), eps=jnp.asarray(epsilon, dt),
                delta=jnp.asarray(delta, dt), Gmargin=jnp.asarray(Gmargin, dt))
    carry = dict(done=jnp.asarray(False), x=x0, z=x0,
                 theta=jnp.asarray(1.0, dt), kk=jnp.asarray(0, jnp.int32),
                 gamma=jnp.asarray(gamma0, dt), F_prev=jnp.asarray(jnp.inf, dt))
    between_chunks = None
    step = _abpg_expo_step
    if fast_gram:
        _fg.require_fast_gram(f)
        st = _fg.init_state(f, x0)
        carry.update(Gx=st["G0"], Gz=st["G0"], Minv=st["M0"],
                     fx=jnp.asarray(-st["ld0"], dt))
        if hasattr(h, "div_prox_map_warm"):
            carry["cpx"] = jnp.asarray(-jnp.inf, dt)
        step = _abpg_expo_dopt_step
        between_chunks = _dopt_state_refresh(f)
    else:
        carry.update(fx=jnp.asarray(f.value(x0), dt))
    header = ("\nABPG_expo method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       theta       gamma        TSG       D(x+,y)     D(z+,z)     time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:10.3e}  {7:6.1f}".format(
            k, r["F"], r["theta"], r["Gamma"], r["G"], r["dxy"], r["dzz"], t))

    stoch = _stoch_carry(f, carry, seed, fast_gram)
    cfg = _ABPGExpoCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                       restart=bool(restart), restart_rule=str(restart_rule),
                       stochastic=stoch)
    carry, hist, T = run_driver(step, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=header, print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg,
                                between_chunks=between_chunks)
    return carry["x"], hist["F"], hist["Gamma"], hist["G"], T


# ---------------------------------------------------------------------------
# ABPG_gain
# ---------------------------------------------------------------------------


class _ABPGGainCfg(NamedTuple):
    theta_eq: bool
    checkdiv: bool
    restart: bool
    restart_rule: str
    stochastic: bool = False
    gamma2: bool = False  # static gamma == 2 (DS engine: sq instead of pow)


def _abpg_gain_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    ls_inc, ls_dec, eps = prob["ls_inc"], prob["ls_dec"], prob["eps"]
    x, z, kk = c["x"], c["z"], c["kk"]
    G_1, theta_1 = c["G"], c["theta"]
    dt = x.dtype
    one = jnp.asarray(1.0, dt)
    # f(x) was already computed by the accepted trial of the PREVIOUS
    # iteration (the descent acceptance evaluates f(x_new)); the carry
    # threads it forward so each iteration spends oracle evaluations on
    # the trial point only.  c["fx"] is initialized eagerly at f(x0).
    fx = c["fx"]
    Fk = fx + h.extra_psi(x)

    def attempt(G, t, key):
        if cfg.theta_eq:
            theta = jnp.where(kk > 0, solve_theta(theta_1, gam, G / G_1), theta_1)
        else:
            alpha = G / G_1
            theta = jnp.where(
                kk > 0,
                theta_1 * ((1.0 + alpha * (gam - 1.0)) / (gam * alpha + theta_1)),
                theta_1,
            )
        y = (1.0 - theta) * x + theta * z
        if cfg.stochastic:
            # fresh noise per TRIAL, like the reference's per-call numpy
            # draw (each gain trial has a different y)
            key, sub = jax.random.split(key)
            fy, g = f.value_and_grad(y, key=sub)
        else:
            fy, g = f.value_and_grad(y)
        z_new = h.div_prox_map(z, g, theta ** (gam - 1.0) * G * L)
        x_new = (1.0 - theta) * x + theta * z_new
        dxy, dzz = _div_pair(h, x_new, y, z_new, z)
        early = dzz < eps
        Gdr = dxy / dzz / theta**gam
        if cfg.checkdiv:
            fxn = jnp.asarray(jnp.nan, dt)  # filled in once after the loop
            fail = ~(Gdr <= G)
        else:
            fxn = f.value(x_new)
            fail = ~(fxn <= fy + jnp.vdot(g, x_new - y)
                     + theta**gam * G * L * dzz + _accept_delta(f, fy))
        fail = fail & jnp.logical_not(early) & (t < _LS_MAX)
        out = dict(G=G, theta=theta, g=g, z=z_new, x=x_new, dxy=dxy,
                   dzz=dzz, Gdr=Gdr, fxn=fxn, fail=fail, t=t)
        if cfg.stochastic:
            out["key"] = key
        return out

    s = attempt(G_1 / ls_dec, 0, c.get("key"))
    s = lax.while_loop(
        lambda s: s["fail"],
        lambda s: attempt(s["G"] * ls_inc, s["t"] + 1, s.get("key")),
        s,
    )
    G, theta, g = s["G"], s["theta"], s["g"]
    z_new, x_new = s["z"], s["x"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]
    fx_new = f.value(x_new) if cfg.checkdiv else s["fxn"]

    sumlogG = c["sumlogG"] + jnp.log(G)
    Gavg = jnp.exp(sumlogG / (gam + k.astype(dt)))

    theta_c, kk, z_new = _abpg_restart(cfg, c, k, Fk, g, x_new, z_new,
                                       theta, kk + 1, k_guard=False)

    stop = dzz < eps
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              G=G, sumlogG=sumlogG, F_prev=Fk, fx=fx_new)
    if "key" in c:
        c2["key"] = s["key"]
    return c2, dict(F=Fk, Gain=G, Gdiv=Gdr, Gavg=Gavg, theta=theta,
                    dxy=dxy, dzz=dzz, _stop=stop)


# ---------------------------------------------------------------------------
# Fast-Gram specializations (D-opt linear-Gram oracles) — shared machinery
# in algorithms/fastgram.py
# ---------------------------------------------------------------------------


def _abpg_gain_dopt_step(cfg, prob, c, k):
    """ABPG_gain specialized to linear-Gram D-opt oracles (fast_gram=True).

    G(x) = V diag(x) V^T is LINEAR in x and the ABPG iterates y and x+ are
    convex combinations of carried points, so their Grams are m x m
    combinations of carried Grams — each line-search trial pays exactly ONE
    full O(m^2 n) contraction (the fresh prox output z+).  The m x m
    factorization is replaced by a warm-started Schulz inverse (matmul-only,
    seeded from the previous trial's inverse or the oracle's f32 seed when
    the iterate moved too far), and log-determinants advance through the
    exact identity  logdet G' = logdet G - logdet(M G)  +  logdet(M G')
    for M ~= G'^{-1}, each factor an 8-term trace series when
    ||I - M G||_F <= 0.03 and the oracle's full factorization otherwise
    (small-operand lax.cond — fine inside scan).

    Same mathematical trajectory as ``_abpg_gain_step`` up to f64-grade
    roundoff (~1e-12); the discrete gain line search makes the realized
    path diverge chaotically from the generic step's, like every other
    valid arithmetic change (see tests/test_mixed_oracle.py).  Opt-in via
    ``ABPG_gain(..., fast_gram=True)``; single-device layouts.
    """
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    ls_inc, ls_dec, eps = prob["ls_inc"], prob["ls_dec"], prob["eps"]
    x, z, kk = c["x"], c["z"], c["kk"]
    Gx, Gz, M_1 = c["Gx"], c["Gz"], c["Minv"]
    G_1, theta_1 = c["G"], c["theta"]
    dt = x.dtype
    one = jnp.asarray(1.0, dt)
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)

    def attempt(G, t):
        if cfg.theta_eq:
            theta = jnp.where(kk > 0, solve_theta(theta_1, gam, G / G_1), theta_1)
        else:
            alpha = G / G_1
            theta = jnp.where(
                kk > 0,
                theta_1 * ((1.0 + alpha * (gam - 1.0)) / (gam * alpha + theta_1)),
                theta_1,
            )
        y = (1.0 - theta) * x + theta * z
        Gy = (1.0 - theta) * Gx + theta * Gz
        M = _fg.inv_at(f, Gy, M_1)
        # logdet Gy = ld_x - logdet(M Gx)   [M ~= Gy^{-1}]
        ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
        g = f.grad_from_inv(M)
        z_new, cpx = _warm_prox(h, c, z, g, theta ** (gam - 1.0) * G * L)
        x_new = (1.0 - theta) * x + theta * z_new
        Gz_new = f.gram(z_new)
        Gx_new = (1.0 - theta) * Gx + theta * Gz_new
        # logdet Gx_new = ld_y + logdet(M Gx_new)
        ld_xn, s_xn = _fg.anchored_logdet_shift(f, ld_y, 1.0, M, Gx_new,
                                                Gx_new)
        fxn = -ld_xn
        dxy, dzz = _div_pair(h, x_new, y, z_new, z)
        early = dzz < eps
        Gdr = dxy / dzz / theta**gam
        if cfg.checkdiv:
            fail = ~(Gdr <= G)
        else:
            # acceptance on the logdet SHIFT (fxn - fy = -s_xn): immune to
            # O(1) value cancellation (see fastgram.anchored_logdet_shift)
            fail = ~(-s_xn <= jnp.vdot(g, x_new - y)
                     + theta**gam * G * L * dzz + _accept_delta(f, ld_x))
        fail = fail & jnp.logical_not(early) & (t < _LS_MAX)
        out = dict(G=G, theta=theta, g=g, z=z_new, x=x_new,
                   Gz=Gz_new, Gx=Gx_new, Minv=M, fxn=fxn, dxy=dxy,
                   dzz=dzz, Gdr=Gdr, fail=fail, t=t)
        if cpx is not None:
            out["cpx"] = cpx
        return out

    s = attempt(G_1 / ls_dec, 0)
    s = lax.while_loop(
        lambda s: s["fail"],
        lambda s: attempt(s["G"] * ls_inc, s["t"] + 1),
        s,
    )
    G, theta, g = s["G"], s["theta"], s["g"]
    z_new, x_new = s["z"], s["x"]
    Gz_new, Gx_new = s["Gz"], s["Gx"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]

    sumlogG = c["sumlogG"] + jnp.log(G)
    Gavg = jnp.exp(sumlogG / (gam + k.astype(dt)))

    theta_c, kk, z_new, Gz_new = _abpg_restart(
        cfg, c, k, Fk, g, x_new, z_new, theta, kk + 1,
        Gx_new=Gx_new, Gz_new=Gz_new, k_guard=False)

    stop = dzz < eps
    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta_c, kk=kk,
              G=G, sumlogG=sumlogG, F_prev=Fk, fx=s["fxn"],
              Gx=Gx_new, Gz=Gz_new, Minv=s["Minv"])
    if "cpx" in c:
        c2["cpx"] = s["cpx"]
    return c2, dict(F=Fk, Gain=G, Gdiv=Gdr, Gavg=Gavg, theta=theta,
                    dxy=dxy, dzz=dzz, _stop=stop)


def _abpg_gain_dopt_step_ds(cfg, prob, c, k):
    """ABPG_gain fast-gram step, DOUBLE-SINGLE engine (fast_gram="ds").

    Mirrors ``_abpg_gain_dopt_step`` quantity-for-quantity with every
    trajectory-bearing value a DS (two-f32) pair — theta from the DS Newton
    ``solve_theta_ds``, DS convex combinations of iterates and Grams, DS
    trace-series logdet shifts, DS Burg divergences — so the realized
    trajectory tracks the f64 engine's decision-for-decision (~1e-13 per
    quantity; measured F agreement ~1e-10 grade, tests/test_ds_fastgram.py)
    from pure f32/int8 ops.  h.extra_psi == 0 on the Burg simplex.
    """
    from ..ops import double_single as dsl

    f, h = prob["f"], prob["h"]
    L, gam = _dsg(prob, "L"), _dsg(prob, "gamma")
    ls_inc, ls_dec = _dsg(prob, "ls_inc"), _dsg(prob, "ls_dec")
    eps = prob["eps"]
    x, z, kk = _dsg(c, "x"), _dsg(c, "z"), c["kk"]
    Gx, Gz = _dsg(c, "Gx"), _dsg(c, "Gz")
    G_1, theta_1 = _dsg(c, "G"), _dsg(c, "theta")
    fx = _dsg(c, "fx")
    ld_x = dsl.neg(fx)
    Fk = fx
    one = dsl.from_f32(jnp.ones_like(theta_1[0]))
    gm1 = dsl.add_f32(gam, jnp.float32(-1.0))
    delta = jnp.float32(getattr(f, "accept_tol", 0.0)) * (
        1.0 + jnp.abs(fx[0]))

    if cfg.gamma2:
        pow_g = dsl.sq
        pow_gm1 = lambda t: t  # noqa: E731
    else:
        def pow_g(t):
            return dsl.exp(dsl.mul(gam, dsl.log(t)))

        def pow_gm1(t):
            return dsl.exp(dsl.mul(gm1, dsl.log(t)))

    def attempt(G, t, cpx):
        if cfg.theta_eq:
            th = solve_theta_ds(theta_1, gam, dsl.div(G, G_1),
                                square_gamma=cfg.gamma2)
            theta = dsl.where(kk > 0, th, theta_1)
        else:
            alpha = dsl.div(G, G_1)
            num = dsl.add_f32(dsl.mul(alpha, gm1), jnp.float32(1.0))
            den = dsl.add(dsl.mul(gam, alpha), theta_1)
            theta = dsl.where(kk > 0, dsl.mul(theta_1, dsl.div(num, den)),
                              theta_1)
        omt = dsl.sub(one, theta)
        y = _ds_combine(x, omt, z, theta)
        Gy = _ds_combine(Gx, omt, Gz, theta)
        M32, Mds = _fg.inv_pair_ds(f, Gy, c["Minv"])
        g = f.grad_from_inv_ds(Mds)
        Lt = dsl.mul(dsl.mul(pow_gm1(theta), G), L)
        z_new, cpx = h.div_prox_map_ds_warm(z, g, Lt, cpx)
        x_new = _ds_combine(x, omt, z_new, theta)
        Gz_new = f.gram_ds(z_new)
        Gx_new = _ds_combine(Gx, omt, Gz_new, theta)
        # both logdet advances in ONE batched series (fastgram)
        ld_y, ld_xn, s_xn = _fg.anchored_shift_pair_ds(f, ld_x, Mds,
                                                       Gx, Gy, Gx_new)
        # one stacked fold for <g, x_new-y>, D(x+, y) and D(z+, z)
        gd, dxy, dzz = dsl.sum_many([dsl.mul(g, dsl.sub(x_new, y)),
                                     h.divergence_terms_ds(x_new, y),
                                     h.divergence_terms_ds(z_new, z)])
        early = dzz[0] < eps
        thg = pow_g(theta)
        Gdr = dsl.div(dsl.div(dxy, dzz), thg)
        if cfg.checkdiv:
            fail = ~dsl.le(Gdr, G)
        else:
            # acceptance on the DS logdet SHIFT plus the declared-noise
            # allowance (see _accept_delta / DOptimalObjDS.accept_tol)
            rhs = dsl.add_f32(
                dsl.add(gd, dsl.mul(dsl.mul(dsl.mul(thg, G), L), dzz)),
                delta)
            fail = ~dsl.le(dsl.neg(s_xn), rhs)
        fail = fail & jnp.logical_not(early) & (t < _LS_MAX)
        return dict(G=G, theta=theta, g=g, z=z_new, x=x_new, Gz=Gz_new,
                    Gx=Gx_new, Minv=M32, fxn=dsl.neg(ld_xn), dxy=dxy,
                    dzz=dzz, Gdr=Gdr, cpx=cpx, fail=fail, t=t)

    cpx0 = _dsg(c, "cpx")
    s = attempt(dsl.div(G_1, ls_dec), 0, cpx0)
    s = lax.while_loop(
        lambda s: s["fail"],
        lambda s: attempt(dsl.mul(s["G"], ls_inc), s["t"] + 1, cpx0),
        s,
    )
    G, theta, g = s["G"], s["theta"], s["g"]
    z_new, x_new = s["z"], s["x"]
    Gz_new, Gx_new = s["Gz"], s["Gx"]
    dxy, dzz, Gdr = s["dxy"], s["dzz"], s["Gdr"]

    sumlogG = dsl.add(_dsg(c, "sumlogG"), dsl.log(G))
    dt32 = jnp.float32
    Gavg = jnp.exp((sumlogG[0] + sumlogG[1])
                   / (gam[0] + k.astype(dt32)))

    # restart (function 'f' / gradient 'g' rule), DS carries
    kk = kk + 1
    theta_c = theta
    if cfg.restart:
        F_prev = _dsg(c, "F_prev")
        if cfg.restart_rule == 'f':
            trig = dsl.lt(F_prev, Fk)
        else:
            trig = dsl.lt(dsl.from_f32(jnp.zeros_like(Fk[0])),
                          dsl.dot(g, dsl.sub(x_new, x)))
        theta_c = dsl.where(trig, one, theta)
        kk = jnp.where(trig, 0, kk)
        z_new = dsl.where(trig, x_new, z_new)
        Gz_new = dsl.where(trig, Gx_new, Gz_new)

    stop = dzz[0] < eps
    c2 = dict(done=c["done"], kk=kk, Minv=s["Minv"])
    _dsp(c2, "x", x_new)
    _dsp(c2, "z", z_new)
    _dsp(c2, "theta", theta_c)
    _dsp(c2, "G", G)
    _dsp(c2, "sumlogG", sumlogG)
    _dsp(c2, "F_prev", Fk)
    _dsp(c2, "Gx", Gx_new)
    _dsp(c2, "Gz", Gz_new)
    _dsp(c2, "fx", s["fxn"])
    _dsp(c2, "cpx", s["cpx"])
    return c2, dict(F=Fk[0], F_lo=Fk[1], Gain=G[0], Gdiv=Gdr[0],
                    Gavg=Gavg, theta=theta[0], dxy=dxy[0] + dxy[1],
                    dzz=dzz[0] + dzz[1], _stop=stop)


def _dopt_state_refresh(f, with_z=True):
    """between_chunks hook: jitted recontraction of the carried fast-Gram
    state (see ``fastgram.refresh_state`` for why it must be jitted)."""

    def refresh(carry, k_next):
        # colocate the oracle with the carry: solver_device may have
        # routed execution to another device
        dev = next(iter(carry["x"].devices()))
        fl = jax.device_put(f, dev)
        upd = _fg.refresh_state(fl, carry["x"],
                                carry["z"] if with_z else carry["x"],
                                with_z=with_z)
        return {**carry, **upd}

    return refresh


def ABPG_gain(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, G0=1,
              ls_inc=1.2, ls_dec=1.2, theta_eq=True, checkdiv=False,
              restart=False, restart_rule='g', verbose=True, verbskip=1,
              chunk=None, checkpoint=None, fast_gram=False, seed=None):
    """ABPG with gain adaption ("ABPG-g", the workhorse): per-iteration line
    search on the triangle-scaling gain G (optimistic divide by ls_dec, then
    multiply by ls_inc on failure), theta from solve_theta(theta_1, gamma,
    G/G_1) or the closed form (reference: algorithms.py:295-420).
    Returns ``(x, F, Gain, Gdiv, Gavg, T)``.

    Documented deviation: with ``restart=True, restart_rule='f'`` the
    reference's k=0 iteration compares F[0] against the uninitialized
    history slot F[-1] == 0 and restarts whenever F[0] > 0
    (algorithms.py:404-405); here F_prev starts at +inf so the k=0
    comparison never triggers (see ABPG_expo).

    ``fast_gram=True`` switches to the stateful linear-Gram step for
    D-opt oracles exposing the fast-Gram protocol (``gram``,
    ``logdet_full``, ``inv_seed``, ``grad_from_inv`` — DOptimalObj and
    DOptimalObjMixed): one O(m^2 n) contraction per line-search trial
    instead of three, no m x m factorization in the hot loop (see
    ``_abpg_gain_dopt_step``).  Same method, different-but-valid
    arithmetic: the realized trajectory deviates chaotically through the
    discrete gain line search while converging at the same rate.

    ``fast_gram="ds"``: the same engine in DOUBLE-SINGLE (two-f32)
    arithmetic — f64-grade trajectories from pure f32/int8 ops, no
    ``jax_enable_x64`` (oracle: ``DOptimalObjDS.from_design(H)``, h:
    ``BurgEntropySimplex``).  Tracks the f64 fast_gram trajectory to
    ~1e-10 (tests); returns host-f64 ``x`` and ``F``.
    """
    if fast_gram == "ds":
        from ..ops import double_single as dsl

        _fg.require_fast_gram_ds(f, h)
        if chunk is None:
            # DS solves are latency-sensitive: every chunk boundary pays a
            # host round trip (launch + history fetch + state refresh), so
            # chunks are longer than the driver's default 256.  The value
            # has not been measured on the GPU yet (PERF.md).  The DS
            # per-chunk drift is ~1e-13/step, so 1024-step chunks keep
            # the refresh guarantee comfortably.
            chunk = max(int(verbskip), 1024)
        x0_ds = _as_ds(x0)
        st = _fg.init_state_ds(f, x0_ds)
        one = dsl.from_f64(1.0)
        carry = dict(done=jnp.asarray(False), Minv=st["M0"],
                     kk=jnp.asarray(0, jnp.int32))
        _dsp(carry, "x", x0_ds)
        _dsp(carry, "z", x0_ds)
        _dsp(carry, "theta", one)
        _dsp(carry, "G", dsl.from_f64(float(G0)))
        G0ds = dsl.from_f64(float(G0))
        _dsp(carry, "sumlogG", dsl.mul(dsl.from_f64(float(gamma)),
                                       dsl.log(G0ds)))
        _dsp(carry, "F_prev", dsl.from_f32(jnp.asarray(jnp.inf, jnp.float32)))
        _dsp(carry, "Gx", st["G0"])
        _dsp(carry, "Gz", st["G0"])
        _dsp(carry, "fx", dsl.neg(st["ld0"]))
        _dsp(carry, "cpx", dsl.from_f32(jnp.asarray(-jnp.inf, jnp.float32)))
        prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, jnp.float32))
        _dsp(prob, "L", dsl.from_f64(float(L)))
        _dsp(prob, "gamma", dsl.from_f64(float(gamma)))
        _dsp(prob, "ls_inc", dsl.from_f64(float(ls_inc)))
        _dsp(prob, "ls_dec", dsl.from_f64(float(ls_dec)))
        header = ("\nABPG_gain method for min_{x in C} F(x) = f(x) + Psi(x)\n"
                  "     k      F(x)       theta         Gk         TSG       D(x+,y)     D(z+,z)      Gavg       time")

        def row(k, r, t):
            print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:10.3e}  {7:10.3e}  {8:6.1f}".format(
                k, r["F"], r["theta"], r["Gain"], r["Gdiv"], r["dxy"],
                r["dzz"], r["Gavg"], t))

        cfg = _ABPGGainCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                           restart=bool(restart),
                           restart_rule=str(restart_rule),
                           gamma2=(float(gamma) == 2.0))
        carry, hist, T = run_driver(
            _abpg_gain_dopt_step_ds, carry, maxitrs, verbose=verbose,
            verbskip=verbskip, header=header, print_row=row, chunk=chunk,
            checkpoint=checkpoint, problem=prob, cfg=cfg,
            between_chunks=_dopt_state_refresh_ds(f))
        x, F = _ds_wrap_returns(carry, hist)
        return x, F, hist["Gain"], hist["Gdiv"], hist["Gavg"], T

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    gam = jnp.asarray(gamma, dt)
    G0a = jnp.asarray(G0, dt)
    prob = dict(f=f, h=h, L=jnp.asarray(L, dt), gamma=gam,
                eps=jnp.asarray(epsilon, dt), ls_inc=jnp.asarray(ls_inc, dt),
                ls_dec=jnp.asarray(ls_dec, dt))
    carry = dict(done=jnp.asarray(False), x=x0, z=x0,
                 theta=jnp.asarray(1.0, dt), kk=jnp.asarray(0, jnp.int32),
                 G=G0a, sumlogG=gam * jnp.log(G0a),
                 F_prev=jnp.asarray(jnp.inf, dt))
    between_chunks = None
    if fast_gram:
        _fg.require_fast_gram(f)
        st = _fg.init_state(f, x0)
        carry.update(Gx=st["G0"], Gz=st["G0"], Minv=st["M0"],
                     fx=jnp.asarray(-st["ld0"], dt))
        if hasattr(h, "div_prox_map_warm"):
            carry["cpx"] = jnp.asarray(-jnp.inf, dt)
        step = _abpg_gain_dopt_step
        between_chunks = _dopt_state_refresh(f)
    else:
        carry.update(fx=jnp.asarray(f.value(x0), dt))
        step = _abpg_gain_step
    header = ("\nABPG_gain method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       theta         Gk         TSG       D(x+,y)     D(z+,z)      Gavg       time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:10.3e}  {7:10.3e}  {8:6.1f}".format(
            k, r["F"], r["theta"], r["Gain"], r["Gdiv"], r["dxy"], r["dzz"], r["Gavg"], t))

    stoch = _stoch_carry(f, carry, seed, fast_gram)
    cfg = _ABPGGainCfg(theta_eq=bool(theta_eq), checkdiv=bool(checkdiv),
                       restart=bool(restart), restart_rule=str(restart_rule),
                       stochastic=stoch)
    carry, hist, T = run_driver(step, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=header, print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob, cfg=cfg,
                                between_chunks=between_chunks)
    return carry["x"], hist["F"], hist["Gain"], hist["Gdiv"], hist["Gavg"], T


# ---------------------------------------------------------------------------
# ABDA
# ---------------------------------------------------------------------------


class _ABDACfg(NamedTuple):
    theta_eq: bool
    stochastic: bool = False
    gamma2: bool = False  # static gamma == 2 (DS engine: sq instead of pow)


def _abda_step(cfg, prob, c, k):
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, kk = c["x"], c["z"], c["kk"]
    dt = x.dtype
    fx = f.value(x)
    Fk = fx + h.extra_psi(x)

    if cfg.theta_eq:
        theta = jnp.where(kk > 0, solve_theta(c["theta"], gam),
                          jnp.asarray(1.0, dt))
    else:
        theta = gam / (kk.astype(dt) + gam)

    y = (1.0 - theta) * x + theta * z
    key, sub = _oracle_key(cfg, c)
    g = f.grad(y, key=sub) if sub is not None else f.grad(y)
    w = theta ** (1.0 - gam)
    gavg = c["gavg"] + w * g
    csum = c["csum"] + w
    z_new = h.prox_map(gavg / csum, L / csum)
    x_new = (1.0 - theta) * x + theta * z_new

    dxy, dzz = _div_pair(h, x_new, y, z_new, z)
    Gdr = dxy / dzz / theta**gam
    stop = dzz < prob["eps"]

    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta, kk=kk + 1,
              gavg=gavg, csum=csum, F_prev=Fk)
    if key is not None:
        c2["key"] = key
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz, _stop=stop)


def _abda_dopt_step(cfg, prob, c, k):
    """ABDA specialized to linear-Gram D-opt oracles (fast_gram=True):
    gradient from the combined-Gram Schulz inverse; F history through
    anchored trace-series logdet shifts (see fastgram)."""
    f, h, L, gam = prob["f"], prob["h"], prob["L"], prob["gamma"]
    x, z, kk = c["x"], c["z"], c["kk"]
    Gx, Gz, M_1 = c["Gx"], c["Gz"], c["Minv"]
    dt = x.dtype
    fx = c["fx"]
    ld_x = -fx
    Fk = fx + h.extra_psi(x)

    if cfg.theta_eq:
        theta = jnp.where(kk > 0, solve_theta(c["theta"], gam),
                          jnp.asarray(1.0, dt))
    else:
        theta = gam / (kk.astype(dt) + gam)

    y = (1.0 - theta) * x + theta * z
    Gy = (1.0 - theta) * Gx + theta * Gz
    M = _fg.inv_at(f, Gy, M_1)
    g = f.grad_from_inv(M)
    w = theta ** (1.0 - gam)
    gavg = c["gavg"] + w * g
    csum = c["csum"] + w
    if "cpx" in c and hasattr(h, "prox_map_warm"):
        z_new, cpx = h.prox_map_warm(gavg / csum, L / csum, c["cpx"])
    else:
        z_new, cpx = h.prox_map(gavg / csum, L / csum), None
    x_new = (1.0 - theta) * x + theta * z_new
    Gz_new = f.gram(z_new)
    Gx_new = (1.0 - theta) * Gx + theta * Gz_new
    ld_y = _fg.anchored_logdet(f, ld_x, -1.0, M, Gx, Gy)
    ld_xn = _fg.anchored_logdet(f, ld_y, 1.0, M, Gx_new, Gx_new)

    dxy, dzz = _div_pair(h, x_new, y, z_new, z)
    Gdr = dxy / dzz / theta**gam
    stop = dzz < prob["eps"]

    c2 = dict(done=c["done"], x=x_new, z=z_new, theta=theta, kk=kk + 1,
              gavg=gavg, csum=csum, F_prev=Fk,
              Gx=Gx_new, Gz=Gz_new, Minv=M, fx=-ld_xn)
    if "cpx" in c:
        c2["cpx"] = cpx
    return c2, dict(F=Fk, G=Gdr, theta=theta, dxy=dxy, dzz=dzz, _stop=stop)


def _abda_dopt_step_ds(cfg, prob, c, k):
    """ABDA fast-gram step, DOUBLE-SINGLE engine (fast_gram="ds"); mirrors
    ``_abda_dopt_step`` — dual-averaged DS gradient accumulator and the
    PRIMAL DS prox (see ``_abpg_gain_dopt_step_ds`` for the machinery)."""
    from ..ops import double_single as dsl

    f, h = prob["f"], prob["h"]
    L, gam = _dsg(prob, "L"), _dsg(prob, "gamma")
    eps = prob["eps"]
    x, z, kk = _dsg(c, "x"), _dsg(c, "z"), c["kk"]
    Gx, Gz = _dsg(c, "Gx"), _dsg(c, "Gz")
    fx = _dsg(c, "fx")
    ld_x = dsl.neg(fx)
    Fk = fx
    dt32 = jnp.float32
    one = dsl.from_f32(jnp.ones_like(x[0][0]))

    if cfg.theta_eq:
        th = solve_theta_ds(_dsg(c, "theta"), gam, square_gamma=cfg.gamma2)
        theta = dsl.where(kk > 0, th, one)
    else:
        kkf = dsl.from_f32(kk.astype(dt32))
        theta = dsl.div(gam, dsl.add(kkf, gam))

    omt = dsl.sub(one, theta)
    y = _ds_combine(x, omt, z, theta)
    Gy = _ds_combine(Gx, omt, Gz, theta)
    M32, Mds = _fg.inv_pair_ds(f, Gy, c["Minv"])
    g = f.grad_from_inv_ds(Mds)
    # w = theta^(1-gamma): for gamma == 2 exactly 1/theta
    if cfg.gamma2:
        w = dsl.div(one, theta)
    else:
        gm1 = dsl.add_f32(gam, dt32(-1.0))
        w = dsl.exp(dsl.neg(dsl.mul(gm1, dsl.log(theta))))
    gavg = dsl.add(_dsg(c, "gavg"), dsl.mul(g, _ds_bc(w, g)))
    csum = dsl.add(_dsg(c, "csum"), w)
    z_new, cpx = h.prox_map_ds_warm(
        dsl.div(gavg, _ds_bc(csum, gavg)), dsl.div(L, csum),
        _dsg(c, "cpx"))
    x_new = _ds_combine(x, omt, z_new, theta)
    Gz_new = f.gram_ds(z_new)
    Gx_new = _ds_combine(Gx, omt, Gz_new, theta)
    ld_y, ld_xn, _ = _fg.anchored_shift_pair_ds(f, ld_x, Mds, Gx, Gy,
                                                Gx_new)

    dxy, dzz = dsl.sum_many([h.divergence_terms_ds(x_new, y),
                             h.divergence_terms_ds(z_new, z)])
    thg = dsl.sq(theta) if cfg.gamma2 else dsl.exp(dsl.mul(gam,
                                                           dsl.log(theta)))
    Gdr = dsl.div(dsl.div(dxy, dzz), thg)
    stop = dzz[0] < eps

    c2 = dict(done=c["done"], kk=kk + 1, Minv=M32)
    _dsp(c2, "x", x_new)
    _dsp(c2, "z", z_new)
    _dsp(c2, "theta", theta)
    _dsp(c2, "gavg", gavg)
    _dsp(c2, "csum", csum)
    _dsp(c2, "F_prev", Fk)
    _dsp(c2, "Gx", Gx_new)
    _dsp(c2, "Gz", Gz_new)
    _dsp(c2, "fx", dsl.neg(ld_xn))
    _dsp(c2, "cpx", cpx)
    return c2, dict(F=Fk[0], F_lo=Fk[1], G=Gdr[0], theta=theta[0],
                    dxy=dxy[0] + dxy[1], dzz=dzz[0] + dzz[1], _stop=stop)


def ABDA(f, h, L, x0, gamma, maxitrs, epsilon=1e-14, theta_eq=True,
         verbose=True, verbskip=1, chunk=None, checkpoint=None,
         fast_gram=False, seed=None):
    """Accelerated Bregman Dual Averaging: accumulates the weighted gradient
    average and uses the *primal* prox_map (reference: algorithms.py:423-514;
    restart is intentionally unsupported, :445-446).
    Returns ``(x, F, G, T)``.

    ``fast_gram=True``: stateful linear-Gram step for D-opt oracles (see
    ``ABPG_gain``).

    ``fast_gram="ds"``: the DOUBLE-SINGLE engine (see ``BPG``); oracle
    ``DOptimalObjDS.from_design(H)``, h ``BurgEntropySimplex``.
    """
    if fast_gram == "ds":
        from ..ops import double_single as dsl

        _fg.require_fast_gram_ds(f, h)
        if chunk is None:
            # DS solves are latency-sensitive: every chunk boundary pays a
            # host round trip (launch + history fetch + state refresh), so
            # chunks are longer than the driver's default 256.  The value
            # has not been measured on the GPU yet (PERF.md).  The DS
            # per-chunk drift is ~1e-13/step, so 1024-step chunks keep
            # the refresh guarantee comfortably.
            chunk = max(int(verbskip), 1024)
        if not hasattr(h, "prox_map_ds_warm"):
            raise ValueError("ABDA fast_gram='ds' needs an h-oracle with a "
                             "DS primal prox (BurgEntropySimplex)")
        x0_ds = _as_ds(x0)
        st = _fg.init_state_ds(f, x0_ds)
        carry = dict(done=jnp.asarray(False), Minv=st["M0"],
                     kk=jnp.asarray(0, jnp.int32))
        _dsp(carry, "x", x0_ds)
        _dsp(carry, "z", x0_ds)
        _dsp(carry, "theta", dsl.from_f64(1.0))
        _dsp(carry, "gavg", dsl.from_f32(jnp.zeros_like(x0_ds[0])))
        _dsp(carry, "csum", dsl.from_f64(0.0))
        _dsp(carry, "F_prev", dsl.from_f32(jnp.asarray(jnp.inf, jnp.float32)))
        _dsp(carry, "Gx", st["G0"])
        _dsp(carry, "Gz", st["G0"])
        _dsp(carry, "fx", dsl.neg(st["ld0"]))
        _dsp(carry, "cpx", dsl.from_f32(jnp.asarray(-jnp.inf, jnp.float32)))
        prob = dict(f=f, h=h, eps=jnp.asarray(epsilon, jnp.float32))
        _dsp(prob, "L", dsl.from_f64(float(L)))
        _dsp(prob, "gamma", dsl.from_f64(float(gamma)))
        header = ("\nABDA method for min_{x in C} F(x) = f(x) + Psi(x)\n"
                  "     k      F(x)       theta        TSG       D(x+,y)     D(z+,z)     time")

        def row(k, r, t):
            print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:6.1f}".format(
                k, r["F"], r["theta"], r["G"], r["dxy"], r["dzz"], t))

        cfg = _ABDACfg(theta_eq=bool(theta_eq),
                       gamma2=(float(gamma) == 2.0))
        carry, hist, T = run_driver(
            _abda_dopt_step_ds, carry, maxitrs, verbose=verbose,
            verbskip=verbskip, header=header, print_row=row, chunk=chunk,
            checkpoint=checkpoint, problem=prob, cfg=cfg,
            between_chunks=_dopt_state_refresh_ds(f))
        x, F = _ds_wrap_returns(carry, hist)
        return x, F, hist["G"], T

    x0 = jnp.asarray(x0)
    dt = x0.dtype
    prob = dict(f=f, h=h, L=jnp.asarray(L, dt),
                gamma=jnp.asarray(gamma, dt), eps=jnp.asarray(epsilon, dt))
    carry = dict(done=jnp.asarray(False), x=x0, z=x0,
                 theta=jnp.asarray(1.0, dt), kk=jnp.asarray(0, jnp.int32),
                 gavg=jnp.zeros_like(x0), csum=jnp.asarray(0.0, dt),
                 F_prev=jnp.asarray(jnp.inf, dt))
    between_chunks = None
    step = _abda_step
    if fast_gram:
        _fg.require_fast_gram(f)
        st = _fg.init_state(f, x0)
        carry.update(Gx=st["G0"], Gz=st["G0"], Minv=st["M0"],
                     fx=jnp.asarray(-st["ld0"], dt))
        if hasattr(h, "prox_map_warm"):
            carry["cpx"] = jnp.asarray(-jnp.inf, dt)
        step = _abda_dopt_step
        between_chunks = _dopt_state_refresh(f)
    header = ("\nABDA method for min_{x in C} F(x) = f(x) + Psi(x)\n"
              "     k      F(x)       theta        TSG       D(x+,y)     D(z+,z)     time")

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:10.3e}  {5:10.3e}  {6:6.1f}".format(
            k, r["F"], r["theta"], r["G"], r["dxy"], r["dzz"], t))

    stoch = _stoch_carry(f, carry, seed, fast_gram)
    carry, hist, T = run_driver(step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk,
                                checkpoint=checkpoint, problem=prob,
                                cfg=_ABDACfg(theta_eq=bool(theta_eq),
                                             stochastic=stoch),
                                between_chunks=between_chunks)
    return carry["x"], hist["F"], hist["G"], T
