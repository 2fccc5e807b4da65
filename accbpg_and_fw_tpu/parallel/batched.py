"""Batched (vmapped) multi-problem solving.

The reference's iteration-complexity studies run K = 3-10 repeats over grids
of (m, n) configs as sequential Python loops (SURVEY.md §6, e.g.
ipynb/ABPGvsFW/ex_Dopt_FW_m80.ipynb:cell3).  Here the whole solve is vmapped
over the instance batch, so K independent solves compile to ONE scan whose
per-iteration work is batched contractions instead of K sequential GEMV
streams.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..algorithms import d_opt as _d_opt
from ..algorithms.d_opt import (
    _DOptCfg,
    _dopt_factorize,
    _dopt_factorize_ds,
    _dopt_step_ds,
    _ds_split_np,
    _inv_m_ds_np,
    _make_dopt_step,
    _warn_if_downcast,
)
from ..algorithms.driver import _masked_scan_body, _wrap_step


@functools.lru_cache(maxsize=64)
def _vmapped_jit(solve_one):
    return jax.jit(jax.vmap(solve_one))


def vmap_solver(solve_one, *batched_args):
    """jit(vmap(...)) a single-instance solver over leading batch axes.
    The jitted wrapper is cached per ``solve_one`` so repeat calls reuse
    the compiled executable instead of re-tracing."""
    return _vmapped_jit(solve_one)(*batched_args)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _batch_solve(away, refresh_every, num_iters, u_mode, Vs, x0s, eps):
    """Module-level jitted batch solve — cached across calls with matching
    shapes and static options (a closure form would recompile per call)."""

    def solve_one(V, x0):
        step = _make_dopt_step(V, eps, away=away, u_mode=u_mode)
        # budget-mask at num_iters so the refresh path's rounded-up block
        # grid cannot run the carry past the requested budget
        body = _masked_scan_body(step, num_iters)

        if not refresh_every or refresh_every >= num_iters:
            H, w, logdet = _dopt_factorize(V, x0)
            carry = dict(done=jnp.asarray(False), x=x0, w=w, H=H,
                         logdet=logdet)
            carry, hist = lax.scan(body, carry,
                                   jnp.arange(num_iters, dtype=jnp.int32))
            return carry["x"], hist["F"], hist["SP"], hist["SN"]

        R = int(refresh_every)
        nblocks = -(-num_iters // R)
        # every block re-factorizes at entry, so the initial (H, w, logdet)
        # are placeholders that the first block overwrites
        m = V.shape[0]
        carry = dict(done=jnp.asarray(False), x=x0,
                     w=jnp.zeros_like(x0),
                     H=jnp.zeros((m, m), V.dtype),
                     logdet=jnp.asarray(0.0, V.dtype))

        def block(c, b):
            Hn, wn, ldn = _dopt_factorize(V, c["x"])
            c = dict(done=c["done"], x=c["x"], w=wn, H=Hn, logdet=ldn)
            ks = b * R + jnp.arange(R, dtype=jnp.int32)
            return lax.scan(body, c, ks)

        carry, hists = lax.scan(block, carry,
                                jnp.arange(nblocks, dtype=jnp.int32))
        hist = jax.tree_util.tree_map(
            lambda a: a.reshape((nblocks * R,) + a.shape[2:])[:num_iters],
            hists,
        )
        return carry["x"], hist["F"], hist["SP"], hist["SN"]

    return jax.vmap(solve_one)(Vs, x0s)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _batch_solve_ds(away, num_iters, Vh, Vl, carry, eps, inv_m_hi, inv_m_lo,
                    Vp=None, sVu=None):
    """``Vp``/``sVu`` (optional, trace-time-static presence): per-instance
    packed int8 digit planes + column scales for the big-n u-update path
    (see d_opt._dopt_step_ds) — supplied by the caller for instances
    above d_opt._OZAKI_U_MIN_SIZE."""
    cfg = _DOptCfg(away=away, mixed=False)

    def solve_one(Vh1, Vl1, c1, Vp1=None, sVu1=None):
        # inv_m rides as a runtime arg — DS constants must never be baked
        # into the jit (ops/double_single.py hazard note)
        prob = dict(V_hi=Vh1, V_lo=Vl1, eps=eps,
                    inv_m_hi=inv_m_hi, inv_m_lo=inv_m_lo)
        if Vp1 is not None:
            prob["V_packed"] = Vp1
            prob["sV_u"] = sVu1

        def step(c, k):
            return _dopt_step_ds(cfg, prob, c, k)

        wrapped = _wrap_step(step)
        c2, hist = lax.scan(wrapped, c1,
                            jnp.arange(num_iters, dtype=jnp.int32))
        return (c2, c2["x_hi"], c2["x_lo"], hist["F"], hist["SP"],
                hist["SN"])

    if Vp is None:
        return jax.vmap(solve_one)(Vh, Vl, carry)
    return jax.vmap(solve_one)(Vh, Vl, carry, Vp, sVu)


def dopt_fw_batch_ds(Vs, x0s, eps, num_iters, away=True, refresh_every=0,
                     exit_every=2048):
    """Batch D-opt FW(-away) in DOUBLE-SINGLE precision: the trajectories
    carry ~49 significand bits (certify slack targets down to 1e-8, like
    float64) but every operation is pure f32.  Whether that beats the
    native f64 batch on a GPU has not been measured (PERF.md).

    Vs: (K, m, n); x0s: (K, n).  Returns ``(x, F, SP, SN)`` with leading
    batch axis (x in float64, reconstructed from the DS planes).

    ``refresh_every``: optional host-side float64 re-factorization of
    (H, w, logdet) from the current iterates every R iterations (resets
    incremental drift; the refreshed slacks are the honest ones).

    ``exit_every``: all-done early-exit granularity — the scan launches in
    blocks of at most this many iterations so a generous ``num_iters``
    budget costs only the iterations actually run (one host sync per
    block).

    The error-free transforms are broadcast-materialized at their entry
    points (see double_single._bc2): XLA otherwise rewrote them once vmap
    introduced broadcast operands, which left K >= 2 batches drifting.
    """
    import numpy as onp

    Vs64 = onp.asarray(Vs, onp.float64)
    x0s64 = onp.asarray(x0s, onp.float64)
    K = Vs64.shape[0]
    if num_iters <= 0:
        z = onp.zeros((K, 0))
        return x0s64.copy(), z, z.copy(), z.copy()
    carries = {"done": onp.zeros(K, bool)}
    planes = {"V_hi": [], "V_lo": []}
    for name in ("x", "w", "H", "ld"):
        carries[f"{name}_hi"] = []
        carries[f"{name}_lo"] = []
    for kk in range(K):
        H, w, logdet = _dopt_factorize_ds(Vs64[kk], x0s64[kk])
        vh, vl = _ds_split_np(Vs64[kk])
        planes["V_hi"].append(vh)
        planes["V_lo"].append(vl)
        for name, val in (("x", x0s64[kk]), ("w", w), ("H", H),
                          ("ld", onp.float64(logdet))):
            hi, lo = _ds_split_np(val)
            carries[f"{name}_hi"].append(hi)
            carries[f"{name}_lo"].append(lo)
    carry = {k: jnp.asarray(onp.stack(v)) if k != "done" else
             jnp.asarray(v) for k, v in carries.items()}
    Vh = jnp.asarray(onp.stack(planes["V_hi"]))
    Vl = jnp.asarray(onp.stack(planes["V_lo"]))
    imh, iml = _inv_m_ds_np(Vs64.shape[1])
    Vp = sVu = None
    if Vs64[0].size >= _d_opt._OZAKI_U_MIN_SIZE:
        # per-instance packed int8 digit planes for the big-n u-update
        from ..ops import mixed_precision as mp

        packed, scales = [], []
        for kk in range(K):
            dV, sV = mp.digit_split_matrix_np(Vs64[kk],
                                              _d_opt._OZAKI_U_LEVELS)
            packed.append(onp.ascontiguousarray(
                onp.transpose(dV, (1, 0, 2)).reshape(
                    dV.shape[1], dV.shape[0] * dV.shape[2])))
            scales.append(onp.asarray(sV, onp.float32))
        Vp = jnp.asarray(onp.stack(packed))
        sVu = jnp.asarray(onp.stack(scales))

    R = int(refresh_every) if refresh_every else int(num_iters)
    R = min(R, int(num_iters))
    block = min(R, int(exit_every)) if exit_every else R
    Fs, SPs, SNs = [], [], []
    done_iters = 0
    since_refresh = 0
    while done_iters < num_iters:
        r = min(block, R - since_refresh, num_iters - done_iters)
        out = _batch_solve_ds(bool(away), int(r), Vh, Vl, carry,
                              jnp.asarray(eps, jnp.float32),
                              jnp.asarray(imh), jnp.asarray(iml),
                              Vp, sVu)
        carry2, xh, xl, F, SP, SN = out
        Fs.append(onp.asarray(F))
        SPs.append(onp.asarray(SP))
        SNs.append(onp.asarray(SN))
        carry = carry2
        done_iters += r
        since_refresh += r
        if done_iters >= num_iters or bool(jnp.all(carry["done"])):
            break
        if not refresh_every or since_refresh < R:
            continue
        since_refresh = 0
        # host-side f64 refresh from the current iterates
        xh_np = onp.asarray(carry["x_hi"], onp.float64)
        xl_np = onp.asarray(carry["x_lo"], onp.float64)
        x_now = xh_np + xl_np
        upd = {"w_hi": [], "w_lo": [], "H_hi": [], "H_lo": [],
               "ld_hi": [], "ld_lo": []}
        for kk in range(K):
            Hn, wn, ldn = _dopt_factorize_ds(Vs64[kk], x_now[kk])
            for name, val in (("w", wn), ("H", Hn), ("ld", onp.float64(ldn))):
                hi, lo = _ds_split_np(val)
                upd[f"{name}_hi"].append(hi)
                upd[f"{name}_lo"].append(lo)
        carry = dict(carry)
        for kname, v in upd.items():
            carry[kname] = jnp.asarray(onp.stack(v))

    x = (onp.asarray(carry["x_hi"], onp.float64)
         + onp.asarray(carry["x_lo"], onp.float64))
    F = onp.concatenate(Fs, axis=1)
    SP = onp.concatenate(SPs, axis=1)
    SN = onp.concatenate(SNs, axis=1)
    return x, F, SP, SN


def dopt_fw_batch(Vs, x0s, eps, num_iters, away=True, refresh_every=0,
                  precision="native"):
    """Solve a batch of D-optimal design instances in one computation.

    Vs: (K, m, n) stacked design matrices; x0s: (K, n) initial points.
    Runs ``num_iters`` Frank-Wolfe(-away) iterations for every instance
    (instances that converge earlier freeze via their done flag) and returns
    ``(x, F, SP, SN)`` with leading batch axis K.  Compiled executables are
    cached across calls with matching shapes/static options.

    ``refresh_every``: refactorize (H, w, logdet) from the current iterate
    every R iterations inside the scan — cancels rank-1 rounding drift for
    float32 runs (f32 incremental state stalls around slack ~1e-4; f64
    needs no refresh).  O(m^2 n) per refresh, amortized over R iterations.

    ``precision``: "native" (the input dtype's exact arithmetic; what
    "auto" runs), "mixed" (the f64 w-update contraction through the
    exact-digit int8-Ozaki GEMV, ~3e-12 relative — trajectories deviate
    chaotically through the discrete line searches like any valid
    arithmetic change) or "ds" (double-single, f64-grade from pure f32;
    ``dopt_fw_batch_ds``).  f32 "native" supports slack targets down to
    ~1e-4 only.  Any other value raises ``ValueError``.

    Note: under vmap the toward/away ``lax.cond`` lowers to a select (both
    branches execute); that doubles the per-iteration FLOPs but turns K
    independent O(mn) GEMVs into one (K, m, n) batched contraction.
    """
    if precision == "ds":
        return dopt_fw_batch_ds(Vs, x0s, eps, num_iters, away=away,
                                refresh_every=refresh_every)
    if precision not in ("auto", "native", "mixed"):
        raise ValueError(f"unknown precision {precision!r}; expected "
                         "'auto', 'native', 'mixed' or 'ds'")
    Vs_in = Vs
    Vs = jnp.asarray(Vs)
    _warn_if_downcast(Vs_in, Vs)
    x0s = jnp.asarray(x0s, Vs.dtype)
    eps = jnp.asarray(eps, Vs.dtype)
    # "native" means the input dtype's EXACT arithmetic (numpy-matching
    # trajectories); the inexact int8-Ozaki w-update is its own explicit
    # setting, never an implicit auto-route
    u_mode = "mixed" if precision == "mixed" else "exact"
    return _batch_solve(bool(away), int(refresh_every), int(num_iters),
                        u_mode, Vs, x0s, eps)
