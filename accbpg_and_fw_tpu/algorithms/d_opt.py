"""D-optimal design Frank-Wolfe solvers with O(mn) rank-1 iterations.

JAX re-designs of the reference's accbpg/D_opt_alg.py: the classic
Khachiyan Frank-Wolfe (``D_opt_FW``) and the Wolfe-Atwood away-step variant
(``D_opt_FW_away``) for

    minimize  -log det(V diag(x) V^T)   s.t.  x in unit simplex.

Design differences from the reference (same math, compiled and stabler):

* the whole iteration is a jitted scan step — argmax/argmin, the rank-1
  H/w updates, and the step-size arithmetic all stay on device (the
  reference re-enters Python per iteration, D_opt_alg.py:51-82);
* the determinant is tracked in LOG space (log1p-accumulated), so
  F(x) = -logdet(VXVT) is cheap and accurate; the reference's away version
  recomputes np.linalg.det(H) — an O(m^3) per-iteration cost — because its
  linear-space running det drifts (D_opt_alg.py:136-138);
* optional ``refresh_every``: re-factorize H, w and logdet from scratch at
  the first chunk boundary after every R iterations, canceling rank-1
  rounding drift (needed for float32 runs; the reference never refreshes);
  the factorization is Cholesky-based (VXVT is SPD);
* the away-branch logdet update uses w[j] (the reference uses w[i] at
  D_opt_alg.py:177 — a known bug that its F[k] hides by recomputing det(H)).

Sharding: V column-shards over a mesh (P(None, 'data')); x and w inherit the
column sharding; H (m-by-m) and all scalars replicate.  The per-iteration
collectives are then the w-argmax/argmin and the psum inside HVi @ V.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .driver import run_driver

# DS-engine u-update routing: from this V size on, the O(mn) contraction
# u = (Hv)^T V runs as one packed int8 matmul with exact int32
# accumulation instead of the elementwise DS contract.  The threshold has
# not been measured on the GPU (PERF.md, open questions).  8 digit levels
# (48 bits both sides): u error 8.4e-13 relative, matching the DS
# contract's 4e-13 (7 levels measured 3.8e-11, whose ~1.3e-9 slack floor
# at m=1000 kept the n=2000 sweep's away endgame from certifying 1e-8);
# int32 accumulation stays exact for m <= 65k (m * 65^2 * levels < 2^31).
_OZAKI_U_MIN_SIZE = 1_800_000
_OZAKI_U_LEVELS = 8


def _dopt_factorize(V, x):
    """Fresh O(m^2 n + m^3) state: (H, w, logdet) for VXVT = V diag(x) V^T.

    Cholesky-based (VXVT is SPD): logdet = 2 sum log diag(R), H = R^-T R^-1,
    and w = colnorms^2 of R^-1 V.
    """
    from jax.scipy.linalg import solve_triangular

    VXVT = (V * x) @ V.T
    R = jnp.linalg.cholesky(VXVT)  # lower
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(R)))
    Rinv = solve_triangular(R, jnp.eye(V.shape[0], dtype=V.dtype), lower=True)
    H = Rinv.T @ Rinv
    W = Rinv @ V
    w = jnp.sum(W * W, axis=0)
    return H, w, logdet


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(lambda u, v: jnp.where(pred, u, v), a, b)


class _DOptCfg:
    """Hashable static config for the cached D-opt step."""

    __slots__ = ("away", "mixed")

    def __init__(self, away, mixed):
        self.away = bool(away)
        self.mixed = bool(mixed)

    def __hash__(self):
        return hash((self.away, self.mixed))

    def __eq__(self, other):
        return (isinstance(other, _DOptCfg) and self.away == other.away
                and self.mixed == other.mixed)

    def __repr__(self):
        # stable across processes: part of the checkpoint fingerprint
        return f"_DOptCfg(away={self.away}, mixed={self.mixed})"


def _dopt_u(cfg, prob, hv):
    if cfg.mixed:
        from ..ops.mixed_precision import ozaki_gemv

        # Per-pair dot_generals (not ozaki_gemv_packed): 21 independent
        # small contractions that XLA may schedule beside the H update.
        return ozaki_gemv(hv, prob["V_digits"], prob["sV"], levels_a=7,
                          max_diag=6).astype(prob["V"].dtype)
    return hv @ prob["V"]


def _dopt_step(cfg, prob, c, k):
    V, eps = prob["V"], prob["eps"]
    m, n = V.shape
    dt = V.dtype
    m_f = jnp.asarray(float(m), dt)

    def toward_update(state, i, wi):
        x, w, H, logdet = state
        t = (wi / m_f - 1.0) / (wi - 1.0)
        Vi = lax.dynamic_index_in_dim(V, i, axis=1, keepdims=False)
        HVi = H @ Vi
        c_ = t / (1.0 - t + t * wi)  # == t / (1 + t*(wi-1))
        H_new = (H - c_ * jnp.outer(HVi, HVi)) / (1.0 - t)
        u = _dopt_u(cfg, prob, HVi)
        # Force u_i == w_i: the exact line search sets the new w_i to exactly
        # m only when the recomputed v_i^T H v_i agrees with the incrementally
        # tracked w_i.  In exact float64 they agree to ~1e-15 (no-op); an
        # inexact contraction (the int8-Ozaki "mixed" u, ~1e-12) otherwise
        # leaves a residual slack of order m*delta that sustains a permanent
        # ~1e-6 limit cycle (observed: SN frozen at 2.7e-6 for 40k
        # iterations at m=1000).
        u = u.at[i].set(wi)
        w_new = (w - c_ * u * u) / (1.0 - t)
        x_new = (x * (1.0 - t)).at[i].add(t)
        logdet_new = logdet + (m_f - 1.0) * jnp.log1p(-t) + jnp.log1p(t * (wi - 1.0))
        return (x_new, w_new, H_new, logdet_new)

    def away_update(state, j, wj):
        x, w, H, logdet = state
        xj = x[j]
        t = jnp.minimum((1.0 - wj / m_f) / (wj - 1.0), xj / (1.0 - xj))
        Vj = lax.dynamic_index_in_dim(V, j, axis=1, keepdims=False)
        HVj = H @ Vj
        c_ = t / (1.0 + t - t * wj)
        H_new = (H + c_ * jnp.outer(HVj, HVj)) / (1.0 + t)
        u = _dopt_u(cfg, prob, HVj)
        u = u.at[j].set(wj)  # consistency pin; see toward_update
        w_new = (w + c_ * u * u) / (1.0 + t)
        x_new = (x * (1.0 + t)).at[j].add(-t)
        logdet_new = logdet + (m_f - 1.0) * jnp.log1p(t) + jnp.log1p(t - t * wj)
        return (x_new, w_new, H_new, logdet_new)

    x, w, H, logdet = c["x"], c["w"], c["H"], c["logdet"]
    Fk = -logdet
    i = jnp.argmax(w)
    wi = w[i]

    if cfg.away:
        ww = w - wi  # shift so max is 0; masked entries dominate at 0
        j = jnp.argmin(ww * (x > 1.0e-8))
        wj = w[j]
        eps_neg = 1.0 - wj / m_f
    else:
        wmin = jnp.min(jnp.where(x > 0, w, jnp.inf))
        eps_neg = 1.0 - wmin / m_f

    eps_pos = wi / m_f - 1.0
    stop = (eps_pos <= eps) & (eps_neg <= eps)

    state = (x, w, H, logdet)
    if cfg.away:
        new_state = lax.cond(
            eps_pos >= eps_neg,
            lambda s: toward_update(s, i, wi),
            lambda s: away_update(s, j, wj),
            state,
        )
    else:
        new_state = toward_update(state, i, wi)

    # the reference breaks BEFORE applying the update (D_opt_alg.py:72-73)
    x_n, w_n, H_n, logdet_n = _tree_where(stop, state, new_state)
    c2 = dict(done=c["done"], x=x_n, w=w_n, H=H_n, logdet=logdet_n)
    return c2, dict(F=Fk, SP=eps_pos, SN=eps_neg, _stop=stop)


def _dopt_step_ds(cfg, prob, c, k):
    """Unified FW(-away) step with the WHOLE state in double-single f32
    (ops/double_single.py): ~f64-accurate trajectories (certifies slack
    1e-8) from pure f32 XLA ops — no jax_enable_x64 requirement, vmappable
    for batched sweeps.

    Same math as ``_dopt_step`` expressed through a signed-tau unification:
    toward tau=+t, away tau=-t, then a single shared update path
    reproduces both branches of D_opt_alg.py:162-179.
    """
    from ..ops import double_single as dsa

    Vds = (prob["V_hi"], prob["V_lo"])
    eps = prob["eps"]
    m, n = Vds[0].shape
    m_f = jnp.float32(m)
    # 1/m in DS — passed through prob as a RUNTIME value: XLA's constant
    # folder destroys error-free transforms on jit-constant subgraphs
    # (ops/double_single.py module hazard note)
    inv_m = (prob["inv_m_hi"], prob["inv_m_lo"])
    iota = jnp.arange(n, dtype=jnp.int32)

    x = (c["x_hi"], c["x_lo"])
    w = (c["w_hi"], c["w_lo"])
    H = (c["H_hi"], c["H_lo"])
    ld = (c["ld_hi"], c["ld_lo"])

    # toward candidate: DS argmax (hi plane, lo tie-break, first index)
    wmax_hi = jnp.max(w[0])
    cand = w[0] == wmax_hi
    wmax_lo = jnp.max(jnp.where(cand, w[1], -jnp.inf))
    i = jnp.min(jnp.where(cand & (w[1] == wmax_lo), iota, n + 1))
    wi = (wmax_hi, wmax_lo)

    if cfg.away:
        # away candidate: first argmin of (w - wi) * (x > 1e-8)
        mask = x[0] > 1.0e-8
        wwh, wwl = dsa.sub(w, wi)
        mwh = jnp.where(mask, wwh, 0.0)
        mwl = jnp.where(mask, wwl, 0.0)
        mmin_hi = jnp.min(mwh)
        candj = mwh == mmin_hi
        mmin_lo = jnp.min(jnp.where(candj, mwl, jnp.inf))
        j = jnp.min(jnp.where(candj & (mwl == mmin_lo), iota, n + 1))
        wj = dsa.add((mmin_hi, mmin_lo), wi)
    else:
        mask = x[0] > 0.0
        wmin_hi = jnp.min(jnp.where(mask, w[0], jnp.inf))
        candj = mask & (w[0] == wmin_hi)
        wmin_lo = jnp.min(jnp.where(candj, w[1], jnp.inf))
        wj = (wmin_hi, wmin_lo)
        j = i

    sp_ds = dsa.mul(dsa.add_f32(wi, -m_f), inv_m)
    sn_ds = dsa.mul(dsa.add_f32(dsa.neg(wj), m_f), inv_m)
    sp = sp_ds[0] + sp_ds[1]
    sn = sn_ds[0] + sn_ds[1]
    Fk = -(ld[0] + ld[1])
    stop = (sp <= eps) & (sn <= eps)

    t_t = dsa.div(sp_ds, dsa.add_f32(wi, -1.0))
    if cfg.away:
        xj = (x[0][j], x[1][j])
        a1 = dsa.div(sn_ds, dsa.add_f32(wj, -1.0))
        a2 = dsa.div(xj, dsa.add_f32(dsa.neg(xj), 1.0))
        use_a1 = dsa.lt(a1, a2)
        t_a = dsa.where(use_a1, a1, a2)
        toward = sp >= sn
        v = jnp.where(toward, i, j)
        wv = dsa.where(toward, wi, wj)
        tau = dsa.where(toward, t_t, dsa.neg(t_a))
        # boundary away step (t = x_j/(1-x_j)) DROPS coordinate j: zero it
        # EXACTLY.  The DS residual of x_j(1+t) - t is ~1e-10 — large
        # enough to leave ghost coordinates near the reference's 1e-8
        # support threshold whose mask-flapping sustains a ~5e-8 slack
        # limit cycle (observed; the reference's f64 residual is ~1e-17
        # and harmless, D_opt_alg.py:173-175).
        dropped = jnp.logical_not(toward) & jnp.logical_not(use_a1)
    else:
        v = i
        wv = wi
        tau = t_t
        dropped = jnp.asarray(False)

    wv_m1 = dsa.add_f32(wv, -1.0)
    c_ = dsa.div(tau, dsa.add_f32(dsa.mul(tau, wv_m1), 1.0))
    one_m_tau = dsa.add_f32(dsa.neg(tau), 1.0)
    r_tau = dsa.div((jnp.float32(1.0), jnp.float32(0.0)), one_m_tau)

    Vi = (lax.dynamic_index_in_dim(Vds[0], v, axis=1, keepdims=False),
          lax.dynamic_index_in_dim(Vds[1], v, axis=1, keepdims=False))
    # DS contractions via ops/double_single.contract (f32 cross terms +
    # sloppy partial sums), ~1e-13 accurate
    HVi = dsa.contract(Vi, H, 1)
    if "V_packed" in prob:
        # Big-n path: the O(mn) u = (Hv)^T V contraction through ONE
        # packed int8 matmul with exact int32 accumulation + DS combine
        # (ops/mixed_precision.ozaki_gemv_packed_ds), ~1e-12 relative.
        from ..ops import mixed_precision as mp

        levels = prob["V_packed"].shape[-1] // n
        u = mp.ozaki_gemv_packed_ds(HVi, prob["V_packed"], prob["sV_u"],
                                    levels, levels_a=levels)
    else:
        u = dsa.contract(HVi, Vds, 0)
    # consistency pin u[v] = w[v] (see _dopt_step)
    u = (u[0].at[v].set(wv[0]), u[1].at[v].set(wv[1]))

    w_new = dsa.mul(dsa.sub(w, dsa.mul(c_, dsa.sq(u))), r_tau)
    outer = dsa.mul((HVi[0][:, None], HVi[1][:, None]),
                    (HVi[0][None, :], HVi[1][None, :]))
    H_new = dsa.mul(dsa.sub(H, dsa.mul(c_, outer)), r_tau)
    xs = dsa.mul(x, one_m_tau)
    # DS addition at the stepped coordinate (adding the hi/lo planes
    # separately would drop the cross terms — a full f32-ulp error)
    xv_new = dsa.add((xs[0][v], xs[1][v]), tau)
    zero = jnp.float32(0.0)
    xv_hi = jnp.where(dropped, zero, xv_new[0])
    xv_lo = jnp.where(dropped, zero, xv_new[1])
    x_new = (xs[0].at[v].set(xv_hi), xs[1].at[v].set(xv_lo))

    tau_f = tau[0] + tau[1]
    twv = dsa.mul(tau, wv_m1)
    inc = (m_f - 1.0) * jnp.log1p(-tau_f) + jnp.log1p(twv[0] + twv[1])
    ld_new = dsa.add_f32(ld, inc)

    # the reference breaks BEFORE applying the update (D_opt_alg.py:72-73)
    keep = lambda new, old: jnp.where(stop, old, new)  # noqa: E731
    c2 = dict(done=c["done"],
              x_hi=keep(x_new[0], x[0]), x_lo=keep(x_new[1], x[1]),
              w_hi=keep(w_new[0], w[0]), w_lo=keep(w_new[1], w[1]),
              H_hi=keep(H_new[0], H[0]), H_lo=keep(H_new[1], H[1]),
              ld_hi=keep(ld_new[0], ld[0]), ld_lo=keep(ld_new[1], ld[1]))
    # F to full DS resolution: hi plane + the residual after the f32 sum
    # (host reconstruction adds them back in f64 — _run_dopt_ds)
    F_lo = (-ld[0] - Fk) + (-ld[1])
    return c2, dict(F=Fk, F_lo=F_lo, SP=sp, SN=sn, _stop=stop)


def _ds_split_np(a):
    import numpy as _np

    hi = _np.asarray(a, _np.float32)
    lo = _np.asarray(_np.asarray(a, _np.float64) - hi.astype(_np.float64),
                     _np.float32)
    return hi, lo


def _inv_m_ds_np(m):
    """1/m as a DS pair of f32 numpy scalars (lo computed in f64 — NumPy 2
    weak promotion would evaluate python_float - np.float32 in f32)."""
    import numpy as _np

    hi = _np.float32(1.0 / m)
    lo = _np.float32(1.0 / m - float(hi))
    return hi, lo


def _dopt_factorize_ds(V64, x64):
    """Fresh DS state from a host float64 factorization (numpy — exact
    regardless of jax_enable_x64)."""
    import numpy as _np

    m = V64.shape[0]
    VXVT = (V64 * x64) @ V64.T
    L = _np.linalg.cholesky(VXVT)
    logdet = 2.0 * _np.sum(_np.log(_np.diag(L)))
    Linv = _np.linalg.solve(L, _np.eye(m))
    H = Linv.T @ Linv
    W = Linv @ V64
    w = _np.einsum("ij,ij->j", W, W)
    return H, w, logdet


_U_MODES = ("auto", "exact", "mixed", "ds")


def _check_u_mode(u_mode):
    if u_mode not in _U_MODES:
        raise ValueError(f"unknown u_mode {u_mode!r}; expected one of "
                         f"{_U_MODES}")


def _dopt_problem(V, eps, u_mode):
    """Build the traced problem pytree + static cfg ("auto" is "exact")."""
    _check_u_mode(u_mode)
    prob = dict(V=V, eps=jnp.asarray(eps, V.dtype))
    if u_mode == "mixed":
        from ..ops.mixed_precision import digit_split_matrix

        V_digits, sV = digit_split_matrix(V, levels=7)
        prob["V_digits"] = V_digits
        prob["sV"] = sV
    return prob, _DOptCfg(away=False, mixed=(u_mode == "mixed"))


def _make_dopt_step(V, eps, *, away, u_mode="auto"):
    """Closure-style step (compat for batched/scaling/dry-run callers):
    ``u_mode`` selects how the O(mn) rank-1 w-update contraction
    u = (H v)^T V is computed:

    * "exact" (and "auto"): native dtype dot (bit-matches the reference
      trajectory on CPU);
    * "mixed": Ozaki-style int8 digit contraction with exact int32
      accumulation (ops/mixed_precision.py) — ~3e-12 relative error.
    """
    prob, cfg = _dopt_problem(V, eps, u_mode)
    cfg = _DOptCfg(away=away, mixed=cfg.mixed)

    def step(c, k):
        return _dopt_step(cfg, prob, c, k)

    return step


def _warn_if_downcast(V_in, V_dev):
    import numpy as np

    if (getattr(V_in, "dtype", None) == np.float64
            and V_dev.dtype == jnp.float32):
        import warnings

        warnings.warn(
            "float64 design matrix silently downcast to float32 because "
            "jax_enable_x64 is off; tight slack tolerances (<1e-4) are "
            "unreachable in float32. Enable x64 "
            "(jax.config.update('jax_enable_x64', True)) for "
            "reference-accuracy solves.",
            stacklevel=3,
        )


def _run_dopt_ds(V, x0, eps, maxitrs, verbose, verbskip, chunk, away,
                 refresh_every, header, checkpoint=None):
    """Double-single engine: f64-accurate trajectories from pure f32 XLA
    (see ``_dopt_step_ds``).  Host-side f64 factorization for the initial
    state and optional periodic refresh."""
    import numpy as onp

    V64 = onp.asarray(V, onp.float64)
    x64 = onp.asarray(x0, onp.float64)
    H, w, logdet = _dopt_factorize_ds(V64, x64)
    Vh, Vl = _ds_split_np(V64)
    xh, xl = _ds_split_np(x64)
    wh, wl = _ds_split_np(w)
    Hh, Hl = _ds_split_np(H)
    ldh, ldl = _ds_split_np(onp.float64(logdet))
    imh, iml = _inv_m_ds_np(V64.shape[0])
    prob = dict(V_hi=jnp.asarray(Vh), V_lo=jnp.asarray(Vl),
                eps=jnp.asarray(eps, jnp.float32),
                inv_m_hi=jnp.asarray(imh), inv_m_lo=jnp.asarray(iml))
    if V64.size >= _OZAKI_U_MIN_SIZE:
        # packed int8 digit planes of V for the big-n u-update path
        # (see _dopt_step_ds); split on HOST so no x64 is required
        from ..ops import mixed_precision as mp

        dV, sV = mp.digit_split_matrix_np(V64, _OZAKI_U_LEVELS)
        prob["V_packed"] = mp.pack_digit_planes(jnp.asarray(dV))
        prob["sV_u"] = jnp.asarray(sV, jnp.float32)
    carry = dict(done=jnp.asarray(False),
                 x_hi=jnp.asarray(xh), x_lo=jnp.asarray(xl),
                 w_hi=jnp.asarray(wh), w_lo=jnp.asarray(wl),
                 H_hi=jnp.asarray(Hh), H_lo=jnp.asarray(Hl),
                 ld_hi=jnp.asarray(ldh), ld_lo=jnp.asarray(ldl))
    cfg = _DOptCfg(away=away, mixed=False)

    between = None
    if refresh_every:
        last_refresh = [0]

        def between(c, k_next):
            if k_next - last_refresh[0] >= refresh_every:
                last_refresh[0] = k_next
                x64c = (onp.asarray(c["x_hi"], onp.float64)
                        + onp.asarray(c["x_lo"], onp.float64))
                Hn, wn, ldn = _dopt_factorize_ds(V64, x64c)
                c = dict(c)
                for name, val in (("w", wn), ("H", Hn),
                                  ("ld", onp.float64(ldn))):
                    hi, lo = _ds_split_np(val)
                    c[f"{name}_hi"] = jnp.asarray(hi)
                    c[f"{name}_lo"] = jnp.asarray(lo)
            return c

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:6.1f}".format(
            k, r["F"], r["SP"], r["SN"], t))

    carry, hist, T = run_driver(_dopt_step_ds, carry, maxitrs,
                                verbose=verbose, verbskip=verbskip,
                                header=header, print_row=row, chunk=chunk,
                                checkpoint=checkpoint,
                                between_chunks=between, problem=prob,
                                cfg=cfg)
    x_out = (onp.asarray(carry["x_hi"], onp.float64)
             + onp.asarray(carry["x_lo"], onp.float64))
    F_out = (onp.asarray(hist["F"], onp.float64)
             + onp.asarray(hist["F_lo"], onp.float64))
    return x_out, F_out, hist["SP"], hist["SN"], T


def _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk, away,
              refresh_every, header, checkpoint=None, u_mode="auto"):
    _check_u_mode(u_mode)
    if u_mode == "ds":
        return _run_dopt_ds(V, x0, eps, maxitrs, verbose, verbskip, chunk,
                            away, refresh_every, header,
                            checkpoint=checkpoint)
    V_in = V
    V = jnp.asarray(V)
    _warn_if_downcast(V_in, V)
    x0 = jnp.asarray(x0, V.dtype)
    H, w, logdet = _dopt_factorize(V, x0)
    prob, cfg = _dopt_problem(V, eps, u_mode)
    cfg = _DOptCfg(away=away, mixed=cfg.mixed)
    carry = dict(done=jnp.asarray(False), x=x0, w=w, H=H, logdet=logdet)

    between = None
    if refresh_every:
        # Refactorize at chunk boundaries (instead of a lax.cond inside the
        # scan, whose large carry would thread through both branches every
        # iteration).  One extra O(m^2 n) dispatch per crossed refresh
        # boundary, zero per-iteration cost.
        @jax.jit
        def _refresh(c):
            Hn, wn, ldn = _dopt_factorize(V, c["x"])
            return dict(done=c["done"], x=c["x"], w=wn, H=Hn, logdet=ldn)

        last_refresh = [0]

        def between(c, k_next):
            if k_next - last_refresh[0] >= refresh_every:
                last_refresh[0] = k_next
                return _refresh(c)
            return c

    def row(k, r, t):
        print("{0:6d}  {1:10.3e}  {2:10.3e}  {3:10.3e}  {4:6.1f}".format(
            k, r["F"], r["SP"], r["SN"], t))

    carry, hist, T = run_driver(_dopt_step, carry, maxitrs, verbose=verbose,
                                verbskip=verbskip, header=header,
                                print_row=row, chunk=chunk, checkpoint=checkpoint,
                                between_chunks=between, problem=prob, cfg=cfg)
    return carry["x"], hist["F"], hist["SP"], hist["SN"], T


def D_opt_FW(V, x0, eps, maxitrs, verbose=True, verbskip=1, chunk=None,
             refresh_every=0, checkpoint=None, u_mode="auto"):
    """Khachiyan Frank-Wolfe for D-optimal design on the simplex with rank-1
    Sherman-Morrison updates of H = (V diag(x) V^T)^{-1} and w = -gradient
    (reference: D_opt_alg.py:9-88).  Returns ``(x, F, SP, SN, T)``.

    ``u_mode`` selects the engine/precision: "exact" (native dtype; what
    "auto" runs), "mixed" (int8-Ozaki w-updates for f64 inputs) or "ds"
    (double-single scan: f64-grade trajectories from pure f32).  Any other
    value raises ``ValueError``.
    """
    header = ("\nSolving D-opt design problem using Frank-Wolfe method\n"
              "     k      F(x)     pos_slack   neg_slack    time")
    return _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk,
                     away=False, refresh_every=refresh_every, header=header,
                     checkpoint=checkpoint, u_mode=u_mode)


def D_opt_FW_away(V, x0, eps, maxitrs, verbose=True, verbskip=1, chunk=None,
                  refresh_every=0, checkpoint=None, u_mode="auto"):
    """Wolfe-Atwood method: Frank-Wolfe with away steps for D-optimal design
    (linearly convergent; reference: D_opt_alg.py:91-185).
    Returns ``(x, F, SP, SN, T)``.  ``u_mode``: see ``D_opt_FW``.
    """
    header = ("\nSolving D-opt design problem using Frank-Wolfe method with away steps\n"
              "     k      F(x)     pos_slack   neg_slack    time")
    return _run_dopt(V, x0, eps, maxitrs, verbose, verbskip, chunk,
                     away=True, refresh_every=refresh_every, header=header,
                     checkpoint=checkpoint, u_mode=u_mode)
