"""Jittable root-finding kernels shared by the Bregman prox maps.

These replace the reference's data-dependent Python loops
(/root/reference/accbpg/functions.py:326-356 bisection+Newton simplex
multiplier, :522-544 Cardano cubic) with fixed-bound ``lax.while_loop``
equivalents that compile once under ``jit`` and run entirely on device.
All reductions are plain ``jnp.sum`` so that under a sharded input XLA
lowers them to ``psum`` collectives automatically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def solve_cubic(c, beta):
    """Unique real root of ``z**3 - beta*z**2 = c`` for ``c > 0``.

    Closed-form (Cardano).  Used by the SumOf2nd4thPowers prox family
    (reference: functions.py:522-544).  Fully elementwise / scalar — safe
    inside jit and vmap.
    """
    c = jnp.asarray(c)
    beta = jnp.asarray(beta, dtype=c.dtype)
    z = beta / 3.0
    beta3 = beta**3
    delta = c**2 + 4.0 * beta3 * c / 27.0
    sq_delta = jnp.sqrt(delta)
    b = 0.5 * c + beta3 / 27.0
    z = z + jnp.cbrt(b + 0.5 * sq_delta)
    z = z + jnp.cbrt(b - 0.5 * sq_delta)
    # Cardano suffers cancellation when b ~ sq_delta/2; two Newton polish
    # steps restore near-machine accuracy at negligible cost.
    for _ in range(2):
        num = z * z * (z - beta) - c
        den = z * (3.0 * z - 2.0 * beta)
        z = z - num / jnp.where(den == 0, jnp.ones_like(den), den)
    return z


def solve_cubic_ds(c, beta):
    """DOUBLE-SINGLE root of ``z**3 - beta*z**2 = c`` (c, beta DS pairs).

    Seeds with the f32 Cardano closed form on the hi planes, then polishes
    with 3 Newton steps whose RESIDUAL is evaluated in exact DS arithmetic
    (the correction divides by an f32 derivative — the correction itself
    is ~1e-8-relative, so an f32 denominator leaves ~1e-16 relative error
    in z).  This is the f64-grade prox root for the SumOf2nd4thPowers
    kernel family without any f64 ops (reference cubic:
    functions.py:522-544).
    """
    from . import double_single as dsl

    z0 = solve_cubic(c[0], beta[0])
    z = dsl.from_f32(z0)
    for _ in range(3):
        zmb = dsl.sub(z, beta)
        num = dsl.sub(dsl.mul(dsl.sq(z), zmb), c)          # z^2(z-b) - c
        den = z[0] * (3.0 * z[0] - 2.0 * beta[0])
        inv_den = jnp.where(den == 0, jnp.zeros_like(den), 1.0 / den)
        z = dsl.sub(z, (num[0] * inv_den, num[1] * inv_den))
    return z


def simplex_inv_multiplier(gg, eps, max_newton=100, c_warm=None):
    """Solve ``sum_i 1/(gg_i + c) = 1`` for the unique ``c > -min(gg)``.

    This is the KKT multiplier of ``argmin_{x in simplex} <g,x> - L*sum log x``
    whose solution is ``x = 1/(gg + c)`` with ``gg = g/L`` (Burg-entropy
    simplex prox; reference: functions.py:336-356).

    Same monotone from-below Newton as the reference (functions.py:344-355),
    restructured for latency — the prox is called inside every driver
    iteration and each sequential reduction pass over ``gg`` is a launch:

    * The reference's bisection phase (:337-341) never iterates: at its
      start ``c0 = cmin + 1`` the minimum coordinate contributes exactly
      ``1/(gg_min + cmin + 1) = 1`` and every other term is positive, so
      ``resid(c0) >= 0`` already.  But c0 can sit ~n below the root, which
      costs Newton ~log2(root - cmin) doubling passes on the hyperbolic
      tail.  Instead start from the AM-HM (Jensen) point
      ``c_hm = n - mean(gg)``: for positive t_i = gg_i + c,
      ``sum 1/t_i >= n^2 / sum t_i``, so ``resid(c_hm) >= 0`` ALWAYS —
      a certified from-below start that is first-order exact when the
      spread of ``gg`` is small.  We take ``max(c0, c_hm)`` (both are
      below the root; max keeps the better one and guards the degenerate
      ``c_hm <= cmin`` case).  Measured: ~15-20 Newton passes -> ~4-6.
    * Each Newton iteration is ONE fused reduction pass: the carry holds
      (c, resid(c), resid'(c)) and the body evaluates both sums of the
      NEXT point from a single ``1/(gg + c_new)`` — instead of separate
      derivative and residual passes.  Under a sharded ``gg`` the fused
      pass is a single psum of the stacked partial sums.

    Returns the multiplier ``c`` (scalar).
    """
    gg = jnp.asarray(gg)
    dtype = gg.dtype
    eps = jnp.asarray(eps, dtype)

    cmin = -jnp.min(gg)  # ensures min(gg + c) >= 0 for c >= cmin

    # Padded / fixed-at-zero coordinates enter as gg = +inf (their
    # 1/(gg + c) contributes exactly 0; see parallel/mesh._pad_cols) —
    # the warm start must average over the FINITE coordinates only.
    finite = jnp.isfinite(gg)
    n_eff = jnp.sum(finite.astype(dtype))
    gg_sum = jnp.sum(jnp.where(finite, gg, jnp.zeros_like(gg)))

    def resid_and_deriv(c):
        r = 1.0 / (gg + c)
        return jnp.sum(r) - 1.0, -jnp.sum(r * r)

    c0 = cmin + jnp.asarray(1.0, dtype)
    c_hm = n_eff - gg_sum / n_eff
    c = jnp.maximum(c0, c_hm)
    if c_warm is not None:
        # Warm start from a carried previous multiplier (stateful
        # drivers): both c0 and c_hm are certified below the root, and a
        # stale c above the root self-corrects — for a convex decreasing
        # residual the first Newton step from the f < 0 side lands below
        # the root, monotone from there.  Guards: the domain (c > cmin),
        # non-finite carries, and the certified root upper bound
        # c* <= cmin + n (from 1 = sum 1/(gg+c*) <= n/(gg_min + c*)) so a
        # wildly stale carry is discarded rather than risking a Newton
        # jump out of the domain from the flat far tail.
        cw = jnp.asarray(c_warm, dtype)
        ok = jnp.isfinite(cw) & (cw > cmin) & (cw <= cmin + n_eff)
        c = jnp.where(ok, jnp.maximum(c, cw), c)

    # Newton on resid(c); monotone decreasing & convex in c, so from
    # resid(c) >= 0 it converges from below (reference :344-355).
    def nw_cond(state):
        c, fc, fpc, it = state
        return jnp.logical_and(jnp.abs(fc) > eps, it < max_newton)

    def nw_body(state):
        c, fc, fpc, it = state
        c_new = c - fc / fpc
        # Domain safeguard: from any below-root start the updates increase
        # monotonically and this never fires (bitwise no-op); a from-above
        # warm start overshooting past cmin bisects back into the domain.
        c_new = jnp.where(c_new > cmin, c_new, 0.5 * (c + cmin))
        # Guard: if the update underflows to no movement, freeze (matches
        # the reference's early break at functions.py:348-349).
        frozen = c_new == c
        fc_new, fpc_new = resid_and_deriv(c_new)
        fc_new = jnp.where(frozen, jnp.zeros_like(fc), fc_new)
        return (c_new, fc_new, fpc_new, it + 1)

    fc0, fpc0 = resid_and_deriv(c)
    c, fc, fpc, _ = lax.while_loop(nw_cond, nw_body, (c, fc0, fpc0, 0))
    # Two unconditional polish steps: the |resid| <= eps exit can land just
    # under eps (the far-start Newton of the reference overshoots its last
    # quadratic step to ~machine residual instead); polishing restores that
    # landing quality — e.g. BPG monotone-descent checks at 1e-8 and
    # sharded-vs-single parity at 1e-10 need the prox exact to ~ulp, not
    # to eps.  Two fused passes, negligible next to the loop.
    for _ in range(2):
        c_new = c - fc / fpc
        frozen = c_new == c
        fc_new, fpc_new = resid_and_deriv(c_new)
        c = c_new
        fc = jnp.where(frozen, jnp.zeros_like(fc), fc_new)
        fpc = fpc_new
    return c


def simplex_inv_multiplier_ds(gg, eps, max_newton=100, c_warm=None):
    """``simplex_inv_multiplier`` in DOUBLE-SINGLE arithmetic: the Burg
    simplex KKT multiplier to ~1e-13 relative from pure f32 ops.

    Same structure as the f64 kernel above — certified from-below AM-HM
    warm start, fused Newton passes, domain safeguard, freeze guard, two
    unconditional polish steps — with every residual sum a DS pairwise
    fold, so a ``fast_gram="ds"`` driver's trajectory tracks the f64
    driver's decision-for-decision (the Newton exit tests compare at the
    same |resid| > eps thresholds on hi planes).  ``gg``/``c_warm`` are DS
    pairs; returns the DS multiplier."""
    from . import double_single as ds

    ggh = gg[0]
    dtype = ggh.dtype
    one = jnp.asarray(1.0, dtype)

    cmin = ds.neg(ds.min_along(gg, 0))
    finite = jnp.isfinite(ggh)
    n_eff = jnp.sum(finite.astype(dtype))
    gg_fin = ds.where(finite, gg, ds.from_f32(jnp.zeros_like(ggh)))
    gg_sum = ds.sum_along(gg_fin, 0)

    def resid_and_deriv(c):
        cb = (jnp.broadcast_to(c[0], ggh.shape),
              jnp.broadcast_to(c[1], ggh.shape))
        r = ds.div(ds.from_f32(jnp.ones_like(ggh)), ds.add(gg, cb))
        # ONE stacked fold for both sums (reduction chains dominate the
        # in-scan prox cost; see double_single.sum_many)
        s_r, s_r2 = ds.sum_many([r, ds.sq(r)])
        resid = ds.add_f32(s_r, -one)
        deriv = ds.neg(s_r2)
        return resid, deriv

    c0 = ds.add_f32(cmin, one)
    c_hm = ds.sub(ds.from_f32(n_eff), ds.mul_f32(gg_sum, 1.0 / n_eff))
    c = ds.where(ds.lt(c0, c_hm), c_hm, c0)
    if c_warm is not None:
        cw = c_warm
        ok = (jnp.isfinite(cw[0]) & ds.lt(cmin, cw)
              & ds.le(cw, ds.add_f32(cmin, n_eff)))
        c = ds.where(ok & ds.lt(c, cw), cw, c)

    def nw_cond(state):
        c, fc, fpc, it = state
        return jnp.logical_and(jnp.abs(fc[0]) > eps, it < max_newton)

    def nw_body(state):
        c, fc, fpc, it = state
        c_new = ds.sub(c, ds.div(fc, fpc))
        bis = ds.mul_f32(ds.add(c, cmin), 0.5)
        c_new = ds.where(ds.lt(cmin, c_new), c_new, bis)
        frozen = (c_new[0] == c[0]) & (c_new[1] == c[1])
        fc_new, fpc_new = resid_and_deriv(c_new)
        fc_new = ds.where(frozen, ds.from_f32(jnp.zeros_like(fc[0])), fc_new)
        return (c_new, fc_new, fpc_new, it + 1)

    fc0, fpc0 = resid_and_deriv(c)
    c, fc, fpc, _ = lax.while_loop(nw_cond, nw_body, (c, fc0, fpc0, 0))
    for _ in range(2):
        c_new = ds.sub(c, ds.div(fc, fpc))
        frozen = (c_new[0] == c[0]) & (c_new[1] == c[1])
        fc_new, fpc_new = resid_and_deriv(c_new)
        c = c_new
        fc = ds.where(frozen, ds.from_f32(jnp.zeros_like(fc[0])), fc_new)
        fpc = fpc_new
    return c


def project_simplex_burg(y, eps=1e-8):
    """Map ``y`` to ``x = 1/(y + c)`` with ``sum(x) = 1`` (Burg-Newton map).

    The reference uses this both for the Burg simplex prox and as the
    "simplex projection" of SumOf2nd4thPowersOnSimplex
    (functions.py:590-614).  Shape-preserving; works on matrices by
    flattening.
    """
    shape = y.shape
    y_flat = y.reshape(-1)
    c = simplex_inv_multiplier(y_flat, eps)
    return (1.0 / (y_flat + c)).reshape(shape)


def bisect_monotone(fn, lo, hi, iters=64):
    """Scalar bisection for an increasing function on [lo, hi].

    Returns the (approximate) root of ``fn``; if ``fn`` has no sign change the
    result clamps to an endpoint.  Fixed iteration count => jittable.
    """
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi, dtype=lo.dtype)

    def body(_, state):
        lo_, hi_ = state
        mid = 0.5 * (lo_ + hi_)
        go_right = fn(mid) < 0
        return (jnp.where(go_right, mid, lo_), jnp.where(go_right, hi_, mid))

    lo, hi = lax.fori_loop(0, iters, body, (lo, hi))
    return 0.5 * (lo + hi)


def newton_scalar(fn, dfn, x0, tol, max_iters=100):
    """Bounded scalar Newton iteration (jittable)."""

    def cond(state):
        x, fx, it = state
        return jnp.logical_and(jnp.abs(fx) > tol, it < max_iters)

    def body(state):
        x, fx, it = state
        x_new = x - fx / dfn(x)
        return (x_new, fn(x_new), it + 1)

    x0 = jnp.asarray(x0)
    x, _, _ = lax.while_loop(cond, body, (x0, fn(x0), 0))
    return x
