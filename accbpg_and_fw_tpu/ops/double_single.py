"""Double-single (two-float32) arithmetic: ~f64 accuracy from f32 hardware.

Some accelerators have no float64 path, and on others f64 runs at a fraction
of the f32 rate.  This module represents a value as an UNEVALUATED SUM of two
float32s ``(hi, lo)`` with ``|lo| <= ulp(hi)/2``, giving ~49 bits of
significand (~1e-14 relative) from pure f32 adds/multiplies, via the
classic error-free transformations (Dekker 1971, Knuth TAOCP v2 §4.2.2,
and the double-double arithmetic of Hida/Li/Bailey's QD library):

* ``two_sum``   — exact rounding error of a f32 addition (6 flops);
* ``split`` / ``two_prod`` — Veltkamp splitting + Dekker product: the
  exact rounding error of a f32 multiplication without FMA (17 flops);
* ``add/mul/div`` etc. compose these into renormalized (hi, lo) results.

All functions are elementwise over arbitrary jnp array shapes (adds and
multiplies only — no matmuls, no transcendentals).  A DS number is a plain
``(hi, lo)`` tuple of same-shape f32 arrays.

Correctness requires IEEE-754 round-to-nearest f32 add/mul and that the
compiler does not algebraically rewrite the error terms.  XLA preserves
float semantics (it may fuse ``a*b - p`` into an FMA, which makes the
Dekker error MORE exact, never less).  Verified against f64 on the CPU by
tests/test_double_single.py, and in true f32 on an H100 by the engines
phase of chip_smoke.py (DS FW-away certifies slack 1e-8 and matches the
f64 engine's iterate to 5e-11).

No reference counterpart: the reference is f64 numpy throughout
(accbpg/D_opt_alg.py operates on float64 arrays); this module gives that
accuracy from f32 arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp constant for float32 (24-bit mantissa)

# -- XLA:CPU escape hatch -----------------------------------------------------
#
# XLA:CPU in this environment MISCOMPUTES composed error-free-transform
# graphs (root-caused 2026-08-19): a DS multiply with any broadcast operand
# returns f32-grade lo planes (measured 5.9e-8 relative vs 1.05e-14 for the
# same values as materialized inputs), FLAKILY — identical code has both
# passed and failed minutes apart; some composed graphs also execute as
# infinite loops (see tests/conftest.py).  The optimized HLO, the
# post-optimization MLIR kernels and the buffer assignment were all
# verified faithful Dekker, so the fault is below the IR we can influence;
# no XLA flag tried (fusion emitters off, excess precision off, parallelism
# pins, optimization_barrier placements) changes the values.  The GPU
# lowering of the same graphs is correct to ~1e-14 (measured on an H100).
#
# Escape hatch: on the CPU backend (the TEST venue — conftest enables x64)
# the EFT primitives are backed by native f64 instead: each returns the
# same (hi, lo) DS pair, computed as one f64 op + exact split.  That is
# VALID double-single arithmetic of at-least-DS accuracy, so every driver,
# prox, series and reduction exercises identical logic; the true f32 EFT
# path is what compiles for the GPU, where it is measured correct.  Override
# with F64_FALLBACK[0] = True/False (None = auto by backend).

F64_FALLBACK = [None]


def _use_f64():
    if F64_FALLBACK[0] is not None:
        return F64_FALLBACK[0]
    import jax as _jax

    return (_jax.default_backend() == "cpu"
            and bool(_jax.config.jax_enable_x64))


def _split_f64(v64):
    hi = v64.astype(jnp.float32)
    return hi, (v64 - hi.astype(jnp.float64)).astype(jnp.float32)


# -- error-free transformations (raw f32) -----------------------------------
#
# HAZARD — never bake DS values into a jit as compile-time CONSTANTS.
# XLA's constant folder evaluates fully-constant subgraphs with
# real-arithmetic simplifications (t - (t - a) -> a; s - a -> b for
# s = a + b), which nullifies exactly the cancellations these transforms
# are made of: a DS product of two jit-time constants was measured to come
# back with its error term folded to 0 (f32 accuracy), while the SAME
# values passed as runtime arguments were exact — and optimization_barrier
# does NOT protect the constant path.  Thread every DS quantity (including
# precomputed constants like 1/m) through the jit as an ARGUMENT;
# tests/test_double_single.py::test_runtime_args_stay_exact guards the
# argument path.


def _bc2(a, b):
    """Materialize broadcasts BEFORE an error-free transform.

    HAZARD (root-caused 2026-08-19): feeding mixed-shape operands to the
    EFTs and letting each binary op broadcast implicitly lets XLA's
    algebraic simplifier rewrite the cancellation patterns across the
    broadcasts — measured: ``mul((30,200), (200,))`` came back 5.9e-8
    relative (f32 grade) while the SAME values pre-broadcast measured
    1.05e-14, on XLA:CPU with and without fusion emitters.  This silently
    degraded every DS product with a broadcast operand (the mixed oracle's
    ``W = V diag(x)`` included — its Gram measured 4.3e-9 instead of the
    intended ~1e-13).  Explicit ``broadcast_to`` keeps every EFT
    intermediate on one shape and the rewrites stop firing."""
    sa, sb = jnp.shape(a), jnp.shape(b)
    if sa == sb:
        return a, b
    sh = jnp.broadcast_shapes(sa, sb)
    if sa != sh:
        a = jnp.broadcast_to(a, sh)
    if sb != sh:
        b = jnp.broadcast_to(b, sh)
    return a, b


def two_sum(a, b):
    """s + err == a + b exactly, s = fl(a + b) (Knuth)."""
    a, b = _bc2(a, b)
    if _use_f64():
        return _split_f64(jnp.asarray(a, jnp.float64)
                          + jnp.asarray(b, jnp.float64))
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """two_sum assuming |a| >= |b| (3 flops)."""
    a, b = _bc2(a, b)
    if _use_f64():
        return _split_f64(jnp.asarray(a, jnp.float64)
                          + jnp.asarray(b, jnp.float64))
    s = a + b
    err = b - (s - a)
    return s, err


def split(a):
    """a == hi + lo with hi, lo each fitting in 12 significand bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + err == a * b exactly, p = fl(a * b) (Dekker).

    17 flops: XLA exposes no FMA primitive and folds a written-out
    ``a*b - p`` to exactly 0 (probed incl. optimization_barrier
    variants), so the Veltkamp split is mandatory."""
    a, b = _bc2(a, b)
    if _use_f64():
        # exact: a f32xf32 product fits in f64 (48 <= 53 bits), and the
        # hi/lo split returns EXACTLY Dekker's (p, err) pair
        return _split_f64(jnp.asarray(a, jnp.float64)
                          * jnp.asarray(b, jnp.float64))
    p = a * b
    ahi, alo = split(a)
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def two_prod_presplit(a, ahi, alo, b):
    """two_prod with a's Veltkamp split precomputed (13 flops vs 17).

    For products of a broadcast 1-D operand against a 2-D array, hoisting
    the broadcast side's split out of the 2-D elementwise work saves
    4 flops/element.  The split planes must broadcast alongside ``a``
    (see ``_bc2``)."""
    a, b = _bc2(a, b)
    if _use_f64():
        return _split_f64(jnp.asarray(a, jnp.float64)
                          * jnp.asarray(b, jnp.float64))
    ahi, _ = _bc2(ahi, b)
    alo, _ = _bc2(alo, b)
    p = a * b
    bhi, blo = split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


# -- DS constructors ---------------------------------------------------------

def from_f32(a):
    a = jnp.asarray(a, jnp.float32)
    return a, jnp.zeros_like(a)


def from_f64(a):
    """Split a f64 array into a DS pair (exact to ~2^-49).

    Host inputs (numpy arrays, Python floats) are split in NUMPY, which is
    immune to the x64 footgun: with ``jax_enable_x64`` off, ``jnp.asarray``
    silently downcasts f64 to f32 and the lo plane would collapse to exact
    zeros — the caller would hold plain f32 while believing it has ~49
    significand bits.  A device/traced input must already be float64
    (requires x64); anything else raises instead of degrading silently.
    """
    import numpy as np

    if not isinstance(a, jax.Array):
        a64 = np.asarray(a, np.float64)
        hi = np.asarray(a64, np.float32)
        lo = np.asarray(a64 - hi.astype(np.float64), np.float32)
        return jnp.asarray(hi), jnp.asarray(lo)
    if a.dtype != jnp.float64:
        raise ValueError(
            f"from_f64 needs a float64 input, got {a.dtype} — with "
            "jax_enable_x64 off the lo plane would be exactly 0 (plain f32 "
            "accuracy). Pass the numpy array directly, enable x64, or use "
            "from_f32 for genuine f32 values.")
    hi = jnp.asarray(a, jnp.float32)
    lo = jnp.asarray(a - hi.astype(a.dtype), jnp.float32)
    return hi, lo


def to_f64(x):
    return x[0].astype(jnp.float64) + x[1].astype(jnp.float64)


# -- DS arithmetic -----------------------------------------------------------

def neg(x):
    return -x[0], -x[1]


def add(x, y):
    """DS + DS (accurate variant, QD ieee_add)."""
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    s2 = s2 + t2
    return quick_two_sum(s1, s2)


def add_sloppy(x, y):
    """DS + DS, 'sloppy' variant (Dekker add2: 7 flops, depth 4).  Error
    bound holds when the terms do not catastrophically cancel — exactly the
    case for reduction-tree partial sums; use `add` for general operands."""
    s, e = two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    return quick_two_sum(s, e)


def add_f32(x, b):
    """DS + f32."""
    s1, s2 = two_sum(x[0], b)
    s2 = s2 + x[1]
    return quick_two_sum(s1, s2)


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """DS * DS."""
    p1, p2 = two_prod(x[0], y[0])
    p2 = p2 + (x[0] * y[1] + x[1] * y[0])
    return quick_two_sum(p1, p2)


def mul_f32(x, b):
    """DS * f32."""
    p1, p2 = two_prod(x[0], b)
    p2 = p2 + x[1] * b
    return quick_two_sum(p1, p2)


def div(x, y):
    """DS / DS (long division, 3 quotient terms)."""
    q1 = x[0] / y[0]
    r = sub(x, mul_f32(y, q1))
    q2 = r[0] / y[0]
    r = sub(r, mul_f32(y, q2))
    q3 = r[0] / y[0]
    q1, q2 = quick_two_sum(q1, q2)
    return add((q1, q2), from_f32(q3))


def sq(x):
    """DS squared (slightly cheaper than mul(x, x))."""
    p1, p2 = two_prod(x[0], x[0])
    p2 = p2 + 2.0 * (x[0] * x[1])
    return quick_two_sum(p1, p2)


# -- reductions / selection --------------------------------------------------

def sum_along(x, axis, keepdims=False, sloppy=False):
    """DS sum along an axis via pairwise halving of DS adds.

    Summing hi and lo with jnp.sum would drop the error terms; folding
    pairwise with DS adds keeps ~49-bit accuracy at O(log n) depth.  Uses
    only slice/concat/elementwise ops.  ``sloppy=True`` folds with
    `add_sloppy` (7 vs 11 flops/add) — the partial-sum error bound that
    justifies it holds for reduction trees, whose partial sums do not
    cancel catastrophically.
    """
    from jax import lax as _lax

    fold = add_sloppy if sloppy else add
    hi, lo = x
    axis = axis % hi.ndim
    while hi.shape[axis] > 1:
        m = hi.shape[axis]
        half = m // 2
        a = (_lax.slice_in_dim(hi, 0, half, axis=axis),
             _lax.slice_in_dim(lo, 0, half, axis=axis))
        b = (_lax.slice_in_dim(hi, half, 2 * half, axis=axis),
             _lax.slice_in_dim(lo, half, 2 * half, axis=axis))
        s = fold(a, b)
        if m % 2:
            s = (jnp.concatenate(
                    [s[0], _lax.slice_in_dim(hi, 2 * half, m, axis=axis)],
                    axis=axis),
                 jnp.concatenate(
                    [s[1], _lax.slice_in_dim(lo, 2 * half, m, axis=axis)],
                    axis=axis))
        hi, lo = s
    if not keepdims:
        hi = jnp.squeeze(hi, axis)
        lo = jnp.squeeze(lo, axis)
    return hi, lo


def sum_many(vs, sloppy=True):
    """Reduce SEVERAL equal-length DS 1-D vectors in ONE pairwise fold.

    In-scan, each DS reduction is a ~log2(n)-deep chain of shrinking
    vector ops whose dispatch latency dominates the solver iteration
    (measured: the DS BPG step spends most of its ~800 us in its ~15
    separate reductions at n=1000).  Stacking k vectors into a (k, n)
    fold pays ONE chain for all k.  Returns a list of k DS scalars."""
    hi = jnp.stack([v[0] for v in vs])
    lo = jnp.stack([v[1] for v in vs])
    sh, sl = sum_along((hi, lo), axis=1, sloppy=sloppy)
    return [(sh[i], sl[i]) for i in range(len(vs))]


def min_along(x, axis=0, keepdims=False):
    """DS minimum along an axis (pairwise fold with the DS total order)."""
    from jax import lax as _lax

    hi, lo = x
    while hi.shape[axis] > 1:
        m = hi.shape[axis]
        half = m // 2
        a = (_lax.slice_in_dim(hi, 0, half, axis=axis),
             _lax.slice_in_dim(lo, 0, half, axis=axis))
        b = (_lax.slice_in_dim(hi, half, 2 * half, axis=axis),
             _lax.slice_in_dim(lo, half, 2 * half, axis=axis))
        s = where(lt(a, b), a, b)
        if m % 2:
            s = (jnp.concatenate(
                    [s[0], _lax.slice_in_dim(hi, 2 * half, m, axis=axis)],
                    axis=axis),
                 jnp.concatenate(
                    [s[1], _lax.slice_in_dim(lo, 2 * half, m, axis=axis)],
                    axis=axis))
        hi, lo = s
    if not keepdims:
        hi = jnp.squeeze(hi, axis)
        lo = jnp.squeeze(lo, axis)
    return hi, lo


def contract(a, B, axis, keepdims=False):
    """DS contraction ``out[j] = sum_k a[k] * B[k, j]`` (``axis=0``) or
    ``out[i] = sum_k B[i, k] * a[k]`` (``axis=1``) for a DS 1-D vector
    ``a`` aligned with the contraction axis of DS 2-D ``B``.

    The D-opt rank-1-update hot path (u = (Hv)^T V and Hv = H v,
    algorithms/d_opt.py), cost-tuned to ~24 flops/element vs ~33 for
    ``mul`` + ``sum_along``:

    * ``a``'s Veltkamp split is HOISTED to the 1-D operand — computed once
      on (k,) instead of per 2-D element (`two_prod_presplit`);
    * the 2^-24-scale cross terms ``a_hi*B_lo + a_lo*B_hi`` fold into the
      error plane and all error/cross content accumulates through the
      reduction; partial sums use sloppy DS adds;
    * the ``a_lo*B_lo`` term (2^-48 relative) is dropped.

    Accuracy ~1e-13 relative, verified against f64 in
    tests/test_double_single.py.
    """
    ah, al = a
    Bh, Bl = B
    ahi, alo = split(ah)
    sh = [1, 1]
    sh[axis] = ah.shape[0]
    ah_b = ah.reshape(sh)
    p, err = two_prod_presplit(ah_b, ahi.reshape(sh), alo.reshape(sh), Bh)
    cross = ah_b * Bl + al.reshape(sh) * Bh
    return sum_along((p, err + cross), axis, keepdims=keepdims, sloppy=True)


def outer(col, row):
    """DS outer product ``col[:, None] * row[None, :]`` with both Veltkamp
    splits hoisted to the 1-D operands (~15 flops/element vs 22 for `mul`);
    the 2^-48-scale lo*lo term is dropped.  The D-opt rank-1 H-update hot
    path (algorithms/d_opt.py)."""
    ch, cl = col
    rh, rl = row
    if _use_f64():
        p, err = two_prod(ch[:, None], rh[None, :])
        cross = ch[:, None] * rl[None, :] + cl[:, None] * rh[None, :]
        return quick_two_sum(p, err + cross)
    chi, clo = split(ch)
    rhi, rlo = split(rh)
    shape = (ch.shape[0], rh.shape[0])
    # materialize the outer broadcasts BEFORE the EFT pattern (see _bc2)
    C, Chi, Clo = (jnp.broadcast_to(v[:, None], shape) for v in (ch, chi, clo))
    R, Rhi, Rlo = (jnp.broadcast_to(v[None, :], shape) for v in (rh, rhi, rlo))
    p = C * R
    err = ((Chi * Rhi - p) + Chi * Rlo + Clo * Rhi) + Clo * Rlo
    cross = C * rl[None, :] + cl[:, None] * R
    return quick_two_sum(p, err + cross)


def where(pred, x, y):
    return jnp.where(pred, x[0], y[0]), jnp.where(pred, x[1], y[1])


def lt(x, y):
    """DS < DS."""
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] < y[1]))


def le(x, y):
    """DS <= DS (NaN operands compare False, like IEEE)."""
    return (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))


def abs_(x):
    """|DS| (sign decided by the hi plane; at hi == 0 lo is the value)."""
    neg_mask = (x[0] < 0) | ((x[0] == 0) & (x[1] < 0))
    return where(neg_mask, neg(x), x)


def index(x, i):
    return x[0][i], x[1][i]


def dot(a, b, sloppy=True):
    """DS inner product of two DS 1-D vectors (driver acceptance tests)."""
    return sum_along(mul(a, b), 0, sloppy=sloppy)


def int32_to_ds(a):
    """Exact int32 -> DS conversion (|a| < 2^31).

    ``hi = fl(a)`` rounds to 24 bits; the residual ``a - int(hi)`` fits in
    ~7 bits at this magnitude and converts exactly.  Used by the DS Ozaki
    combines (mixed_precision.ozaki_gram_ds): int32 digit-diagonal
    accumulators routinely exceed the 2^24 exact-f32 range."""
    hi = a.astype(jnp.float32)
    lo = (a - hi.astype(jnp.int32)).astype(jnp.float32)
    return hi, lo


# -- DS transcendentals -------------------------------------------------------
#
# Classic double-double recipes (QD library): exp by argument reduction +
# Taylor with DS coefficients, log/sqrt by Newton refinement of the f32
# seed (one Newton step squares the seed's ~1e-7 relative error).  All
# constants are precomputed in HOST numpy (hi/lo literal f32 pairs), so no
# DS arithmetic between jit-time constants exists for XLA's constant
# folder to rewrite (see the module HAZARD note).

import math as _math

import numpy as _np

def _const_ds(v):
    hi = _np.float32(v)
    lo = _np.float32(_np.float64(v) - _np.float64(hi))
    return float(hi), float(lo)


_LN2 = _const_ds(0.6931471805599453094172321)
_EXP_TERMS = 14
_INV_FACT = [_const_ds(1.0 / _math.factorial(k))
             for k in range(2, _EXP_TERMS + 1)]


def exp(x):
    """DS exp (elementwise).  Accurate to ~2^-48 relative for |x| <~ 85.

    Argument reduction x = k*ln2 + r, |r| <= ln2/2; 14-term Taylor in DS
    (remainder (ln2/2)^15/15! ~ 1e-19); exact 2^k scaling."""
    k = jnp.round(x[0] / jnp.float32(_LN2[0]))
    kl = mul_f32((jnp.full_like(x[0], _LN2[0]),
                  jnp.full_like(x[0], _LN2[1])), k)
    r = sub(x, kl)
    # Horner with DS 1/j! coefficients
    p = (jnp.full_like(r[0], _INV_FACT[-1][0]),
         jnp.full_like(r[0], _INV_FACT[-1][1]))
    for c in reversed(_INV_FACT[:-1]):
        p = add(mul(p, r), (jnp.full_like(r[0], c[0]),
                            jnp.full_like(r[0], c[1])))
    p = add(mul(p, r), from_f32(jnp.ones_like(r[0])))  # 1 + r*(...)
    p = add(mul(p, r), from_f32(jnp.ones_like(r[0])))
    s = jnp.exp2(k)  # power of two: exact f32 scale
    return p[0] * s, p[1] * s


def log(x, newton_steps=2):
    """DS natural log (elementwise, x > 0).

    f32 seed + Newton y <- y + (x*exp(-y) - 1); each step squares the
    error (~1e-7 seed -> ~1e-14 after one step; 2 steps land at the DS
    noise floor)."""
    y = from_f32(jnp.log(x[0]))
    for _ in range(newton_steps):
        e = add_f32(mul(x, exp(neg(y))), jnp.float32(-1.0))
        y = add(y, e)
    return y


def sqrt(x):
    """DS square root (elementwise, x >= 0): f32 seed + one DS Newton
    step  y <- y + (x - y^2) / (2 y)  (error squares: ~1e-7 -> ~1e-14)."""
    y0 = jnp.sqrt(x[0])
    d = sub(x, sq(from_f32(y0)))
    inv2y = jnp.float32(0.5) / y0
    y = add_f32(mul_f32(d, inv2y), y0)
    # renormalize via quick_two_sum for a clean (hi, lo) pair
    return quick_two_sum(y[0], y[1])


_LOG1P_TERMS = 14


def half_sq_log_term(delta):
    """``(1 + delta) - log(1 + delta) - 1 = delta - log1p(delta)`` with full
    DS RELATIVE accuracy near delta = 0 (elementwise).

    This is the pointwise Burg/Shannon divergence kernel: the direct form
    ``r - log(r) - 1`` catastrophically cancels for r near 1 (the result is
    ~delta^2/2), so for |delta| < 0.05 we evaluate the series
    ``delta^2 * sum_{j>=0} (-delta)^j / (j+2)`` in DS (j <= 12 puts the
    truncation below 2^-49 of the leading term); the direct DS form covers
    the rest."""
    small = jnp.abs(delta[0]) < jnp.float32(0.05)
    # series branch (evaluated everywhere; cheap elementwise)
    c = _const_ds(1.0 / (_LOG1P_TERMS + 2))
    p = (jnp.full_like(delta[0], c[0]), jnp.full_like(delta[0], c[1]))
    for j in range(_LOG1P_TERMS - 1, -1, -1):
        c = _const_ds(1.0 / (j + 2))
        p = add(mul(p, neg(delta)), (jnp.full_like(delta[0], c[0]),
                                     jnp.full_like(delta[0], c[1])))
    series = mul(sq(delta), p)
    # direct branch: delta - log(1 + delta); guard the log against the
    # series-domain deltas only (the branch is discarded there anyway)
    delta_big = where(small, from_f32(jnp.ones_like(delta[0])), delta)
    r = add_f32(delta_big, jnp.float32(1.0))
    direct = sub(delta_big, log(r, newton_steps=1))
    return where(small, series, direct)
