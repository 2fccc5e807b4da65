"""Exact-accumulation mixed-precision contractions (Ozaki-style int8 splits).

On hardware whose f64 matmul rate is far below its int8 rate, near-f64
GEMV accuracy can come from int8 products instead.  This module does so
(on the GPU, native f64 is the default and these routes are explicit
choices):

* each operand is split into radix-64 signed digits (int8), with
  power-of-two scales so the split is EXACT;
* digit-pair products are at most 2^14, so int32 accumulation over
  K <= 2^16 rows is EXACT — no rounding anywhere until the final f64
  combine;
* truncating digit pairs beyond diagonal D leaves a relative error
  ~64^-D; with 7 digit levels and D=6 the measured error is ~3e-12
  (vs 2e-15 for true f64, 1.7e-7 for f32).

Used by the D-opt Frank-Wolfe solvers' "mixed" and "ds" engines for the
O(mn) rank-1 w-updates; the split of the fixed design matrix is
precomputed once per solve.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

BASE = 64.0  # radix-64 digits: |digit| <= 64 fits int8; products <= 2^14


def digit_split_matrix(B, levels: int):
    """Split matrix B (f64/f32, shape (m, n)) into int8 digit planes with
    per-COLUMN power-of-two scales.  Returns (digits[levels, m, n], s[n])
    with B == sum_p digits[p] * BASE**-(p+1) * s + O(BASE**-levels)."""
    B = jnp.asarray(B)
    s = 2.0 ** jnp.ceil(jnp.log2(jnp.max(jnp.abs(B), axis=0) + 1e-300))
    r = B / s
    planes = []
    for _ in range(levels):
        d = jnp.round(r * BASE)
        planes.append(d.astype(jnp.int8))
        r = r * BASE - d
    return jnp.stack(planes), s


def digit_split_vector(a, levels: int):
    """Split vector a into int8 digit planes with one power-of-two scale."""
    a = jnp.asarray(a)
    s = 2.0 ** jnp.ceil(jnp.log2(jnp.max(jnp.abs(a)) + 1e-300))
    r = a / s
    planes = []
    for _ in range(levels):
        d = jnp.round(r * BASE)
        planes.append(d.astype(jnp.int8))
        r = r * BASE - d
    return jnp.stack(planes), s


def pack_digit_planes(B_digits):
    """(levels, m, n) int8 -> (m, levels*n) packed layout so ALL digit-pair
    products of a GEMV happen in ONE int8 contraction (one pass over
    the planes instead of levels_a * levels_b separate dispatches)."""
    levels, m, n = B_digits.shape
    return jnp.transpose(B_digits, (1, 0, 2)).reshape(m, levels * n)


def ozaki_gemv(a, B_digits, sB, levels_a: int = 7, max_diag: int = 6):
    """u = a @ B through exact int8/int32 digit products.

    a: (m,) f64; B_digits/sB from digit_split_matrix.  Digit pairs (p, q)
    with p + q <= max_diag are contracted as int8 products with exact int32
    accumulation; same-diagonal results combine in int32 and lift to f64
    with their shared exact scale.

    This per-pair form is the D-opt "mixed" engine's w-update
    (d_opt.py:_dopt_u): 21 independent small dot_generals that the
    compiler may schedule beside the H update; ``ozaki_gemv_packed`` is
    the single-contraction form for isolated GEMVs.
    """
    levels_b = B_digits.shape[0]
    a_digits, sa = digit_split_vector(a, levels_a)
    n = B_digits.shape[2]
    out = jnp.zeros(n, jnp.float64)
    for d in range(max_diag + 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_a - 1) + 1):
            q = d - p
            r32 = lax.dot_general(
                a_digits[p][None, :], B_digits[q],
                (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )[0]
            acc = r32 if acc is None else acc + r32
        if acc is not None:
            out = out + acc.astype(jnp.float64) * (BASE ** -(d + 2))
    return out * (sa * sB)


def ozaki_gemv_packed(a, B_packed, sB, levels_b: int, levels_a: int = 7):
    """u = a @ B with ALL levels_a x levels_b digit pairs in one contraction.

    B_packed from ``pack_digit_planes``; one (levels_a, m) x (m, levels_b*n)
    int8 contraction (exact int32 accumulation — one pass over the digit
    planes instead of one per pair).  The combine stays in integer and
    f32 arithmetic: same-diagonal products sum in int32 (exact, bounded by
    levels * K * 2^14 < 2^31), the three leading diagonals lift to f64
    individually, and the geometrically-vanishing tail (scale <= BASE^-5 of
    the result) accumulates in f32 whose rounding is far below the digit
    truncation.  Measured ~1e-12 relative error.
    """
    n = B_packed.shape[1] // levels_b
    a_digits, sa = digit_split_vector(a, levels_a)  # (levels_a, m) int8
    prod = lax.dot_general(
        a_digits, B_packed,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(levels_a, levels_b, n)  # exact

    diags = []
    for d in range(levels_a + levels_b - 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_a - 1) + 1):
            term = prod[p, d - p]
            acc = term if acc is None else acc + term
        diags.append(acc)

    u = (diags[0].astype(jnp.float64) * BASE**-2
         + diags[1].astype(jnp.float64) * BASE**-3
         + diags[2].astype(jnp.float64) * BASE**-4)
    tail = jnp.zeros(n, jnp.float32)
    for d in range(3, len(diags)):
        # int32 -> f32 conversion is exact (|diag| < 2^24); the power-of-two
        # scale multiplications are exact; only the f32 adds round, at
        # ~2^-24 of the tail's own BASE^-5-scaled magnitude
        tail = tail + diags[d].astype(jnp.float32) * jnp.float32(BASE ** -(d + 2))
    u = u + tail.astype(jnp.float64)
    return u * (sa * sB)


# ---------------------------------------------------------------------------
# GEMM-level Ozaki contractions: the O(m^2 n) products of the BPG/ABPG
# D-optimal oracle — Gram V diag(x) V^T and M @ V — as ONE int8
# contraction each, with exact int32 accumulation (reference workload:
# ABPG-gain on D-opt 30x10000, ipynb/ABPGvsFW/ex_Dopt_ABPGvsFW.ipynb
# cell5).
# ---------------------------------------------------------------------------


def digit_split_rows(X, levels: int):
    """Split matrix X (m, n) into int8 digit planes with per-ROW
    power-of-two scales: X == (sum_p digits[p] * BASE**-(p+1)) * s[:, None]
    + O(BASE**-levels).  Returns (digits[levels, m, n], s[m, 1])."""
    X = jnp.asarray(X)
    s = 2.0 ** jnp.ceil(
        jnp.log2(jnp.max(jnp.abs(X), axis=1, keepdims=True) + 1e-300))
    r = X / s
    planes = []
    for _ in range(levels):
        d = jnp.round(r * BASE)
        planes.append(d.astype(jnp.int8))
        r = r * BASE - d
    return jnp.stack(planes), s


def digit_split_rows_ds(Wh, Wl, levels: int):
    """``digit_split_rows`` for a DOUBLE-SINGLE input (hi, lo f32 planes)
    — pure f32 arithmetic throughout.

    Digits are taken from the hi plane (an off-by-one near a rounding boundary only
    grows |digit| to <= 65, still exact in int8/int32 products), and the
    residual update is exact: power-of-two scalings are exact in both
    planes, the hi subtraction cancels exactly, and a two_sum renormalizes
    lo into the next level.  ``levels`` digits capture 6*levels bits of
    the ~49-bit DS value."""
    from . import double_single as _ds

    s = 2.0 ** jnp.ceil(
        jnp.log2(jnp.max(jnp.abs(Wh), axis=1, keepdims=True) + 1e-30))
    rh = Wh / s
    rl = Wl / s
    planes = []
    for _ in range(levels):
        d = jnp.round(rh * BASE)
        planes.append(d.astype(jnp.int8))
        nh = rh * BASE - d
        rh, rl = _ds.two_sum(nh, rl * BASE)
    return jnp.stack(planes), s


def digit_split_matrix_ds(Bh, Bl, levels: int):
    """``digit_split_matrix`` (per-COLUMN scales) for a double-single input
    — pure f32 arithmetic, same exactness argument as
    ``digit_split_rows_ds``.  Returns (digits[levels, m, n], s[n])."""
    from . import double_single as _ds

    s = 2.0 ** jnp.ceil(jnp.log2(jnp.max(jnp.abs(Bh), axis=0) + 1e-30))
    rh = Bh / s
    rl = Bl / s
    planes = []
    for _ in range(levels):
        d = jnp.round(rh * BASE)
        planes.append(d.astype(jnp.int8))
        nh = rh * BASE - d
        rh, rl = _ds.two_sum(nh, rl * BASE)
    return jnp.stack(planes), s


def ozaki_gram_ds(dA, sA, dW, sW, max_diag: int | None = None):
    """``ozaki_gram`` with a DOUBLE-SINGLE combine: G = A @ W^T as a DS
    (hi, lo) pair from pure f32/int8 arithmetic — no ``jax_enable_x64``.

    The int8 contraction and diagonal grouping are identical to
    ``ozaki_gram``; each int32 diagonal converts EXACTLY to DS
    (``double_single.int32_to_ds`` — the accumulators exceed the 2^24
    exact-f32 range at n >= ~4096) and accumulates through DS adds with
    exact power-of-two scalings.  Relative accuracy ~BASE**-(max_diag+1)
    (~1e-13 at the default 7x7/6 split), measured against f64 in
    tests/test_ds_fastgram.py."""
    from . import double_single as _ds

    La, m, n = dA.shape
    Lw = dW.shape[0]
    if max_diag is None:
        max_diag = La + Lw - 2
    P = lax.dot_general(
        dA.reshape(La * m, n), dW.reshape(Lw * m, n),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(La, m, Lw, m)
    G = _ds.from_f32(jnp.zeros((m, m), jnp.float32))
    for d in range(min(max_diag, La + Lw - 2) + 1):
        acc = None
        for p in range(max(0, d - Lw + 1), min(d, La - 1) + 1):
            t = P[p, :, d - p, :]
            acc = t if acc is None else acc + t
        term = _ds.int32_to_ds(acc)
        scale = jnp.float32(BASE ** -(d + 2))  # power of two: exact
        G = _ds.add(G, (term[0] * scale, term[1] * scale))
    s = sA * sW.T  # product of powers of two: exact
    return G[0] * s, G[1] * s


def ozaki_mm_ds(Mh, Ml, B_packed, sB, levels_b: int, levels_m: int = 7,
                max_diag: int | None = None):
    """``ozaki_mm`` for a DOUBLE-SINGLE small matrix M against a
    digit-packed B, with a DS combine — P = M @ B as (hi, lo) f32 planes.

    M's digit planes come from the pure-f32 ``digit_split_rows_ds``;
    leading diagonals accumulate in DS (their f32 rounding would be ~1e-7
    relative), the geometrically-vanishing tail (scale <= BASE^-5 of the
    result) in plain f32 — same argument as ``ozaki_gemv_packed``."""
    from . import double_single as _ds

    m, kdim = Mh.shape
    n = B_packed.shape[1] // levels_b
    if max_diag is None:
        max_diag = levels_m + levels_b - 2
    dM, sM = digit_split_rows_ds(Mh, Ml, levels_m)
    P = lax.dot_general(
        dM.reshape(levels_m * m, kdim), B_packed,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(levels_m, m, levels_b, n)
    out = _ds.from_f32(jnp.zeros((m, n), jnp.float32))
    tail = jnp.zeros((m, n), jnp.float32)
    for d in range(min(max_diag, levels_m + levels_b - 2) + 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_m - 1) + 1):
            t = P[p, :, d - p, :]
            acc = t if acc is None else acc + t
        if d < 3:
            term = _ds.int32_to_ds(acc)
            scale = jnp.float32(BASE ** -(d + 2))
            out = _ds.add(out, (term[0] * scale, term[1] * scale))
        else:
            tail = tail + acc.astype(jnp.float32) * jnp.float32(
                BASE ** -(d + 2))
    out = _ds.add(out, _ds.from_f32(tail))
    s = sM * sB
    return out[0] * s, out[1] * s


def digit_split_matrix_np(B, levels: int):
    """``digit_split_matrix`` computed in HOST numpy float64 — exact
    regardless of ``jax_enable_x64`` (``jnp.asarray`` would silently
    downcast a f64 matrix to f32 with x64 off, collapsing every digit
    plane past the 4th to garbage — the CLAUDE.md precision footgun).
    Returns numpy (digits[levels, m, n] int8, s[n] f64)."""
    import numpy as np

    B = np.asarray(B, np.float64)
    s = 2.0 ** np.ceil(np.log2(np.max(np.abs(B), axis=0) + 1e-300))
    r = B / s
    planes = []
    for _ in range(levels):
        d = np.round(r * BASE)
        planes.append(d.astype(np.int8))
        r = r * BASE - d
    return np.stack(planes), s


def digit_split_vector_ds(a, levels: int):
    """Digit-split a DOUBLE-SINGLE (hi, lo) 1-D vector into int8 planes
    with ONE shared power-of-two scale.  Returns ((levels, m) int8, s).

    Same exactness argument as ``digit_split_rows_ds``: power-of-two
    scalings are exact in both planes, the hi-digit subtraction cancels
    exactly (Sterbenz: |r*BASE - round(r*BASE)| <= 1/2), and a two_sum
    renormalizes the lo plane into the next level.  Digits can reach
    |65| near rounding boundaries — still exact in int8/int32 products."""
    from . import double_single as _ds

    ah, al = a
    s = 2.0 ** jnp.ceil(jnp.log2(jnp.max(jnp.abs(ah)) + 1e-30))
    inv_s = 1.0 / s  # power of two: exact
    rh = ah * inv_s
    rl = al * inv_s
    planes = []
    for _ in range(levels):
        d = jnp.round(rh * BASE)
        planes.append(d.astype(jnp.int8))
        nh = rh * BASE - d
        rh, rl = _ds.two_sum(nh, rl * BASE)
    return jnp.stack(planes), s


def ozaki_gemv_packed_ds(a, B_packed, sB, levels_b: int, levels_a: int = 7):
    """u = a @ B for a DOUBLE-SINGLE vector ``a`` against a digit-packed
    B (``pack_digit_planes`` layout), with a DS combine — no f64 anywhere.

    The D-opt DS engine's w-update u = (Hv)^T V (algorithms/d_opt.py
    ``_dopt_step_ds``): ONE (levels_a, m) x (m, levels_b*n) int8
    contraction reads each digit plane once (exact int32 accumulation,
    bounded by m * 65^2 * levels < 2^31 for m <= 65k); the
    levels_a + levels_b - 1 diagonal groups convert exactly to DS, scale
    by exact powers of two, and fold in one pairwise DS reduction.
    Truncation ~BASE**-levels relative (~1e-12 measured), against ~29
    DS flops per element for the elementwise ``double_single.contract``."""
    from . import double_single as _ds

    n = B_packed.shape[1] // levels_b
    a_digits, sa = digit_split_vector_ds(a, levels_a)
    prod = lax.dot_general(
        a_digits, B_packed,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(levels_a, levels_b, n)
    dh = []
    dl = []
    for d in range(levels_a + levels_b - 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_a - 1) + 1):
            t = prod[p, d - p]
            acc = t if acc is None else acc + t
        gh, gl = _ds.int32_to_ds(acc)
        sc = jnp.float32(BASE ** -(d + 2))  # power of two: exact
        dh.append(gh * sc)
        dl.append(gl * sc)
    uh, ul = _ds.sum_along((jnp.stack(dh), jnp.stack(dl)), 0, sloppy=True)
    sc = sa * sB  # product of powers of two: exact
    return uh * sc, ul * sc


def ozaki_gram(dA, sA, dW, sW, max_diag: int | None = None):
    """G = A @ W^T with A == (digits dA, row scales sA), W == (dW, sW).

    dA, dW: (levels, m, n) int8 digit planes (same n); one dot_general of
    the (levels*m, n) stacks gives EVERY digit-pair product with exact
    int32 accumulation (pair products <= 2^12, so K <= 2^18 rows stay
    exact); the (levels, m, levels, m) combine then runs over tiny m x m
    tiles in f64.  ``max_diag``: drop digit pairs with p + q > max_diag
    (relative truncation ~BASE**-(max_diag+1))."""
    La, m, n = dA.shape
    Lw = dW.shape[0]
    if max_diag is None:
        max_diag = La + Lw - 2
    P = lax.dot_general(
        dA.reshape(La * m, n), dW.reshape(Lw * m, n),
        (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(La, m, Lw, m)
    G = jnp.zeros((m, m), jnp.float64)
    for d in range(min(max_diag, La + Lw - 2) + 1):
        acc = None
        for p in range(max(0, d - Lw + 1), min(d, La - 1) + 1):
            t = P[p, :, d - p, :]
            acc = t if acc is None else acc + t
        G = G + acc.astype(jnp.float64) * (BASE ** -(d + 2))
    return G * (sA * sW.T)


def ozaki_mm(M, B_packed, sB, levels_b: int, levels_m: int = 7,
             max_diag: int | None = None):
    """P = M @ B for a small f64 matrix M (m, m) against a digit-packed
    B (m, n) (``pack_digit_planes`` layout, per-COLUMN scales sB).

    M is digit-split per call (m^2 elements — cheap); ONE int8 contraction
    produces all digit pairs; the combine accumulates the three leading
    diagonals in f64 and the geometrically-vanishing tail in f32 (same
    rounding argument as ``ozaki_gemv_packed``)."""
    dM, sM = digit_split_rows(M, levels_m)  # (levels_m, m, m), (m, 1)
    return ozaki_mm_presplit(dM.reshape(levels_m * M.shape[0], M.shape[1]),
                             sM, B_packed, sB, levels_m, levels_b, max_diag)


def ozaki_mm_presplit(dM_flat, sM, B_packed, sB, levels_m: int,
                      levels_b: int, max_diag: int | None = None):
    """``ozaki_mm`` with the LEFT matrix already digit-split: dM_flat is
    ``digit_split_rows(M, levels_m)`` reshaped to (levels_m*m, k), sM its
    (m, 1) row scales.  For a CONSTANT large M (the SymNMF similarity
    matrix) the split amortizes to zero per iteration — the same
    precompute pattern as ``_RegressionMixed``'s packed data planes.
    Exactness: digit products <= 65^2 < 2^13, so int32 accumulation is
    exact through k <= 2^18 contraction rows."""
    m = dM_flat.shape[0] // levels_m
    n = B_packed.shape[1] // levels_b
    if max_diag is None:
        max_diag = levels_m + levels_b - 2
    P = lax.dot_general(
        dM_flat, B_packed,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(levels_m, m, levels_b, n)
    out = jnp.zeros((m, n), jnp.float64)
    tail = jnp.zeros((m, n), jnp.float32)
    for d in range(min(max_diag, levels_m + levels_b - 2) + 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_m - 1) + 1):
            t = P[p, :, d - p, :]
            acc = t if acc is None else acc + t
        if d < 3:
            out = out + acc.astype(jnp.float64) * (BASE ** -(d + 2))
        else:
            # |acc| < 2^24 -> exact int32->f32; power-of-two scales exact
            tail = tail + acc.astype(jnp.float32) * jnp.float32(
                BASE ** -(d + 2))
    out = out + tail.astype(jnp.float64)
    return out * (sM * sB)


def ozaki_mm_presplit_ds(dM_flat, sM, B_packed, sB, levels_m: int,
                         levels_b: int, max_diag: int | None = None):
    """``ozaki_mm_presplit`` with a DOUBLE-SINGLE combine — P = M @ B as
    (hi, lo) f32 planes, no f64 anywhere (the presplit form keeps the
    constant M's digit planes amortized; same exactness argument as
    ``ozaki_mm_ds``: leading diagonals accumulate through exact int32->DS
    conversion, the geometrically-vanishing tail in plain f32)."""
    from . import double_single as _ds

    m = dM_flat.shape[0] // levels_m
    n = B_packed.shape[1] // levels_b
    if max_diag is None:
        max_diag = levels_m + levels_b - 2
    P = lax.dot_general(
        dM_flat, B_packed,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).reshape(levels_m, m, levels_b, n)
    out = _ds.from_f32(jnp.zeros((m, n), jnp.float32))
    tail = jnp.zeros((m, n), jnp.float32)
    for d in range(min(max_diag, levels_m + levels_b - 2) + 1):
        acc = None
        for p in range(max(0, d - levels_b + 1), min(d, levels_m - 1) + 1):
            t = P[p, :, d - p, :]
            acc = t if acc is None else acc + t
        scale = jnp.float32(BASE ** -(d + 2))
        if d < 3:
            term = _ds.int32_to_ds(acc)
            out = _ds.add(out, (term[0] * scale, term[1] * scale))
        else:
            tail = tail + acc.astype(jnp.float32) * scale
    out = _ds.add(out, _ds.from_f32(tail))
    s = jnp.asarray(sM, jnp.float32) * jnp.asarray(sB, jnp.float32)
    return out[0] * s, out[1] * s
