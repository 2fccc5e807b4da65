"""Shared machinery for the stateful linear-Gram D-opt fast paths.

The D-opt Gram G(x) = V diag(x) V^T (reference: functions.py:27-82) is
LINEAR in x, so a driver whose iterates are convex combinations of carried
points can:

* combine carried m x m Grams instead of paying the O(m^2 n) contraction;
* replace the per-evaluation m x m factorization with a warm-started
  Newton-Schulz inverse (matmul-only — no sequential Cholesky in the
  hot loop);
* advance log-determinants through the exact identity
  ``logdet G' = logdet G + logdet(M G') - logdet(M G)`` for any M,
  evaluated by an 8-term trace series when M approximates an inverse well
  enough that ``||I - M G||_F <= 0.03`` (truncation ~6e-13), falling back
  to the oracle's full factorization otherwise (small-operand lax.cond —
  fine inside scan, see CLAUDE.md).

Oracles opt in by exposing the protocol ``gram`` / ``logdet_full`` /
``inv_seed`` / ``grad_from_inv`` (DOptimalObj, DOptimalObjMixed).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

SERIES_TAU2 = 0.03 ** 2  # ||E||_F^2 gate for the 8-term logdet series
WARM_TAU2 = 0.05 ** 2    # gate for warm-starting Schulz from a carried M

_PROTOCOL = ("gram", "logdet_full", "inv_seed", "grad_from_inv")


def supports_fast_gram(f):
    return all(hasattr(f, a) for a in _PROTOCOL)


def require_fast_gram(f):
    if not supports_fast_gram(f):
        raise ValueError(
            "fast_gram=True needs a linear-Gram oracle exposing "
            "gram/logdet_full/inv_seed/grad_from_inv "
            "(DOptimalObj or DOptimalObjMixed)")


def schulz(M, G, steps=4):
    """Newton-Schulz inverse polish: M <- 2M - M G M (matmul-only; the
    error ||I - G M|| SQUARES per step, so 4 steps take a 5e-2 warm start
    or a 1e-3 f32-Cholesky seed to below 1e-12).

    Precision.HIGHEST is load-bearing for f32 operands: at DEFAULT
    precision an accelerator may run f32 matmuls in reduced-precision
    passes (TF32 on the GPU, ~1e-3 relative), which caps the Schulz fixed
    point at ~1e-2 — measured: the f32 polish DEGRADED a 3.5e-7 seed to
    1e-2 before this pin (f64 operands are unaffected)."""
    hi = jax.lax.Precision.HIGHEST
    for _ in range(steps):
        M = 2.0 * M - jnp.matmul(
            M, jnp.matmul(G, M, precision=hi), precision=hi)
    return M


def inv_at(f, G, M_prev):
    """Inverse of the m x m Gram G, warm-started from a carried inverse of
    a nearby Gram when quadratic Schulz convergence is certain, reseeded
    from the oracle's f32 factorization otherwise."""
    eye = jnp.eye(G.shape[0], dtype=G.dtype)
    E0 = eye - M_prev @ G
    warm_ok = jnp.sum(E0 * E0) <= WARM_TAU2
    M0 = lax.cond(warm_ok, lambda: M_prev, lambda: f.inv_seed(G))
    return schulz(M0, G)


def series_logdet(E):
    """log det(I - E) via 8 trace terms and 3 m x m matmuls.

    tr(E^j) for j = 5..8 come free as elementwise contractions of the
    computed powers (tr(AB) = sum(A * B^T)).  Truncation error is
    <= m ||E||^9 / (9 (1 - ||E||)) ~ 6e-13 at the gate ||E||_F <= 0.03.
    """
    E2 = E @ E
    E3 = E @ E2
    E4 = E2 @ E2
    t1 = jnp.trace(E)
    t2 = jnp.trace(E2)
    t3 = jnp.trace(E3)
    t4 = jnp.trace(E4)
    t5 = jnp.sum(E2 * E3.T)
    t6 = jnp.sum(E3 * E3.T)
    t7 = jnp.sum(E3 * E4.T)
    t8 = jnp.sum(E4 * E4.T)
    return -(t1 + t2 / 2 + t3 / 3 + t4 / 4 + t5 / 5 + t6 / 6 + t7 / 7
             + t8 / 8)


def anchored_logdet_shift(f, ld_anchor, sign, M, G_series, G_target):
    """(logdet(G_target), shift) from a known anchor logdet.

    ``sign=+1``: target = the G entering the series, anchor = the point M
    inverts:      ld_target = ld_anchor + logdet(M G_series).
    ``sign=-1``: target = the point M inverts, anchor = the series G:
                  ld_target = ld_anchor - logdet(M G_series).
    Falls back to the oracle's full factorization of G_target when the
    series residual is too large.

    The SHIFT (ld_target - ld_anchor) is returned separately because it is
    the series value itself — absolutely accurate to ~1e-16 even when the
    logdets are O(1).  Descent acceptances must test the shift directly:
    comparing two separately-computed O(1) objective values loses the
    difference to cancellation once the descent margin shrinks below the
    oracle's value noise (observed: the gain line search of the mixed
    oracle on XLA:CPU failing persistently, G inflating to ~3e7 and the
    run stalling into a spurious dzz-converged stop at 4380/9000
    iterations).  In the fallback branch the shift comes from a
    subtraction, but there ||E|| > 0.03 so the shift is large and the
    cancellation is harmless.
    """
    E = jnp.eye(G_series.shape[0], dtype=G_series.dtype) - M @ G_series
    ok = jnp.sum(E * E) <= SERIES_TAU2
    s = lax.cond(ok,
                 lambda: sign * series_logdet(E),
                 lambda: f.logdet_full(G_target) - ld_anchor)
    return ld_anchor + s, s


def anchored_logdet(f, ld_anchor, sign, M, G_series, G_target):
    """logdet(G_target) from a known anchor (see anchored_logdet_shift)."""
    return anchored_logdet_shift(f, ld_anchor, sign, M, G_series,
                                 G_target)[0]


# ---------------------------------------------------------------------------
# Double-single (two-f32) engine: the same linear-Gram machinery at f64
# GRADE from pure f32/int8 ops — no jax_enable_x64, no f64 anywhere.
# Oracles opt in with the DS protocol ``gram_ds`` / ``logdet_full_ds`` /
# ``inv_seed32`` / ``grad_from_inv_ds`` (DOptimalObjDS).  Every multi-word
# value is a DS ``(hi, lo)`` f32 pair (ops/double_single.py).
# ---------------------------------------------------------------------------

_DS_PROTOCOL = ("gram_ds", "logdet_full_ds", "inv_seed32", "grad_from_inv_ds")


def supports_fast_gram_ds(f):
    return all(hasattr(f, a) for a in _DS_PROTOCOL)


def require_fast_gram_ds(f, h):
    if not supports_fast_gram_ds(f):
        raise ValueError(
            "fast_gram='ds' needs a double-single linear-Gram oracle "
            "exposing gram_ds/logdet_full_ds/inv_seed32/grad_from_inv_ds "
            "(DOptimalObjDS.from_design(H))")
    if not hasattr(h, "div_prox_map_ds_warm"):
        raise ValueError(
            "fast_gram='ds' needs an h-oracle with a double-single prox "
            "(BurgEntropySimplex)")
    m = int(f.m)
    if m > 128:
        import warnings

        warnings.warn(
            f"fast_gram='ds' with m={m}: the DS m x m algebra (ds_linalg "
            "broadcast matmuls, DS Cholesky fallback) materializes "
            "O(m^3) intermediates — sized for the reference's m <= ~100 "
            "benchmark regime. For large m prefer fast_gram=True with "
            "the f64 oracle (host) or DOptimalObjMixed (chip).")


def inv_pair_ds(f, G, M_prev32, f32_steps=4, ds_steps=2):
    """(f32 inverse for the carry, DS inverse for gradient/series) of a DS
    Gram: warm-started f32 Schulz (matmul-only, converges to its ~1e-6
    roundoff fixed point) + ``ds_steps`` DS Newton-Schulz polish steps,
    each SQUARING the residual (1e-6 -> 1e-12 -> DS floor)."""
    from ..ops import ds_linalg as dl

    Gh = G[0] + G[1]
    eye = jnp.eye(Gh.shape[0], dtype=Gh.dtype)
    E0 = eye - jnp.matmul(M_prev32, Gh, precision=jax.lax.Precision.HIGHEST)
    warm_ok = jnp.sum(E0 * E0) <= WARM_TAU2
    M0 = lax.cond(warm_ok, lambda: M_prev32, lambda: f.inv_seed32(G))
    M32 = schulz(M0, Gh, steps=f32_steps)
    M_ds = M32
    for _ in range(ds_steps):
        M_ds = dl.schulz_step_ds(M_ds, G)
    return M32, M_ds


def series_logdet_ds(E):
    """``series_logdet`` with a DS input/output — dispatch-lean form.

    Only ONE DS matmul (E^2; batched over a leading axis when ``E`` stacks
    several residuals): tr(E^3) = sum(E2 o E^T) and tr(E^4) = sum(E2 o
    E2^T) are elementwise DS contractions of it, all four folded in ONE
    stacked reduction; the j >= 5 terms (<= m * 0.03^5 ~ 1e-6 at the
    gate, needing only ~1e-7 relative) come from f32 HIGHEST-precision
    matmuls of the hi planes.  In-scan this cut the anchored-shift cost
    from ~79 to ~35 us/iteration at m=30.  Accepts E of shape
    (..., m, m); returns DS scalars of the leading batch shape.
    """
    from ..ops import double_single as ds
    from ..ops import ds_linalg as dl

    E2 = dl.mm(E, E)
    swap = lambda A: (jnp.swapaxes(A[0], -1, -2),  # noqa: E731
                      jnp.swapaxes(A[1], -1, -2))
    ET, E2T = swap(E), swap(E2)
    batch = E[0].shape[:-2]
    m = E[0].shape[-1]

    def flat(A):
        return (A[0].reshape(batch + (m * m,)),
                A[1].reshape(batch + (m * m,)))

    # t1..t4 in one stacked DS fold: diag(E) padded to m^2 width
    diag = (jnp.diagonal(E[0], axis1=-2, axis2=-1),
            jnp.diagonal(E[1], axis1=-2, axis2=-1))
    pad = batch + (m * m - m,)
    t1v = (jnp.concatenate([diag[0], jnp.zeros(pad, jnp.float32)], -1),
           jnp.concatenate([diag[1], jnp.zeros(pad, jnp.float32)], -1))
    stack = [t1v, ds.mul(flat(E), flat(ET)), ds.mul(flat(E2), flat(ET)),
             ds.mul(flat(E2), flat(E2T))]
    sh = (jnp.stack([v[0] for v in stack], -2),
          jnp.stack([v[1] for v in stack], -2))
    s = ds.sum_along(sh, axis=-1, sloppy=True)
    t = [(s[0][..., i], s[1][..., i]) for i in range(4)]

    # j >= 5: f32 hi-plane matmuls (HIGHEST: f32 matmuls may default to
    # reduced-precision passes, see `schulz`)
    hi = jax.lax.Precision.HIGHEST
    Eh = E[0] + E[1]
    E2h = E2[0] + E2[1]
    E3h = jnp.matmul(E2h, Eh, precision=hi)
    E4h = jnp.matmul(E2h, E2h, precision=hi)
    E3hT = jnp.swapaxes(E3h, -1, -2)
    E4hT = jnp.swapaxes(E4h, -1, -2)
    tail = (jnp.sum(E2h * E3hT, axis=(-1, -2)) / 5.0    # tr(E^5)
            + jnp.sum(E3h * E3hT, axis=(-1, -2)) / 6.0  # tr(E^6)
            + jnp.sum(E3h * E4hT, axis=(-1, -2)) / 7.0  # tr(E^7)
            + jnp.sum(E4h * E4hT, axis=(-1, -2)) / 8.0)  # tr(E^8)
    acc = t[0]
    for j, tj in ((2, t[1]), (3, t[2]), (4, t[3])):
        acc = ds.add(acc, ds.mul_f32(tj, jnp.float32(1.0 / j)))
    acc = ds.add(acc, ds.from_f32(tail.astype(jnp.float32)))
    return ds.neg(acc)


def anchored_shift_pair_ds(f, ld_x, M_ds, Gx, Gy, Gxn):
    """The accelerated steps' TWO logdet advances in one batched series:

        ld_y  = ld_x - logdet(M Gx)   [M ~= Gy^{-1}; fallback target Gy]
        ld_xn = ld_y + logdet(M Gxn)  [fallback target Gxn]

    Returns ``(ld_y, ld_xn, s_xn)``.  Both residual series evaluate as ONE
    batched DS chain (dl.mm/series_logdet_ds over a leading 2-axis) —
    in-scan the per-matrix dispatch chains dominate, so pairing halves
    the shift cost."""
    from ..ops import double_single as ds
    from ..ops import ds_linalg as dl

    if not isinstance(M_ds, tuple):
        M_ds = ds.from_f32(M_ds)
    Gs = (jnp.stack([Gx[0], Gxn[0]]), jnp.stack([Gx[1], Gxn[1]]))
    Mb = (M_ds[0][None], M_ds[1][None])
    P = dl.mm(Mb, Gs)
    m = Gx[0].shape[0]
    eye = jnp.eye(m, dtype=jnp.float32)[None]
    E = ds.sub((eye, jnp.zeros_like(eye)), P)
    Eh = E[0] + E[1]
    n2 = jnp.sum(Eh * Eh, axis=(-1, -2))
    s = series_logdet_ds(E)
    s_a = (s[0][0], s[1][0])
    s_b = (s[0][1], s[1][1])

    ld_y = lax.cond(
        n2[0] <= SERIES_TAU2,
        lambda: ds.add(ld_x, ds.neg(s_a)),
        lambda: f.logdet_full_ds(Gy))
    okb = n2[1] <= SERIES_TAU2

    def fast_b():
        return ds.add(ld_y, s_b), s_b

    def fallback_b():
        ld = f.logdet_full_ds(Gxn)
        return ld, ds.sub(ld, ld_y)

    ld_xn, s_xn = lax.cond(okb, fast_b, fallback_b)
    return ld_y, ld_xn, s_xn


def anchored_logdet_shift_ds(f, ld_anchor, sign, M_ds, G_series, G_target):
    """``anchored_logdet_shift`` in DS: identical gates and fallback
    semantics, DS-accurate shifts (the acceptance-immunity argument of the
    f64 docstring above carries over at the ~1e-13 level)."""
    from ..ops import double_single as ds
    from ..ops import ds_linalg as dl

    # E = I - M G_series with M DS, G DS
    MG = dl.mm(M_ds if isinstance(M_ds, tuple) else ds.from_f32(M_ds),
               G_series)
    E = dl.eye_minus(MG)
    Eh = E[0] + E[1]
    ok = jnp.sum(Eh * Eh) <= SERIES_TAU2

    def fast():
        return ds.mul_f32(series_logdet_ds(E), jnp.float32(sign))

    def fallback():
        return ds.sub(f.logdet_full_ds(G_target), ld_anchor)

    s = lax.cond(ok, fast, fallback)
    return ds.add(ld_anchor, s), s


@functools.partial(jax.jit, static_argnames=())
def init_state_ds(f, x0):
    """Pre-scan DS Gram / f32 inverse / DS logdet at the starting point
    (jitted for the same per-call-recompile reason as ``init_state``)."""
    G0 = f.gram_ds(x0)
    M32 = schulz(f.inv_seed32(G0), G0[0] + G0[1])
    ld0 = f.logdet_full_ds(G0)
    return dict(G0=G0, M0=M32, ld0=ld0)


@functools.partial(jax.jit, static_argnames=("with_z",))
def refresh_state_ds(f, x, z, with_z=True):
    """between_chunks recontraction for the DS engine: fresh DS Grams from
    the exact iterates, fresh f32 inverse seed, fresh DS anchor logdet.
    Takes only the recomputed inputs and returns only the recomputed
    leaves (merged into the carry outside the jit) — the round-2 advisor
    note on ``refresh_state`` jitting whole carries applies here too."""
    Gx = f.gram_ds(x)
    out = dict(Gx=Gx, fx=tuple(map(jnp.negative, f.logdet_full_ds(Gx))),
               Minv=schulz(f.inv_seed32(Gx), Gx[0] + Gx[1]))
    if with_z:
        out["Gz"] = f.gram_ds(z)
    return out


@jax.jit
def init_state(f, x0):
    """Pre-scan Gram / inverse / logdet at the starting point.

    Jitted (module-level cache): called eagerly, the ``lax.cond`` inside
    the mixed oracle's factorization closes over CONCRETE arrays, so every
    call builds a fresh jaxpr and compiles a fresh ``jit(cond)``
    executable — 2 compiles per chunk through the refresh hook.  Under jit
    the cond compiles once per (oracle-structure, shape) and is cached for
    the whole process.
    """
    G0 = f.gram(x0)
    return dict(G0=G0, M0=schulz(f.inv_seed(G0), G0),
                ld0=f.logdet_full(G0))


@functools.partial(jax.jit, static_argnames=("with_z",))
def refresh_state(f, x, z, with_z=True):
    """between_chunks recontraction of the carried Grams / inverse /
    logdet from the exact iterates, so combination/series roundoff cannot
    accumulate past one chunk (~1e-16/step worst-case drift).  Jitted for
    the same per-call-recompile reason as ``init_state``.  Takes only the
    recomputed inputs and returns only the recomputed leaves (merged into
    the carry by the caller) — jitting the whole carry would make every
    pass-through leaf a jit input (device-mismatch hazards, one executable
    per optional-key carry layout; round-2 advisor note)."""
    Gx = f.gram(x)
    out = {"Gx": Gx, "fx": -f.logdet_full(Gx),
           "Minv": schulz(f.inv_seed(Gx), Gx)}
    if with_z:
        out["Gz"] = f.gram(z)
    return out
