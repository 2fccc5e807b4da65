"""Double-single (two-f32) dense linear algebra for SMALL matrices.

The DS fast-gram engine (algorithms/fastgram.py, ``fast_gram="ds"``) needs
f64-grade m x m algebra without ``jax_enable_x64``: Schulz inverse polish,
trace-series log-det terms, and a Cholesky fallback for ill-conditioned
Grams.  These matrices are tiny (m ~ 30-100 for the reference's D-opt
benchmarks), so every product here is a BROADCAST elementwise DS multiply
reduced with error-free pairwise adds — O(m^3) f32 flops with ~30x the
constant of a plain matmul.  Memory for
the (m, m, m) intermediate bounds the sensible range to m <~ 300; the
large-m regime belongs to the int8-Ozaki contractions
(mixed_precision.ozaki_gram / ozaki_mm), not to this module.

No reference counterpart (the reference is f64 numpy throughout); see
SURVEY.md §7 "numerical parity".
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from . import double_single as ds


def _bc_a(A):
    """(..., m, k) -> (..., m, k, 1) broadcast planes."""
    return (A[0][..., :, :, None], A[1][..., :, :, None])


def _bc_b(B):
    """(..., k, n) -> (..., 1, k, n) broadcast planes."""
    return (B[0][..., None, :, :], B[1][..., None, :, :])


def mm(A, B, sloppy=True):
    """DS (..., m, k) @ DS (..., k, n) -> DS (..., m, n), fully
    error-free-transformed.  Leading batch dims broadcast — batching
    SEVERAL small matmuls into one call pays ONE reduction chain for all
    of them (the same dispatch-latency argument as double_single.sum_many)."""
    P = ds.mul(_bc_a(A), _bc_b(B))
    return ds.sum_along(P, axis=-2, sloppy=sloppy)


def mm_ds_f32(A, B32):
    """DS (m,k) @ f32 (k,n) -> DS (m,n) (exact products, DS reduction)."""
    Ah, Al = A[0][:, :, None], A[1][:, :, None]
    Bb = B32[None, :, :]
    p, err = ds.two_prod(Ah, Bb)
    return ds.sum_along((p, err + Al * Bb), axis=1, sloppy=True)


def mm_f32_ds(A32, B):
    """f32 (m,k) @ DS (k,n) -> DS (m,n)."""
    Ab = A32[:, :, None]
    Bh, Bl = B[0][None, :, :], B[1][None, :, :]
    p, err = ds.two_prod(Ab, Bh)
    return ds.sum_along((p, err + Ab * Bl), axis=1, sloppy=True)


def mm_f32_f32(A32, B32):
    """f32 (m,k) @ f32 (k,n) -> exact-product DS (m,n) result."""
    p, err = ds.two_prod(A32[:, :, None], B32[None, :, :])
    return ds.sum_along((p, err), axis=1, sloppy=True)


def trace(A):
    """DS trace of a DS square matrix."""
    return ds.sum_along((jnp.diagonal(A[0]), jnp.diagonal(A[1])), 0)


def eye_minus(A):
    """I - A for DS square A (the Schulz/series residual)."""
    m = A[0].shape[0]
    eye = jnp.eye(m, dtype=jnp.float32)
    return ds.sub((eye, jnp.zeros_like(eye)), A)


def schulz_step_ds(M, G):
    """One DS Newton-Schulz step  M' = 2 M - M (G M)  for DS (or f32) M
    against a DS Gram G — squares ``||I - M G||``, lifting an f32-accurate
    inverse (~1e-6) to DS grade (~1e-12) in one pass of small DS matmuls."""
    if not isinstance(M, tuple):
        M = ds.from_f32(M)
    GM = mm(G, M)
    MGM = mm(M, GM)
    return ds.sub(ds.add(M, M), MGM)


def cholesky(G, jitter=0.0):
    """DS Cholesky of a DS SPD matrix (left-looking, column fori_loop).

    m sequential steps, each a masked DS contraction over previous columns
    — the rare-path fallback when the f32 factorization's residual gate
    fails (fastgram series fallback / logdet_full_ds); never in a hot loop.
    Returns lower-triangular DS R with G = R R^T.
    """
    m = G[0].shape[0]
    rows = jnp.arange(m)

    def body(j, R):
        Rh, Rl = R
        colmask = (rows < j).astype(jnp.float32)[None, :]  # cols k < j
        rowj = (lax.dynamic_slice_in_dim(Rh, j, 1, axis=0)[0],
                lax.dynamic_slice_in_dim(Rl, j, 1, axis=0)[0])
        Rm = (Rh * colmask, Rl * colmask)
        # v = G[:, j] - sum_{k<j} R[:, k] * R[j, k]
        gj = (lax.dynamic_slice_in_dim(Gh, j, 1, axis=1)[:, 0],
              lax.dynamic_slice_in_dim(Gl, j, 1, axis=1)[:, 0])
        s = ds.sum_along(ds.mul(Rm, (rowj[0][None, :], rowj[1][None, :])),
                         axis=1)
        v = ds.sub(gj, s)
        d = (lax.dynamic_slice_in_dim(v[0], j, 1)[0] + jnp.float32(jitter),
             lax.dynamic_slice_in_dim(v[1], j, 1)[0])
        rjj = ds.sqrt((jnp.maximum(d[0], jnp.float32(1e-30)), d[1]))
        col = ds.div(v, (jnp.broadcast_to(rjj[0], v[0].shape),
                         jnp.broadcast_to(rjj[1], v[1].shape)))
        keep = (rows >= j)
        colh = jnp.where(keep, col[0], 0.0)
        coll = jnp.where(keep, col[1], 0.0)
        Rh = lax.dynamic_update_slice(Rh, colh[:, None], (0, j))
        Rl = lax.dynamic_update_slice(Rl, coll[:, None], (0, j))
        return Rh, Rl

    Gh, Gl = G
    R0 = (jnp.zeros_like(Gh), jnp.zeros_like(Gl))
    return lax.fori_loop(0, m, body, R0)


def logdet_chol(R):
    """2 * sum log diag(R) for a DS Cholesky factor."""
    d = (jnp.diagonal(R[0]), jnp.diagonal(R[1]))
    return ds.mul_f32(ds.sum_along(ds.log(d), 0), jnp.float32(2.0))
