"""Relatively-smooth f-oracles — JAX re-designs.

Replaces the reference's accbpg/functions.py:27-194,908-1104.  Key compute
redesigns versus the reference:

* ``DOptimalObj``: one Cholesky factorization of H*diag(x)*H^T shared by the
  log-det and the gradient (the reference does a separate slogdet + solve,
  functions.py:46-58).  logdet = 2*sum(log diag(chol)); gradient
  g_i = -||R^{-T} h_i||^2 via a triangular solve — the Gram product and the
  triangular solves are dense matrix products.  With H column-sharded over a
  mesh, the Gram accumulation psums automatically under jit.
* ``PoissonRegression`` / ``KLdivRegression``: gradients as transposed
  matvecs A^T(...) instead of broadcast-and-reduce (functions.py:106-108).
* ``LogisticRegression``: fused value+grad sharing the logits GEMV, with
  an analytic sigmoid-weighted gradient.
* ``FrobeniusSymLoss``: same O(n r^2) trick as the reference
  (functions.py:927-954) but pure-functional; optional gradient noise is
  PRNG-keyed (``stochastic`` protocol) instead of global numpy RNG.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from ..struct import pytree_dataclass, static_field
from .base import SmoothOracle

# Full-precision products for the log-determinant oracles.  At DEFAULT
# precision a GPU runs f32 matmuls in TF32 (10-bit mantissa), which put
# 7e-3 on F after 500 BPG iterations of an 80x200 f32 design (H100); f64
# products are unaffected.
_HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class DOptimalObj(SmoothOracle):
    """f(x) = -log det(H diag(x) H^T), H is m-by-n with m < n
    (reference: functions.py:27-82).

    ``n_valid``: when set (by ``parallel.shard_dopt_problem`` for
    mesh-padded designs), gradient entries past it report +1e30 instead of
    the 0 a zero column produces.  Zero-padding is exactly neutral for
    gradient-mapped proxes (``div_prox_map`` sends pads to 0 through
    h'(0) = -inf) and for the FW argmin, but NOT for ``h.prox_map`` on
    accumulated duals (ABDA): a 0 gradient there hands padded coordinates
    real mass.  A +1e30 entry makes every Burg/simplex prox map pads to
    ~1e-30 mass while line-search inner products stay exact (pad iterates
    are exactly 0, and 0 * 1e30 == 0)."""

    H: Any = None
    n_valid: Any = None

    def _mask_pads(self, g):
        if self.n_valid is None:
            return g
        lane = jnp.arange(g.shape[-1])
        return jnp.where(lane < self.n_valid, g, jnp.asarray(1e30, g.dtype))

    @property
    def m(self):
        return self.H.shape[0]

    @property
    def n(self):
        return self.H.shape[1]

    def _chol(self, x):
        HX = self.H * x  # column scaling, broadcasts over rows
        HXHT = jnp.matmul(HX, self.H.T, precision=_HIGHEST)
        return jnp.linalg.cholesky(HXHT)

    def value(self, x, key=None):
        R = self._chol(x)
        return -2.0 * jnp.sum(jnp.log(jnp.diagonal(R)))

    def grad(self, x, key=None):
        return self.value_and_grad(x, key=key)[1]

    def value_and_grad(self, x, key=None):
        R = self._chol(x)  # lower triangular, HXHT = R R^T
        f = -2.0 * jnp.sum(jnp.log(jnp.diagonal(R)))
        # g_i = -h_i^T (HXHT)^{-1} h_i = -||R^{-1} h_i||^2
        W = solve_triangular(R, self.H, lower=True)
        g = -jnp.sum(W * W, axis=0)
        return f, self._mask_pads(g)

    # -- fast-Gram protocol (stateful accelerated drivers; ABPG_gain
    #    fast_gram=True).  The Gram G(x) = H diag(x) H^T is linear in x, so
    #    drivers whose iterates are convex combinations of carried points
    #    can combine carried m x m Grams instead of recontracting. --

    def gram(self, x):
        return jnp.matmul(self.H * x, self.H.T, precision=_HIGHEST)

    def logdet_full(self, G):
        R = jnp.linalg.cholesky(G)
        return 2.0 * jnp.sum(jnp.log(jnp.diagonal(R)))

    def inv_seed(self, G):
        """Approximate inverse of the m x m Gram, to be Schulz-polished by
        the caller (matmul-only refinement; see bpg._schulz)."""
        R = jnp.linalg.cholesky(G)
        return cho_solve((R, True), jnp.eye(self.m, dtype=G.dtype))

    def grad_from_inv(self, M):
        # Pad masking matters here too: ABDA with fast_gram=True on a
        # mesh-padded problem feeds this gradient into prox_map on
        # accumulated duals; without the +1e30 mask padded coordinates
        # would re-acquire mass (ADVICE r4 medium).
        return self._mask_pads(
            -jnp.sum(self.H * jnp.matmul(M, self.H, precision=_HIGHEST),
                     axis=0))


@pytree_dataclass
class DOptimalObjMixed(SmoothOracle):
    """``DOptimalObj`` with the O(m^2 n) contractions in exact int8 Ozaki
    digit GEMMs — f64-grade oracle answers WITHOUT f64 matmuls, for
    hardware whose f64 matmul rate is far below its int8 rate (on the
    GPU, native f64 is the default; this oracle is an explicit choice).
    Here:

    * Gram ``V diag(x) V^T``: V's digit planes are split once per oracle
      (per-row scales); ``diag(x) -> W = V * x`` is split per call; ONE
      int8 contraction + exact int32 accumulation gives the Gram to
      ~1e-13 relative (``mixed_precision.ozaki_gram``).
    * gradient ``g_j = -v_j^T (Gram)^{-1} v_j``: the m x m inverse is true
      f64 (Cholesky — tiny at these m), then ``M @ V`` runs as a second
      int8 contraction against V's column-scaled packed planes
      (``mixed_precision.ozaki_mm``), and the column-dot with V is f64
      elementwise (O(mn), bandwidth not FLOPs).
    * log-det: f64 Cholesky diagonal (m logs).

    Gradient accuracy ~1e-12 relative (tests) while the Jacobi-equilibrated
    Gram stays within the f32 factorization's accuracy gate
    (cond(Gs) <~ 1e3); beyond it a small-operand ``lax.cond`` takes one
    exact f64 factorization per evaluation (slower, but finite and
    correct — no NaN at cond ~1e8, with accuracy then limited
    by condition-number amplification of the int8 Gram's ~1e-13 error;
    ``tests/test_mixed_oracle.py::test_ill_conditioned_gram_graceful``).
    Drop-in for every driver that takes a ``DOptimalObj`` (same
    pytree-oracle duck type).  Requires ``jax_enable_x64`` like any
    f64-parity run.

    Reference semantics: functions.py:27-82; the workload this accelerates
    is the notebook's ABPG-gain 30x10000 headline
    (ipynb/ABPGvsFW/ex_Dopt_ABPGvsFW.ipynb cell5, 577 s reference CPU).
    """

    # Declared oracle accuracy for line-search acceptances: descent tests
    # compare quantities whose TRUE difference can sit below the oracle's
    # ~1e-12 value/gradient noise; drivers add accept_tol * (1 + |f|) so a
    # noise-level violation cannot fail the search forever (the observed
    # failure mode: the gain G inflating ~1e6 until steps stall into a
    # spurious dzz-converged stop).  Mirrors the reference's AIBM
    # inexact-oracle delta (algorithms.py:625-637).  Measured on the gain
    # LS at 30x1000 (XLA:CPU): no delta -> stall at 4380/9000 iterations
    # with G ~ 3e7; 1e-10 -> 8024 iterations, F within 9e-5 of the f64
    # 9000-iteration value.  The fast_gram path is immune by construction
    # (its acceptance tests the trace-series logdet SHIFT directly) and
    # runs the full budget with G ~ 1.
    accept_tol = 1e-10

    H: Any = None          # (m, n) f64 design matrix (kept for elementwise)
    Vds_hi: Any = None     # (m, n) f32 double-single planes of H (W split)
    Vds_lo: Any = None
    Vd_rows: Any = None    # (levels, m, n) int8, per-row scales (Gram side)
    sV_rows: Any = None    # (m, 1)
    V_packed: Any = None   # (m, levels*n) int8, per-column scales (MV side)
    sV_cols: Any = None    # (n,)
    levels: int = static_field(default=7)
    max_diag: int = static_field(default=6)

    @classmethod
    def from_design(cls, H, levels: int = 7, max_diag: int = 6):
        from . import mixed_precision as mp

        H = jnp.asarray(H, jnp.float64)
        hi = H.astype(jnp.float32)
        lo = (H - hi.astype(jnp.float64)).astype(jnp.float32)
        dr, sr = mp.digit_split_rows(H, levels)
        dc, sc = mp.digit_split_matrix(H, levels)
        return cls(H=H, Vds_hi=hi, Vds_lo=lo, Vd_rows=dr, sV_rows=sr,
                   V_packed=mp.pack_digit_planes(dc), sV_cols=sc,
                   levels=levels, max_diag=max_diag)

    @property
    def m(self):
        return self.H.shape[0]

    @property
    def n(self):
        return self.H.shape[1]

    def _gram(self, x):
        from . import double_single as dsl
        from . import mixed_precision as mp

        # W = V diag(x) split in pure f32 double-single instead of f64
        xh = x.astype(jnp.float32)
        xl = (x - xh.astype(x.dtype)).astype(jnp.float32)
        Wh, Wl = dsl.mul((self.Vds_hi, self.Vds_lo), (xh, xl))
        dW, sW = mp.digit_split_rows_ds(Wh, Wl, self.levels)
        return mp.ozaki_gram(self.Vd_rows, self.sV_rows, dW,
                             sW.astype(jnp.float64), max_diag=self.max_diag)

    # Accuracy gate for the 2-term logdet correction and the 2-step Schulz
    # refinement: both need the f32 factorization residual ||E||_F below
    # ~1e-4 (truncation m*||E||^3/3 and squared seed error then land under
    # 1e-12).  ||E|| ~ eps_f32 * cond(equilibrated Gram), so the fast path
    # covers cond(Gs) up to ~1e3; beyond it (or on an outright f32
    # Cholesky failure) a small-operand lax.cond takes one exact f64
    # factorization — slower, but only for genuinely ill-conditioned
    # iterates.
    _E_GATE2 = 1e-8  # squared Frobenius threshold (||E||_F <= 1e-4)

    def _equilibrated(self, G):
        """Jacobi scaling Gs = D^-1/2 G D^-1/2 (unit diagonal): removes
        the design's row-scaling contribution to the condition number
        before the f32 factorization; logdet(G) = logdet(Gs) + sum log d."""
        d = jnp.sqrt(jnp.diagonal(G))
        Gs = (G / d[:, None]) / d[None, :]
        return Gs, d

    def _chol32_core(self, Gs):
        """(logdet(Gs), M0 ~= Gs^{-1} seed) with the exact-f64 fallback.

        Fast path: native f32 Cholesky + the exact identity
        logdet(Gs) = 2 sum log diag(R) + logdet(R^-1 Gs R^-T), whose
        correction factor is I + E with E ~ eps_f32 * cond small; 2-term
        trace series; the inverse seed is the f32 triangular solve
        (<= ~1e-4 wrong under the gate, for the caller's Schulz polish).
        Slow path (gate failed / f32 NaN): ONE true f64 Cholesky, a rare
        escape hatch, never in the common case."""
        eye32 = jnp.eye(Gs.shape[0], dtype=jnp.float32)
        R = jnp.linalg.cholesky(Gs.astype(jnp.float32))
        R64 = R.astype(jnp.float64)
        delta = (Gs - R64 @ R64.T).astype(jnp.float32)
        Y = solve_triangular(R, delta, lower=True)          # R^-1 D
        E = solve_triangular(R, Y.T, lower=True).T          # R^-1 D R^-T
        En2 = jnp.sum(E.astype(jnp.float64) ** 2)
        ok = jnp.isfinite(En2) & (En2 <= self._E_GATE2)

        def fast():
            trE = jnp.trace(E).astype(jnp.float64)
            # HIGHEST: f32 matmuls may default to reduced-precision passes
            # (TF32 on the GPU), ~1e-3 relative noise on tr(E^2) (see
            # fastgram.schulz)
            trE2 = jnp.trace(jnp.matmul(
                E, E, precision=jax.lax.Precision.HIGHEST)
            ).astype(jnp.float64)
            ld = (2.0 * jnp.sum(jnp.log(jnp.diagonal(R64)))
                  + trE - 0.5 * trE2)
            return ld, cho_solve((R, True), eye32).astype(jnp.float64)

        def exact():
            R64f = jnp.linalg.cholesky(Gs)
            ld = 2.0 * jnp.sum(jnp.log(jnp.diagonal(R64f)))
            eye64 = jnp.eye(Gs.shape[0], dtype=Gs.dtype)
            return ld, cho_solve((R64f, True), eye64)

        return jax.lax.cond(ok, fast, exact)

    def _chol32_logdet(self, G):
        Gs, d = self._equilibrated(G)
        ld_s, _ = self._chol32_core(Gs)
        return None, ld_s + 2.0 * jnp.sum(jnp.log(d))

    def value(self, x, key=None):
        _, logdet = self._chol32_logdet(self._gram(x))
        return -logdet

    def value_and_grad(self, x, key=None):
        from . import mixed_precision as mp

        G = self._gram(x)
        Gs, d = self._equilibrated(G)
        ld_s, M = self._chol32_core(Gs)
        f = -(ld_s + 2.0 * jnp.sum(jnp.log(d)))
        # Schulz refinement of the inverse seed (M <- 2M - M Gs M squares
        # the seed error: <= ~1e-4 under the gate -> ~1e-16 in two steps;
        # the exact branch's seed is f64-grade already).  Each step is two
        # PARALLEL m x m f64 matmuls, not a sequential factorization.
        for _ in range(2):
            M = 2.0 * M - M @ (Gs @ M)
        # un-equilibrate: G^{-1} = D^-1/2 Gs^{-1} D^-1/2
        M = (M / d[:, None]) / d[None, :]
        MV = mp.ozaki_mm(M, self.V_packed, self.sV_cols, self.levels,
                         levels_m=self.levels, max_diag=self.max_diag)
        g = -jnp.sum(self.H * MV, axis=0)
        return f, g

    # -- fast-Gram protocol (see DOptimalObj): the int8-Ozaki Gram is the
    #    ONE full contraction a stateful driver trial pays. --

    def gram(self, x):
        return self._gram(x)

    def logdet_full(self, G):
        return self._chol32_logdet(G)[1]

    def inv_seed(self, G):
        """Inverse seed for the caller's Schulz polish: equilibrated f32
        Cholesky solve in the common case (error <= ~1e-4 under the
        ||E|| gate), the exact-f64 branch when the Gram is too
        ill-conditioned for f32 (see ``_chol32_core``)."""
        Gs, d = self._equilibrated(G)
        _, M = self._chol32_core(Gs)
        return (M / d[:, None]) / d[None, :]

    def grad_from_inv(self, M):
        from . import mixed_precision as mp

        MV = mp.ozaki_mm(M, self.V_packed, self.sV_cols, self.levels,
                         levels_m=self.levels, max_diag=self.max_diag)
        return -jnp.sum(self.H * MV, axis=0)


@pytree_dataclass
class DOptimalObjDS(SmoothOracle):
    """``DOptimalObj`` in DOUBLE-SINGLE (two-f32) arithmetic: f64-grade
    oracle answers from pure f32/int8 ops — no ``jax_enable_x64``, no f64
    ANYWHERE (the ``DOptimalObjMixed`` oracle still runs f64 elementwise
    combines and logs).

    Exposes the DS fast-Gram protocol consumed by the ``fast_gram="ds"``
    driver steps (algorithms/bpg.py): every multi-plane value is a DS
    ``(hi, lo)`` f32 pair,

    * ``gram_ds``: W = V diag(x) in DS, digit-split in f32
      (``digit_split_rows_ds``), ONE int8 contraction with exact int32
      accumulation, DS combine (``ozaki_gram_ds``) — relative ~1e-13;
    * ``logdet_full_ds``: exact power-of-two Jacobi equilibration, f32
      Cholesky + DS trace-series correction under a residual gate, DS
      column-Cholesky (ds_linalg) as the ill-conditioned fallback;
    * ``inv_seed32``: f32 equilibrated Cholesky solve (callers Schulz-polish
      to DS grade, fastgram.inv_pair_ds);
    * ``grad_from_inv_ds``: M @ V as an int8 Ozaki GEMM with DS combine,
      then the column dot with V in DS elementwise.

    Reference semantics: functions.py:27-82 (same f, gradient, Gram);
    target workload: the accelerated-family benchmarks of
    ipynb/ABPGvsFW/ex_Dopt_ABPGvsFW.ipynb cells 3/5 at f64-grade accuracy
    WITHOUT x64 (BASELINE.md round-3 rows).
    """

    # Declared oracle accuracy for line-search acceptances (see
    # DOptimalObjMixed.accept_tol — same failure mode at the DS noise
    # scale): without it the 30x1000 gain line search spiraled on-chip
    # once true descent margins sank below the ~1e-12 DS shift noise
    # (G inflating, theta -> 0, spurious dzz-converged stop at k=449/9000).
    accept_tol = 1e-12

    Vh: Any = None         # (m, n) f32 DS planes of the design matrix
    Vl: Any = None
    Vd_rows: Any = None    # (levels, m, n) int8, per-row scales (Gram side)
    sV_rows: Any = None    # (m, 1) f32 powers of two
    V_packed: Any = None   # (m, levels*n) int8, per-column scales (MV side)
    sV_cols: Any = None    # (n,) f32 powers of two
    levels: int = static_field(default=7)
    max_diag: int = static_field(default=6)

    @classmethod
    def from_design(cls, H, levels: int = 7, max_diag: int = 6):
        """Build from a HOST f64 design (numpy) — the hi/lo split happens
        in numpy so no x64 flag is needed (double_single.from_f64)."""
        import numpy as np

        from . import double_single as dsl
        from . import mixed_precision as mp

        H64 = np.asarray(H, np.float64)
        hi, lo = dsl.from_f64(H64)
        dr, sr = mp.digit_split_rows_ds(hi, lo, levels)
        dc, sc = mp.digit_split_matrix_ds(hi, lo, levels)
        return cls(Vh=hi, Vl=lo, Vd_rows=dr, sV_rows=sr,
                   V_packed=mp.pack_digit_planes(dc), sV_cols=sc,
                   levels=levels, max_diag=max_diag)

    @property
    def m(self):
        return self.Vh.shape[0]

    @property
    def n(self):
        return self.Vh.shape[1]

    # plain-oracle interface (diagnostics / init only — the DS drivers
    # never call these in the hot loop); accepts a DS pair or an f32 array
    def value(self, x, key=None):
        if not isinstance(x, tuple):
            x = (jnp.asarray(x, jnp.float32), jnp.zeros(jnp.shape(x),
                                                        jnp.float32))
        ld = self.logdet_full_ds(self.gram_ds(x))
        return -(ld[0] + ld[1])

    def value_and_grad(self, x, key=None):
        raise NotImplementedError(
            "DOptimalObjDS is a fast-gram-protocol oracle; use it with "
            "fast_gram='ds' drivers (BPG/ABPG/ABPG_gain/...)")

    # -- DS fast-Gram protocol ------------------------------------------------

    def gram_ds(self, x):
        from . import double_single as dsl
        from . import mixed_precision as mp

        Wh, Wl = dsl.mul((self.Vh, self.Vl), (x[0][None, :], x[1][None, :]))
        dW, sW = mp.digit_split_rows_ds(Wh, Wl, self.levels)
        return mp.ozaki_gram_ds(self.Vd_rows, self.sV_rows, dW, sW,
                                max_diag=self.max_diag)

    # residual gate for the f32-Cholesky logdet correction and inverse
    # seed (see DOptimalObjMixed._E_GATE2 — same analysis, f32 planes)
    _E_GATE2 = 1e-8

    def _equilibrated(self, G):
        """EXACT power-of-two Jacobi scaling: d_i = 2^round(log2 sqrt G_ii),
        Gs = D^-1 G D^-1 computed by exact f32 scalings of both planes;
        logdet(G) = logdet(Gs) + 2 sum log d_i with each log d_i = k_i ln2
        exact in DS."""
        from . import double_single as dsl

        d = jnp.exp2(jnp.round(0.5 * jnp.log2(jnp.diagonal(G[0]))))
        inv = 1.0 / d  # power of two: exact
        scale = inv[:, None] * inv[None, :]
        Gs = (G[0] * scale, G[1] * scale)
        # 2*sum log d = 2*ln2 * sum k, k integer-valued f32
        ksum = jnp.sum(jnp.log2(d))
        ln2 = (jnp.float32(dsl._LN2[0]), jnp.float32(dsl._LN2[1]))
        logdet_d2 = dsl.mul_f32(ln2, 2.0 * ksum)
        return Gs, d, logdet_d2

    def logdet_full_ds(self, G):
        """DS logdet of a DS Gram (anchor/fallback path, not per-trial)."""
        from . import double_single as dsl
        from . import ds_linalg as dl

        Gs, d, ld_d2 = self._equilibrated(G)
        R32 = jnp.linalg.cholesky(Gs[0])
        # delta = Gs - R R^T exactly (DS); E = R^-1 delta R^-T in f32
        RRT = dl.mm_f32_f32(R32, R32.T)
        delta = dsl.sub(Gs, RRT)
        Y = solve_triangular(R32, delta[0] + delta[1], lower=True)
        E = solve_triangular(R32, Y.T, lower=True).T
        En2 = jnp.sum(E * E)
        ok = jnp.isfinite(En2) & (En2 <= self._E_GATE2)

        def fast():
            ld_r = dsl.mul_f32(
                dsl.sum_along(dsl.log(dsl.from_f32(jnp.diagonal(R32))), 0),
                jnp.float32(2.0))
            # logdet(I + E) = tr E - tr E^2/2 + tr E^3/3 (E ~ <= 1e-4
            # under the gate; quartic term <= m*1e-16).  HIGHEST precision:
            # f32 matmuls may default to reduced precision (see
            # fastgram.schulz)
            hi = jax.lax.Precision.HIGHEST
            E2 = jnp.matmul(E, E, precision=hi)
            corr = (jnp.trace(E) - 0.5 * jnp.trace(E2)
                    + jnp.trace(jnp.matmul(E2, E, precision=hi)) / 3.0)
            return dsl.add_f32(ld_r, corr)

        def exact():
            return dl.logdet_chol(dl.cholesky(Gs))

        ld_s = jax.lax.cond(ok, fast, exact)
        return dsl.add(ld_s, ld_d2)

    def inv_seed32(self, G):
        """f32 inverse seed of the DS Gram for the caller's Schulz polish
        (error ~eps_f32 * cond; fastgram.inv_pair_ds lifts it to DS)."""
        Gs, d, _ = self._equilibrated(G)
        R32 = jnp.linalg.cholesky(Gs[0])
        M = cho_solve((R32, True), jnp.eye(self.m, dtype=jnp.float32))
        inv = 1.0 / d
        return M * (inv[:, None] * inv[None, :])

    def grad_from_inv_ds(self, M):
        from . import double_single as dsl
        from . import mixed_precision as mp

        MV = mp.ozaki_mm_ds(M[0], M[1], self.V_packed, self.sV_cols,
                            self.levels, levels_m=self.levels,
                            max_diag=self.max_diag)
        g = dsl.sum_along(dsl.mul((self.Vh, self.Vl), MV), axis=0,
                          sloppy=True)
        return dsl.neg(g)


@pytree_dataclass
class PoissonRegression(SmoothOracle):
    """f(x) = D_KL(b, Ax) for the linear inverse problem Ax ~ b
    (reference: functions.py:85-120)."""

    A: Any = None
    b: Any = None

    def value(self, x, key=None):
        Ax = self.A @ x
        return jnp.sum(self.b * jnp.log(self.b / Ax) + Ax - self.b)

    def grad(self, x, key=None):
        Ax = self.A @ x
        return (1.0 - self.b / Ax) @ self.A

    def value_and_grad(self, x, key=None):
        Ax = self.A @ x
        f = jnp.sum(self.b * jnp.log(self.b / Ax) + Ax - self.b)
        g = (1.0 - self.b / Ax) @ self.A
        return f, g


@pytree_dataclass
class _RegressionMixed(SmoothOracle):
    """Shared machinery for f64-grade regression oracles without f64
    GEMVs: both orientations of the data matrix are pre-split into int8
    Ozaki digit planes (``mixed_precision.digit_split_matrix``), and the
    two per-iteration contractions A@x and r@A run as exact int8
    products (~1e-12 relative).  The O(N)/O(n) elementwise work stays true
    f64 (cheap).  Needs jax_enable_x64; storage is 2*levels bytes per
    matrix entry (vs 8 for f64).

    Serves the same role for Poisson/KL regression that ``DOptimalObjMixed``
    serves for D-optimal design (reference oracles: functions.py:85-158)."""

    b: Any = None
    AT_p: Any = None   # (n, levels*N) int8: packed digits of A^T (A @ x)
    AT_s: Any = None   # (N,) column scales of A^T
    A_p: Any = None    # (N, levels*n) int8: packed digits of A (r @ A)
    A_s: Any = None    # (n,) column scales of A
    levels: int = static_field(default=7)
    max_diag: int = static_field(default=6)  # kept for API compat; the
    # packed GEMV evaluates every diagonal (tail in f32 — ozaki_gemv_packed)

    @classmethod
    def from_data(cls, A, b, levels: int = 7, max_diag: int = 6, **kw):
        from . import mixed_precision as mp

        A = jnp.asarray(A, jnp.float64)
        dT, sT = mp.digit_split_matrix(A.T, levels)
        dA, sA = mp.digit_split_matrix(A, levels)
        return cls(b=jnp.asarray(b, jnp.float64),
                   AT_p=mp.pack_digit_planes(dT), AT_s=sT,
                   A_p=mp.pack_digit_planes(dA), A_s=sA,
                   levels=levels, max_diag=max_diag, **kw)

    # PACKED single-matmul GEMVs: the per-pair ozaki_gemv loop re-reads
    # each digit plane once per diagonal pair (~4x the packed form's
    # memory traffic at 7 levels), and a regression oracle's GEMV IS the
    # whole op, so the one-pass packed contraction is used here.

    def _ax(self, x):
        from . import mixed_precision as mp

        return mp.ozaki_gemv_packed(x, self.AT_p, self.AT_s,
                                    levels_b=self.levels,
                                    levels_a=self.levels)

    def _rta(self, r):
        from . import mixed_precision as mp

        return mp.ozaki_gemv_packed(r, self.A_p, self.A_s,
                                    levels_b=self.levels,
                                    levels_a=self.levels)


@pytree_dataclass
class PoissonRegressionMixed(_RegressionMixed):
    """``PoissonRegression`` with the GEMVs as exact int8 Ozaki products
    (f(x) = D_KL(b, Ax); reference: functions.py:85-120)."""

    accept_tol = 1e-10  # declared value/grad noise for line-search deltas

    def value(self, x, key=None):
        Ax = self._ax(x)
        return jnp.sum(self.b * jnp.log(self.b / Ax) + Ax - self.b)

    def value_and_grad(self, x, key=None):
        Ax = self._ax(x)
        f = jnp.sum(self.b * jnp.log(self.b / Ax) + Ax - self.b)
        return f, self._rta(1.0 - self.b / Ax)


@pytree_dataclass
class KLdivRegressionMixed(_RegressionMixed):
    """``KLdivRegression`` with the GEMVs as exact int8 Ozaki products
    (f(x) = D_KL(Ax, b); reference: functions.py:123-158)."""

    accept_tol = 1e-10  # declared value/grad noise for line-search deltas

    def value(self, x, key=None):
        Ax = self._ax(x)
        return jnp.sum(Ax * jnp.log(Ax / self.b) - Ax + self.b)

    def value_and_grad(self, x, key=None):
        Ax = self._ax(x)
        r = jnp.log(Ax / self.b)
        f = jnp.sum(Ax * r - Ax + self.b)
        return f, self._rta(r)


@pytree_dataclass
class PoissonRegressionDS(_RegressionMixed):
    """``PoissonRegressionMixed`` with DOUBLE-SINGLE elementwise internals
    (round-4 verdict item 8): the two packed int8 GEMVs combine in DS
    (``ozaki_gemv_packed_ds``) and the m-vector log/divides run as DS
    f32-pair transcendentals — no f64 arithmetic anywhere inside the
    oracle; f64 appears only at the driver API boundary (the iterate and
    the returned value/gradient).  Same ~1e-13-relative oracle grade."""

    accept_tol = 1e-10

    def _ax_ds(self, x_ds):
        from . import mixed_precision as mp

        return mp.ozaki_gemv_packed_ds(
            x_ds, self.AT_p, jnp.asarray(self.AT_s, jnp.float32),
            levels_b=self.levels, levels_a=self.levels)

    def _rta_ds(self, r_ds):
        from . import mixed_precision as mp

        return mp.ozaki_gemv_packed_ds(
            r_ds, self.A_p, jnp.asarray(self.A_s, jnp.float32),
            levels_b=self.levels, levels_a=self.levels)

    def _terms(self, x):
        from . import double_single as dsl

        x_ds = dsl.from_f64(jnp.asarray(x, jnp.float64))
        b_ds = dsl.from_f64(self.b)
        Ax = self._ax_ds(x_ds)
        return dsl, b_ds, Ax

    def value(self, x, key=None):
        dsl, b_ds, Ax = self._terms(x)
        # sum(b*log(b/Ax) + Ax - b)
        t = dsl.add(dsl.mul(b_ds, dsl.log(dsl.div(b_ds, Ax))),
                    dsl.sub(Ax, b_ds))
        s = dsl.sum_along(t, 0)
        return dsl.to_f64(s)

    def value_and_grad(self, x, key=None):
        dsl, b_ds, Ax = self._terms(x)
        t = dsl.add(dsl.mul(b_ds, dsl.log(dsl.div(b_ds, Ax))),
                    dsl.sub(Ax, b_ds))
        f = dsl.to_f64(dsl.sum_along(t, 0))
        one = (jnp.ones_like(Ax[0]), jnp.zeros_like(Ax[0]))
        r = dsl.sub(one, dsl.div(b_ds, Ax))
        g = self._rta_ds(r)
        return f, dsl.to_f64(g)


@pytree_dataclass
class KLdivRegressionDS(PoissonRegressionDS):
    """``KLdivRegressionMixed`` with DS elementwise internals — see
    ``PoissonRegressionDS`` (f(x) = D_KL(Ax, b), reference
    functions.py:123-158)."""

    def value(self, x, key=None):
        dsl, b_ds, Ax = self._terms(x)
        r = dsl.log(dsl.div(Ax, b_ds))
        t = dsl.add(dsl.mul(Ax, r), dsl.sub(b_ds, Ax))
        return dsl.to_f64(dsl.sum_along(t, 0))

    def value_and_grad(self, x, key=None):
        dsl, b_ds, Ax = self._terms(x)
        r = dsl.log(dsl.div(Ax, b_ds))
        t = dsl.add(dsl.mul(Ax, r), dsl.sub(b_ds, Ax))
        f = dsl.to_f64(dsl.sum_along(t, 0))
        g = self._rta_ds(r)
        return f, dsl.to_f64(g)


@pytree_dataclass
class SVMfunMixed(_RegressionMixed):
    """``SVM_fun`` (mean hinge + (lamda/2)||x||^2) with both GEMV
    orientations as exact int8 Ozaki products — the same two packed
    contractions as the regression oracles (reference: functions.py:161-194).
    ``from_data(A, y, lamda=...)``; the label vector rides the ``b`` slot.

    Unlike the smooth oracles, f64-grade margins matter STRUCTURALLY here:
    the hinge's active set ``margin < 1`` is a hard threshold, so an f32
    margin error can flip rows of the subgradient."""

    lamda: Any = 0.5

    accept_tol = 1e-10  # declared value/grad noise for line-search deltas

    @classmethod
    def from_data(cls, A, y, lamda=0.5, levels: int = 7, **kw):
        return super().from_data(A, y, levels=levels,
                                 lamda=jnp.float64(lamda), **kw)

    def value(self, x, key=None):
        margin = self.b * self._ax(x)
        return (jnp.mean(jnp.maximum(0.0, 1.0 - margin))
                + (self.lamda / 2.0) * jnp.vdot(x, x))

    def value_and_grad(self, x, key=None):
        margin = self.b * self._ax(x)
        f = (jnp.mean(jnp.maximum(0.0, 1.0 - margin))
             + (self.lamda / 2.0) * jnp.vdot(x, x))
        active = (margin < 1.0).astype(x.dtype)
        g = self.lamda * x - self._rta(active * self.b) / self.b.shape[0]
        return f, g


@pytree_dataclass
class KLdivRegression(SmoothOracle):
    """f(x) = D_KL(Ax, b) (reference: functions.py:123-158)."""

    A: Any = None
    b: Any = None

    def value(self, x, key=None):
        Ax = self.A @ x
        return jnp.sum(Ax * jnp.log(Ax / self.b) - Ax + self.b)

    def grad(self, x, key=None):
        Ax = self.A @ x
        return jnp.log(Ax / self.b) @ self.A

    def value_and_grad(self, x, key=None):
        Ax = self.A @ x
        r = jnp.log(Ax / self.b)
        f = jnp.sum(Ax * r - Ax + self.b)
        return f, r @ self.A


@pytree_dataclass
class SVM_fun(SmoothOracle):
    """Hinge loss + (lamda/2)||x||^2 with subgradient oracle
    (reference: functions.py:161-194)."""

    lamda: Any = 0.5
    A: Any = None
    y: Any = None

    def hinge_loss(self, x):
        return jnp.mean(jnp.maximum(0.0, 1.0 - self.y * (self.A @ x)))

    def value(self, x, key=None):
        return self.hinge_loss(x) + (self.lamda / 2.0) * jnp.vdot(x, x)

    def subgradient_loss(self, x):
        margin = self.y * (self.A @ x)
        active = (margin < 1.0).astype(x.dtype)
        return (active * self.y) @ self.A / self.A.shape[0]

    def grad(self, x, key=None):
        return self.lamda * x - self.subgradient_loss(x)

    def value_and_grad(self, x, key=None):
        margin = self.y * (self.A @ x)
        f = jnp.mean(jnp.maximum(0.0, 1.0 - margin)) + (self.lamda / 2.0) * jnp.vdot(x, x)
        active = (margin < 1.0).astype(x.dtype)
        g = self.lamda * x - (active * self.y) @ self.A / self.A.shape[0]
        return f, g


@pytree_dataclass
class FrobeniusSymLoss(SmoothOracle):
    """SymNMF loss f(X) = 0.5*||M - X X^T||_F^2 (reference: functions.py:908-1034).

    Uses the expanded form 0.5*(||M||^2 + ||X^T X||^2) - <X, M X> so the only
    large GEMMs are M@X (n x n x r) and X^T X (r x r) — never the n x n outer
    product.  Optional gradient noise is drawn from a PRNG key passed by the
    driver (reference draws from the global numpy RNG, :957-960).

    The reference also defines a (broken) cvxpy ``div_prox_map`` on this
    f-oracle referencing nonexistent attributes (functions.py:996-997); that
    dead code is intentionally not reproduced.
    """

    M: Any = None
    M_norm: Any = None
    noise_level: Any = None
    stochastic: bool = static_field(default=False)

    @classmethod
    def create(cls, M, X_init=None, noise_level=None):
        # X_init is accepted for reference signature compatibility
        # (functions.py:913 uses it only to preallocate scratch buffers).
        del X_init
        M = jnp.asarray(M)
        return cls(
            M=M,
            M_norm=jnp.linalg.norm(M),
            noise_level=noise_level,
            stochastic=noise_level is not None,
        )

    def value(self, x, key=None):
        XtX = x.T @ x  # r x r
        t1 = 0.5 * (self.M_norm**2 + jnp.linalg.norm(XtX) ** 2)
        return t1 - jnp.vdot(x, self.M @ x)

    def _noise(self, x, key):
        if self.noise_level is None or key is None:
            return 0.0
        return (jax.random.normal(key, x.shape, x.dtype) - 0.5) * self.noise_level

    def grad(self, x, key=None):
        MX = self.M @ x
        G = 2.0 * (x @ (x.T @ x) - MX)
        return G + self._noise(x, key)

    def value_and_grad(self, x, key=None):
        XtX = x.T @ x
        MX = self.M @ x
        f = 0.5 * (self.M_norm**2 + jnp.linalg.norm(XtX) ** 2) - jnp.vdot(x, MX)
        G = 2.0 * (x @ XtX - MX)
        return f, G + self._noise(x, key)


@pytree_dataclass
class FrobeniusSymLossMixed(SmoothOracle):
    """``FrobeniusSymLoss`` at f64 grade without f64 GEMMs.

    The one large contraction per oracle call, M @ X (n x n x r), runs as
    an exact int8 Ozaki product against digit planes of the CONSTANT
    similarity matrix M, pre-split once (``mixed_precision.digit_split_rows``
    + ``ozaki_mm_presplit`` — the same precompute pattern as
    ``_RegressionMixed``); X^T X is an exact ``ozaki_gram``.  Only the
    O(n r^2) tail (X @ XtX, vdots) stays true f64.  Needs jax_enable_x64;
    storage is ``levels`` bytes per M entry (vs 8 for f64).

    Reference oracle: functions.py:908-1034 (float64 numpy).
    """

    M_d: Any = None      # (levels*n, n) int8 row-digit planes of M
    M_s: Any = None      # (n, 1) f64 row scales
    M_norm2: Any = None  # ||M||_F^2
    levels: int = static_field(default=7)

    accept_tol = 1e-10  # declared value/grad noise for line-search deltas

    @classmethod
    def from_data(cls, M, levels: int = 7):
        from . import mixed_precision as mp

        M = jnp.asarray(M, jnp.float64)
        dM, sM = mp.digit_split_rows(M, levels)
        return cls(M_d=dM.reshape(levels * M.shape[0], M.shape[1]), M_s=sM,
                   M_norm2=jnp.vdot(M, M), levels=levels)

    def _mx(self, x):
        from . import mixed_precision as mp

        dX, sX = mp.digit_split_matrix(x, self.levels)
        return mp.ozaki_mm_presplit(self.M_d, self.M_s,
                                    mp.pack_digit_planes(dX), sX,
                                    self.levels, self.levels)

    def _xtx(self, x):
        from . import mixed_precision as mp

        dXt, sXt = mp.digit_split_rows(x.T, self.levels)
        return mp.ozaki_gram(dXt, sXt, dXt, sXt)

    def value(self, x, key=None):
        XtX = self._xtx(x)
        return (0.5 * (self.M_norm2 + jnp.vdot(XtX, XtX))
                - jnp.vdot(x, self._mx(x)))

    def value_and_grad(self, x, key=None):
        from . import mixed_precision as mp

        XtX = self._xtx(x)
        MX = self._mx(x)
        f = 0.5 * (self.M_norm2 + jnp.vdot(XtX, XtX)) - jnp.vdot(x, MX)
        # x @ XtX through the same exact int8 route, so the oracle runs no
        # f64 matmul at all
        dXtX, sXtX = mp.digit_split_matrix(XtX, self.levels)
        xXtX = mp.ozaki_mm(x, mp.pack_digit_planes(dXtX), sXtX,
                           levels_b=self.levels, levels_m=self.levels)
        return f, 2.0 * (xXtX - MX)


@pytree_dataclass
class FrobeniusSymLossDS(SmoothOracle):
    """``FrobeniusSymLossMixed`` with DOUBLE-SINGLE interiors: every
    combine and tail is
    (hi, lo) f32: M @ X through ``ozaki_mm_presplit_ds``, X^T X through
    ``ozaki_gram_ds``, X @ (X^T X) through ``ozaki_mm_ds``, all vdots as
    DS folds.  f64 exists only at the driver API boundary.

    Reference oracle: functions.py:908-1034."""

    M_d: Any = None      # (levels*n, n) int8 row-digit planes of M
    M_s: Any = None      # (n, 1) f32 row scales (powers of two)
    M_norm2: Any = None  # ||M||_F^2 (f64 host scalar)
    levels: int = static_field(default=7)

    accept_tol = 1e-10

    @classmethod
    def from_data(cls, M, levels: int = 7):
        from . import mixed_precision as mp

        M = jnp.asarray(M, jnp.float64)
        dM, sM = mp.digit_split_rows(M, levels)
        return cls(M_d=dM.reshape(levels * M.shape[0], M.shape[1]),
                   M_s=jnp.asarray(sM, jnp.float32),
                   M_norm2=jnp.vdot(M, M), levels=levels)

    def _pieces(self, x):
        from . import double_single as dsl
        from . import mixed_precision as mp

        x_ds = dsl.from_f64(jnp.asarray(x, jnp.float64))
        dX, sX = mp.digit_split_matrix_ds(x_ds[0], x_ds[1], self.levels)
        MX = mp.ozaki_mm_presplit_ds(self.M_d, self.M_s,
                                     mp.pack_digit_planes(dX), sX,
                                     self.levels, self.levels)
        dXt, sXt = mp.digit_split_rows_ds(x_ds[0].T, x_ds[1].T, self.levels)
        XtX = mp.ozaki_gram_ds(dXt, sXt, dXt, sXt)
        return dsl, mp, x_ds, MX, XtX

    @staticmethod
    def _vdot_ds(dsl, a, b):
        t = dsl.mul(a, b)
        return dsl.sum_along(dsl.sum_along(t, 1), 0)

    def _value_ds(self, dsl, x_ds, MX, XtX):
        q = self._vdot_ds(dsl, XtX, XtX)
        c = self._vdot_ds(dsl, x_ds, MX)
        v = dsl.sub(dsl.mul_f32(q, jnp.float32(0.5)), c)
        return 0.5 * self.M_norm2 + dsl.to_f64(v)

    def value(self, x, key=None):
        dsl, mp_, x_ds, MX, XtX = self._pieces(x)
        return self._value_ds(dsl, x_ds, MX, XtX)

    def value_and_grad(self, x, key=None):
        dsl, mp_, x_ds, MX, XtX = self._pieces(x)
        f = self._value_ds(dsl, x_ds, MX, XtX)
        dK, sK = mp_.digit_split_matrix_ds(XtX[0], XtX[1], self.levels)
        xK = mp_.ozaki_mm_ds(x_ds[0], x_ds[1], mp_.pack_digit_planes(dK),
                             sK, levels_b=self.levels,
                             levels_m=self.levels)
        g = dsl.mul_f32(dsl.sub(xK, MX), jnp.float32(2.0))
        return f, dsl.to_f64(g)


@pytree_dataclass
class AX_b(SmoothOracle):
    """Affine map f(X) = X A - b, used as the constraint function of the
    primal-dual switching method (reference: functions.py:1037-1065).

    The reference's flag=0 and flag=2 paths disagree on orientation
    (X@A-b vs A@X-b); the flag=0 orientation is the one the primal-dual
    driver exercises, so value/value_and_grad here consistently compute
    X @ A - b.
    """

    A: Any = None
    b: Any = None

    def value(self, x, key=None):
        return x @ self.A - self.b

    def grad(self, x, key=None):
        return self.A

    def value_and_grad(self, x, key=None):
        return self.value(x), self.A


@pytree_dataclass
class LogisticRegression(SmoothOracle):
    """Mean softplus logistic loss f(w) = mean_i log(1+exp(-y_i x_i^T w))
    (reference: functions.py:1068-1104, the one JAX oracle in the reference).

    Fused value+grad shares the logits GEMV; the gradient is the analytic
    -X^T (y * sigmoid(-z)) / m rather than autodiff, and a ``hessian``
    method is provided for parity with the reference's jax.hessian closure.
    """

    X: Any = None
    y: Any = None
    alpha: Any = 0.01

    def value(self, x, key=None):
        z = self.y * (self.X @ x)
        return jnp.mean(jax.nn.softplus(-z))

    def f(self, x):  # reference alias
        return self.value(x)

    def grad(self, x, key=None):
        z = self.y * (self.X @ x)
        w = jax.nn.sigmoid(-z) * self.y
        return -(w @ self.X) / self.X.shape[0]

    def value_and_grad(self, x, key=None):
        z = self.y * (self.X @ x)
        f = jnp.mean(jax.nn.softplus(-z))
        w = jax.nn.sigmoid(-z) * self.y
        return f, -(w @ self.X) / self.X.shape[0]

    def hessian(self, x):
        z = self.y * (self.X @ x)
        s = jax.nn.sigmoid(-z)
        d = s * (1.0 - s)  # y_i^2 = 1
        return (self.X.T * d) @ self.X / self.X.shape[0]


def calculate_tse_constant(h, x_next, y, z_next, z, alpha):
    """Empirical maximal triangle-scaling exponent gamma with
    D(x+, y) <= alpha^gamma * D(z+, z)  (reference: functions.py:1107-1152).

    Vectorized over the reference's downward 1e-5-step scan from 2.5: since
    alpha in (0,1), alpha**gamma is increasing as gamma decreases, so the
    feasible set is a down-set and the answer is the max feasible grid
    point (floor 1.01 - 1e-5, matching the reference's `gamma < 1.01` exit).
    """
    if not (0 < alpha < 1):
        raise ValueError("Step size alpha must be in the interval (0, 1)")
    lhs = h.divergence(x_next, y)
    rhs = h.divergence(z_next, z)
    gammas = jnp.arange(2.5, 1.01 - 1e-5, -1e-5)
    ok = lhs <= alpha**gammas * rhs
    idx = jnp.argmax(ok)  # first True in descending grid = max feasible gamma
    found = jnp.any(ok)
    return jnp.where(found, gammas[idx], gammas[-1] - 1e-5)
