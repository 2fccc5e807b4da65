"""Legendre kernel (h-oracle) library — all 17 kernels of the reference.

JAX re-implementations of the h-oracles in the reference's
accbpg/functions.py:238-905.  Every class is a frozen pytree
dataclass with pure jnp methods: closed-form proxes stay closed-form, the
simplex multipliers use the fixed-bound Newton kernels from ``roots.py``, and
the reference's cvxpy fallbacks (PolyDiv prox, functions.py:874-894) are
replaced with native on-device solvers.

Numerical-stability deviations from the reference (all mathematically
equivalent): Shannon simplex proxes use log-sum-exp stabilization; PolyDiv's
prox solves the true KKT scalar equation instead of calling SCS; PolyDiv's
``grad`` uses lamda**2 consistently with h (the reference's lamda**4 at
functions.py:898 is a known bug, SURVEY.md §7).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..struct import pytree_dataclass, static_field
from .base import LegendreOracle
from .roots import project_simplex_burg, simplex_inv_multiplier, solve_cubic


def _fnorm(x):
    """2-norm for vectors, Frobenius norm for matrices (any rank)."""
    return jnp.sqrt(jnp.vdot(x, x).real)


# ---------------------------------------------------------------------------
# Burg entropy family: h(x) = -sum log(x_i), domain x > 0
# (reference: functions.py:238-395)
# ---------------------------------------------------------------------------


@pytree_dataclass
class BurgEntropy(LegendreOracle):
    """h(x) = -sum_i log(x_i) on the positive orthant."""

    def value(self, x):
        return -jnp.sum(jnp.log(x))

    def grad(self, x):
        return -1.0 / x

    def divergence(self, x, y):
        r = x / y
        t = r - jnp.log(r) - 1.0
        # x==y==0 coordinates are structurally absent (zero-padded design
        # columns for even device sharding, parallel/mesh.py): their
        # divergence contribution is lim_{x->0} 0, not 0/0 = NaN.  Genuine
        # domain violations (x==0, y>0 or vice versa) still produce inf/NaN
        # and fail line searches, as documented.
        t = jnp.where((x == 0) & (y == 0), jnp.zeros_like(t), t)
        return jnp.sum(t)

    def prox_map(self, g, L):
        # argmin_{x>0} <g,x> - L*sum log x  =>  x = L/g  (needs g > 0)
        return L / g

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + L / y, L)

    # -- double-single variants (fast_gram="ds" drivers; see ops/double_single)

    def divergence_terms_ds(self, x, y):
        """Elementwise DS Bregman divergence terms ``r - log r - 1``,
        r = x/y, via the cancellation-free ``half_sq_log_term`` kernel so
        each element keeps DS RELATIVE accuracy even as r -> 1 (the regime
        every convergent driver ends in).  Returned unsummed so callers
        can batch several reductions into one fold (sum_many)."""
        from . import double_single as ds

        delta = ds.add_f32(ds.div(x, y), jnp.float32(-1.0))
        t = ds.half_sq_log_term(delta)
        both_zero = (x[0] == 0) & (x[1] == 0) & (y[0] == 0) & (y[1] == 0)
        return ds.where(both_zero, ds.from_f32(jnp.zeros_like(t[0])), t)

    def divergence_ds(self, x, y):
        """DS Bregman divergence sum(r - log r - 1) (see
        ``divergence_terms_ds``)."""
        from . import double_single as ds

        return ds.sum_along(self.divergence_terms_ds(x, y), 0)


@pytree_dataclass
class BurgEntropyL1(BurgEntropy):
    """Burg entropy with Psi(x) = lamda*||x||_1 (reference :274-298).

    The prox may be unbounded when g approaches -lamda; same caveat as the
    reference.
    """

    lamda: Any = 0.0

    def extra_psi(self, x):
        return self.lamda * jnp.sum(x)

    def prox_map(self, g, L):
        return L / (self.lamda + g)


@pytree_dataclass
class BurgEntropyL2(BurgEntropy):
    """Burg entropy with Psi(x) = (lamda/2)||x||_2^2 (reference :301-323)."""

    lamda: Any = 0.0

    def extra_psi(self, x):
        return (self.lamda / 2.0) * jnp.vdot(x, x)

    def prox_map(self, g, L):
        # x solves lamda*x^2 + g*x - L = 0 per coordinate (positive root);
        # at lamda == 0 the quadratic degenerates and the closed form is
        # 0/0 — take the linear-equation limit x = L/g (= 1/gg) instead of
        # poisoning the iterate with NaN
        gg = g / L
        lamda_L = self.lamda / L
        safe = jnp.where(lamda_L == 0, 1.0, lamda_L)
        root = (jnp.sqrt(gg * gg + 4.0 * safe) - gg) / (2.0 * safe)
        return jnp.where(lamda_L == 0, 1.0 / gg, root)


@pytree_dataclass
class BurgEntropySimplex(BurgEntropy):
    """Burg entropy restricted to the unit simplex (reference :326-356).

    prox_map solves sum_i 1/(g_i/L + c) = 1 for the multiplier c with a
    jit-compiled warm-started Newton (roots.simplex_inv_multiplier); every
    Newton step is ONE fused full-vector reduction that psums under
    sharding.
    """

    eps: Any = 1e-8

    def prox_map(self, g, L):
        gg = g / L
        c = simplex_inv_multiplier(gg, self.eps)
        return 1.0 / (gg + c)

    # -- warm-started variants for stateful drivers (fast_gram steps):
    #    the multiplier changes slowly across iterations, so carrying it
    #    saves most of the Newton passes (each one a sequential
    #    full-vector reduction).  Any carried value is safe: certified
    #    from-below starts win a max, out-of-domain/stale carries are
    #    discarded (see roots.simplex_inv_multiplier). --

    def prox_map_warm(self, g, L, c_prev):
        gg = g / L
        c = simplex_inv_multiplier(gg, self.eps, c_warm=c_prev)
        return 1.0 / (gg + c), c

    def div_prox_map_warm(self, y, g, L, c_prev):
        return self.prox_map_warm(g + L / y, L, c_prev)

    # -- double-single variants (fast_gram="ds"): x, y, g, L, c are DS pairs

    def prox_map_ds_warm(self, g, L, c_prev):
        from . import double_single as ds
        from .roots import simplex_inv_multiplier_ds

        Lb = (jnp.broadcast_to(L[0], g[0].shape),
              jnp.broadcast_to(L[1], g[1].shape))
        gg = ds.div(g, Lb)
        c = simplex_inv_multiplier_ds(gg, self.eps, c_warm=c_prev)
        cb = (jnp.broadcast_to(c[0], gg[0].shape),
              jnp.broadcast_to(c[1], gg[1].shape))
        ones = ds.from_f32(jnp.ones_like(gg[0]))
        return ds.div(ones, ds.add(gg, cb)), c

    def div_prox_map_ds_warm(self, y, g, L, c_prev):
        from . import double_single as ds

        Lb = (jnp.broadcast_to(L[0], g[0].shape),
              jnp.broadcast_to(L[1], g[1].shape))
        g_shift = ds.add(g, ds.div(Lb, y))
        return self.prox_map_ds_warm(g_shift, L, c_prev)


@pytree_dataclass
class BurgEntropyL2Ball(BurgEntropy):
    """Burg entropy over an L2 ball on the positive side (reference :359-395)."""

    lamda: Any = 0.0
    radius: Any = 1.0
    center: Any = None
    delta: Any = 1e-30

    def div_prox_map(self, y, g, L):
        x = L / (g + L / y)
        if self.center is None:
            center = jnp.zeros_like(x)
        else:
            center = jnp.broadcast_to(jnp.asarray(self.center, x.dtype), x.shape)
        x = x - center
        x = x / jnp.maximum(self.radius, _fnorm(x))
        x = x * self.radius
        x = x + center
        # keep strictly inside the Burg domain (reference's delta floor :391)
        x = jnp.where(x == 0, jnp.asarray(self.delta, x.dtype), x)
        return x


# ---------------------------------------------------------------------------
# Shannon entropy family: h(x) = sum x_i log x_i, domain x >= 0
# (reference: functions.py:398-490)
# ---------------------------------------------------------------------------


@pytree_dataclass
class ShannonEntropy(LegendreOracle):
    """h(x) = sum_i x_i log(x_i), h(0) = 0 (reference :398-438)."""

    delta: Any = 1e-20

    def value(self, x):
        xx = jnp.maximum(x, self.delta)
        return jnp.sum(xx * jnp.log(xx))

    def grad(self, x):
        xx = jnp.maximum(x, self.delta)
        return 1.0 + jnp.log(xx)

    def divergence(self, x, y):
        d = self.delta
        return jnp.sum(x * jnp.log((x + d) / (y + d))) + (jnp.sum(y) - jnp.sum(x))

    def prox_map(self, g, L):
        # argmin_{x>=0} <g,x> + L*h(x)  =>  x = exp(-g/L - 1)
        return jnp.exp(-g / L - 1.0)

    def div_prox_map(self, y, g, L):
        # multiplicative / entropic mirror step
        return y * jnp.exp(-g / L)


@pytree_dataclass
class ShannonEntropyL1(ShannonEntropy):
    """Shannon entropy with Psi(x) = lamda*||x||_1 (reference :441-466)."""

    lamda: Any = 0.0

    def extra_psi(self, x):
        return self.lamda * jnp.sum(x)

    def prox_map(self, g, L):
        return ShannonEntropy.prox_map(self, self.lamda + g, L)

    def div_prox_map(self, y, g, L):
        return ShannonEntropy.div_prox_map(self, y, self.lamda + g, L)


@pytree_dataclass
class ShannonEntropySimplex(ShannonEntropy):
    """Shannon entropy on the unit simplex (reference :469-490).

    Both proxes are softmax-type normalizations; computed through
    log-sum-exp for overflow safety (mathematically identical to the
    reference's direct exp/sum).
    """

    def prox_map(self, g, L):
        return jax.nn.softmax(-g / L)

    def div_prox_map(self, y, g, L):
        # x propto y * exp(-g/L), normalized to the simplex.  Exactly-zero
        # coordinates of y must STAY exactly zero (the reference's
        # y*exp(-g/L)/sum keeps them at 0 — the absorbing state of entropic
        # mirror descent; a plain delta floor would revive them with mass
        # ~delta*exp(-g_i/L)).  -inf logits give softmax mass exactly 0.
        logits = jnp.where(y > 0,
                           jnp.log(jnp.maximum(y, self.delta)) - g / L,
                           -jnp.inf)
        return jax.nn.softmax(logits)


# ---------------------------------------------------------------------------
# 2nd+4th power kernels: h(x) = (sigma/2)||x||^2 + (alpha/4)||x||^4
# (reference: functions.py:493-735)
# ---------------------------------------------------------------------------


@pytree_dataclass
class SumOf2nd4thPowers(LegendreOracle):
    """h(x) = (sigma/2)||x||^2 + (alpha/4)||x||^4 (reference :493-555).

    div_prox_map reduces to the unique real root of the cubic
    z^3 - sigma*z^2 = alpha*||u||^2 (Cardano closed form).
    """

    alpha: Any = 1.0
    sigma: Any = 1.0

    def value(self, x):
        n2 = jnp.vdot(x, x)
        return (self.alpha / 4.0) * n2 * n2 + (self.sigma / 2.0) * n2

    def grad(self, x):
        n2 = jnp.vdot(x, x)
        return (self.sigma + self.alpha * n2) * x

    def divergence(self, x, y):
        return self.value(x) - self.value(y) - jnp.vdot(self.grad(y), x - y)

    def _mirror_point(self, y, g, L):
        """u = grad h(y) - g/L, the point whose grad-h-inverse is the prox."""
        z = self.alpha * jnp.vdot(y, y) + self.sigma
        return z * y - g / L

    def _grad_inverse(self, u):
        """Solve grad h(x) = u:  x = u / z with z^3 - sigma z^2 = alpha||u||^2."""
        z = solve_cubic(self.alpha * jnp.vdot(u, u), self.sigma)
        return u / z

    def prox_map(self, g, L):
        # argmin <g,x> + L h(x)  =>  grad h(x) = -g/L  (the reference leaves
        # this unimplemented, functions.py:493-555, so its own dual-averaging
        # and AIBM paths cannot use these kernels; here it is the same cubic)
        return self._grad_inverse(-g / L)

    def div_prox_map(self, y, g, L):
        return self._grad_inverse(self._mirror_point(y, g, L))


@pytree_dataclass
class SumOf2nd4thPowersPositiveOrthant(SumOf2nd4thPowers):
    """Same kernel, prox clipped to [0, upper_bound] before the cubic solve
    (reference :558-577)."""

    upper_bound: Any = None

    def _clip(self, u):
        if self.upper_bound is None:
            return jnp.maximum(u, 0.0)
        return jnp.clip(u, 0.0, self.upper_bound)

    def prox_map(self, g, L):
        return self._grad_inverse(self._clip(-g / L))

    def div_prox_map(self, y, g, L):
        return self._grad_inverse(self._clip(self._mirror_point(y, g, L)))


@pytree_dataclass
class SumOf2nd4thPowersPositiveOrthantDS(SumOf2nd4thPowersPositiveOrthant):
    """``SumOf2nd4thPowersPositiveOrthant`` with a DOUBLE-SINGLE-interior
    prox: the mirror point, clip, norm reductions and Cardano root all run
    in (hi, lo) f32 pairs — f64-grade answers with NO f64 arithmetic in
    the prox (the kernel math is reference functions.py:558-577 +
    :522-544).  f64 exists only at the driver API boundary, matching the
    ``FrobeniusSymLossDS`` f-oracle — together they form the f64-grade
    SymNMF fast path.  value/grad/divergence stay inherited (exact f64) —
    they appear only in line searches, not the BPG(no-LS) hot loop."""

    def _ds_pieces(self, L):
        from . import double_single as dsl

        f64 = jnp.float64
        alpha = dsl.from_f64(jnp.asarray(self.alpha, f64))
        sigma = dsl.from_f64(jnp.asarray(self.sigma, f64))
        inv_L = dsl.from_f64(1.0 / jnp.asarray(L, f64))
        return dsl, alpha, sigma, inv_L

    @staticmethod
    def _norm2_ds(dsl, x):
        flat = (x[0].reshape(-1), x[1].reshape(-1))
        return dsl.sum_along(dsl.sq(flat), 0)

    def _clip_ds(self, dsl, u):
        pos = (u[0] > 0) | ((u[0] == 0) & (u[1] > 0))
        zero = jnp.zeros_like(u[0])
        u = (jnp.where(pos, u[0], zero), jnp.where(pos, u[1], zero))
        if self.upper_bound is not None:
            ub = dsl.from_f64(jnp.asarray(self.upper_bound, jnp.float64))
            over = dsl.lt(ub, u)
            u = dsl.where(over, (jnp.broadcast_to(ub[0], u[0].shape),
                                 jnp.broadcast_to(ub[1], u[1].shape)), u)
        return u

    def _grad_inverse_ds(self, dsl, alpha, sigma, u):
        from .roots import solve_cubic_ds

        n2u = self._norm2_ds(dsl, u)
        z = solve_cubic_ds(dsl.mul(alpha, n2u), sigma)
        one = (jnp.ones_like(z[0]), jnp.zeros_like(z[0]))
        inv_z = dsl.div(one, z)
        return dsl.mul(u, inv_z)

    def prox_map(self, g, L):
        dsl, alpha, sigma, inv_L = self._ds_pieces(L)
        g_ds = dsl.from_f64(jnp.asarray(g, jnp.float64))
        u = self._clip_ds(dsl, dsl.neg(dsl.mul(g_ds, inv_L)))
        return dsl.to_f64(self._grad_inverse_ds(dsl, alpha, sigma, u))

    def div_prox_map(self, y, g, L):
        dsl, alpha, sigma, inv_L = self._ds_pieces(L)
        y_ds = dsl.from_f64(jnp.asarray(y, jnp.float64))
        g_ds = dsl.from_f64(jnp.asarray(g, jnp.float64))
        n2 = self._norm2_ds(dsl, y_ds)
        zc = dsl.add(dsl.mul(alpha, n2), sigma)
        u = dsl.sub(dsl.mul(zc, y_ds), dsl.mul(g_ds, inv_L))
        u = self._clip_ds(dsl, u)
        return dsl.to_f64(self._grad_inverse_ds(dsl, alpha, sigma, u))


@pytree_dataclass
class SumOf2nd4thPowersOnSimplex(SumOf2nd4thPowers):
    """Same kernel on the matrix simplex (reference :580-636).

    Matches the reference semantics: unconstrained cubic prox followed by the
    Burg-Newton map x = 1/(y+c) with sum(x) = radius-normalized to 1.
    """

    radius: Any = 1.0
    eps: Any = 1e-4

    def div_prox_map(self, y, g, L):
        x = SumOf2nd4thPowers.div_prox_map(self, y, g, L)
        return project_simplex_burg(x, self.eps)


@pytree_dataclass
class SumOf2nd4thPowersDualProxMap(SumOf2nd4thPowers):
    """Same kernel; prox over {x >= 0, ||x|| <= radius} via a primal-dual
    extragradient inner solver (reference :639-698).

    The reference runs up to 7000 Python-loop iterations; here it is one
    bounded ``lax.while_loop`` with the same updates and gap-based early
    exit, fully on device.
    """

    num_iters: int = static_field(default=7000)
    eta_base: Any = 1e-2
    tolerance: Any = 1e-4
    radius: Any = 15.0

    def _project_X(self, X):
        Xp = jnp.maximum(X, 0.0)
        norm = _fnorm(Xp)
        return jnp.where(norm <= self.radius, X, (self.radius / norm) * Xp)

    def div_prox_map(self, y, g, L):
        G = g + self.grad(y)
        alpha, sigma = self.alpha, self.sigma

        def f_func(X, lam):
            n2 = jnp.vdot(X, X)
            return (
                jnp.vdot(G, X - y)
                - L * (alpha / 4.0 * n2 * n2 + sigma / 2.0 * n2)
                - jnp.vdot(lam, X)
            )

        def grads(X, lam):
            n2 = jnp.vdot(X, X)
            gX = G - L * (alpha * n2 * X + sigma * X) - lam
            return gX, -X

        def cond(state):
            X, lam, it, gap = state
            # the reference only breaks on a gap computed at its i >= 1
            # (functions.py:693: ``if i > 0 and gap < tolerance``), so the
            # first body's gap (it == 1 here) must not exit the loop
            return jnp.logical_and(
                it < self.num_iters,
                jnp.logical_or(it <= 1, gap >= self.tolerance),
            )

        def body(state):
            X, lam, it, _ = state
            eta = self.eta_base / (it + 1.0)
            gX, gl = grads(X, lam)
            X_mid = self._project_X(X + eta * gX)
            lam_mid = jnp.maximum(lam - eta * gl, 0.0)
            gXm, glm = grads(X_mid, lam_mid)
            X_new = self._project_X(X + eta * gXm)
            lam_new = jnp.maximum(lam - eta * glm, 0.0)
            X_cand = self._project_X(X_new + eta * gX)
            lam_cand = jnp.maximum(lam_new - eta * gl, 0.0)
            gap = f_func(X_cand, lam_new) - f_func(X_new, lam_cand)
            return (X_new, lam_new, it + 1.0, gap)

        X0 = jnp.zeros_like(y)
        lam0 = jnp.zeros_like(y)
        X, _, _, _ = lax.while_loop(
            cond, body, (X0, lam0, jnp.zeros((), y.dtype), jnp.asarray(jnp.inf, y.dtype))
        )
        return X


@pytree_dataclass
class SumOf2nd4thPowersWithFrankWolfe(SumOf2nd4thPowers):
    """Same kernel; div_prox_map delegates to an LMO (h-as-LMO adapter,
    reference :701-735)."""

    lmo: Optional[Callable] = static_field(default=None)

    def div_prox_map(self, y, g, L):
        return self.lmo(g)


# ---------------------------------------------------------------------------
# Euclidean / miscellaneous kernels (reference: functions.py:738-905)
# ---------------------------------------------------------------------------


@pytree_dataclass
class SquaredL2Norm(LegendreOracle):
    """h(x) = (1/2)||x||^2 — plain Euclidean geometry (reference :738-759)."""

    def value(self, x):
        return 0.5 * jnp.vdot(x, x)

    def grad(self, x):
        return x

    def divergence(self, x, y):
        xy = x - y
        return 0.5 * jnp.vdot(xy, xy)

    def prox_map(self, g, L):
        return -(1.0 / L) * g

    def div_prox_map(self, y, g, L):
        return y - (1.0 / L) * g


@pytree_dataclass
class PowerNeg1(LegendreOracle):
    """h(x) = sum_i 1/x_i on x > 0 (reference :762-779).

    Note: the reference's ``__call__`` returns the elementwise vector 1/x
    (functions.py:766-767); we return the sum, which is what its own
    ``divergence`` formula integrates to.
    """

    def value(self, x):
        return jnp.sum(1.0 / x)

    def grad(self, x):
        return -1.0 / (x * x)

    def divergence(self, x, y):
        xy = x - y
        return jnp.sum(xy * xy / (x * y * y))

    def prox_map(self, g, L):
        return jnp.sqrt(L / g)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + L / (y * y), L)


@pytree_dataclass
class L2L1Linf(LegendreOracle):
    """h = (1/2)||x||^2 with Psi = lamda*||x||_1 and box ||x||_inf <= B
    (reference :782-835).  prox = soft-threshold then clip."""

    lamda: Any = 0.0
    B: Any = 1.0

    def value(self, x):
        return 0.5 * jnp.vdot(x, x)

    def extra_psi(self, x):
        return self.lamda * jnp.sum(jnp.abs(x))

    def grad(self, x):
        return x

    def divergence(self, x, y):
        xy = x - y
        return 0.5 * jnp.vdot(xy, xy)

    def prox_map(self, g, L):
        x = -(1.0 / L) * g
        thr = self.lamda / L
        x = jnp.sign(x) * jnp.maximum(jnp.abs(x) - thr, 0.0)
        return jnp.clip(x, -self.B, self.B)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * y, L)


@pytree_dataclass
class PolyDiv(LegendreOracle):
    """Data-dependent polynomial kernel over an L2 ball (arXiv:1710.04718
    eq. 27; reference :838-905):

        h(x) = (lamda^2/4)||x||^4 + (2 lamda Dbar/3)||x||^3 + (Dbar2/2)||x||^2

    where Dbar / Dbar2 are mean row norms of the dataset DS.  The reference
    solves the prox with cvxpy/SCS; here it is solved natively: the prox over
    the ball is radial, x* = -t * g/||g||, with t the root of the monotone
    scalar equation

        L*(lamda^2 t^3 + 2 lamda Dbar t^2 + Dbar2 t) = ||g||

    clamped to [0, radius] — 64 bisection steps on device, no external
    solver.  (Deviation: the reference first rescales ||g|| to radius before
    solving, functions.py:885-888; we solve the true KKT equation.)
    """

    DS_mean: Any = 0.0
    DS_mean_quad: Any = 0.0
    lamda: Any = 0.0
    radius: Any = 1.0

    @classmethod
    def from_data(cls, DS, lamda=0.0, radius=1.0):
        DS = jnp.asarray(DS)
        row_norms = jnp.linalg.norm(DS, axis=1)
        return cls(
            DS_mean=jnp.mean(row_norms),
            DS_mean_quad=jnp.mean(row_norms**2),
            lamda=lamda,
            radius=radius,
        )

    def value(self, x):
        r = _fnorm(x)
        return (
            self.lamda**2 * 0.25 * r**4
            + 2.0 * self.lamda * self.DS_mean / 3.0 * r**3
            + self.DS_mean_quad * 0.5 * r**2
        )

    def grad(self, x):
        r2 = jnp.vdot(x, x)
        r = jnp.sqrt(r2)
        return (self.lamda**2 * r2 + 2.0 * self.lamda * self.DS_mean * r + self.DS_mean_quad) * x

    def divergence(self, x, y):
        return self.value(x) - self.value(y) - jnp.vdot(self.grad(y), x - y)

    def prox_map(self, g, L):
        from .roots import bisect_monotone

        gnorm = jnp.maximum(_fnorm(g), 1e-12)
        lam, dbar, dbar2 = self.lamda, self.DS_mean, self.DS_mean_quad

        def phi_prime(t):
            return L * (lam**2 * t**3 + 2.0 * lam * dbar * t**2 + dbar2 * t) - gnorm

        t = bisect_monotone(phi_prime, jnp.zeros((), g.dtype), self.radius)
        # if unconstrained root exceeds the ball, sit on the boundary
        t = jnp.where(phi_prime(self.radius) <= 0, self.radius, t)
        return -(t / gnorm) * g

    def div_prox_map(self, y, g, L):
        return self.prox_map(g - L * self.grad(y), L)
