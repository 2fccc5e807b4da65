"""Problem factories (L3): each returns ``(f, h, L, x0, ...)`` tuples.

JAX equivalents of the reference's accbpg/applications.py.  Problem
data is generated with the reference's numpy-RNG call sequences under the
same ``randseed`` semantics (so seeded instances are bit-identical to the
reference's and its stored notebook traces apply), then moved to device as
jnp arrays inside pytree oracles.  The JAX generators (hard_FW_log_reg_jax)
are PRNG-keyed end to end.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cholesky

from ..ops import (
    AX_b,
    BurgEntropyL1,
    BurgEntropyL2,
    BurgEntropySimplex,
    DOptimalObj,
    FrobeniusSymLoss,
    KLdivRegression,
    LogisticRegression,
    PoissonRegression,
    PolyDiv,
    ShannonEntropyL1,
    SquaredL2Norm,
    SumOf2nd4thPowers,
    SumOf2nd4thPowersPositiveOrthant,
    SumOf2nd4thPowersPositiveOrthantDS,
    SVM_fun,
)
from .utils import (
    edge_point_on_simplex,
    generate_dataset_for_svm,
    load_libsvm_file,
    random_point_in_l2_ball,
    random_point_on_simplex,
)


def _dev(x, dtype=None):
    return jnp.asarray(np.asarray(x), dtype=dtype)


# ---------------------------------------------------------------------------
# D-optimal design (reference: applications.py:17-95)
# ---------------------------------------------------------------------------


def D_opt_libsvm(filename):
    """D-optimal design from a LIBSVM dataset; transposed so m < n
    (reference: applications.py:17-33)."""
    X, _ = load_libsvm_file(filename)
    H = X.T.toarray("C") if X.shape[0] > X.shape[1] else X.toarray("C")
    n = H.shape[1]
    return (DOptimalObj(H=_dev(H)), BurgEntropySimplex(), 1.0,
            jnp.full(n, 1.0 / n))


def D_opt_design(m, n, randseed=-1, oracle=None):
    """Random D-optimal design instance: H ~ randn(m, n), Burg-simplex h,
    L = 1, x0 = center of simplex (reference: applications.py:36-56).
    Seeded instances reproduce the reference's exactly.

    ``oracle="mixed"`` returns a ``DOptimalObjMixed`` f-oracle (f64-grade
    answers via exact int8 Ozaki GEMMs + refined f32 Cholesky; needs x64
    enabled);
    default is the plain ``DOptimalObj`` in the ambient dtype."""
    if randseed > 0:
        np.random.seed(randseed)
    H = np.random.randn(m, n)
    if oracle == "mixed":
        from ..ops.f_oracles import DOptimalObjMixed

        f = DOptimalObjMixed.from_design(H)
        x0 = jnp.full(n, 1.0 / n, jnp.float64)
    elif oracle is None:
        f = DOptimalObj(H=_dev(H))
        x0 = jnp.full(n, 1.0 / n)
    else:
        raise ValueError(f"unknown oracle={oracle!r} (None or 'mixed')")
    return (f, BurgEntropySimplex(), 1.0, x0)


def D_opt_KYinit(V):
    """Kumar-Yildirim sparse initial point via Gram-Schmidt probe directions
    (JOTA 126(1):1-21, 2005; reference: applications.py:59-95)."""
    V = np.asarray(V)
    m, n = V.shape
    if n <= 2 * m:
        return jnp.full(n, 1.0 / n)

    chosen = []
    Q = np.zeros((m, m))
    for i in range(m):
        b = np.random.rand(m)
        q = b - Q[:, :i] @ (Q[:, :i].T @ b)
        qV = q @ V
        kmax, kmin = int(np.argmax(qV)), int(np.argmin(qV))
        chosen += [kmax, kmin]
        v = V[:, kmin] - V[:, kmax]
        q = v - Q[:, :i] @ (Q[:, :i].T @ v)
        Q[:, i] = q / np.linalg.norm(q)

    x0 = np.zeros(n)
    x0[chosen] = 1.0 / len(chosen)
    x0 /= x0.sum()
    return _dev(x0)


# ---------------------------------------------------------------------------
# Poisson / KL regression (reference: applications.py:98-295)
# ---------------------------------------------------------------------------


def _poisson_data(m, n, noise, randseed, normalizeA):
    if randseed > 0:
        np.random.seed(randseed)
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    x = np.random.rand(n) / n
    x = np.maximum(x - x.sum() / x.size, 0) * 10
    b = A @ x + noise * (np.random.rand(m) - 0.5)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    return A, b


def _regression_oracle(kind, A, b, oracle, levels=None):
    """Build the f-oracle for a Poisson/KL regression factory.

    ``oracle``: None (plain, ambient dtype), "mixed", "ds", or "auto".
    "auto" is the plain oracle: with native f64 no engine is needed (the
    "mixed"/"ds" engines have not been measured on the GPU, PERF.md).
    ``levels`` overrides the digit-plane count for the mixed/ds engines
    (the class default 7 is the ~1e-13 oracle grade)."""
    from ..ops.f_oracles import (KLdivRegression, KLdivRegressionDS,
                                 KLdivRegressionMixed, PoissonRegression,
                                 PoissonRegressionDS,
                                 PoissonRegressionMixed)

    plain, mixed, dscls = {
        "poisson": (PoissonRegression, PoissonRegressionMixed,
                    PoissonRegressionDS),
        "kl": (KLdivRegression, KLdivRegressionMixed, KLdivRegressionDS),
    }[kind]
    if oracle == "auto":
        oracle = None
    kw = {} if levels is None else {"levels": levels}
    if oracle == "mixed":
        return mixed.from_data(A, b, **kw)
    if oracle == "ds":
        return dscls.from_data(A, b, **kw)
    if oracle is not None:
        raise ValueError(f"unknown oracle {oracle!r}; expected None, "
                         "'mixed', 'ds' or 'auto'")
    return plain(A=_dev(A), b=_dev(b))


def Poisson_regrL1(m, n, noise=0.01, lamda=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None):
    """L1-regularized Poisson regression: min_{x>=0} D_KL(b, Ax) + lamda|x|_1
    (reference: applications.py:98-134).  ``oracle``/``levels``: see
    ``_regression_oracle`` ("auto" routes to the best measured engine)."""
    A, b = _poisson_data(m, n, noise, randseed, normalizeA)
    f = _regression_oracle("poisson", A, b, oracle, levels)
    return f, BurgEntropyL1(lamda=lamda), float(b.sum()), jnp.full(n, 10.0 / n)


def Poisson_regrL2(m, n, noise=0.01, lamda=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None):
    """L2-regularized Poisson regression (reference: applications.py:137-172).
    ``oracle``/``levels``: see ``_regression_oracle``."""
    A, b = _poisson_data(m, n, noise, randseed, normalizeA)
    f = _regression_oracle("poisson", A, b, oracle, levels)
    return f, BurgEntropyL2(lamda=lamda), float(b.sum()), jnp.full(n, 1.0 / n)


def KL_nonneg_regr(m, n, noise=0.01, lamdaL1=0, randseed=-1, normalizeA=True,
                   oracle=None, levels=None):
    """L1-regularized KL regression: min_{x>=0} D_KL(Ax, b) + lamda|x|_1
    with Shannon-entropy kernel, L = max column sum
    (reference: applications.py:175-206).  ``oracle``: see
    ``_regression_oracle``."""
    if randseed > 0:
        np.random.seed(randseed)
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    x = np.random.rand(n)
    b = A @ x + noise * (np.random.rand(m) - 0.5)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    f = _regression_oracle("kl", A, b, oracle, levels)
    return f, ShannonEntropyL1(lamda=lamdaL1), float(A.sum(axis=0).max()), jnp.full(n, 0.5)


def Poisson_regr_simplex_acc(m, n, noise=0.01, normalizeA=True):
    """Poisson regression on the simplex with a (Burg, Euclidean) kernel pair
    (reference: applications.py:209-224)."""
    x0 = random_point_on_simplex(n, center=False)
    solution = random_point_on_simplex(n, center=False)
    A = np.random.rand(m, n)
    if normalizeA:
        A = A / A.sum(axis=0)
    b = A @ solution + noise * np.random.rand(m)
    assert b.min() > 0, "need b > 0 for nonnegative regression."
    f = PoissonRegression(A=_dev(A), b=_dev(b))
    return f, [BurgEntropySimplex(eps=1e-7), SquaredL2Norm()], float(np.abs(b).sum()), _dev(x0)


def Poisson_regr_simplex(m, n, noise=0.01, normalizeA=True):
    """Four x0/solution placement scenarios (center/edge cross product) of
    Poisson regression on the simplex (reference: applications.py:227-295).
    Returns ``(h, {scenario: (f, L, solution, x0)})``."""

    def make(solution, x0):
        A = np.random.rand(m, n)
        if normalizeA:
            A = A / A.sum(axis=0)
        b = A @ solution + noise * np.random.rand(m)
        assert b.min() > 0, "need b > 0 for nonnegative regression."
        f = PoissonRegression(A=_dev(A), b=_dev(b))
        return f, float(b.sum()), _dev(solution), _dev(x0)

    def scenario(place):
        # draw x0 BEFORE solution — the reference's generate_sol_and_x0
        # (applications.py:262-285) consumes the global numpy RNG in that
        # order, and seeded instances must be bit-identical to it
        if place == "x0_center_sol_center":
            x0 = random_point_on_simplex(n, center=True)
            solution = random_point_on_simplex(n)
        elif place == "x0_edge_sol_edge":
            x0 = edge_point_on_simplex(np.random.randint(n), n)
            solution = edge_point_on_simplex(np.random.randint(n), n)
        elif place == "x0_edge_sol_center":
            x0 = edge_point_on_simplex(np.random.randint(n), n)
            solution = random_point_on_simplex(n, center=True)
        else:  # x0_center_sol_edge
            x0 = random_point_on_simplex(n, center=True)
            solution = edge_point_on_simplex(np.random.randint(n), n)
        return make(solution, x0)

    scenarios = {place: scenario(place) for place in (
        "x0_center_sol_center", "x0_edge_sol_edge",
        "x0_edge_sol_center", "x0_center_sol_edge")}
    return BurgEntropySimplex(), scenarios


# ---------------------------------------------------------------------------
# SVM on an L2 ball (reference: applications.py:298-327)
# ---------------------------------------------------------------------------


def svm_digits_ds_divs_ball(center=None, lamda=0.5, real_ds=False):
    """SVM (hinge + L2) over an L2 ball with the (PolyDiv, SquaredL2Norm)
    kernel pair (reference: applications.py:298-327)."""
    if real_ds:
        from sklearn.datasets import load_digits

        X, Y = load_digits(n_class=2, return_X_y=True)
        Y = (np.asarray(Y) > 0).astype(int) * 2 - 1
        X = np.asarray(X, dtype=float)
    else:
        X, Y = generate_dataset_for_svm(700, 2000)

    f = SVM_fun(lamda=lamda, A=_dev(X), y=_dev(Y))
    n = X.shape[1]
    radius = min(
        np.sum(np.linalg.norm(X[:, :-1], axis=1)) / (n * lamda),
        (2.0 / lamda) ** 0.5,
    )
    if center is None:
        center = np.zeros(n)

    poly_h = PolyDiv.from_data(_dev(X), lamda=lamda, radius=radius)
    L = float(poly_h.DS_mean + min((2 * lamda) ** 0.5, float(poly_h.DS_mean_quad))) * 0.08
    x0 = random_point_in_l2_ball(center, radius, pos_dir=False)
    return f, [poly_h, SquaredL2Norm()], L, _dev(x0), radius


# ---------------------------------------------------------------------------
# SymNMF / Frobenius losses (reference: applications.py:330-429)
# ---------------------------------------------------------------------------


def FrobeniusSymLossExL2Ball(n, r, ball_center, radius=1.0, on_boundary=True):
    """SymNMF with factor rows sampled on/in an L2 ball
    (reference: applications.py:330-366)."""
    X = np.random.randn(n, r)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    if on_boundary:
        X *= radius
    else:
        X *= radius * np.random.uniform(0, 1, size=(n, 1)) ** (1.0 / r)
    X += ball_center
    assert np.all(X >= 0), "X must be non-negative"

    M = X @ X.T
    X0 = np.ones((n, r)) * radius + 1e-5 * radius
    f = FrobeniusSymLoss.create(_dev(M), _dev(X0))
    sigma = 2 * np.linalg.norm(M, 2)
    return f, SumOf2nd4thPowers(alpha=6.0, sigma=sigma), 1.0, _dev(X0), _dev(M)


def FrobeniusSymLossExLInfBall(n, r, ball_center, radius=1.0, on_boundary=True):
    """SymNMF with factor rows sampled on/in an L-inf ball
    (reference: applications.py:369-401)."""
    X = np.random.randn(n, r)
    X /= np.max(np.abs(X))
    if on_boundary:
        X *= radius
    else:
        X *= radius * np.random.uniform(0, 1)
    X += ball_center
    assert np.all(X >= 0), "X must be non-negative"

    M = X @ X.T
    X0 = np.ones((n, r)) * radius + 1e-5 * radius
    f = FrobeniusSymLoss.create(_dev(M), _dev(X0))
    sigma = 2 * np.linalg.norm(M, 2)
    return f, SumOf2nd4thPowers(alpha=6.0, sigma=sigma), 1.0, _dev(X0), _dev(M)


def FrobeniusSymLossResMeasEx(M, r, noise=0.0, oracle=None):
    """SymNMF of a given similarity matrix M with positive-orthant kernel and
    a Euclidean comparison kernel (reference: applications.py:404-415).

    ``oracle="mixed"`` returns a ``FrobeniusSymLossMixed`` f-oracle
    (f64-grade M@X / X^T X via exact int8 Ozaki products against
    pre-split digit planes of M; needs x64; incompatible with ``noise``).
    ``oracle="ds"`` pairs ``FrobeniusSymLossDS`` with the DS-Cardano prox
    kernel — f64-grade SymNMF from pure f32 arithmetic.  ``oracle="auto"``
    is the plain oracle."""
    M = np.asarray(M)
    X0 = np.random.rand(M.shape[0], r)
    if oracle == "auto":
        oracle = None
    h_cls = SumOf2nd4thPowersPositiveOrthant
    if oracle in ("mixed", "ds"):
        if noise:
            raise ValueError(f"oracle={oracle!r} has no stochastic mode")
        from ..ops.f_oracles import FrobeniusSymLossDS, FrobeniusSymLossMixed

        if oracle == "ds":
            f = FrobeniusSymLossDS.from_data(M)
            h_cls = SumOf2nd4thPowersPositiveOrthantDS
        else:
            f = FrobeniusSymLossMixed.from_data(M)
        X0 = X0.astype(np.float64)
    elif oracle is None:
        f = FrobeniusSymLoss.create(_dev(M), _dev(X0),
                                    noise_level=noise if noise else None)
    else:
        raise ValueError(f"unknown oracle={oracle!r} "
                         "(None, 'mixed', 'ds' or 'auto')")
    h = h_cls(alpha=6.0, sigma=2 * np.linalg.norm(M, 2), upper_bound=None)
    return f, [h, SquaredL2Norm()], 1.0, _dev(X0)


def FrobeniusSymLossExWithLinearCnstrnts(M, r, noise=0):
    """SymNMF with a linear constraint function for the primal-dual method
    (reference: applications.py:418-429)."""
    M = np.asarray(M)
    X0 = np.random.rand(M.shape[0], r)
    f = FrobeniusSymLoss.create(_dev(M), _dev(X0),
                                noise_level=noise if noise else None)
    h = SumOf2nd4thPowersPositiveOrthant(alpha=6.0,
                                         sigma=2 * np.linalg.norm(M, 2))
    g = AX_b(A=_dev(np.random.rand(r)), b=_dev(np.random.rand(M.shape[0]) + 0.5))
    return f, g, h, 1.0, _dev(X0)


# ---------------------------------------------------------------------------
# Logistic regression generators for (L0,L1) Frank-Wolfe
# (reference: applications.py:432-701)
# ---------------------------------------------------------------------------


def toeplitz_matrix(n_features, rho):
    """Toeplitz correlation matrix rho^|i-j| (reference: applications.py:432-434)."""
    idx = jnp.arange(n_features)
    return rho ** jnp.abs(idx[:, None] - idx[None, :])


def L0L1_FW_log_reg(key, n_samples, n_features, ball_constrnt_radius,
                    solution_spread_radius_btm=0.91,
                    solution_spread_radius_up=0.96, noise=0.0, rho=0.98):
    """Legacy hard logistic-regression generator: Toeplitz-correlated design
    with 3^j column scaling (reference: applications.py:437-499;
    hard_FW_log_reg_jax is the parameterized successor)."""
    from .utils import random_point_in_l2_ball_jax_version

    key, key_X, key_noise, key_omega = jax.random.split(key, 4)
    x0 = jnp.zeros(n_features) + 1e-6

    Sigma = toeplitz_matrix(n_features, rho)
    chol_Sigma = cholesky(Sigma, lower=True)
    Z = jax.random.normal(key_X, shape=(n_samples, n_features))
    X = (Z @ chol_Sigma.T) * (3.0 ** jnp.arange(n_features))[None, :]

    true_omega = random_point_in_l2_ball_jax_version(
        jnp.zeros(n_features), ball_constrnt_radius,
        spread_btm=solution_spread_radius_btm,
        spread_up=solution_spread_radius_up, key=key_omega)

    logits = X @ true_omega + noise * jax.random.normal(key_noise, (n_samples,))
    y = jnp.sign(logits)
    y = jnp.where(y == 0, 1.0, y)

    f = LogisticRegression(X=X, y=y)
    row_norms = jnp.linalg.norm(X, axis=1)
    L = jnp.max(row_norms) ** 2
    return f, SquaredL2Norm(), L, 1e-9, jnp.max(row_norms), x0


def hard_FW_log_reg_jax(key, n_samples, n_features, radius=1.0, domain="l1",
                        k_sparse=5, rho=0.95, col_scale=10.0, flip_y=0.0,
                        margin=0.5, class_bias=0.0, x0_mode="center",
                        noise=0.01):
    """Fully parameterized hard logistic-regression generator for FW
    benchmarking: correlated Toeplitz design, domain-constrained k-sparse
    ground truth (l1/l2/linf/simplex), label flips, margin control
    (reference: applications.py:502-658).

    Returns ``(f, h, L, L0, L1, x0, X, y)``.
    """
    key, key_X, key_true, key_noise, key_flip = jax.random.split(key, 5)
    # independent subkeys for the support / value / x0-vertex draws (a single
    # reused key would correlate them)
    key_supp, key_vals, key_x0vert = jax.random.split(key_true, 3)

    Sigma = toeplitz_matrix(n_features, rho)
    chol_Sigma = cholesky(Sigma, lower=True)
    Z = jax.random.normal(key_X, shape=(n_samples, n_features))
    X = Z @ chol_Sigma.T
    X = X * (col_scale ** jnp.linspace(0, 1, n_features))[None, :]

    if domain in ("l1", "simplex"):
        supp = jax.random.choice(key_supp, n_features,
                                 shape=(min(k_sparse, n_features),),
                                 replace=False)
        vals = jax.random.uniform(key_vals, shape=(supp.shape[0],),
                                  minval=0.5, maxval=1.0)
        vals = vals / jnp.sum(jnp.abs(vals)) * radius
        true_omega = jnp.zeros(n_features).at[supp].set(vals)
        if domain == "simplex":
            true_omega = jnp.abs(true_omega)
            true_omega = true_omega / jnp.sum(true_omega) * radius
    elif domain == "linf":
        signs = jax.random.choice(key_supp, jnp.array([-1.0, 1.0]),
                                  shape=(n_features,))
        true_omega = signs * radius
    else:  # l2
        v = jax.random.normal(key_supp, shape=(n_features,))
        true_omega = radius * v / (jnp.linalg.norm(v) + 1e-12)

    logits = margin * (X @ true_omega) + class_bias
    y = jnp.sign(logits + noise * jax.random.normal(key_noise, (n_samples,)))
    if flip_y > 0:
        flip = jax.random.uniform(key_flip, (n_samples,)) < flip_y
        y = jnp.where(flip, -y, y)
    y = jnp.where(y == 0, 1.0, y)

    if domain in ("l1", "simplex") and x0_mode != "center":
        idx = jax.random.randint(key_x0vert, (), 0, n_features)
        v = jnp.zeros(n_features).at[idx].set(radius)
        if domain == "simplex":
            v = v / jnp.sum(v) * radius
        x0 = v
    else:
        x0 = jnp.zeros(n_features)

    row_norms = jnp.linalg.norm(X, axis=1)
    L = jnp.max(row_norms) ** 2
    L1 = jnp.max(row_norms)
    L0 = 1e-12

    return LogisticRegression(X=X, y=y), SquaredL2Norm(), L, L0, L1, x0, X, y


def load_a9a_data(path, bias=True):
    """Load the a9a LIBSVM dataset as dense (X, y in {-1,1})
    (reference: applications.py:661-672)."""
    X, y = load_libsvm_file(path)
    X = X.toarray()
    if bias:
        X = np.hstack([X, np.ones((X.shape[0], 1))])
    y = np.where(y <= 0, -1, 1)
    return X, y


def L0L1_FW_log_reg_a9a(ball_constrnt_radius, path):
    """Real-data (L0,L1) logistic regression on a9a with standardized
    features (reference: applications.py:675-701)."""
    X, y = load_a9a_data(path=path)
    X = (X - X.mean(axis=0)) / np.maximum(X.std(axis=0), 1e-12)

    n_features = X.shape[1]
    x0 = np.random.uniform(-0.5, 0.5, size=n_features)
    x0 = x0 / max(np.linalg.norm(x0, 2) / ball_constrnt_radius,
                  np.linalg.norm(x0, np.inf) / ball_constrnt_radius, 1.0)

    f = LogisticRegression(X=_dev(X), y=_dev(y))
    row_norms = np.linalg.norm(X, axis=1)
    L = float(np.max(row_norms) ** 2)
    return f, SquaredL2Norm(), L, 1e-9, float(np.max(row_norms)), _dev(x0)
