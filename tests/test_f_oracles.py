"""f-oracle tests: fused value_and_grad vs autodiff and direct formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accbpg_and_fw_tpu as acc


def test_d_optimal_obj(rng):
    m, n = 6, 15
    H = rng.normal(size=(m, n))
    f = acc.DOptimalObj(H=jnp.asarray(H))
    x = jnp.asarray(rng.uniform(0.5, 1.5, size=n) / n)

    # value vs numpy slogdet
    HXHT = (H * np.asarray(x)) @ H.T
    sign, logdet = np.linalg.slogdet(HXHT)
    assert sign > 0
    fx, g = f.value_and_grad(x)
    assert abs(float(fx) - (-logdet)) < 1e-9

    # gradient vs autodiff of the value
    g_ad = jax.grad(lambda v: f.value(v))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), rtol=1e-8, atol=1e-10)

    # gradient formula: g_i = -h_i^T HXHT^{-1} h_i
    Hinv = np.linalg.solve(HXHT, H)
    np.testing.assert_allclose(np.asarray(g), -(H * Hinv).sum(axis=0), rtol=1e-8)

    # value/grad consistent with fused path
    np.testing.assert_allclose(float(f.value(x)), float(fx))
    np.testing.assert_allclose(np.asarray(f.grad(x)), np.asarray(g))


@pytest.mark.parametrize("cls", [acc.PoissonRegression, acc.KLdivRegression])
def test_regressions_vs_autodiff(cls, rng):
    m, n = 12, 7
    A = jnp.asarray(rng.uniform(0.1, 1.0, size=(m, n)))
    b = jnp.asarray(rng.uniform(0.5, 1.5, size=m))
    f = cls(A=A, b=b)
    x = jnp.asarray(rng.uniform(0.2, 1.0, size=n))
    fx, g = f.value_and_grad(x)
    g_ad = jax.grad(lambda v: f.value(v))(x)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), rtol=1e-8)
    assert np.isfinite(float(fx))
    # KL divergences are nonnegative at their own kind of residual
    if cls is acc.PoissonRegression:
        direct = float(jnp.sum(b * jnp.log(b / (A @ x)) + A @ x - b))
    else:
        Ax = A @ x
        direct = float(jnp.sum(Ax * jnp.log(Ax / b) - Ax + b))
    assert abs(float(fx) - direct) < 1e-10


def test_svm_fun(rng):
    m, n = 20, 5
    A = jnp.asarray(rng.normal(size=(m, n)))
    y = jnp.asarray(np.sign(rng.normal(size=m)))
    f = acc.SVM_fun(lamda=0.5, A=A, y=y)
    x = jnp.asarray(rng.normal(size=n))
    fx, g = f.value_and_grad(x)
    # value formula
    hinge = float(jnp.mean(jnp.maximum(0, 1 - y * (A @ x))))
    assert abs(float(fx) - (hinge + 0.25 * float(jnp.vdot(x, x)) * 2 * 0.5)) < 1e-10
    # subgradient matches indicator formula
    ind = (np.asarray(y * (A @ x)) < 1).astype(float)
    expect = 0.5 * np.asarray(x) - (ind * np.asarray(y)) @ np.asarray(A) / m
    np.testing.assert_allclose(np.asarray(g), expect, rtol=1e-10)


def test_logistic_regression(rng):
    m, n = 30, 8
    X = jnp.asarray(rng.normal(size=(m, n)))
    w_true = jnp.asarray(rng.normal(size=n))
    y = jnp.sign(X @ w_true)
    f = acc.LogisticRegression(X=X, y=y)
    w = jnp.asarray(rng.normal(size=n) * 0.1)
    fx, g = f.value_and_grad(w)
    g_ad = jax.grad(lambda v: f.value(v))(w)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), rtol=1e-8, atol=1e-12)
    H = f.hessian(w)
    H_ad = jax.hessian(lambda v: f.value(v))(w)
    np.testing.assert_allclose(np.asarray(H), np.asarray(H_ad), rtol=1e-7, atol=1e-12)


def test_frobenius_sym_loss(rng):
    n, r = 10, 3
    X0 = rng.uniform(size=(n, r))
    M = X0 @ X0.T
    f = acc.FrobeniusSymLoss.create(M)
    X = jnp.asarray(rng.uniform(size=(n, r)))
    fx, g = f.value_and_grad(X)
    # direct formula
    direct = 0.5 * np.linalg.norm(M - np.asarray(X) @ np.asarray(X).T) ** 2
    assert abs(float(fx) - direct) < 1e-8
    g_ad = jax.grad(lambda v: 0.5 * jnp.sum((jnp.asarray(M) - v @ v.T) ** 2))(X)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad), rtol=1e-8)
    assert not f.stochastic

    f_noisy = acc.FrobeniusSymLoss.create(M, noise_level=0.1)
    assert f_noisy.stochastic
    _, g1 = f_noisy.value_and_grad(X, key=jax.random.PRNGKey(0))
    _, g2 = f_noisy.value_and_grad(X, key=jax.random.PRNGKey(1))
    assert float(jnp.max(jnp.abs(g1 - g2))) > 0  # noise actually injected


def test_ax_b(rng):
    n, r = 6, 4
    A = jnp.asarray(rng.uniform(size=r))
    b = jnp.asarray(rng.uniform(size=n))
    g = acc.AX_b(A=A, b=b)
    X = jnp.asarray(rng.uniform(size=(n, r)))
    val = g.value(X)
    np.testing.assert_allclose(np.asarray(val), np.asarray(X @ A - b))
    v2, gr = g.value_and_grad(X)
    np.testing.assert_allclose(np.asarray(v2), np.asarray(val))
    np.testing.assert_allclose(np.asarray(gr), np.asarray(A))


def test_calculate_tse_constant():
    h = acc.SquaredL2Norm()
    # For the Euclidean kernel, D(x+,y) = alpha^2 D(z+,z) exactly when
    # x+-y = alpha*(z+-z): gamma should come out at ~2.
    z = jnp.asarray([0.0, 0.0])
    z_next = jnp.asarray([1.0, 1.0])
    alpha = 0.3
    y = jnp.asarray([0.5, 0.5])
    x_next = y + alpha * (z_next - z)
    gamma = float(acc.calculate_tse_constant(h, x_next, y, z_next, z, alpha))
    assert abs(gamma - 2.0) < 1e-3


def test_regression_oracle_auto_routing():
    """oracle="auto" is the plain oracle on every backend; explicit
    engines resolve."""
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.ops.f_oracles import (KLdivRegressionDS,
                                                 PoissonRegression,
                                                 PoissonRegressionMixed)

    f, h, L, x0 = acc.Poisson_regrL1(20, 30, randseed=3, oracle="auto")
    assert isinstance(f, PoissonRegression)
    f, h, L, x0 = acc.Poisson_regrL1(20, 30, randseed=3, oracle="mixed")
    assert isinstance(f, PoissonRegressionMixed)
    f, h, L, x0 = acc.KL_nonneg_regr(20, 30, randseed=3, oracle="ds")
    assert isinstance(f, KLdivRegressionDS)
    import pytest as _pytest

    with _pytest.raises(ValueError, match="unknown oracle"):
        acc.Poisson_regrL2(10, 10, oracle="bogus")


def test_symnmf_factory_ds_route():
    """FrobeniusSymLossResMeasEx oracle="ds" pairs the DS f-oracle with
    the DS-Cardano prox kernel."""
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.ops.f_oracles import FrobeniusSymLossDS

    rng = np.random.default_rng(0)
    M = rng.random((32, 32))
    M = 0.5 * (M + M.T)
    f, hs, L, X0 = acc.FrobeniusSymLossResMeasEx(M, 4, oracle="ds")
    assert isinstance(f, FrobeniusSymLossDS)
    assert isinstance(hs[0], acc.SumOf2nd4thPowersPositiveOrthantDS)
    # auto -> plain
    f2, *_ = acc.FrobeniusSymLossResMeasEx(M, 4, oracle="auto")
    assert isinstance(f2, acc.FrobeniusSymLoss)
