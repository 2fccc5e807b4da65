"""Driver execution-device routing: the explicit solver_device override.
Without it a solve runs where its arrays are; nothing is routed to
another device behind the caller's back."""

import jax
import numpy as np
import pytest

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.algorithms import driver as drv


def _problem():
    return acc.D_opt_design(20, 60, randseed=5)


def test_solver_device_override_matches_default():
    f, h, L, x0 = _problem()
    x_a, F_a, _, _ = acc.BPG(f, h, L, x0, maxitrs=80, verbose=False)
    with acc.solver_device("cpu"):
        x_b, F_b, _, _ = acc.BPG(f, h, L, x0, maxitrs=80, verbose=False)
    np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_b))
    np.testing.assert_array_equal(np.asarray(F_a), np.asarray(F_b))


def test_override_restored_after_block():
    assert drv._DEVICE_OVERRIDE[0] is None
    with acc.solver_device("cpu"):
        assert drv._DEVICE_OVERRIDE[0] == "cpu"
    assert drv._DEVICE_OVERRIDE[0] is None


# -- "auto" routes: one rule on every backend ------------------------------


@pytest.fixture
def on_gpu(monkeypatch):
    """Make the process look like a GPU process to the routing code."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _dopt(m=12, n=150, seed=4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), np.full(n, 1.0 / n)


@pytest.mark.parametrize("away", [True, False])
def test_auto_u_mode_is_exact_on_gpu(on_gpu, away):
    solve = acc.D_opt_FW_away if away else acc.D_opt_FW
    V, x0 = _dopt()
    ra = solve(V, x0, eps=1e-6, maxitrs=400, verbose=False, chunk=128)
    re = solve(V, x0, eps=1e-6, maxitrs=400, verbose=False, chunk=128,
               u_mode="exact")
    np.testing.assert_array_equal(np.asarray(ra[0]), np.asarray(re[0]))
    np.testing.assert_array_equal(ra[1], re[1])


def test_auto_batch_precision_is_native_on_gpu(on_gpu):
    from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

    rng = np.random.default_rng(5)
    Vs = rng.standard_normal((2, 8, 60))
    x0s = np.full((2, 60), 1.0 / 60)
    ra = dopt_fw_batch(Vs, x0s, eps=1e-6, num_iters=150, precision="auto")
    rn = dopt_fw_batch(Vs, x0s, eps=1e-6, num_iters=150, precision="native")
    for a, b in zip(ra, rn):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_auto_regression_oracle_is_plain_on_gpu(on_gpu):
    f, *_ = acc.Poisson_regrL1(40, 30, randseed=3, oracle="auto")
    assert type(f) is acc.PoissonRegression
    f, *_ = acc.KL_nonneg_regr(40, 30, randseed=3, oracle="auto")
    assert type(f) is acc.KLdivRegression


def test_auto_symnmf_oracle_is_plain_on_gpu(on_gpu):
    rng = np.random.default_rng(0)
    M = rng.random((64, 64))
    f, *_ = acc.FrobeniusSymLossResMeasEx(0.5 * (M + M.T), 2, oracle="auto")
    assert type(f) is acc.FrobeniusSymLoss


@pytest.mark.parametrize("u_mode", ["pallas", "pallas_lazy", "bogus"])
def test_unknown_u_mode_raises(u_mode):
    V, x0 = _dopt()
    with pytest.raises(ValueError, match="unknown u_mode"):
        acc.D_opt_FW_away(V, x0, eps=1e-6, maxitrs=10, verbose=False,
                          u_mode=u_mode)


@pytest.mark.parametrize("precision", ["pallas", "pallas_lazy"])
def test_removed_batch_precision_raises(precision):
    from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

    Vs = np.random.default_rng(1).standard_normal((2, 4, 20))
    with pytest.raises(ValueError, match="unknown precision"):
        dopt_fw_batch(Vs, np.full((2, 20), 0.05), eps=1e-6, num_iters=5,
                      precision=precision)
