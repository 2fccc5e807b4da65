"""The D-opt Frank-Wolfe engines that remain — u_mode "exact" (what "auto"
runs) and "ds", and the batch's precision "native" and "ds" — through the
driver scenarios: agreement with an independent NumPy Frank-Wolfe, budget
exhausted mid-chunk, truncation at convergence, checkpoint resume,
``refresh_every``, and batch == per-instance.  Every scenario runs both the
away-step method (``D_opt_FW_away``) and the plain one (``D_opt_FW``)."""

import numpy as np
import pytest

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

AWAY = pytest.mark.parametrize("away", [True, False],
                               ids=["away", "plain"])
MODE = pytest.mark.parametrize("mode", ["exact", "ds"])


def _solve(away):
    return acc.D_opt_FW_away if away else acc.D_opt_FW


def _problem(m=10, n=80, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, n)), np.full(n, 1.0 / n)


def _eps(away):
    # plain FW never drops a coordinate, so its negative slack stays near
    # 1 and a 1e-3 target runs to the budget
    return 1e-8 if away else 1e-3


def _stop_eps(away):
    # a target plain FW reaches: its positive slack alone decides
    return 1e-8 if away else 1.0


def _numpy_fw(V, x0, eps, maxitrs, away):
    """Khachiyan / Wolfe-Atwood in NumPy with w = diag(V^T G^-1 V)
    recomputed from scratch every iteration (no rank-1 updates).
    Returns (x, iterations recorded), iterations counting the stopping
    one as the solvers do."""
    m = V.shape[0]
    x = np.array(x0, np.float64)
    for k in range(maxitrs):
        G = (V * x) @ V.T
        w = np.einsum("ij,ij->j", V, np.linalg.solve(G, V))
        i = int(np.argmax(w))
        eps_pos = w[i] / m - 1.0
        if away:
            j = int(np.argmin((w - w[i]) * (x > 1e-8)))
            eps_neg = 1.0 - w[j] / m
        else:
            eps_neg = 1.0 - w[x > 0].min() / m
        if eps_pos <= eps and eps_neg <= eps:
            return x, k + 1
        if not away or eps_pos >= eps_neg:
            t = (w[i] / m - 1.0) / (w[i] - 1.0)
            x = x * (1.0 - t)
            x[i] += t
        else:
            t = min((1.0 - w[j] / m) / (w[j] - 1.0), x[j] / (1.0 - x[j]))
            x = x * (1.0 + t)
            x[j] -= t
    return x, maxitrs


@MODE
@AWAY
def test_matches_numpy_frank_wolfe(mode, away):
    V, x0 = _problem()
    eps = _eps(away)
    x_np, k_np = _numpy_fw(V, x0, eps, 3000, away)
    x, F, SP, SN, T = _solve(away)(V, x0, eps=eps, maxitrs=3000,
                                   verbose=False, chunk=256, u_mode=mode)
    assert len(F) == k_np
    np.testing.assert_allclose(np.asarray(x, np.float64), x_np, atol=1e-10)


@MODE
@AWAY
def test_budget_exhausted_mid_chunk(mode, away):
    """700 iterations with 512-iteration chunks: the second launch stops at
    the budget, and the iterate equals a single-chunk run's."""
    V, x0 = _problem(m=8, n=60, seed=5)
    kw = dict(eps=1e-14, maxitrs=700, verbose=False, u_mode=mode)
    x, F, *_ = _solve(away)(V, x0, chunk=512, **kw)
    x1, F1, *_ = _solve(away)(V, x0, chunk=700, **kw)
    assert len(F) == len(F1) == 700
    np.testing.assert_allclose(np.asarray(x), np.asarray(x1), atol=1e-13)


@MODE
@AWAY
def test_convergence_truncation(mode, away):
    """The history ends at the first iteration whose slacks meet eps (the
    reference's break) and a larger budget changes nothing."""
    V, x0 = _problem(seed=3)
    eps = _stop_eps(away)
    x, F, SP, SN, T = _solve(away)(V, x0, eps=eps, maxitrs=5000,
                                   verbose=False, chunk=128, u_mode=mode)
    met = (np.asarray(SP) <= eps) & (np.asarray(SN) <= eps)
    assert met[-1] and not met[:-1].any()
    assert len(T) == len(F) < 5000
    x2, F2, *_ = _solve(away)(V, x0, eps=eps, maxitrs=9000, verbose=False,
                              chunk=128, u_mode=mode)
    np.testing.assert_array_equal(np.asarray(F2), np.asarray(F))
    np.testing.assert_array_equal(np.asarray(x2), np.asarray(x))


@MODE
@AWAY
def test_checkpoint_resume(mode, away, tmp_path):
    """An interrupted run resumed from its checkpoint reproduces the
    uninterrupted run exactly, and a finished checkpoint resumes to the
    same result without launching."""
    V, x0 = _problem(seed=4)
    eps = _eps(away)
    kw = dict(eps=eps, verbose=False, chunk=64, u_mode=mode)
    ck = str(tmp_path / "fw.npz")
    x_u, F_u, *_ = _solve(away)(V, x0, maxitrs=4000, **kw)
    x_1, F_1, *_ = _solve(away)(V, x0, maxitrs=100, checkpoint=ck, **kw)
    assert len(F_1) == 100
    x_2, F_2, *_ = _solve(away)(V, x0, maxitrs=4000, checkpoint=ck, **kw)
    np.testing.assert_array_equal(np.asarray(F_2), np.asarray(F_u))
    np.testing.assert_array_equal(np.asarray(x_2), np.asarray(x_u))
    x_3, F_3, *_ = _solve(away)(V, x0, maxitrs=4000, checkpoint=ck, **kw)
    np.testing.assert_array_equal(np.asarray(F_3), np.asarray(F_2))


@MODE
@AWAY
def test_refresh_every_preserves_trajectory(mode, away):
    """Re-factorizing (H, w, logdet) every 128 iterations only cancels
    rounding drift: the solve stops where the unrefreshed one does."""
    V, x0 = _problem(m=12, n=120, seed=9)
    eps = _eps(away)
    kw = dict(eps=eps, maxitrs=4000, verbose=False, chunk=64, u_mode=mode)
    x1, F1, *_ = _solve(away)(V, x0, **kw)
    x2, F2, *_ = _solve(away)(V, x0, refresh_every=128, **kw)
    assert abs(len(F1) - len(F2)) <= 2
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-9)


@pytest.mark.parametrize("precision,mode", [("native", "exact"),
                                            ("ds", "ds")])
@AWAY
def test_batch_matches_per_instance(precision, mode, away):
    """Each instance of a batch follows its own single-instance solve:
    the same stopping iteration and the same iterate."""
    rng = np.random.default_rng(6)
    K, m, n = 3, 8, 70
    Vs = rng.standard_normal((K, m, n))
    x0s = np.full((K, n), 1.0 / n)
    eps = _stop_eps(away)
    xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=eps, num_iters=3000,
                                     away=away, precision=precision)
    for k in range(K):
        x, F, *_ = _solve(away)(Vs[k], x0s[k], eps=eps, maxitrs=3000,
                                verbose=False, chunk=500, u_mode=mode)
        met = (np.asarray(SPb[k]) <= eps) & (np.asarray(SNb[k]) <= eps)
        assert int(np.argmax(met)) + 1 == len(F)
        np.testing.assert_allclose(np.asarray(xb[k]), np.asarray(x),
                                   atol=1e-10)
