"""Secondary benchmark: SymNMF (FrobeniusSymLoss) at scale.

Compares our scan-compiled BPG against a faithful numpy
implementation of the same algorithm on the same seeded instance at a
fixed iteration budget.  The numpy loop mirrors the reference's BPG +
FrobeniusSymLoss + SumOf2nd4thPowersPositiveOrthant semantics
(accbpg/algorithms.py:11-72, functions.py:908-1034, :558-577) — our
drivers are proven trajectory-identical by tests/test_reference_parity.py,
so the numpy loop stands in for the reference at sizes its studies never
ran (the reference SymNMF experiments top out around n=200).

The per-iteration cost is ONE n x n x r GEMM (M @ X) plus O(n r^2) —
the most matmul-shaped workload in the reference's whole problem suite.

    PYTHONPATH=. python benchmarks/symnmf_scale.py --n 4096 --r 32
"""

import argparse
import json
import time

import numpy as np


def _cubic_root(sigma, c, iters=60):
    """Largest real root of z^3 - sigma z^2 = c (c >= 0): z >= sigma,
    phi monotone there; Newton from a from-above start."""
    z = max(sigma, np.cbrt(c)) + 1.0
    for _ in range(iters):
        phi = z * (z * (z - sigma)) - c
        dphi = z * (3.0 * z - 2.0 * sigma)
        z = z - phi / dphi
    return z


def numpy_bpg_symnmf(M, X0, alpha, sigma, L, maxitrs):
    """Reference-semantics BPG (no line search) in plain numpy float64."""
    X = X0.copy()
    nM2 = np.linalg.norm(M) ** 2
    F = np.zeros(maxitrs)
    for k in range(maxitrs):
        MX = M @ X
        XtX = X.T @ X
        F[k] = 0.5 * (nM2 + np.linalg.norm(XtX) ** 2) - np.vdot(X, MX)
        G = 2.0 * (X @ XtX - MX)
        # SumOf2nd4thPowersPositiveOrthant.div_prox_map:
        u = (sigma + alpha * np.vdot(X, X)) * X - G / L
        u = np.maximum(u, 0.0)
        z = _cubic_root(sigma, alpha * np.vdot(u, u))
        X = u / z
    return X, F


def make_instance(n, r, seed):
    """Seeded low-rank-plus-noise similarity target, rand X0 (the
    reference's ResMeasEx protocol, applications.py:404-415, at scale)."""
    rng = np.random.default_rng(seed)
    Y = np.abs(rng.standard_normal((n, r)))
    M = Y @ Y.T / r
    M += 0.01 * np.abs(rng.standard_normal((n, n)))
    M = 0.5 * (M + M.T)
    X0 = rng.random((n, r))
    # spectral norm by power iteration (np.linalg.norm(M, 2) is an O(n^3)
    # SVD -- intractable at n=4096; sigma is a kernel PARAMETER, identical
    # on both sides, so the estimator choice cannot split trajectories)
    v = rng.standard_normal(n)
    for _ in range(50):
        v = M @ v
        v /= np.linalg.norm(v)
    sigma = 2.0 * float(v @ (M @ v))
    return M, X0, sigma


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--r", type=int, default=32)
    p.add_argument("--maxitrs", type=int, default=300)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--skip-numpy", action="store_true")
    p.add_argument("--mixed", action="store_true",
                   help="also run the f64-grade mixed-precision oracle")
    p.add_argument("--ds", action="store_true",
                   help="DS-interior oracle (FrobeniusSymLossDS): all"
                        " combines/tails in two-f32 planes")
    p.add_argument("--levels", type=int, default=7,
                   help="int8 digit planes for the mixed oracle (7 = ~1e-13"
                        " rel; each level is n^2 bytes of per-call stream)")
    a = p.parse_args()

    M, X0, sigma = make_instance(a.n, a.r, a.seed)
    alpha, L = 6.0, 1.0
    out = {"config": {"n": a.n, "r": a.r, "maxitrs": a.maxitrs,
                      "alg": "BPG(no-LS) SymNMF positive-orthant"}}

    if not a.skip_numpy:
        t0 = time.time()
        Xr, Fr = numpy_bpg_symnmf(M, X0, alpha, sigma, L, a.maxitrs)
        out["numpy_wall_s"] = round(time.time() - t0, 2)
        out["numpy_F_final"] = float(Fr[-1])

    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc

    f32 = acc.FrobeniusSymLoss.create(jnp.asarray(M, jnp.float32))
    h = acc.SumOf2nd4thPowersPositiveOrthant(alpha=alpha, sigma=sigma,
                                             upper_bound=None)
    X0d = jnp.asarray(X0, jnp.float32)
    for _ in range(2):  # second run reuses the cached executable
        X, F, Ls, T = acc.BPG(f32, h, L, X0d, maxitrs=a.maxitrs,
                              linesearch=False, verbose=False)
    out["ours_wall_s"] = round(float(T[-1]), 3)
    out["ours_F_final"] = float(F[-1])
    if "numpy_wall_s" in out:
        out["speedup"] = round(out["numpy_wall_s"]
                               / max(out["ours_wall_s"], 1e-9), 1)
        out["F_reldiff"] = abs(out["ours_F_final"] - out["numpy_F_final"]) \
            / max(1.0, abs(out["numpy_F_final"]))

    if a.mixed:
        import jax

        jax.config.update("jax_enable_x64", True)
        fm = acc.FrobeniusSymLossMixed.from_data(M, levels=a.levels)
        out["config"]["levels"] = a.levels
        hm = acc.SumOf2nd4thPowersPositiveOrthant(
            alpha=jnp.float64(alpha), sigma=jnp.float64(sigma),
            upper_bound=None)
        X0m = jnp.asarray(X0, jnp.float64)
        for _ in range(2):
            X, F, Ls, T = acc.BPG(fm, hm, L, X0m, maxitrs=a.maxitrs,
                                  linesearch=False, verbose=False)
        out["mixed_wall_s"] = round(float(T[-1]), 3)
        out["mixed_F_final"] = float(F[-1])
        if a.ds:
            fds = acc.FrobeniusSymLossDS.from_data(M, levels=a.levels)
            # the DS-Cardano prox: the other half of the step in f32 pairs
            hds = acc.SumOf2nd4thPowersPositiveOrthantDS(
                alpha=jnp.float64(alpha), sigma=jnp.float64(sigma),
                upper_bound=None)
            for _ in range(2):
                X, F, Ls, T = acc.BPG(fds, hds, L, X0m, maxitrs=a.maxitrs,
                                      linesearch=False, verbose=False)
            out["ds_wall_s"] = round(float(T[-1]), 3)
            out["ds_F_final"] = float(F[-1])
            # fresh f64 certification of the DS iterate (never trust the
            # incremental history alone).  NOTE: this is F(X_final), ONE
            # prox step beyond F[-1] (which the driver evaluates at the
            # pre-step iterate, reference semantics) — at these budgets
            # BPG still descends ~0.6% per step, so fresh < F[-1] by one
            # step's progress is the CORRECT relationship (verified
            # against pure f64 on CPU).
            Xn = np.asarray(X, np.float64)
            XtX = Xn.T @ Xn
            out["ds_F_fresh_f64"] = float(
                0.5 * (np.linalg.norm(M) ** 2 + np.linalg.norm(XtX) ** 2)
                - np.vdot(Xn, M @ Xn))
        if "numpy_wall_s" in out:
            out["mixed_speedup"] = round(
                out["numpy_wall_s"] / max(out["mixed_wall_s"], 1e-9), 1)
            out["mixed_F_absdiff"] = abs(out["mixed_F_final"]
                                         - out["numpy_F_final"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
