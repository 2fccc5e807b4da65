"""Secondary benchmark: L1-regularized Poisson regression at scale.

Compares our scan-compiled BPG against a faithful numpy implementation
of the same algorithm on the same seeded instance, at a fixed iteration
budget.  The numpy loop below mirrors the reference's BPG + Poisson +
Burg-L1 oracle semantics (accbpg/algorithms.py:11-72, functions.py:85-120,
:274-298) — our drivers are proven trajectory-identical to the reference's
by tests/test_reference_parity.py, so the numpy loop stands in for the
reference at sizes where its notebooks never ran.

    PYTHONPATH=. python benchmarks/poisson_scale.py --m 4000 --n 2000
"""

import argparse
import json
import time

import numpy as np


def numpy_bpg_poisson(A, b, lamda, L, x0, maxitrs):
    """Reference-semantics BPG (no line search) in plain numpy float64."""
    x = x0.copy()
    F = np.zeros(maxitrs)
    for k in range(maxitrs):
        Ax = A @ x
        F[k] = np.sum(b * np.log(b / Ax) + Ax - b) + lamda * x.sum()
        g = (1.0 - b / Ax) @ A
        # Burg-L1 div_prox_map: prox_map(g - L*grad_h(x), L) = L/(lamda+g+L/x)
        x = L / (lamda + g + L / x)
    return x, F


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4000)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--maxitrs", type=int, default=2000)
    p.add_argument("--skip-numpy", action="store_true")
    p.add_argument("--mixed", action="store_true",
                   help="also run the f64-grade mixed-precision oracle")
    p.add_argument("--ds", action="store_true",
                   help="DS-elementwise oracle (PoissonRegressionDS)")
    a = p.parse_args()

    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc

    f, h, L, x0 = acc.Poisson_regrL1(a.m, a.n, noise=0.0001, lamda=1e-3,
                                     randseed=1)
    A64 = np.asarray(f.A, np.float64)
    b64 = np.asarray(f.b, np.float64)
    x064 = np.asarray(x0, np.float64)

    out = {"config": {"m": a.m, "n": a.n, "maxitrs": a.maxitrs,
                      "alg": "BPG(no-LS) Poisson-L1"}}

    if not a.skip_numpy:
        t0 = time.time()
        xr, Fr = numpy_bpg_poisson(A64, b64, 1e-3, float(L), x064, a.maxitrs)
        out["numpy_wall_s"] = round(time.time() - t0, 2)
        out["numpy_F_final"] = float(Fr[-1])

    # our solver (device dtype: f32 by default, f64 under x64)
    f32 = acc.PoissonRegression(A=jnp.asarray(A64), b=jnp.asarray(b64))
    h32 = acc.BurgEntropyL1(lamda=1e-3)
    x, F, Ls, T = acc.BPG(f32, h32, L, jnp.asarray(x064), maxitrs=a.maxitrs,
                          linesearch=False, verbose=False)
    # second run reuses the cached executable: steady-state number
    x, F, Ls, T = acc.BPG(f32, h32, L, jnp.asarray(x064), maxitrs=a.maxitrs,
                          linesearch=False, verbose=False)
    out["ours_wall_s"] = round(float(T[-1]), 3)
    out["ours_F_final"] = float(F[-1])
    if "numpy_wall_s" in out:
        out["speedup"] = round(out["numpy_wall_s"] / max(out["ours_wall_s"], 1e-9), 1)
        out["F_agree"] = bool(abs(out["ours_F_final"] - out["numpy_F_final"])
                              <= 1e-3 * max(1.0, abs(out["numpy_F_final"])))

    if a.mixed:
        # f64-grade without f64 GEMVs: exact int8 Ozaki GEMVs
        import jax

        jax.config.update("jax_enable_x64", True)
        fm = acc.PoissonRegressionMixed.from_data(A64, b64)
        hm = acc.BurgEntropyL1(lamda=jnp.float64(1e-3))
        for _ in range(2):
            x, F, Ls, T = acc.BPG(fm, hm, L, jnp.asarray(x064),
                                  maxitrs=a.maxitrs, linesearch=False,
                                  verbose=False)
        out["mixed_wall_s"] = round(float(T[-1]), 3)
        out["mixed_F_final"] = float(F[-1])
        if a.ds:
            del fm  # both oracles' packed planes together exhaust HBM at 2e8 entries
            fd = acc.PoissonRegressionDS.from_data(A64, b64)
            for _ in range(2):
                x, F, Ls, T = acc.BPG(fd, hm, L, jnp.asarray(x064),
                                      maxitrs=a.maxitrs, linesearch=False,
                                      verbose=False)
            out["ds_wall_s"] = round(float(T[-1]), 3)
            out["ds_F_final"] = float(F[-1])
        if "numpy_wall_s" in out:
            out["mixed_speedup"] = round(
                out["numpy_wall_s"] / max(out["mixed_wall_s"], 1e-9), 1)
            out["mixed_F_absdiff"] = abs(out["mixed_F_final"]
                                         - out["numpy_F_final"])

    # oracle="auto": the factory's default engine (the plain oracle)
    import jax

    jax.config.update("jax_enable_x64", True)
    fa, ha, La, x0a = acc.Poisson_regrL1(a.m, a.n, noise=0.0001, lamda=1e-3,
                                         randseed=1, oracle="auto")
    out["auto_engine"] = type(fa).__name__
    for _ in range(2):
        x, F, Ls, T = acc.BPG(fa, ha, La, jnp.asarray(x064),
                              maxitrs=a.maxitrs, linesearch=False,
                              verbose=False)
    out["auto_wall_s"] = round(float(T[-1]), 3)
    out["auto_F_final"] = float(F[-1])
    if "numpy_wall_s" in out:
        out["auto_speedup"] = round(
            out["numpy_wall_s"] / max(out["auto_wall_s"], 1e-9), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
