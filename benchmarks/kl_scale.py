"""KL-regression at scale: BPG(no-LS) on min_x D_KL(Ax, b) + lamda|x|_1.

Companion to ``poisson_scale.py`` for the second mixed regression oracle
(``KLdivRegressionMixed``): the numpy loop is reference-semantics f64
(gradient log(Ax/b) @ A, multiplicative Shannon mirror prox with L1 shift —
/root/reference/accbpg/functions.py:123-158, :441-466, algorithms.py:11-72
without line search), and the drivers are proven trajectory-identical at
f64.  The mixed oracle's two per-iteration GEMVs run as packed int8 Ozaki
contractions (exact int32 accumulation, ~1e-13 relative).

    PYTHONPATH=. python benchmarks/kl_scale.py --m 20000 --n 10000 --maxitrs 500 --mixed
"""

import argparse
import json
import time

import numpy as np


def numpy_bpg_kl(A, b, lamda, L, x0, maxitrs):
    """Reference-semantics numpy BPG (no LS) with the ShannonEntropyL1
    multiplicative mirror step x1 = x * exp(-(g + lamda)/L)."""
    x = x0.copy()
    F = np.zeros(maxitrs)
    for k in range(maxitrs):
        Ax = A @ x
        r = np.log(Ax / b)
        F[k] = np.sum(Ax * r - Ax + b) + lamda * np.sum(np.abs(x))
        g = r @ A
        x = x * np.exp(-(g + lamda) / L)
    return x, F


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=4000)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--maxitrs", type=int, default=500)
    p.add_argument("--lamda", type=float, default=1e-3)
    p.add_argument("--skip-numpy", action="store_true")
    p.add_argument("--mixed", action="store_true")
    p.add_argument("--levels", type=int, default=7)
    p.add_argument("--ds", action="store_true",
                   help="DS-elementwise oracle (KLdivRegressionDS): packed"
                        " int8 GEMVs with DS combines, DS log — no"
                        " f64 inside the oracle")
    a = p.parse_args()

    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc

    f, h, L, x0 = acc.KL_nonneg_regr(a.m, a.n, noise=0.01, lamdaL1=a.lamda,
                                     randseed=1)
    A64 = np.asarray(f.A, np.float64)
    b64 = np.asarray(f.b, np.float64)
    x064 = np.asarray(x0, np.float64)

    out = {"config": {"m": a.m, "n": a.n, "maxitrs": a.maxitrs,
                      "alg": "BPG(no-LS) KL-L1"}}

    if not a.skip_numpy:
        t0 = time.time()
        xr, Fr = numpy_bpg_kl(A64, b64, a.lamda, float(L), x064, a.maxitrs)
        out["numpy_wall_s"] = round(time.time() - t0, 2)
        out["numpy_F_final"] = float(Fr[-1])

    f32 = acc.KLdivRegression(A=jnp.asarray(A64), b=jnp.asarray(b64))
    h32 = acc.ShannonEntropyL1(lamda=a.lamda)
    for _ in range(2):  # second run reuses the cached executable
        x, F, Ls, T = acc.BPG(f32, h32, L, jnp.asarray(x064),
                              maxitrs=a.maxitrs, linesearch=False,
                              verbose=False)
    out["ours_wall_s"] = round(float(T[-1]), 3)
    out["ours_F_final"] = float(F[-1])

    if a.mixed:
        import jax

        jax.config.update("jax_enable_x64", True)
        fm = acc.KLdivRegressionMixed.from_data(A64, b64,
                                                levels=a.levels)
        out["config"]["levels"] = a.levels
        hm = acc.ShannonEntropyL1(lamda=jnp.float64(a.lamda))
        for _ in range(2):
            x, F, Ls, T = acc.BPG(fm, hm, L, jnp.asarray(x064),
                                  maxitrs=a.maxitrs, linesearch=False,
                                  verbose=False)
        out["mixed_wall_s"] = round(float(T[-1]), 3)
        out["mixed_F_final"] = float(F[-1])
        if "numpy_wall_s" in out:
            out["mixed_speedup"] = round(
                out["numpy_wall_s"] / max(out["mixed_wall_s"], 1e-9), 1)
            out["mixed_F_absdiff"] = abs(out["mixed_F_final"]
                                         - out["numpy_F_final"])
    if a.ds:
        import jax

        jax.config.update("jax_enable_x64", True)
        fd = acc.KLdivRegressionDS.from_data(A64, b64, levels=a.levels)
        hd = acc.ShannonEntropyL1(lamda=jnp.float64(a.lamda))
        for _ in range(2):
            x, F, Ls, T = acc.BPG(fd, hd, L, jnp.asarray(x064),
                                  maxitrs=a.maxitrs, linesearch=False,
                                  verbose=False)
        out["ds_wall_s"] = round(float(T[-1]), 3)
        out["ds_F_final"] = float(F[-1])
        if "numpy_wall_s" in out:
            out["ds_speedup"] = round(
                out["numpy_wall_s"] / max(out["ds_wall_s"], 1e-9), 1)
    # oracle="auto": the factory's default engine (the plain oracle)
    import jax

    jax.config.update("jax_enable_x64", True)
    fa, ha, La, x0a = acc.KL_nonneg_regr(a.m, a.n, noise=0.01,
                                         lamdaL1=a.lamda, randseed=1,
                                         oracle="auto")
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
        out["speedup"] = round(
            out["numpy_wall_s"] / max(out["ours_wall_s"], 1e-9), 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
