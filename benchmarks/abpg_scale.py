"""Accelerated-family benchmarks at the reference's headline scales.

The BPG/ABPG family at the scales the reference's own notebooks publish:

* D-opt 30x1000:  BPG-LS 54.1 s / ABPG-gain 55.7 s @ k=9000
  (ipynb/ABPGvsFW/ex_Dopt_ABPGvsFW.ipynb:cell3, F=-8.800 / -8.816)
* D-opt 30x10000: ABPG-gain 577 s @ k=9000 (cell5, F=-1.625e+01)
* KL-regr L1 1000x100 (seed 1): BPG-LS / ABPG-gain(+RS) 1.5-6.1 s @ k=4000
  (ipynb/ex_KL_regr_L1.ipynb:cell4, F=1.278e-01)

Usage:
  PYTHONPATH=. python benchmarks/abpg_scale.py --ours
  JAX_PLATFORMS=cpu PYTHONPATH=. python benchmarks/abpg_scale.py --reference

`--ours` runs each config twice and reports the warm wall time (compile
excluded).  `--reference` executes the UNMODIFIED reference drivers on the
same seeded instances for same-machine numbers.
"""

import argparse
import json
import time

import numpy as np


def _problems():
    import accbpg_and_fw_tpu as acc

    out = {}
    out["dopt_30x1000"] = acc.D_opt_design(30, 1000, randseed=10)
    out["dopt_30x10000"] = acc.D_opt_design(30, 10000, randseed=10)
    out["kl_1000x100"] = acc.KL_nonneg_regr(1000, 100, noise=0.01,
                                            lamdaL1=0.001, randseed=1)
    return out


def run_ours():
    import accbpg_and_fw_tpu as acc

    probs = _problems()
    results = []

    def bench(name, fn):
        fn()  # compile + warm
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        F = np.asarray(out[1])
        row = {"bench": name, "seconds": round(dt, 3),
               "final_F": float(F[-1]), "iters": int(len(F))}
        print(json.dumps(row), flush=True)
        results.append(row)

    f, h, L, x0 = probs["dopt_30x1000"]
    bench("dopt_30x1000_bpg_ls", lambda: acc.BPG(
        f, h, L, x0, maxitrs=9000, linesearch=True, verbose=False))
    bench("dopt_30x1000_abpg_gain", lambda: acc.ABPG_gain(
        f, h, L, x0, gamma=2, maxitrs=9000, verbose=False))

    f2, h2, L2, x02 = probs["dopt_30x10000"]
    bench("dopt_30x10000_abpg_gain", lambda: acc.ABPG_gain(
        f2, h2, L2, x02, gamma=2, maxitrs=9000, verbose=False))

    f3, h3, L3, x03 = probs["kl_1000x100"]
    bench("kl_1000x100_bpg_ls", lambda: acc.BPG(
        f3, h3, L3, x03, maxitrs=4000, linesearch=True, verbose=False))
    bench("kl_1000x100_abpg_gain", lambda: acc.ABPG_gain(
        f3, h3, L3, x03, gamma=2, maxitrs=4000, restart=True,
        restart_rule="g", verbose=False))
    return results


class _NpDOptimalObj:
    """Numpy D-opt f-oracle with the reference's flag protocol
    (SURVEY.md §2.2: slogdet value, g_i = -||(HXH^T)^{-1/2} h_i||^2) — the
    reference drivers must run PURE numpy here (jnp-backed oracles trip an
    XLA:CPU JIT allocator fault under these long eager loops)."""

    def __init__(self, H):
        self.H = np.asarray(H, np.float64)

    def __call__(self, x):
        return self.func_grad(x, flag=0)

    def func_grad(self, x, flag=2):
        HXHT = (self.H * x) @ self.H.T
        sign, logdet = np.linalg.slogdet(HXHT)
        f = -logdet
        if flag == 0:
            return f
        HXHTinvH = np.linalg.solve(HXHT, self.H)
        g = -np.einsum("ij,ij->j", self.H, HXHTinvH)
        if flag == 1:
            return g
        return f, g

    def gradient(self, x):
        return self.func_grad(x, flag=1)


class _NpBurgSimplex:
    """Numpy Burg-entropy simplex h-oracle (SURVEY.md §2.2: bisection +
    Newton on the KKT multiplier)."""

    def __call__(self, x):
        return -np.sum(np.log(x))

    def extra_Psi(self, x):
        return 0.0

    def gradient(self, x):
        return -1.0 / x

    def divergence(self, x, y):
        r = x / y
        return np.sum(r - np.log(r) - 1.0)

    def prox_map(self, g, L):
        gg = g / L
        c = -gg.min() + 1.0
        while np.sum(1.0 / (gg + c)) - 1.0 < 0:
            c = 0.5 * (-gg.min() + c)
        for _ in range(100):
            fc = np.sum(1.0 / (gg + c)) - 1.0
            if abs(fc) <= 1e-10:
                break
            c -= fc / np.sum(-1.0 / (gg + c) ** 2)
        return 1.0 / (gg + c)

    def div_prox_map(self, y, g, L):
        return self.prox_map(g + L / y, L)


class _NpKLdiv:
    """Numpy KL-divergence regression f-oracle (SURVEY.md §2.2)."""

    def __init__(self, A, b):
        self.A = np.asarray(A, np.float64)
        self.b = np.asarray(b, np.float64)

    def __call__(self, x):
        Ax = self.A @ x
        return np.sum(Ax * np.log(Ax / self.b) - Ax + self.b)

    def func_grad(self, x, flag=2):
        Ax = self.A @ x
        f = np.sum(Ax * np.log(Ax / self.b) - Ax + self.b)
        if flag == 0:
            return f
        g = np.log(Ax / self.b) @ self.A
        if flag == 1:
            return g
        return f, g

    def gradient(self, x):
        return self.func_grad(x, flag=1)


class _NpShannonL1:
    """Numpy Shannon-entropy + L1 h-oracle (SURVEY.md §2.2: multiplicative
    mirror step)."""

    def __init__(self, lamda=0.0):
        self.lamda = lamda

    def __call__(self, x):
        return np.sum(x * np.log(x))

    def extra_Psi(self, x):
        return self.lamda * np.sum(np.abs(x))

    def gradient(self, x):
        return 1.0 + np.log(x)

    def divergence(self, x, y):
        return np.sum(x * np.log(x / y) - x + y)

    def prox_map(self, g, L):
        return np.exp(-(g + self.lamda) / L - 1.0)

    def div_prox_map(self, y, g, L):
        return y * np.exp(-(g + self.lamda) / L)


def run_reference():
    import importlib.util
    import os
    import sys
    import types

    REF = "/root/reference/accbpg"
    saved = {k: sys.modules.get(k) for k in ("accbpg", "accbpg.utils")}
    pkg = types.ModuleType("accbpg")
    spec_u = importlib.util.spec_from_file_location(
        "accbpg.utils", os.path.join(REF, "utils.py"))
    utils = importlib.util.module_from_spec(spec_u)
    spec_u.loader.exec_module(utils)
    pkg.utils = utils
    sys.modules["accbpg"] = pkg
    sys.modules["accbpg.utils"] = utils
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_algorithms", os.path.join(REF, "algorithms.py"))
        ref = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ref)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v

    probs = _problems()
    results = []

    def bench(name, fn):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        F = np.asarray(out[1])
        row = {"bench": name, "seconds": round(dt, 3),
               "final_F": float(F[-1]), "iters": int(len(F))}
        print(json.dumps(row), flush=True)
        results.append(row)

    f_j, h_j, L, x0 = probs["dopt_30x1000"]
    f = _NpDOptimalObj(np.asarray(f_j.H))
    h = _NpBurgSimplex()
    x0 = np.asarray(x0, np.float64)
    bench("ref_dopt_30x1000_bpg_ls", lambda: ref.BPG(
        f, h, L, x0, maxitrs=9000, linesearch=True, verbose=False))
    bench("ref_dopt_30x1000_abpg_gain", lambda: ref.ABPG_gain(
        f, h, L, x0, gamma=2, maxitrs=9000, verbose=False))

    f2_j, h2_j, L2, x02 = probs["dopt_30x10000"]
    f2 = _NpDOptimalObj(np.asarray(f2_j.H))
    x02 = np.asarray(x02, np.float64)
    bench("ref_dopt_30x10000_abpg_gain", lambda: ref.ABPG_gain(
        f2, h, L2, x02, gamma=2, maxitrs=9000, verbose=False))

    f3_j, h3_j, L3, x03 = probs["kl_1000x100"]
    f3 = _NpKLdiv(np.asarray(f3_j.A), np.asarray(f3_j.b))
    h3 = _NpShannonL1(lamda=float(h3_j.lamda))
    x03 = np.asarray(x03, np.float64)
    bench("ref_kl_1000x100_bpg_ls", lambda: ref.BPG(
        f3, h3, L3, x03, maxitrs=4000, linesearch=True, verbose=False))
    bench("ref_kl_1000x100_abpg_gain", lambda: ref.ABPG_gain(
        f3, h3, L3, x03, gamma=2, maxitrs=4000, restart=True,
        restart_rule="g", verbose=False))
    return results


def run_f64(force_cpu=False):
    """f64-parity runs: the plain f64 oracle, the int8-Ozaki
    ``DOptimalObjMixed`` oracle, their fast_gram forms, and the same solves
    pinned to the host CPU with ``solver_device("cpu")``.
    """
    import jax

    jax.config.update("jax_enable_x64", True)
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import accbpg_and_fw_tpu as acc

    probs = _problems()
    results = []

    def bench(name, fn):
        fn()  # compile + warm
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        F = np.asarray(out[1])
        row = {"bench": name, "seconds": round(dt, 3),
               "final_F": float(F[-1]), "iters": int(len(F))}
        print(json.dumps(row), flush=True)
        results.append(row)

    f, h, L, x0 = probs["dopt_30x1000"]
    H64 = np.asarray(f.H, np.float64)
    f64 = acc.DOptimalObj(H=jnp.asarray(H64))
    x064 = jnp.asarray(np.asarray(x0, np.float64))
    fmx = acc.DOptimalObjMixed.from_design(H64)
    bench("f64_dopt_30x1000_bpg_ls", lambda: acc.BPG(
        f64, h, L, x064, maxitrs=9000, linesearch=True, verbose=False))
    bench("f64_dopt_30x1000_bpg_ls_mixed", lambda: acc.BPG(
        fmx, h, L, x064, maxitrs=9000, linesearch=True, verbose=False))
    bench("f64_dopt_30x1000_bpg_ls_mixed_fastgram", lambda: acc.BPG(
        fmx, h, L, x064, maxitrs=9000, linesearch=True, verbose=False,
        fast_gram=True))

    def _cpu_fastgram_bpg():
        with acc.solver_device("cpu"):
            return acc.BPG(f64, h, L, x064, maxitrs=9000, linesearch=True,
                           verbose=False, fast_gram=True)

    bench("f64_dopt_30x1000_bpg_ls_cpu_fastgram", _cpu_fastgram_bpg)
    bench("f64_dopt_30x1000_abpg_gain", lambda: acc.ABPG_gain(
        f64, h, L, x064, gamma=2, maxitrs=9000, verbose=False))
    bench("f64_dopt_30x1000_abpg_gain_mixed", lambda: acc.ABPG_gain(
        fmx, h, L, x064, gamma=2, maxitrs=9000, verbose=False))
    bench("f64_dopt_30x1000_abpg_gain_mixed_fastgram", lambda: acc.ABPG_gain(
        fmx, h, L, x064, gamma=2, maxitrs=9000, verbose=False,
        fast_gram=True))

    def _cpu_fastgram_gain():
        with acc.solver_device("cpu"):
            return acc.ABPG_gain(f64, h, L, x064, gamma=2, maxitrs=9000,
                                 verbose=False, fast_gram=True)

    bench("f64_dopt_30x1000_abpg_gain_cpu_fastgram", _cpu_fastgram_gain)

    f2, h2, L2, x02 = probs["dopt_30x10000"]
    H2 = np.asarray(f2.H, np.float64)
    fmx2 = acc.DOptimalObjMixed.from_design(H2)
    x0264 = jnp.asarray(np.asarray(x02, np.float64))
    bench("f64_dopt_30x10000_abpg_gain_mixed", lambda: acc.ABPG_gain(
        fmx2, h2, L2, x0264, gamma=2, maxitrs=9000, verbose=False))
    bench("f64_dopt_30x10000_abpg_gain_mixed_fastgram", lambda: acc.ABPG_gain(
        fmx2, h2, L2, x0264, gamma=2, maxitrs=9000, verbose=False,
        fast_gram=True))
    f264 = acc.DOptimalObj(H=jnp.asarray(H2))

    def _cpu_fastgram_gain_big():
        with acc.solver_device("cpu"):
            return acc.ABPG_gain(f264, h2, L2, x0264, gamma=2, maxitrs=9000,
                                 verbose=False, fast_gram=True)

    bench("f64_dopt_30x10000_abpg_gain_cpu_fastgram", _cpu_fastgram_gain_big)

    f3, h3, L3, x03 = probs["kl_1000x100"]
    f364 = acc.KLdivRegression(A=jnp.asarray(np.asarray(f3.A, np.float64)),
                               b=jnp.asarray(np.asarray(f3.b, np.float64)))
    x0364 = jnp.asarray(np.asarray(x03, np.float64))
    bench("f64_kl_1000x100_bpg_ls", lambda: acc.BPG(
        f364, h3, L3, x0364, maxitrs=4000, linesearch=True, verbose=False))
    bench("f64_kl_1000x100_abpg_gain", lambda: acc.ABPG_gain(
        f364, h3, L3, x0364, gamma=2, maxitrs=4000, restart=True,
        restart_rule="g", verbose=False))

    # the same KL solves pinned to the host CPU (solver_device also pins
    # jax.default_device, so the eager setup runs there too)
    def _kl_ctx(fn):
        def run():
            with acc.solver_device("cpu"):
                return fn()
        return run

    bench("f64_kl_1000x100_bpg_ls_solverdev", _kl_ctx(lambda: acc.BPG(
        f364, h3, L3, x0364, maxitrs=4000, linesearch=True, verbose=False)))
    bench("f64_kl_1000x100_abpg_gain_solverdev", _kl_ctx(
        lambda: acc.ABPG_gain(f364, h3, L3, x0364, gamma=2, maxitrs=4000,
                              restart=True, restart_rule="g",
                              verbose=False)))
    return results


def run_ds_big():
    """Scale-growth row: 30x100000 — 10x the reference notebook's own
    headline n; numpy's cost grows linearly with n."""
    import accbpg_and_fw_tpu as acc

    f, h, L, x0 = acc.D_opt_design(30, 100000, randseed=10)
    H64 = np.asarray(f.H, np.float64)
    fds = acc.DOptimalObjDS.from_design(H64)
    x064 = np.full(100000, 1e-5)

    def bench(name, fn):
        fn()
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        x = np.asarray(out[0], np.float64)
        F = np.asarray(out[1])
        fresh = -np.linalg.slogdet((H64 * (x / x.sum())) @ H64.T)[1]
        print(json.dumps({"bench": name, "seconds": round(dt, 3),
                          "final_F": float(F[-1]),
                          "fresh_f64_F": float(fresh),
                          "iters": int(len(F))}), flush=True)

    bench("ds_dopt_30x100000_abpg_gain", lambda: acc.ABPG_gain(
        fds, h, L, x064, gamma=2, maxitrs=9000, verbose=False,
        fast_gram="ds"))
    bench("ds_dopt_30x100000_bpg_ls", lambda: acc.BPG(
        fds, h, L, x064, maxitrs=9000, linesearch=True, verbose=False,
        fast_gram="ds"))


def run_ds():
    """Double-single engine (fast_gram="ds"): f64-GRADE answers from pure
    f32/int8 ops — no x64 anywhere in the process.  Each
    run reports the warm wall plus a FRESH host-f64 certification of the
    final iterate (slogdet of the simplex-normalized x)."""
    import accbpg_and_fw_tpu as acc

    probs = _problems()
    results = []

    def bench(name, fn, H64):
        fn()  # compile + warm
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        x = np.asarray(out[0], np.float64)
        F = np.asarray(out[1])
        fresh = -np.linalg.slogdet((H64 * (x / x.sum())) @ H64.T)[1]
        row = {"bench": name, "seconds": round(dt, 3),
               "final_F": float(F[-1]), "fresh_f64_F": float(fresh),
               "iters": int(len(F))}
        print(json.dumps(row), flush=True)
        results.append(row)

    for key, iters in (("dopt_30x1000", 9000), ("dopt_30x10000", 9000)):
        f, h, L, x0 = probs[key]
        H64 = np.asarray(f.H, np.float64)
        fds = acc.DOptimalObjDS.from_design(H64)
        x064 = np.full(H64.shape[1], 1.0 / H64.shape[1])
        bench(f"ds_{key}_bpg_ls", lambda: acc.BPG(
            fds, h, L, x064, maxitrs=iters, linesearch=True,
            verbose=False, fast_gram="ds"), H64)
        bench(f"ds_{key}_abpg_gain", lambda: acc.ABPG_gain(
            fds, h, L, x064, gamma=2, maxitrs=iters, verbose=False,
            fast_gram="ds"), H64)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--ours", action="store_true")
    p.add_argument("--reference", action="store_true")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--ds", action="store_true",
                   help="double-single engine rows (fast_gram='ds'; "
                        "f64-grade from pure f32/int8, no x64)")
    p.add_argument("--ds-big", action="store_true",
                   help="30x100000 scale-growth rows (DS engine)")
    p.add_argument("--cpu", action="store_true",
                   help="force the host backend for --f64")
    a = p.parse_args()
    if a.reference:
        run_reference()
    if a.f64:
        run_f64(force_cpu=a.cpu)
    if a.ds:
        run_ds()
    if a.ds_big:
        run_ds_big()
    if a.ours or not (a.reference or a.f64 or a.ds or a.ds_big):
        run_ours()
