"""Smoke test of the solver library on one NVIDIA GPU, through its public API.

Runs the library's main paths at the reference's sizes in float64, and
checks every result against a host NumPy certificate that shares no code
with the solvers (``diagnostics.dopt_certificate``):

  headline   D_opt_FW_away, D-opt 1000x5000 to slack 1e-8 (bench.py's setup)
  khachiyan  D_opt_FW on the same instance, 2000 iterations
  bpg        ABPG_gain(fast_gram=True) on D-opt 30x10000, checked against
             the same call on the host CPU backend
  sweep      dopt_fw_batch(precision="auto"), K=32 instances of 30x1000
  engines    D_opt_FW_away with u_mode "exact" / "mixed" / "ds", 200x2000
  f32        BPG on an 80x200 float32 design against the float64 run

``--chips 4`` runs only the multi-card path instead: the column-sharded
D-opt FW-away at 1000x20000 and the row-sharded Poisson-regression BPG at
20000x10000, each against the same call on one card.

Usage:  python chip_smoke.py [--chips 4]

Prints the device, the card's name and power limit, and per phase its
first-call time (compilation + one run), wall time, iterations and
checked numbers.  The last line is a JSON object with ``"ok": true`` only
when every phase passed; otherwise the exit code is 1.  Without a GPU it
exits with code 2 before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SLACK_BAR = 1.01e-8


def log(*parts):
    print(*parts, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def timed(fn, *args, **kw):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0


def twice(fn, *args, **kw):
    """(result, first_s, wall_s): the first call compiles and runs, the
    second, timed as the wall time, reuses the compiled executables."""
    _, first = timed(fn, *args, **kw)
    out, wall = timed(fn, *args, **kw)
    return out, first, wall


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# --------------------------------------------------------------------------
# phases: each returns a dict of the numbers it checked; a failed check
# raises.  Sizes are arguments so the tests can run them small on the CPU.
# --------------------------------------------------------------------------


def phase_headline(acc, V, x0, eps, maxitrs, F_star, chunk=2500):
    cert_fn = acc.diagnostics.dopt_certificate
    (x, F, SP, SN, T), first, wall = twice(
        acc.D_opt_FW_away, V, x0, eps=eps, maxitrs=maxitrs, verbose=False,
        chunk=chunk, u_mode="auto")
    cert = cert_fn(V, x)
    out = dict(first_call_s=first, wall_s=wall, iters=len(F),
               F_host=cert["F"], F_star=F_star,
               F_err=abs(cert["F"] - F_star), fresh_slack=cert["slack"],
               gap_bound=cert["gap_bound"], solver_SP=float(SP[-1]),
               solver_SN=float(SN[-1]))
    check(out["F_err"] <= 1e-6, f"|F - F*| = {out['F_err']:.3e} > 1e-6")
    check(cert["slack"] <= SLACK_BAR,
          f"fresh slack {cert['slack']:.3e} > {SLACK_BAR}")
    return out


def phase_khachiyan(acc, V, x0, maxitrs=2000, chunk=500):
    """The solver's F history records F at the START of each iteration, so
    F at the returned x is the next row: resume the run's checkpoint for
    one more iteration to read it through the public API."""
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "fw.npz")
        _, first = timed(acc.D_opt_FW, V, x0, eps=1e-8, maxitrs=maxitrs,
                         verbose=False, chunk=chunk)
        (x, F, SP, SN, T), wall = timed(acc.D_opt_FW, V, x0, eps=1e-8,
                                        maxitrs=maxitrs, verbose=False,
                                        chunk=chunk, checkpoint=ck)
        F1 = acc.D_opt_FW(V, x0, eps=1e-8, maxitrs=maxitrs + 1,
                          verbose=False, chunk=chunk, checkpoint=ck)[1]
    F = np.asarray(F, np.float64)
    F_host = acc.diagnostics.dopt_certificate(V, x)["F"]
    rise = float(np.max((F[1:] - F[:-1]) / np.abs(F[:-1])))
    out = dict(first_call_s=first, wall_s=wall, iters=len(F),
               max_rel_rise=rise, F_solver=float(F1[-1]), F_host=F_host,
               F_rel_err=rel(F_host, float(F1[-1])))
    check(len(F) == maxitrs, f"stopped at {len(F)} of {maxitrs}")
    check(np.array_equal(np.asarray(F1[:maxitrs]), F),
          "resumed history differs")
    check(rise <= 1e-12, f"F rose by {rise:.3e} relative")
    check(out["F_rel_err"] <= 1e-9,
          f"host F vs solver F: {out['F_rel_err']:.3e} relative")
    return out


def _first_above(dev, bar):
    over = np.flatnonzero(dev > bar)
    return int(over[0]) if over.size else len(dev)


def phase_bpg(acc, m, n, seed, maxitrs=9000, cpu_itrs=2000,
              fw_maxitrs=200000):
    """The GPU's F history is compared with the same call on the host CPU.
    ABPG_gain on this instance amplifies rounding: on the CPU alone, x0
    moved by one ulp gives an F history that leaves 1e-8 relative within
    ~400 iterations.  So the 1e-8 bar holds over the prefix in which that
    one-ulp run stays within 1e-10 of the unperturbed one (the trajectory's
    own sensitivity horizon, measured here); past it the GPU-vs-CPU and
    one-ulp deviations are printed side by side."""
    import jax
    import jax.numpy as jnp

    f, h, L, x0 = acc.D_opt_design(m, n, randseed=seed)
    H = np.asarray(f.H, np.float64)
    kw = dict(gamma=2, verbose=False, fast_gram=True)
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "abpg.npz")
        _, first = timed(acc.ABPG_gain, f, h, L, x0, maxitrs=maxitrs, **kw)
        (x, F, *_), wall = timed(acc.ABPG_gain, f, h, L, x0,
                                 maxitrs=maxitrs, checkpoint=ck, **kw)
        F1 = acc.ABPG_gain(f, h, L, x0, maxitrs=maxitrs + 1,
                           checkpoint=ck, **kw)[1]
    F = np.asarray(F, np.float64)
    F_host = acc.diagnostics.dopt_certificate(H, x)["F"]

    x0_np = np.full(n, 1.0 / n)
    x0_ulp = x0_np.copy()
    x0_ulp[0] = np.nextafter(x0_ulp[0], 1.0)
    with acc.solver_device("cpu"):
        cpu = jax.devices("cpu")[0]
        f_cpu = acc.DOptimalObj(H=jax.device_put(H, cpu))
        F_cpu, F_ulp = (np.asarray(acc.ABPG_gain(
            f_cpu, h, L, jax.device_put(xi, cpu), maxitrs=cpu_itrs,
            **kw)[1]) for xi in (x0_np, x0_ulp))
    dev = np.abs(F[:cpu_itrs] - F_cpu) / np.abs(F_cpu)
    dev_ulp = np.abs(F_ulp - F_cpu) / np.abs(F_cpu)
    horizon = _first_above(dev_ulp, 1e-10)
    cpu_dev = float(np.max(dev[:max(horizon, 1)]))

    # F* of the instance: an FW-away solve certified on the host
    xs, Fs, *_ = acc.D_opt_FW_away(H, jnp.full(n, 1.0 / n), eps=1e-8,
                                   maxitrs=fw_maxitrs, verbose=False,
                                   chunk=2048)
    cs = acc.diagnostics.dopt_certificate(H, xs)
    out = dict(first_call_s=first, wall_s=wall, iters=len(F),
               F_solver=float(F1[-1]), F_host=F_host,
               F_rel_err=rel(F_host, float(F1[-1])),
               cpu_horizon_iters=horizon, cpu_max_rel_dev=cpu_dev,
               cpu_first_iter_above_1e8=_first_above(dev, 1e-8),
               ulp_first_iter_above_1e8=_first_above(dev_ulp, 1e-8),
               cpu_max_rel_dev_all=float(np.max(dev)),
               ulp_max_rel_dev_all=float(np.max(dev_ulp)),
               F_star=cs["F"],
               F_star_slack=cs["slack"], F_minus_F_star=F_host - cs["F"])
    check(np.array_equal(np.asarray(F1[:maxitrs]), F),
          "resumed history differs")
    check(out["F_rel_err"] <= 1e-9,
          f"host F vs solver F: {out['F_rel_err']:.3e} relative")
    check(cpu_dev <= 1e-8, f"GPU vs CPU F history: {cpu_dev:.3e} relative "
          f"over the first {horizon} iterations")
    check(cs["slack"] <= SLACK_BAR,
          f"F* run fresh slack {cs['slack']:.3e} > {SLACK_BAR}")
    return out


def phase_sweep(acc, K, m, n, seed, num_iters=20000):
    from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

    rng = np.random.default_rng(seed)
    Vs = rng.standard_normal((K, m, n))
    x0s = np.full((K, n), 1.0 / n)
    cert = acc.diagnostics.dopt_certificate
    out = {}
    for prec in ("auto", "ds"):
        (xb, Fb, SPb, SNb), first, wall = twice(
            dopt_fw_batch, Vs, x0s, eps=1e-8, num_iters=num_iters,
            precision=prec)
        slacks = [cert(Vs[k], xb[k])["slack"] for k in range(K)]
        conv = np.asarray(SPb <= 1e-8) & np.asarray(SNb <= 1e-8)
        iters = [int(np.argmax(c)) + 1 if c.any() else -1 for c in conv]
        out[prec] = dict(first_call_s=first, wall_s=wall,
                         worst_fresh_slack=max(slacks),
                         max_iters_to_1e8=max(iters))
    # "auto" (native f64) is the gated route; "ds" is printed beside it
    check(out["auto"]["worst_fresh_slack"] <= SLACK_BAR,
          f"worst fresh slack {out['auto']['worst_fresh_slack']:.3e}")
    return out


def phase_engines(acc, V, x0, maxitrs=20000):
    cert = acc.diagnostics.dopt_certificate
    m = V.shape[0]
    runs, out = {}, {}
    for mode in ("exact", "mixed", "ds"):
        (x, F, SP, SN, T), first, wall = twice(
            acc.D_opt_FW_away, V, x0, eps=1e-8, maxitrs=maxitrs,
            verbose=False, u_mode=mode)
        c = cert(V, x)
        runs[mode] = (np.asarray(x, np.float64), len(F), c["F"])
        out[mode] = dict(first_call_s=first, wall_s=wall, iters=len(F),
                         fresh_slack=c["slack"], F_host=c["F"])
    F_ex = runs["exact"][2]
    for mode in ("exact", "mixed", "ds"):
        out[mode]["F_dev"] = abs(runs[mode][2] - F_ex)
    out["ds"]["iters_vs_exact"] = runs["ds"][1] - runs["exact"][1]
    out["ds"]["x_max_dev"] = float(np.max(np.abs(runs["ds"][0]
                                                 - runs["exact"][0])))
    for mode in ("exact", "mixed", "ds"):
        check(out[mode]["fresh_slack"] <= SLACK_BAR,
              f"{mode}: fresh slack {out[mode]['fresh_slack']:.3e}")
        check(out[mode]["F_dev"] <= m * 1e-8,
              f"{mode}: |F - F_exact| = {out[mode]['F_dev']:.3e}")
    check(abs(out["ds"]["iters_vs_exact"]) <= 2,
          f"ds stopped {out['ds']['iters_vs_exact']} iterations off exact")
    check(out["ds"]["x_max_dev"] <= 1e-10,
          f"ds x vs exact: {out['ds']['x_max_dev']:.3e}")
    return out


def phase_f32(acc, m, n, seed, maxitrs=500):
    """An f32 run stops by the reference's rule |F_k - F_k-1| < 1e-14 once
    f32 rounding makes two successive F values equal, which happens well
    before ``maxitrs``; its last F is compared with the f64 run's F at the
    same iteration.  The gap to the f64 run's own last F is printed."""
    import jax
    import jax.numpy as jnp

    f, h, L, x0 = acc.D_opt_design(m, n, randseed=seed)
    _, F64, *_ = acc.BPG(f, h, L, x0, maxitrs=maxitrs, verbose=False)
    f32 = acc.DOptimalObj(H=jnp.asarray(f.H, jnp.float32))
    x032 = jnp.asarray(x0, jnp.float32)
    (_, F32, *_), first, wall = twice(acc.BPG, f32, h, L, x032,
                                      maxitrs=maxitrs, verbose=False)
    k = len(F32) - 1
    out = dict(first_call_s=first, wall_s=wall, iters=len(F32),
               dtype=str(np.asarray(F32).dtype),
               matmul_precision=(
                   f"config {jax.config.jax_default_matmul_precision}; "
                   "DOptimalObj products pinned to HIGHEST"),
               F32_last=float(F32[k]), F64_same_iter=float(F64[k]),
               F_dev=abs(float(F32[k]) - float(F64[k])),
               F64_last=float(F64[-1]),
               F_dev_to_F64_last=abs(float(F32[k]) - float(F64[-1])))
    check(out["F_dev"] <= 1e-3, f"f32 vs f64: {out['F_dev']:.3e}")
    return out


def _device_sets(tree):
    import jax

    return sorted({len(l.sharding.device_set)
                   for l in jax.tree_util.tree_leaves(tree)
                   if hasattr(l, "sharding") and l.ndim > 0})


def phase_sharded_dopt(acc, mesh, m, n, seed, iters=4000, chunk=500):
    from accbpg_and_fw_tpu.parallel import shard_dopt_design

    np.random.seed(seed)
    V = np.random.randn(m, n)
    x0 = np.full(n, 1.0 / n)
    cert = acc.diagnostics.dopt_certificate
    kw = dict(eps=1e-12, maxitrs=iters, verbose=False, chunk=chunk,
              u_mode="exact")
    (x1, F1, SP1, *_), first1, wall1 = twice(acc.D_opt_FW_away, V, x0, **kw)
    Vs, x0s = shard_dopt_design(V, x0, mesh)
    sets = _device_sets((Vs, x0s))
    (x4, F4, SP4, *_), first4, wall4 = twice(acc.D_opt_FW_away, Vs, x0s,
                                              **kw)
    x_sets = _device_sets(x4)
    x4 = np.asarray(x4)[:n]
    c1, c4 = cert(V, x1), cert(V, x4)
    out = dict(first_call_1card_s=first1, wall_1card_s=wall1,
               first_call_sharded_s=first4, wall_sharded_s=wall4,
               iters=(len(F1), len(F4)), device_set_sizes=sets,
               x_out_device_set_sizes=x_sets,
               SP_max_dev=float(np.max(np.abs(np.asarray(SP4)
                                              - np.asarray(SP1)))),
               F_host=(c1["F"], c4["F"]),
               F_host_rel_dev=rel(c4["F"], c1["F"]),
               gap_bound=(c1["gap_bound"], c4["gap_bound"]))
    check(sets == [mesh.size], f"sharded leaves on {sets} devices")
    check(len(F1) == len(F4) == iters, "runs stopped early")
    check(out["SP_max_dev"] <= 1e-9, f"SP dev {out['SP_max_dev']:.3e}")
    for c in (c1, c4):
        check(np.isfinite(c["F"]) and c["gap_bound"] >= 0,
              "host certificate invalid")
    check(out["F_host_rel_dev"] <= 1e-9,
          f"host F dev {out['F_host_rel_dev']:.3e}")
    return out


def phase_sharded_poisson(acc, mesh, m, n, seed, iters=200):
    from accbpg_and_fw_tpu.parallel import shard_regression_problem

    f, h, L, x0 = acc.Poisson_regrL1(m, n, noise=1e-4, lamda=1e-3,
                                     randseed=seed)
    kw = dict(maxitrs=iters, verbose=False)
    (_, F1, *_), first1, wall1 = twice(acc.BPG, f, h, L, x0, **kw)
    fs, x0s = shard_regression_problem(f, x0, mesh)
    sets = _device_sets(fs)
    (_, F4, *_), first4, wall4 = twice(acc.BPG, fs, h, L, x0s, **kw)
    F1, F4 = np.asarray(F1), np.asarray(F4)
    out = dict(first_call_1card_s=first1, wall_1card_s=wall1,
               first_call_sharded_s=first4, wall_sharded_s=wall4,
               iters=(len(F1), len(F4)), device_set_sizes=sets,
               F_max_rel_dev=float(np.max(np.abs(F4 - F1) / np.abs(F1))))
    check(sets == [mesh.size], f"sharded leaves on {sets} devices")
    check(len(F1) == len(F4), "histories differ in length")
    check(out["F_max_rel_dev"] <= 1e-9,
          f"F dev {out['F_max_rel_dev']:.3e} relative")
    return out


# --------------------------------------------------------------------------


def _fmt(v):
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, dict):
        return "{" + ", ".join(f"{k}={_fmt(x)}" for k, x in v.items()) + "}"
    if isinstance(v, (tuple, list)):
        return "(" + ", ".join(_fmt(x) for x in v) + ")"
    return str(v)


def single_card_phases(acc):
    base = json.load(open(os.path.join(ROOT, "baselines",
                                       "dopt_1000x5000_ref.json")))
    cfg = base["config"]
    np.random.seed(cfg["seed"])
    V = np.random.randn(cfg["m"], cfg["n"])
    x0 = np.full(cfg["n"], 1.0 / cfg["n"])
    np.random.seed(7)
    Ve = np.random.randn(200, 2000)
    xe = np.full(2000, 1.0 / 2000)
    return [
        ("headline", "f64, matmul precision HIGHEST (f64 has no other)",
         lambda: phase_headline(acc, V, x0, cfg["eps"], base["iters"],
                                base["F_star_certified"])),
        ("khachiyan", "f64", lambda: phase_khachiyan(acc, V, x0)),
        ("bpg", "f64", lambda: phase_bpg(acc, 30, 10000, 10)),
        ("sweep", "f64 (auto) and double-single f32 pairs (ds)",
         lambda: phase_sweep(acc, 32, 30, 1000, 3)),
        ("engines", "f64 (exact), f64 + int8 digits (mixed), "
         "double-single f32 pairs (ds)",
         lambda: phase_engines(acc, Ve, xe)),
        ("f32", "f32 design, f64 reference",
         lambda: phase_f32(acc, 80, 200, 10)),
    ]


def four_card_phases(acc, mesh):
    return [
        ("sharded_dopt", "f64, V column-sharded over 4 cards",
         lambda: phase_sharded_dopt(acc, mesh, 1000, 20000, 10)),
        ("sharded_poisson", "f64, A row-sharded over 4 cards",
         lambda: phase_sharded_poisson(acc, mesh, 20000, 10000, 10)),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"need {args.chips} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.compile_cache import enable_compilation_cache

    log(f"compilation cache: {enable_compilation_cache()}")
    log(f"jax {jax.__version__}; devices: {devices}")
    log(f"card: {card_line()}")

    if args.chips == 4:
        from accbpg_and_fw_tpu.parallel import data_mesh

        phases = four_card_phases(acc, data_mesh(devices[:4]))
    else:
        phases = single_card_phases(acc)

    failed = []
    for name, precision, run in phases:
        log(f"--- {name} [{precision}]")
        t0 = time.perf_counter()
        try:
            nums = run()
        except Exception:  # report every phase; the exit code says failed
            traceback.print_exc()
            failed.append(name)
            log(f"{name}: FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        for k, v in nums.items():
            log(f"  {k}: {_fmt(v)}")
        log(f"{name}: ok ({time.perf_counter() - t0:.1f} s)")

    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
