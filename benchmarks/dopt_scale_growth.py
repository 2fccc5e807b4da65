"""Scale-growth benchmark: D-opt FW-away at 1000x20000 (4x the headline n).

Fixed 40000-iteration budget, seeded instance protocol identical to
bench.py (seed 10, uniform init); neither implementation reaches 1e-8
slack in the budget, so the comparison is equal-quality per-iteration
throughput (fresh-f64 F values agree to 5e-9; both land at slack 1.15e-4;
baselines/dopt_1000x20000_ref.json holds the reference numpy run).

    PYTHONPATH=. python benchmarks/dopt_scale_growth.py               # ours
    PYTHONPATH=. python benchmarks/dopt_scale_growth.py --reference   # numpy ref

Reference loop being benchmarked: /root/reference/accbpg/D_opt_alg.py:91-185.
"""

import argparse
import json
import time

import numpy as np

M, N, SEED, MAXITRS = 1000, 20000, 10, 40000


def make_instance():
    np.random.seed(SEED)
    V = np.random.randn(M, N)
    x0 = np.full(N, 1.0 / N)
    return V, x0


def run_reference():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_dopt", "/root/reference/accbpg/D_opt_alg.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    V, x0 = make_instance()
    t0 = time.time()
    x, F, SP, SN, T = ref.D_opt_FW_away(V, x0, 1e-8, MAXITRS, verbose=True,
                                        verbskip=4000)
    wall = time.time() - t0
    return V, x, wall, len(F), float(SP[-1]), float(SN[-1])


def run_ours(repeats=3):
    import accbpg_and_fw_tpu as acc

    V, x0 = make_instance()
    walls = []
    for _ in range(repeats):
        x, F, SP, SN, T = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=MAXITRS,
                                            verbose=False, chunk=2500,
                                            u_mode="ds")
        walls.append(float(T[-1]))
    return V, x, min(walls), walls, float(SP[-1]), float(SN[-1])


def fresh_F(V, x):
    xs = np.asarray(x, np.float64)
    xs = xs / xs.sum()
    return float(-np.linalg.slogdet((V * xs) @ V.T)[1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if args.reference:
        V, x, wall, iters, sp, sn = run_reference()
        print(json.dumps(dict(engine="reference_numpy", wall_s=round(wall, 1),
                              iters=iters, SP=sp, SN=sn,
                              F_fresh=fresh_F(V, x))))
    else:
        V, x, best, walls, sp, sn = run_ours(args.repeats)
        print(json.dumps(dict(engine="ds_packed_u", wall_s=round(best, 2),
                              all_walls_s=[round(w, 2) for w in walls],
                              SP=sp, SN=sn, F_fresh=fresh_F(V, x))))


if __name__ == "__main__":
    main()
