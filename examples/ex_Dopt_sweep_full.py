"""FULL-SCALE D-opt iteration-complexity sweeps — the reference's literal
n=1000 / n=2000 studies.

Reference: /root/reference/ipynb/ABPGvsFW/ex_Dopt_FW_n1000.ipynb:cell3
(n=1000, m in [100..900], K=3) and ex_Dopt_FW_n2000.ipynb:cell3 (n=2000,
m in [100..1000], K=10, Nmax=100000) — Frank-Wolfe (Khachiyan) vs FW with
away steps (Wolfe-Atwood), Kumar-Yildirim initialization, iterations to
reach each slack target eps in {1e-3..1e-8}, geometric means over repeats.
The reference solves every (method, m, k) run SEQUENTIALLY in f64 numpy
(its recorded wall for ONE 1000x2000 FW-away run is ~255 s, cell7); here
the K repeats solve as ONE vmapped double-single computation per (method,
m) — f64-grade certification from pure f32/int8 (parallel.batched), so the
whole study fits in minutes on a single chip.

Run:  PYTHONPATH=. python examples/ex_Dopt_sweep_full.py [n1000|n2000]
"""

import json
import sys
import time

import numpy as np

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

EPS_TARGETS = [1e-3, 1e-4, 1e-5, 1e-6, 1e-7, 1e-8]


def iters_to_eps(SP, SN, eps):
    ok = (SP <= eps) & (SN <= eps)
    return int(np.argmax(ok)) + 1 if ok.any() else -1


def run_study(n, m_list, K, Nmax, seed=0, verbose=True):
    rng = np.random.default_rng(seed)
    out = {"n": n, "K": K, "Nmax": Nmax, "methods": {}}
    walls = {}
    for away, name in ((False, "FW"), (True, "FW-away")):
        rows = {}
        for m in m_list:
            Vs = np.empty((K, m, n))
            x0s = np.empty((K, n))
            for k in range(K):
                f, h, L, x0Kh = acc.D_opt_design(m, n,
                                                 randseed=seed * 1000 + k)
                Vs[k] = np.asarray(f.H, np.float64)
                x0s[k] = np.asarray(acc.D_opt_KYinit(f.H), np.float64)
            t0 = time.time()
            # precision="auto": the native f64 batch; refresh_every
            # re-factorizes (H, w, logdet) in the scan, which matters for
            # iteration-count honesty: the incremental slack history
            # plateaus above the true slack at large m, and the refresh
            # resets it so deep-target exits fire at the honest iteration
            xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=1e-8,
                                             num_iters=Nmax, away=away,
                                             precision="auto",
                                             refresh_every=4096)
            wall = time.time() - t0
            walls[(name, m)] = wall
            per_eps = {}
            for e in EPS_TARGETS:
                # reference convention (ex_Dopt_FW_n1000.ipynb cell 3):
                # an unreached target enters the geomean CAPPED at Nmax+1
                its = [iters_to_eps(np.asarray(SPb[k]), np.asarray(SNb[k]),
                                    e) for k in range(K)]
                capped = [i if i > 0 else Nmax + 1 for i in its]
                per_eps[f"{e:g}"] = float(
                    np.exp(np.mean(np.log(capped))))
            rows[m] = {"iters_to_eps": per_eps,
                       "batch_wall_s": round(wall, 2),
                       "amortized_wall_per_instance_s": round(wall / K, 2)}
            if verbose:
                print(f"{name} m={m} n={n}: wall {wall:.1f}s "
                      f"({wall/K:.2f}s/instance), iters-to-eps "
                      + " ".join(f"{e:g}:{per_eps[f'{e:g}']:.0f}"
                                 for e in EPS_TARGETS), flush=True)
        out["methods"][name] = rows
    out["total_wall_s"] = round(sum(walls.values()), 1)
    return out


def plot_study(res, path):
    from _galleryutil import get_axes, save_fig

    fig, axes = get_axes(1, 2)
    for ax, (name, rows) in zip(axes, res["methods"].items()):
        ms = sorted(rows)
        for e in EPS_TARGETS:
            ys = [rows[m]["iters_to_eps"][f"{e:g}"] for m in ms]
            ax.semilogy(ms, ys, marker="o", label=rf"$\epsilon$={e:g}")
        ax.set_xlabel("m")
        ax.set_ylabel("iterations to slack (geomean)")
        ax.set_title(f"{name}, n={res['n']} (K={res['K']})")
        ax.legend(fontsize=7)
    save_fig(fig, path)


def start(study="n1000", verbose=True, plot=True):
    if study == "n1000":
        res = run_study(1000, [100, 200, 300, 400, 500, 600, 700, 800, 900],
                        K=3, Nmax=20000, verbose=verbose)
    else:
        res = run_study(2000, [100, 200, 400, 600, 800, 1000],
                        K=3, Nmax=100000, verbose=verbose)
    print(json.dumps(res), flush=True)
    if plot:
        plot_study(res, f"dopt_sweep_full_{study}.png")
    return res


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    start(sys.argv[1] if len(sys.argv) > 1 else "n1000")
