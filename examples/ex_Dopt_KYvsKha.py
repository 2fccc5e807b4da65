"""Kumar-Yildirim vs Khachiyan initialization for FW-away D-optimal design.

Equivalent of the reference's ipynb/ABPGvsFW/ex_Dopt_FW_KYvsKha.ipynb: the
Wolfe-Atwood solver started from the simplex center (Khachiyan) vs from the
Kumar-Yildirim sparse initial point (D_opt_KYinit), compared by slack decay
and iterations-to-eps on seeded instances.

Run:  python examples/ex_Dopt_KYvsKha.py [--m 30] [--n 2000] [--plot]
"""

import argparse

import numpy as np

import accbpg_and_fw_tpu as acc


def start(m=30, n=2000, eps=1e-8, maxitrs=60000, seeds=(10, 11, 12),
          plot=False, verbose=True, chunk=None):
    rows = []
    curves = {}
    for seed in seeds:
        f, h, L, x0 = acc.D_opt_design(m, n, randseed=seed)
        V = np.asarray(f.H)
        x0_ky = acc.D_opt_KYinit(V)

        r_kha = acc.D_opt_FW_away(V, x0, eps=eps, maxitrs=maxitrs,
                                  verbose=False, chunk=chunk)
        r_ky = acc.D_opt_FW_away(V, x0_ky, eps=eps, maxitrs=maxitrs,
                                 verbose=False, chunk=chunk)
        rows.append({"seed": seed, "kha_iters": len(r_kha[1]),
                     "ky_iters": len(r_ky[1]),
                     "kha_F": float(r_kha[1][-1]),
                     "ky_F": float(r_ky[1][-1])})
        if seed == seeds[0]:
            curves = {"Khachiyan init": np.maximum(np.asarray(r_kha[2]),
                                                   np.asarray(r_kha[3])),
                      "KY init": np.maximum(np.asarray(r_ky[2]),
                                            np.asarray(r_ky[3]))}
        if verbose:
            print(f"seed {seed}: Khachiyan {rows[-1]['kha_iters']} iters, "
                  f"KY {rows[-1]['ky_iters']} iters "
                  f"(F agree to {abs(rows[-1]['kha_F'] - rows[-1]['ky_F']):.2e})")

    if plot:
        from _galleryutil import get_axes, save_fig

        fig, (ax1, ax2) = get_axes(1, 2)
        for label, s in curves.items():
            ax1.semilogy(s, label=label)
        ax1.set_xlabel("iteration $k$")
        ax1.set_ylabel("max slack")
        ax1.legend()
        ax1.set_title(f"D-opt {m}x{n}, seed {seeds[0]}")

        idx = np.arange(len(rows))
        ax2.bar(idx - 0.2, [r["kha_iters"] for r in rows], width=0.4,
                label="Khachiyan")
        ax2.bar(idx + 0.2, [r["ky_iters"] for r in rows], width=0.4,
                label="KY")
        ax2.set_xticks(idx, [str(r["seed"]) for r in rows])
        ax2.set_xlabel("seed")
        ax2.set_ylabel(f"iterations to eps={eps:g}")
        ax2.legend()
        save_fig(fig, "dopt_ky_vs_kha.png")
    return rows


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=30)
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(m=a.m, n=a.n, eps=a.eps, plot=a.plot)
