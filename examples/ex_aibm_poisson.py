"""AIBM vs accelerated Bregman gradient methods on Poisson regression.

Equivalent of the reference's aibm/ex_Poisson_regr.py: the Adaptive
Intermediate Bregman Method against BPG-LS, ABPG and ABPG_expo on Poisson
regression over the simplex (Burg-entropy kernel), one panel per
interpolation gamma.

Run:  python examples/ex_aibm_poisson.py [--m 2000] [--n 1000] [--plot]
"""

import argparse

import numpy as np

import accbpg_and_fw_tpu as acc


def start(m=2000, n=1000, maxitrs=1000, noise=0.001, inexact_noise=1e-6,
          gammas=(2.0, 1.4, 1.1), epsilon=1e-12, seed=0, plot=False,
          verbose=True):
    np.random.seed(max(seed, 1))
    f, hs, L, x0 = acc.Poisson_regr_simplex_acc(m, n, noise=noise)
    h = hs[0]
    vk = max(1, maxitrs // 4)

    results = {}
    for gamma in gammas:
        curves = {}
        curves["AIBM"] = acc.AIBM(f, h, L, x0, gamma=gamma, maxitrs=maxitrs,
                                  epsilon=epsilon, noise=inexact_noise,
                                  verbose=verbose, verbskip=vk)[1]
        curves["BPG-Adapt"] = acc.BPG(f, h, L, x0, maxitrs=maxitrs,
                                      linesearch=True, ls_ratio=1.5,
                                      epsilon=epsilon, verbose=verbose,
                                      verbskip=vk)[1]
        curves["AccBPGM-2"] = acc.ABPG(f, h, L, x0, gamma=gamma,
                                       maxitrs=maxitrs, theta_eq=False,
                                       epsilon=epsilon, verbose=verbose,
                                       verbskip=vk)[1]
        curves["AccBPGM-1"] = acc.ABPG_expo(f, h, L, x0, gamma0=3,
                                            maxitrs=maxitrs, theta_eq=False,
                                            Gmargin=1, epsilon=epsilon,
                                            verbose=verbose, verbskip=vk)[1]
        results[gamma] = curves
        if verbose:
            for name, F in curves.items():
                print(f"gamma={gamma}: {name:>10}: F[-1] = "
                      f"{float(F[-1]):.6e} ({len(F)} iters)")

    if plot:
        from _galleryutil import get_axes, save_fig
        from accbpg_and_fw_tpu.viz import plot_comparisons

        fig, axes = get_axes(1, len(results))
        if len(results) == 1:
            axes = [axes]
        for ax, (gamma, curves) in zip(np.ravel(axes), results.items()):
            plot_comparisons(ax, list(curves.values()), list(curves.keys()),
                             plotdiff=True, yscale="log", xlabel=r"$k$",
                             ylabel=r"$F(x_k)-F_\star$",
                             legendloc="upper right")
            ax.set_title(rf"$\gamma$ = {gamma}")
        save_fig(fig, "aibm_poisson.png")
    return results


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=2000)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--maxitrs", type=int, default=1000)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(m=a.m, n=a.n, maxitrs=a.maxitrs, plot=a.plot)
