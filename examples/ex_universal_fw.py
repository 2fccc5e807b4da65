"""Universal gradient method vs BPG on symmetric NMF with inexact oracles.

Equivalent of the reference's universal_method_FW/ex_universal_method_FW.py:
BPG (fixed L and line-search) against UniversalGM driven through the
FW-as-prox adapter (SumOf2nd4thPowersWithFrankWolfe), on the Frobenius
SymNMF loss with noise-injected oracles, one panel per noise level.

Run:  python examples/ex_universal_fw.py [--n 400] [--r 1] [--plot]
"""

import argparse

import numpy as np

import accbpg_and_fw_tpu as acc


def start(n=400, r=1, maxitrs=200, noise_levels=(0.1, 10.0), epsilon=1e-9,
          seed=0, plot=False, verbose=True):
    rng = np.random.default_rng(seed)
    xv = rng.random(n)
    M = np.outer(xv, xv)
    sigma = 2.0 * np.linalg.norm(M, 2)
    X0 = np.ones((n, r)) + 1e-5
    L = 1.0
    vk = max(1, maxitrs // 2)

    results = {}
    for noise in noise_levels:
        f = acc.FrobeniusSymLoss.create(M, X0, noise_level=noise)
        h = acc.SumOf2nd4thPowers(alpha=6.0, sigma=sigma)
        h_fw = acc.SumOf2nd4thPowersWithFrankWolfe(
            alpha=6.0, sigma=sigma,
            lmo=acc.lmo_linf_ball(1.0, center=1.0))

        curves = {}
        curves["BPG"] = acc.BPG(f, h, L, X0, maxitrs=maxitrs,
                                linesearch=False, epsilon=epsilon,
                                verbose=verbose, verbskip=vk)[1]
        curves["BPG-LS"] = acc.BPG(f, h, L, X0, maxitrs=maxitrs,
                                   linesearch=True, ls_ratio=1.5,
                                   epsilon=epsilon, verbose=verbose,
                                   verbskip=vk)[1]
        curves["UniversalGM-FW"] = acc.UniversalGM(
            f, h_fw, L, X0, maxitrs=maxitrs, noise_level=noise,
            epsilon=epsilon, verbose=verbose, verbskip=vk)[1]
        results[noise] = curves
        if verbose:
            for name, F in curves.items():
                print(f"noise={noise}: {name:>14}: F[-1] = "
                      f"{float(F[-1]):.6e} ({len(F)} iters)")

    if plot:
        from _galleryutil import get_axes, save_fig
        from accbpg_and_fw_tpu.viz import plot_comparisons

        fig, axes = get_axes(1, len(results))
        if len(results) == 1:
            axes = [axes]
        for ax, (noise, curves) in zip(np.ravel(axes), results.items()):
            plot_comparisons(ax, list(curves.values()), list(curves.keys()),
                             plotdiff=True, yscale="log", xlabel=r"$k$",
                             ylabel=r"$F(x_k)-F_\star$",
                             legendloc="upper right")
            ax.set_title(rf"$\delta$ = {noise:.2f}")
        save_fig(fig, "universal_fw_symnmf.png")
    return results


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=400)
    p.add_argument("--r", type=int, default=1)
    p.add_argument("--maxitrs", type=int, default=200)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(n=a.n, r=a.r, maxitrs=a.maxitrs, plot=a.plot)
