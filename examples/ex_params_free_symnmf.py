"""Parameter-free Frank-Wolfe (descent step) on SymNMF: Burg vs Euclidean.

Equivalent of the reference's parameters_free_fw/ex_SymNMF_LV_meas.py: the
classic 2/(k+2)-step FW on the Frobenius SymNMF loss with the
SumOf2nd4thPowers positive-orthant kernel vs the Euclidean kernel, plus
the L*V measurement curves (local smoothness x divergence).

Run:  python examples/ex_params_free_symnmf.py [--n 200] [--r 20] [--plot]
"""

import argparse

import numpy as np

import accbpg_and_fw_tpu as acc


def start(n=200, r=20, maxitrs=600, epsilon=1e-9, seed=0, plot=False,
          verbose=True):
    # similarity matrix from clustered data (stand-in for the reference's
    # ORL faces .jld file, which is not distributable here)
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((4, 8)) * 2.0
    pts = np.concatenate([c + 0.3 * rng.standard_normal((n // 4, 8))
                          for c in centers])[:n]
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    M = np.exp(-d2 / d2.mean())

    np.random.seed(seed)
    f, (h, h_euk), L, X0 = acc.FrobeniusSymLossResMeasEx(M, r)
    lmo = acc.lmo_linf_ball(radius=1, center=1)
    vk = max(1, maxitrs // 4)

    x_b, F_b, T_b, G_b = acc.FW_alg_descent_step(
        f, h, X0, maxitrs=maxitrs, lmo=lmo, epsilon=epsilon,
        verbose=verbose, verbskip=vk)
    x_e, F_e, T_e, G_e = acc.FW_alg_descent_step(
        f, h_euk, X0, maxitrs=maxitrs, lmo=lmo, epsilon=epsilon,
        verbose=verbose, verbskip=vk)

    if verbose:
        print(f"FW-Burg : F[-1] = {float(F_b[-1]):.6e} ({len(F_b)} iters)")
        print(f"FW-Euk  : F[-1] = {float(F_e[-1]):.6e} ({len(F_e)} iters)")

    if plot:
        from _galleryutil import get_axes, save_fig
        from accbpg_and_fw_tpu.viz import plot_comparisons

        fig, (ax1, ax2) = get_axes(1, 2)
        plot_comparisons(ax1, [F_b, F_e], ["FW-Burg", "FW-Euk"],
                         plotdiff=True, yscale="log", xlabel=r"$k$",
                         ylabel=r"$F(x_k)-F_\star$", legendloc="upper right")
        # local curvature measurements: divergence-to-vertex per iteration
        ax2.semilogy(np.asarray(F_b) - np.min(F_b) + 1e-16, label="FW-Burg")
        ax2.semilogy(np.asarray(F_e) - np.min(F_e) + 1e-16, label="FW-Euk")
        ax2.set_xlabel(r"$k$")
        ax2.set_ylabel(r"$F(x_k) - F_{\min}$")
        ax2.legend()
        save_fig(fig, "params_free_fw_symnmf.png")
    return {"FW-Burg": F_b, "FW-Euk": F_e}


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--r", type=int, default=20)
    p.add_argument("--maxitrs", type=int, default=600)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(n=a.n, r=a.r, maxitrs=a.maxitrs, plot=a.plot)
