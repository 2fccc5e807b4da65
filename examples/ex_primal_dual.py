"""Primal-dual switching gradient method on linearly-constrained SymNMF.

Equivalent of the reference's
primal_dual_method/ex_Primal_Dual_Switching_Subtasks.py: minimize the
Frobenius SymNMF loss subject to a linear constraint X A <= b (elementwise),
alternating productive objective steps and unproductive constraint steps
with a duality-gap stopping rule.
"""

import numpy as np

import accbpg_and_fw_tpu as acc


def start(n=30, r=4, maxitrs=300, epsilon=10.0, seed=3, verbose=True):
    np.random.seed(seed)
    M = np.random.rand(n, n)
    M = (M + M.T) / 2

    f, g, h, L, X0 = acc.FrobeniusSymLossExWithLinearCnstrnts(M, r)
    F, gaps, Ls = acc.PrimalDualSwitchingGradientMethod(
        f, h, L, g, X0, maxitrs=maxitrs, epsilon=epsilon, verbose=verbose,
        verbskip=max(1, maxitrs // 10))

    print(f"productive steps: {len(F)} / {len(gaps)}")
    if len(F):
        print(f"final productive F = {float(F[-1]):.6e}")
    print(f"final duality gap  = {float(gaps[-1]):.6e}")
    return F, gaps, Ls


def figure(n=400, r=10, maxitrs=200, epsilon=1e-9, seed=11, save=True):
    """The reference's study figure
    (primal_dual_method/ex_Primal_Dual_Switching_Subtasks.py): rank-1
    similarity M = x x^T, duality-gap curves with and without the
    productive-step line search, semilog |gap - min gap|."""
    np.random.seed(seed)
    x = np.random.rand(n)
    M = np.outer(x, x)

    f, g, h, L, X0 = acc.FrobeniusSymLossExWithLinearCnstrnts(M, r)
    _, DG_, _ = acc.PrimalDualSwitchingGradientMethod(
        f, h, L, g, X0, maxitrs, epsilon=epsilon, linesearch=False,
        verbose=False)
    _, DG_LS, _ = acc.PrimalDualSwitchingGradientMethod(
        f, h, L, g, X0, maxitrs, epsilon=epsilon, linesearch=True,
        verbose=False)
    if save:
        import sys

        sys.path.insert(0, __file__.rsplit("/", 1)[0])
        from _galleryutil import get_axes, save_fig

        fig, ax = get_axes(1, 1, figsize=(8, 4))
        acc.plot_comparisons(
            ax, [np.asarray(DG_), np.asarray(DG_LS)],
            ["No LS", "With LS"], x_vals=[], plotdiff=True, yscale="log",
            xlim=[], ylim=[], xlabel="iteration", ylabel="duality gap",
            legendloc="upper right", linestyles=["k:", "g-"],
            linedash=[[1, 2], []])
        save_fig(fig, "primal_dual_gap.png")
    return DG_, DG_LS


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    start()
    figure()
