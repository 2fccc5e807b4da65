"""Frank-Wolfe vs Bregman proximal methods with relative smoothness.

Equivalent of the reference's frank_wolfe_wtih_rs/ studies
(ex_Dopt_design.py, ex_Poisson_regr.py, ex_SVM.py): FW with Bregman
divergence steps against BPG-LS and ABPG on three problem families —
D-optimal design (Burg simplex), Poisson regression on the simplex, and
SVM over an L2 ball with the PolyDiv kernel.

Run:  python examples/ex_fw_rs.py [--maxitrs 500] [--plot]
"""

import argparse

import numpy as np

import accbpg_and_fw_tpu as acc


def _dopt_panel(maxitrs, verbose):
    f, h, L, x0 = acc.D_opt_design(80, 200, randseed=10)
    out = {}
    out["FW"] = acc.FW_alg_div_step(f, h, L, x0, maxitrs=maxitrs, gamma=2.0,
                                    lmo=acc.lmo_simplex(), ls_ratio=2,
                                    verbose=verbose, verbskip=maxitrs)[1]
    out["BPG-LS"] = acc.BPG(f, h, L, x0, maxitrs=maxitrs, linesearch=True,
                            ls_ratio=2, verbose=verbose,
                            verbskip=maxitrs)[1]
    out["ABPG"] = acc.ABPG(f, h, L, x0, gamma=2.0, maxitrs=maxitrs,
                           theta_eq=True, verbose=verbose,
                           verbskip=maxitrs)[1]
    return out


def _poisson_panel(maxitrs, verbose):
    np.random.seed(1)
    h, scenarios = acc.Poisson_regr_simplex(200, 100)
    f, L, sol, x0 = scenarios["x0_center_sol_center"]
    out = {}
    out["FW"] = acc.FW_alg_div_step(f, h, L, x0, maxitrs=maxitrs, gamma=2.0,
                                    lmo=acc.lmo_simplex(), ls_ratio=2,
                                    verbose=verbose, verbskip=maxitrs)[1]
    out["BPG-LS"] = acc.BPG(f, h, L, x0, maxitrs=maxitrs, linesearch=True,
                            ls_ratio=1.5, verbose=verbose,
                            verbskip=maxitrs)[1]
    out["ABPG"] = acc.ABPG(f, h, L, x0, gamma=2.0, maxitrs=maxitrs,
                           theta_eq=False, verbose=verbose,
                           verbskip=maxitrs)[1]
    return out


def _svm_panel(maxitrs, verbose, lamda=0.5):
    np.random.seed(3)
    f, (poly_h, sq_h), L, x0, radius = acc.svm_digits_ds_divs_ball(
        lamda=lamda)
    lmo = acc.lmo_l2_ball(radius)
    out = {}
    out["FW"] = acc.FW_alg_div_step(f, poly_h, L, x0, maxitrs=maxitrs,
                                    gamma=2.0, lmo=lmo, ls_ratio=2,
                                    verbose=verbose, verbskip=maxitrs)[1]
    out["BPG-LS"] = acc.BPG(f, poly_h, L, x0, maxitrs=maxitrs,
                            linesearch=True, ls_ratio=1.5, verbose=verbose,
                            verbskip=maxitrs)[1]
    out["ABPG"] = acc.ABPG(f, poly_h, L, x0, gamma=2.0, maxitrs=maxitrs,
                           theta_eq=False, verbose=verbose,
                           verbskip=maxitrs)[1]
    return out


def start(maxitrs=500, plot=False, verbose=True, panels=("dopt", "poisson",
                                                         "svm")):
    builders = {"dopt": _dopt_panel, "poisson": _poisson_panel,
                "svm": _svm_panel}
    results = {p: builders[p](maxitrs, verbose) for p in panels}
    for p, curves in results.items():
        for name, F in curves.items():
            if verbose:
                print(f"{p:>8}/{name:<7}: F[-1] = {float(F[-1]):.6e} "
                      f"({len(F)} iters)")

    if plot:
        from _galleryutil import get_axes, save_fig
        from accbpg_and_fw_tpu.viz import plot_comparisons

        fig, axes = get_axes(1, len(results))
        if len(results) == 1:
            axes = [axes]
        titles = {"dopt": "D-opt 80x200", "poisson": "Poisson simplex",
                  "svm": "SVM / PolyDiv ball"}
        for ax, (p, curves) in zip(np.ravel(axes), results.items()):
            plot_comparisons(ax, list(curves.values()), list(curves.keys()),
                             plotdiff=True, yscale="log",
                             xlabel=r"$k$", ylabel=r"$F(x_k)-F_\star$",
                             legendloc="upper right")
            ax.set_title(titles[p])
        save_fig(fig, "fw_vs_bpg_rs.png")
    return results


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--maxitrs", type=int, default=500)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(maxitrs=a.maxitrs, plot=a.plot)
