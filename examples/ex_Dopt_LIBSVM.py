"""D-optimal design on LIBSVM datasets.

Equivalent of the reference's ipynb/ex_Dopt_LIBSVM.ipynb and the
frank_wolfe_wtih_rs/ex_Dopt_design.py LIBSVM variant: load a real dataset
(housing/abalone/bodyfat/mpg in LIBSVM text format), build the D-opt
problem and compare BPG-LS, ABPG, ABPG_gain, FW and FW-away.

A dataset path can be given with ``--data``; by default the script looks
for the reference checkout's datasets and otherwise writes a synthetic
LIBSVM file so the full loader path still runs.

Run:  python examples/ex_Dopt_LIBSVM.py [--data path.txt] [--plot]
"""

import argparse
import os
import tempfile

import numpy as np

import accbpg_and_fw_tpu as acc

_REF_DATA = "/root/reference/parameters_free_fw/data"


def _find_dataset(path=None):
    if path:
        return path
    for name in ("housing.txt", "abalone.txt", "bodyfat.txt", "mpg.txt"):
        cand = os.path.join(_REF_DATA, name)
        if os.path.exists(cand):
            return cand
    # synthetic fallback in LIBSVM format (still exercises the full loader)
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(200):
        vals = rng.standard_normal(13)
        rows.append("1 " + " ".join(f"{i + 1}:{v:.6f}"
                                    for i, v in enumerate(vals)))
    fd, tmp = tempfile.mkstemp(suffix=".libsvm")
    with os.fdopen(fd, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tmp


def start(data=None, maxitrs=1000, plot=False, verbose=True):
    path = _find_dataset(data)
    f, h, L, x0 = acc.D_opt_libsvm(path)
    m, n = f.H.shape
    if verbose:
        print(f"dataset {os.path.basename(path)}: design {m}x{n}")
    vk = max(1, maxitrs // 4)

    curves = {}
    curves["BPG-LS"] = acc.BPG(f, h, L, x0, maxitrs=maxitrs, linesearch=True,
                               ls_ratio=2, verbose=verbose, verbskip=vk)[1]
    curves["ABPG"] = acc.ABPG(f, h, L, x0, gamma=2.0, maxitrs=maxitrs,
                              theta_eq=True, verbose=verbose,
                              verbskip=vk)[1]
    curves["ABPG_gain"] = acc.ABPG_gain(f, h, L, x0, gamma=2, G0=0.1,
                                        maxitrs=maxitrs, theta_eq=True,
                                        verbose=verbose, verbskip=vk)[1]
    curves["FW"] = acc.FW_alg_div_step(f, h, L, x0, maxitrs=maxitrs,
                                       gamma=2.0, lmo=acc.lmo_simplex(),
                                       ls_ratio=2, verbose=verbose,
                                       verbskip=vk)[1]
    r_away = acc.D_opt_FW_away(np.asarray(f.H), x0, eps=1e-8,
                               maxitrs=50 * maxitrs, verbose=verbose,
                               verbskip=10 * vk, chunk=2000)
    curves["FW-away"] = r_away[1]

    if verbose:
        for name, F in curves.items():
            print(f"{name:>10}: F[-1] = {float(F[-1]):.6e} ({len(F)} iters)")

    if plot:
        from _galleryutil import get_axes, save_fig
        from accbpg_and_fw_tpu.viz import plot_comparisons

        fig, ax = get_axes(1, 1)
        plot_comparisons(ax, list(curves.values()), list(curves.keys()),
                         plotdiff=True, yscale="log", xlabel=r"$k$",
                         ylabel=r"$F(x_k)-F_\star$", legendloc="upper right")
        ax.set_title(f"D-opt on {os.path.basename(path)} ({m}x{n})")
        save_fig(fig, "dopt_libsvm.png")
    return curves


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--maxitrs", type=int, default=1000)
    p.add_argument("--plot", action="store_true")
    a = p.parse_args()
    start(data=a.data, maxitrs=a.maxitrs, plot=a.plot)
