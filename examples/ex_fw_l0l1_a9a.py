"""Real-data (L0,L1) logistic regression on a9a — the reference's LIBSVM
experiment.

Reference: /root/reference/L0_L1_smoothness/ipynb/ex_L0_L1_and_FW.ipynb
cell 17 (radius 250, 600 iterations, ls_ratio 2.0, gamma 2, L2-ball and
Linf-ball LMOs; FW with the adaptive (L0,L1) step vs standard
divergence-step FW) on the a9a dataset of Platt (1998), loaded from the
reference checkout's read-only copy (or ``ACCBPG_A9A_PATH``).  The
reference calls the since-renamed ``FW_alg_l0_l1_step_adapt``; the current
API equivalent is ``FW_alg_L0_L1_shortest_step`` (SURVEY.md §4 API-drift
note).

Run:  PYTHONPATH=. python examples/ex_fw_l0l1_a9a.py
"""

import os

import numpy as np

import accbpg_and_fw_tpu as acc

_A9A_CANDIDATES = (
    os.environ.get("ACCBPG_A9A_PATH", ""),
    "/root/reference/L0_L1_smoothness/datasets/a9a",
    os.path.join(os.path.dirname(__file__), "data", "a9a"),
)


def a9a_path():
    for p in _A9A_CANDIDATES:
        if p and os.path.exists(p):
            return p
    raise FileNotFoundError(
        "a9a dataset not found; set ACCBPG_A9A_PATH (LIBSVM format, "
        "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/)")


def start(radius=250.0, maxitrs=600, ls_ratio=2.0, gamma=2.0, seed=2025,
          verbose=True, plot=True):
    np.random.seed(seed)  # reference: np.random.uniform x0 draw
    f, h, L, L0, L1, x0 = acc.L0L1_FW_log_reg_a9a(radius, a9a_path())
    if verbose:
        X = np.asarray(f.X)
        print(f"a9a: {X.shape[0]} samples x {X.shape[1]} features, "
              f"L={L:.1f} L1={L1:.2f}", flush=True)

    results = {}
    for lmo_name, lmo in (("L2 ball", acc.lmo_l2_ball(radius)),
                          ("Linf ball", acc.lmo_linf_ball(radius))):
        _, F_l0l1, _, _ = acc.FW_alg_L0_L1_shortest_step(
            f, h, L0, L1, x0, maxitrs, gamma=gamma, lmo=lmo,
            ls_ratio=ls_ratio, verbose=False)
        _, F_std, _, _ = acc.FW_alg_div_step(
            f, h, L, x0, maxitrs, gamma=gamma, lmo=lmo,
            ls_ratio=ls_ratio, verbose=False)
        results[lmo_name] = {"FW-L0_L1": np.asarray(F_l0l1),
                             "FW-stand": np.asarray(F_std)}
        if verbose:
            print(f"{lmo_name}: FW-L0_L1 final F = {F_l0l1[-1]:.6f}, "
                  f"FW-stand final F = {F_std[-1]:.6f}", flush=True)

    if plot:
        from _galleryutil import get_axes, save_fig

        fig, axes = get_axes(1, 2)
        for ax, (lmo_name, curves) in zip(axes, results.items()):
            acc.plot_comparisons(
                ax, list(curves.values()), list(curves.keys()),
                x_vals=[], plotdiff=True, yscale="log",
                xlabel="iteration k", ylabel=r"$F(x_k) - F^\star$")
            ax.set_title(f"a9a, {lmo_name} (r={radius:g})")
        save_fig(fig, "fw_l0l1_a9a.png")
    return results


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    start()
