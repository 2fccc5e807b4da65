"""(L0,L1)-smooth Frank-Wolfe on hard logistic regression.

Equivalent of the reference's L0_L1_smoothness experiments: generate a hard
correlated-design logistic regression constrained to an l1/l2/linf ball or
the simplex (hard_FW_log_reg_jax) and compare the (L0,L1) step rules against
the classic divergence/descent steps.
"""

import jax

import accbpg_and_fw_tpu as acc

_LMOS = {
    "l1": lambda r: acc.lmo_l2_ball(r),  # reference uses l2 LMO for l1 gen too
    "l2": lambda r: acc.lmo_l2_ball(r),
    "linf": lambda r: acc.lmo_linf_ball(r),
    "simplex": lambda r: acc.lmo_simplex(r),
}


def start(domain="l2", n_samples=500, n_features=100, radius=2.0,
          maxitrs=500, seed=0, verbose=True):
    key = jax.random.PRNGKey(seed)
    f, h, L, L0, L1, x0, X, y = acc.hard_FW_log_reg_jax(
        key, n_samples, n_features, radius=radius, domain=domain)
    lmo = _LMOS[domain](radius)
    vk = max(1, maxitrs // 10)
    L, L0, L1 = float(L), max(float(L0), 1e-9), float(L1)

    out = {}
    _, out["FW div"], _, _ = acc.FW_alg_div_step(
        f, h, L, x0, maxitrs, gamma=2.0, lmo=lmo, verbose=verbose, verbskip=vk)
    _, out["FW 2/(k+2)"], _, _ = acc.FW_alg_descent_step(
        f, h, x0, maxitrs, lmo, verbose=verbose, verbskip=vk)
    _, out["FW L0L1 short"], _, _ = acc.FW_alg_L0_L1_shortest_step(
        f, h, L0, L1, x0, maxitrs, gamma=2.0, lmo=lmo, verbose=verbose,
        verbskip=vk)
    _, out["FW L0L1 log+lin"], _, logs1, _ = acc.FW_l0l1_log_and_linear_step(
        f, h, 1e-3, L1, x0, maxitrs, lmo=lmo, ls_ratio=2.0, verbose=verbose,
        verbskip=vk)
    _, out["FW L0L1 log"], _, logs2, _ = acc.FW_l0l1_log_only(
        f, h, 1e-3, L1, x0, maxitrs, lmo=lmo, ls_ratio=2.0, verbose=verbose,
        verbskip=vk)

    for k, F in out.items():
        print(f"{k:>16}: F = {float(F[-1]):.6e} ({len(F)} iters)")
    return out


# ---------------------------------------------------------------------------
# Data-regime studies (reference notebooks
# L0_L1_smoothness/ipynb/ex_L0_L1_and_FW_good_data.ipynb and
# ..._ill_cond_data.ipynb): the same four-driver comparison swept over
# sample- and feature-growth configs on well-conditioned vs heavily
# Toeplitz-correlated noisy designs.  (The _flexible_adapt notebook calls
# APIs dead in the reference package itself — SURVEY §4 — and is excluded.)
# ---------------------------------------------------------------------------

REGIMES = {
    # rho=0.02 near-uncorrelated design, clean labels (notebook cell 3/4:
    # seed 456, radius 25, ls_ratio 2.2, l2 domain)
    "good": dict(seed=456, radius=25.0, rho=0.02, col_scale=2.0,
                 flip_y=0.0, noise=0.01,
                 configs=[(200, 200), (2000, 200), (200, 2000)]),
    # rho=0.99 Toeplitz correlation, 20% label flips, noisy features
    # (ill_cond notebook cell 4: seed 63)
    "illcond": dict(seed=63, radius=25.0, rho=0.99, col_scale=1.0,
                    flip_y=0.2, noise=0.1,
                    configs=[(2000, 200), (200, 2000), (1000, 1000)]),
}


def run_regime(name, maxitrs=2000, verbose=False, save=True,
               configs=None):
    """Sweep the four FW step rules over a data regime's (m, n) configs;
    one objective-vs-iteration panel per config, notebook-style."""
    cfg = REGIMES[name]
    configs = configs or cfg["configs"]
    key = jax.random.PRNGKey(cfg["seed"])
    ls_ratio = 2.2
    panels = []
    for (ns, nf) in configs:
        f, h, L, L0, L1, x0, X, y = acc.hard_FW_log_reg_jax(
            key, ns, nf, radius=cfg["radius"], domain="l2", rho=cfg["rho"],
            col_scale=cfg["col_scale"], flip_y=cfg["flip_y"],
            noise=cfg["noise"])
        lmo = acc.lmo_l2_ball(cfg["radius"])
        L, L0, L1 = float(L), max(float(L0), 1e-9), float(L1)
        out = {}
        _, out["FW-L0L1 log+lin"], _, _, _ = acc.FW_l0l1_log_and_linear_step(
            f, h, L0, L1, x0, maxitrs, lmo=lmo, ls_ratio=ls_ratio,
            verbose=verbose)
        _, out["FW-L0L1 log"], _, _, _ = acc.FW_l0l1_log_only(
            f, h, L0, L1, x0, maxitrs, lmo=lmo, ls_ratio=ls_ratio,
            verbose=verbose)
        _, out["FW-classic"], _, _ = acc.FW_alg_div_step(
            f, h, L, x0, maxitrs, gamma=2.0, lmo=lmo, ls_ratio=ls_ratio,
            verbose=verbose)
        _, out["FW-L0L1 shortest"], _, _ = acc.FW_alg_L0_L1_shortest_step(
            f, h, L0, L1, x0, maxitrs, gamma=2.0, lmo=lmo, verbose=verbose)
        panels.append(((ns, nf), out))
        for k, F in out.items():
            print(f"  [{name} {ns}x{nf}] {k:>18}: F[-1] = "
                  f"{float(F[-1]):.6e}")
    if save:
        import sys as _sys
        _sys.path.insert(0, __file__.rsplit("/", 1)[0])
        import numpy as np

        from _galleryutil import get_axes, save_fig

        fig, axes = get_axes(len(panels), 1, figsize=(7, 3.4 * len(panels)))
        axes = np.atleast_1d(axes)
        for ax, ((ns, nf), out) in zip(axes, panels):
            Fmin = min(float(np.min(np.asarray(F))) for F in out.values())
            for k, F in out.items():
                ax.semilogy(np.maximum(np.asarray(F) - Fmin, 1e-16),
                            label=k, linewidth=1.4)
            ax.set_title(f"{name} data, m={ns}, n={nf}")
            ax.set_xlabel("iteration")
            ax.set_ylabel(r"$F(x_k) - F_{\min}$")
            ax.legend(fontsize=9)
        save_fig(fig, f"fw_l0l1_{name}_data.png")
    return panels


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    import sys

    if len(sys.argv) > 1 and sys.argv[1] in REGIMES:
        run_regime(sys.argv[1],
                   maxitrs=int(sys.argv[2]) if len(sys.argv) > 2 else 2000)
    else:
        for domain in ("l2", "linf", "simplex"):
            print(f"\n=== domain {domain} ===")
            start(domain=domain)
