"""Iteration-complexity sweeps for D-optimal design — vmapped.

Default eps=1e-4 suits float32 (the default device dtype); enable x64 for
tighter targets (f64 batches match reference-numpy iteration counts).

Equivalent of the reference's ipynb/ABPGvsFW studies (ex_Dopt_FW_m80 /
_n1000 / _n2000: K = 3-10 seeded repeats per (m, n) config, iterations to
reach complementary slackness eps, geometric means) — but the K repeats
solve as ONE vmapped computation (parallel.batched.dopt_fw_batch), so a
whole repeat-batch costs barely more than one instance.
"""

import numpy as np

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch


def iters_to_eps(SP, SN, eps):
    """First iteration where both slacks are <= eps (or -1)."""
    ok = (SP <= eps) & (SN <= eps)
    return int(np.argmax(ok)) if ok.any() else -1


def start(m=30, n_list=(200, 400, 800), K=4, eps=1e-4, num_iters=4000,
          seed=0, verbose=True, eps_list=None, plot=False):
    """``eps_list``: run the full eps sweep the reference's figure studies
    plot (iterations-to-eps vs n, one curve per eps); defaults to [eps]."""
    rng = np.random.default_rng(seed)
    eps_list = list(eps_list) if eps_list else [eps]
    eps_run = min(eps_list)
    results = {}
    for n in n_list:
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)
        xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=eps_run,
                                         num_iters=num_iters, away=True)
        per_eps = {}
        for e in eps_list:
            iters = [iters_to_eps(np.asarray(SPb[k]), np.asarray(SNb[k]), e)
                     for k in range(K)]
            solved = [i for i in iters if i >= 0]
            gmean = (float(np.exp(np.mean(np.log(np.maximum(solved, 1)))))
                     if solved else float("nan"))
            per_eps[e] = {"iters": iters, "geomean": gmean}
        results[n] = dict(per_eps[eps_list[0]])
        results[n]["per_eps"] = per_eps
        if verbose:
            for e, r in per_eps.items():
                print(f"m={m} n={n} eps={e:g}: iters = {r['iters']}  "
                      f"geomean = {r['geomean']:.1f}")

    if plot:
        from _galleryutil import get_axes, save_fig

        fig, ax = get_axes(1, 1)
        ns = sorted(results)
        for e in eps_list:
            ax.loglog(ns, [results[n]["per_eps"][e]["geomean"] for n in ns],
                      marker="o", label=rf"$\epsilon$ = {e:g}")
        ax.set_xlabel("$n$")
        ax.set_ylabel("iterations to slack (geomean)")
        ax.set_title(f"FW-away iteration complexity, m={m}, K={K} repeats")
        ax.legend()
        save_fig(fig, f"dopt_sweep_m{m}.png")
    return results


def start_full(m=20, n_list=(100, 200, 300), K=3, eps_list=(1e-3, 1e-4),
               num_iters=3000, seed=0, verbose=True, plot=False,
               fast_gram=True):
    """Four-method sweep mirroring the reference figure studies exactly
    (ipynb/ABPGvsFW/ex_Dopt_FW_m80.ipynb cells 3+5): FW and FW-away from
    the Kumar-Yildirim init, BPG-LS (ls_ratio 1.5) and ABPG-gain
    (ls_inc/dec 1.5, restart) from uniform x0; iterations AND wall time to
    objective gap F - Fmin <= eps (Fmin = best across methods per
    instance), geometric means over K seeded repeats.

    Reference scale is m=80, n up to 1000, K=10, Nmax=100000; defaults
    here are a runnable reduction — pass the full values to reproduce the
    paper figure.  ``fast_gram`` routes the BPG/ABPG runs through the
    linear-Gram stateful steps (f64-grade convergence at f32-era cost);
    ``fast_gram="ds"`` uses the round-3 double-single engine
    (DOptimalObjDS — the fastest on-chip route for the BPG rows).

    The study needs f64 like the reference (at f32 the BPG family
    plateaus above the tight gap targets); x64 is enabled here.
    """
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    labels = ["FW", "FW-away", "BPG-LS", "ABPG-g"]
    iters = {lab: {e: np.zeros((len(n_list), K)) for e in eps_list}
             for lab in labels}
    times = {lab: {e: np.zeros((len(n_list), K)) for e in eps_list}
             for lab in labels}

    for i, n in enumerate(n_list):
        for k in range(K):
            f, h, L, x0 = acc.D_opt_design(m, n,
                                           randseed=int(rng.integers(1 << 30)))
            V = np.asarray(f.H, np.float64)
            x0KY = jnp.asarray(acc.D_opt_KYinit(V), x0.dtype)
            Vd = jnp.asarray(V, x0.dtype)
            runs = {}
            # with the DS engine selected, run the FW rows through their
            # DS scan too
            um = "ds" if fast_gram == "ds" else "auto"
            _, F1, _, _, T1 = acc.D_opt_FW(Vd, x0KY, 1e-8,
                                           maxitrs=num_iters, verbose=False,
                                           u_mode=um)
            runs["FW"] = (np.asarray(F1, float), np.asarray(T1))
            _, F2, _, _, T2 = acc.D_opt_FW_away(Vd, x0KY, 1e-8,
                                                maxitrs=num_iters,
                                                verbose=False, u_mode=um)
            runs["FW-away"] = (np.asarray(F2, float), np.asarray(T2))
            if fast_gram == "ds":
                # the round-3 double-single engine: f64-grade without x64,
                # the fastest on-chip route for the BPG rows
                f_run = acc.DOptimalObjDS.from_design(V)
                x0_run = np.asarray(x0, np.float64)
            else:
                f_run, x0_run = f, x0
            fg = fast_gram if fast_gram == "ds" else (
                fast_gram and hasattr(f, "gram"))
            _, F3, _, T3 = acc.BPG(f_run, h, L, x0_run, maxitrs=num_iters,
                                   linesearch=True, ls_ratio=1.5,
                                   verbose=False, fast_gram=fg)
            runs["BPG-LS"] = (np.asarray(F3, float), np.asarray(T3))
            _, F4, _, _, _, T4 = acc.ABPG_gain(f_run, h, L, x0_run, gamma=2,
                                               maxitrs=num_iters,
                                               ls_inc=1.5, ls_dec=1.5,
                                               restart=True, verbose=False,
                                               fast_gram=fg)
            runs["ABPG-g"] = (np.asarray(F4, float), np.asarray(T4))

            Fmin = min(F.min() for F, _ in runs.values())
            for lab, (F, T) in runs.items():
                for e in eps_list:
                    hit = np.nonzero(F - Fmin <= e)[0]
                    if len(hit):
                        iters[lab][e][i, k] = hit[0]
                        times[lab][e][i, k] = T[hit[0]]
                    else:
                        iters[lab][e][i, k] = num_iters + 1
                        times[lab][e][i, k] = T[-1]
        if verbose:
            e = eps_list[-1]
            row = "  ".join(
                f"{lab}={np.exp(np.mean(np.log(np.maximum(iters[lab][e][i], 1)))):.0f}"
                for lab in labels)
            print(f"m={m} n={n} eps={e:g} iters(geomean): {row}")

    if plot:
        from _galleryutil import get_axes, save_fig

        e = eps_list[-1]
        fig, axes = get_axes(1, 2)
        ns = np.asarray(n_list)
        styles = {"FW": "g-", "FW-away": "k-.", "BPG-LS": "b:",
                  "ABPG-g": "r--"}
        for lab in labels:
            gm_i = np.exp(np.mean(np.log(np.maximum(iters[lab][e], 1)),
                                  axis=1))
            gm_t = np.exp(np.mean(np.log(np.maximum(times[lab][e], 1e-9)),
                                  axis=1))
            # like the reference, drop points that exceeded the budget
            conv = gm_i <= num_iters
            if conv.any():
                axes[0].loglog(ns[conv], gm_i[conv], styles[lab],
                               marker="o", label=lab)
            axes[1].loglog(ns, gm_t, styles[lab], marker="o", label=lab)
        axes[0].set_xlabel("$n$")
        axes[0].set_ylabel(rf"iterations to $F - F^\star \leq$ {e:g}")
        axes[1].set_xlabel("$n$")
        axes[1].set_ylabel("wall time [s] (geomean)")
        for ax in axes:
            ax.legend()
        fig.suptitle(f"D-opt methods, m={m}, K={K} repeats")
        save_fig(fig, f"dopt_sweep_methods_m{m}.png")
    return iters, times


if __name__ == "__main__":
    from _galleryutil import enable_cache

    enable_cache()
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--m", type=int, default=30)
    p.add_argument("--n-list", type=int, nargs="+", default=(200, 400, 800))
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--eps-list", type=float, nargs="+",
                   default=(1e-3, 1e-4))
    p.add_argument("--num-iters", type=int, default=4000)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--full", action="store_true",
                   help="four-method sweep (FW / FW-away / BPG-LS / "
                        "ABPG-g), the reference figure's exact design")
    p.add_argument("--ds", action="store_true",
                   help="run the BPG rows of --full through the "
                        "double-single engine (fast_gram='ds')")
    a = p.parse_args()
    if a.full:
        start_full(m=a.m, n_list=tuple(a.n_list), K=a.K,
                   eps_list=tuple(a.eps_list), num_iters=a.num_iters,
                   plot=a.plot, fast_gram=("ds" if a.ds else True))
    else:
        start(m=a.m, n_list=tuple(a.n_list), K=a.K, eps_list=a.eps_list,
              num_iters=a.num_iters, plot=a.plot)
