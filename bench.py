"""Headline benchmark: D-optimal design 1000x5000, Frank-Wolfe with away steps.

The instance, the iteration budget and the certified optimum F* come from
baselines/dopt_1000x5000_ref.json: the reference implementation
(accbpg/D_opt_alg.py, float64 numpy) converges to complementary slackness
1e-8 in 20741 iterations, and F* is a fresh float64 slogdet of the final
iterate of the trajectory-identical run.

This runs ``D_opt_FW_away(u_mode="auto")`` — the native float64 scan — for
the same budget from the same uniform start, three times after a warm-up
call that compiles, and certifies the last iterate's objective gap against
F* with a fresh float64 slogdet on the host.  It needs a GPU: without one it
exits with code 2 and prints no result.

Output: the card's name and power limit on one line, then one JSON line
{metric, value, unit, ...}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def main():
    import numpy as np

    import jax

    jax.config.update("jax_enable_x64", True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        return 2

    sys.path.insert(0, ROOT)
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.compile_cache import enable_compilation_cache

    enable_compilation_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)

    with open(os.path.join(ROOT, "baselines", "dopt_1000x5000_ref.json")) as fh:
        base = json.load(fh)
    cfg = base["config"]
    m, n = cfg["m"], cfg["n"]
    iters = base["iters"]
    F_star = base["F_star_certified"]

    np.random.seed(cfg["seed"])
    V64 = np.random.randn(m, n)
    x0 = np.full(n, 1.0 / n)

    def solve():
        return acc.D_opt_FW_away(V64, x0, eps=cfg["eps"], maxitrs=iters,
                                 verbose=False, chunk=2500, u_mode="auto")

    t0 = time.perf_counter()
    solve()
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        x, F, SP, SN, T = solve()
        walls.append(time.perf_counter() - t0)

    # certification: fresh float64 evaluation of the (simplex-normalized)
    # final iterate against the certified optimum
    gap = acc.diagnostics.dopt_certificate(V64, x)["F"] - F_star

    result = {
        "metric": "dopt_1000x5000_fw_away_wall_s",
        "value": min(walls),
        "unit": "s",
        "all_runs_s": walls,
        "first_call_s": first_s,
        "iters": int(len(F)),
        "certified_gap": gap,
        "solver_slack": [float(SP[-1]), float(SN[-1])],
        "quality_pass": bool(abs(gap) <= 1e-6),
        "device": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
