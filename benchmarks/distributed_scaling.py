"""Per-collective cost of the REAL multi-process path (2-process local CPU
cluster, gloo) vs the single-process virtual mesh.

The column-sharded FW-away step pays a fixed set of collectives per
iteration (Gram psum, argmax/argmin reductions, simplex-Newton scalar
psums).  This harness measures iterations/s
of the SAME sharded computation on (a) 8 virtual devices in one process
and (b) 2 processes x 4 virtual devices with gloo cross-process
collectives, isolating the cross-process transport cost.  Run:

    python benchmarks/distributed_scaling.py            # orchestrator
    (spawns itself twice with --worker)
"""

import json
import os
import socket
import subprocess
import sys
import time

M, N, ITERS = 100, 8192, 1500


def run_case(nproc):
    if nproc == 1:
        return worker(None, 0, 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(port),
         str(pid), str(nproc)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(nproc)]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{err[-2000:]}")
    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


def worker(port, pid, nproc):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={8 // nproc} "
        "--xla_cpu_use_fusion_emitters=false")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if nproc > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(f"localhost:{port}", num_processes=nproc,
                                   process_id=pid)
    import numpy as np

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.parallel import data_mesh, shard_dopt_design

    rng = np.random.default_rng(0)
    V = rng.standard_normal((M, N)).astype(np.float32)
    x0 = np.full(N, 1.0 / N, np.float32)
    mesh = data_mesh()
    Vs, x0s = shard_dopt_design(V, x0, mesh)

    r = acc.D_opt_FW_away(Vs, x0s, eps=0.0, maxitrs=200, verbose=False,
                          chunk=200)  # compile + warm
    t0 = time.time()
    r = acc.D_opt_FW_away(Vs, x0s, eps=0.0, maxitrs=ITERS, verbose=False,
                          chunk=ITERS)
    wall = time.time() - t0
    res = {"processes": nproc, "devices": 8, "iters": ITERS,
           "wall_s": round(wall, 3),
           "iters_per_s": round(ITERS / wall, 1),
           "us_per_iter": round(wall / ITERS * 1e6, 1)}
    if pid == 0:
        print("RESULT " + json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    else:
        one = run_case(1)
        print(json.dumps(one), flush=True)
        two = run_case(2)
        print(json.dumps(two), flush=True)
        extra = (two["us_per_iter"] - one["us_per_iter"])
        print(json.dumps({"cross_process_overhead_us_per_iter":
                          round(extra, 1),
                          "per_collective_us(3/iter)": round(extra / 3, 1)}),
              flush=True)
        # round 5: a second point on the cross-process curve — 4 processes
        # x 2 virtual devices (same 8-device global mesh, more transport
        # edges per collective); the 2->4 growth rate feeds the multi-host
        # projection's collective model
        four = run_case(4)
        print(json.dumps(four), flush=True)
        extra4 = (four["us_per_iter"] - one["us_per_iter"])
        print(json.dumps({
            "cross_process_overhead_us_per_iter_4p": round(extra4, 1),
            "growth_2p_to_4p": round(
                extra4 / extra if extra > 0 else float("nan"), 2)}),
            flush=True)
