"""Worker process for tests/test_distributed.py.

One of N processes in a LOCAL ``jax.distributed`` CPU cluster (coordinator
on localhost): each process owns 4 virtual CPU devices, the global mesh has
N*4, and the column-sharded D-opt solvers run SPMD with cross-process
collectives (gloo).  This executes the real multi-process code path —
``jax.distributed.initialize`` + cross-host collectives — that a multi-host
GPU run would use over the network (SURVEY.md §2.6; the reference has no
distributed code at all, its accbpg/algorithms.py is single-process).

Usage: python distributed_worker.py PORT PROCESS_ID NUM_PROCESSES
Prints one ``RESULT {json}`` line from process 0.
"""

import json
import os
import sys


def main():
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4 "
        "--xla_cpu_use_fusion_emitters=false")

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    # cross-process CPU collectives need a real backend (gloo); without it
    # psums across processes have no transport
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from accbpg_and_fw_tpu.parallel import distributed_init

    distributed_init(f"localhost:{port}", num_processes=nproc,
                     process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc * 4, len(jax.devices())
    assert len(jax.local_devices()) == 4

    import numpy as np

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.parallel import (
        data_mesh, shard_dopt_design, shard_dopt_problem)

    mesh = data_mesh()  # all N*4 global devices

    f, h, L, x0 = acc.D_opt_design(12, 64, randseed=5)
    V = np.asarray(f.H)
    out = {"devices": len(jax.devices()),
           "processes": jax.process_count()}

    # column-sharded Wolfe-Atwood FW (the §2.6 flagship layout): V columns
    # and all length-n state shard across BOTH processes; H/w collectives
    # ride the cross-process transport every iteration
    Vs, x0s = shard_dopt_design(V, x0, mesh)
    r = acc.D_opt_FW_away(Vs, x0s, eps=1e-8, maxitrs=600, verbose=False,
                          chunk=300)
    F = np.asarray(r[1])
    out["fw_F"] = float(F[-1])
    out["fw_iters"] = int(len(F))

    # linear-Gram BPG: the per-trial O(m^2 n) Gram contraction psums over
    # the 2-process mesh; carried m x m state replicates
    f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
    xb, Fb, Ls, T = acc.BPG(f_sh, h, L, x_sh, maxitrs=40, verbose=False,
                            fast_gram=True)
    out["bpg_F"] = float(np.asarray(Fb)[-1])

    # row-sharded Poisson regression (data-parallel layout): samples split
    # across processes, per-iteration psums of the loss/gradient reductions
    from accbpg_and_fw_tpu.parallel import (shard_regression_problem,
                                            shard_symnmf_problem)

    fp, hp, Lp, xp0 = acc.Poisson_regrL1(64, 20, noise=0.0001, randseed=2)
    fp_sh, xp_sh = shard_regression_problem(fp, xp0, mesh)
    rp = acc.BPG(fp_sh, hp, Lp, xp_sh, maxitrs=50, linesearch=False,
                 verbose=False)
    out["poisson_F"] = float(np.asarray(rp[1])[-1])

    # row-sharded KL regression
    fk, hk, Lk, xk0 = acc.KL_nonneg_regr(64, 20, noise=0.001, randseed=4)
    fk_sh, xk_sh = shard_regression_problem(fk, xk0, mesh)
    rk = acc.BPG(fk_sh, hk, Lk, xk_sh, maxitrs=50, linesearch=False,
                 verbose=False)
    out["kl_F"] = float(np.asarray(rk[1])[-1])

    # row-sharded SymNMF: the n x n similarity matrix splits row-wise, the
    # n x r factor too; X^T X and kernel norms psum across processes
    rng = np.random.default_rng(6)
    nsym, rsym = 64, 4
    Y = np.abs(rng.standard_normal((nsym, rsym)))
    M = Y @ Y.T / rsym + 0.01 * np.abs(rng.standard_normal((nsym, nsym)))
    M = 0.5 * (M + M.T)
    np.random.seed(3)
    fs, (hs, _), Ls_, X0s = acc.FrobeniusSymLossResMeasEx(M, rsym)
    fs_sh, Xs_sh = shard_symnmf_problem(fs, X0s, mesh)
    rs = acc.BPG(fs_sh, hs, Ls_, Xs_sh, maxitrs=50, linesearch=False,
                 verbose=False)
    out["symnmf_F"] = float(np.asarray(rs[1])[-1])

    # round 5: column-sharded MIXED oracle — the int8 digit planes and DS
    # planes themselves shard (shard_dopt_problem now places every
    # column-indexed field), so the Gram/MV contractions psum across the
    # 2-process mesh at f64 grade
    fm, hm, Lm, xm0 = acc.D_opt_design(8, 64, randseed=3, oracle="mixed")
    fm_sh, xm_sh = shard_dopt_problem(fm, xm0, mesh)
    rm = acc.BPG(fm_sh, hm, Lm, xm_sh, maxitrs=30, verbose=False)
    out["mixed_F"] = float(np.asarray(rm[1])[-1])

    if pid == 0:
        print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
