"""Multi-PROCESS ``jax.distributed`` execution (round-2 verdict item 3).

Spawns a 2-process local CPU cluster (coordinator on localhost, 4 virtual
devices per process -> an 8-device global mesh) and runs the column-sharded
D-opt solvers SPMD with real cross-process collectives, asserting parity
with the single-process 8-virtual-device run of the SAME problems.  This is
the software path a multi-host GPU run would use over the network, minus
the hardware.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import accbpg_and_fw_tpu as acc

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cluster_result():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out (coordinator deadlock?)")
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            if ("gloo" in err.lower() and "unimplemented" in err.lower()):
                pytest.skip(f"no gloo CPU collectives in this jax: {err[-400:]}")
            pytest.fail(
                f"worker {p.args} exited {p.returncode}\n"
                f"stdout:\n{out[-2000:]}\nstderr:\n{err[-2000:]}")
    result_lines = [ln for ln in outs[0][0].splitlines()
                    if ln.startswith("RESULT ")]
    assert result_lines, f"no RESULT from process 0:\n{outs[0][0][-2000:]}"
    return json.loads(result_lines[0][len("RESULT "):])


class TestTwoProcessCluster:
    def test_global_mesh_formed(self, cluster_result):
        assert cluster_result["processes"] == 2
        assert cluster_result["devices"] == 8

    def test_fw_away_parity_with_single_process(self, cluster_result):
        f, h, L, x0 = acc.D_opt_design(12, 64, randseed=5)
        V = np.asarray(f.H)
        r = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=600, verbose=False,
                              chunk=300)
        F = np.asarray(r[1])
        assert cluster_result["fw_iters"] == len(F)
        assert abs(cluster_result["fw_F"] - float(F[-1])) < 1e-9

    def test_fastgram_bpg_parity_with_single_process(self, cluster_result):
        f, h, L, x0 = acc.D_opt_design(12, 64, randseed=5)
        xb, Fb, Ls, T = acc.BPG(f, h, L, x0, maxitrs=40, verbose=False,
                                fast_gram=True)
        assert abs(cluster_result["bpg_F"] - float(np.asarray(Fb)[-1])) < 1e-9

    def test_row_sharded_poisson_parity(self, cluster_result):
        f, h, L, x0 = acc.Poisson_regrL1(64, 20, noise=0.0001, randseed=2)
        r = acc.BPG(f, h, L, x0, maxitrs=50, linesearch=False, verbose=False)
        assert abs(cluster_result["poisson_F"]
                   - float(np.asarray(r[1])[-1])) < 1e-9

    def test_row_sharded_kl_parity(self, cluster_result):
        f, h, L, x0 = acc.KL_nonneg_regr(64, 20, noise=0.001, randseed=4)
        r = acc.BPG(f, h, L, x0, maxitrs=50, linesearch=False, verbose=False)
        assert abs(cluster_result["kl_F"]
                   - float(np.asarray(r[1])[-1])) < 1e-9

    def test_row_sharded_symnmf_parity(self, cluster_result):
        rng = np.random.default_rng(6)
        n, rr = 64, 4
        Y = np.abs(rng.standard_normal((n, rr)))
        M = Y @ Y.T / rr + 0.01 * np.abs(rng.standard_normal((n, n)))
        M = 0.5 * (M + M.T)
        np.random.seed(3)
        f, (h, _), L, X0 = acc.FrobeniusSymLossResMeasEx(M, rr)
        r = acc.BPG(f, h, L, X0, maxitrs=50, linesearch=False, verbose=False)
        assert abs(cluster_result["symnmf_F"]
                   - float(np.asarray(r[1])[-1])) < 1e-9

    def test_column_sharded_mixed_oracle_parity(self, cluster_result):
        """Round 5: the Mixed oracle's digit/DS planes shard across the
        2-process mesh (previously only the f64 H leaf was placed)."""
        f, h, L, x0 = acc.D_opt_design(8, 64, randseed=3, oracle="mixed")
        r = acc.BPG(f, h, L, x0, maxitrs=30, verbose=False)
        assert abs(cluster_result["mixed_F"]
                   - float(np.asarray(r[1])[-1])) < 1e-9
