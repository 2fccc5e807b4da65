"""chip_smoke.py and bench.py: their phases at small sizes on the CPU, their
refusal to run without a GPU, and the host certificate they check with."""

import math
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.diagnostics import dopt_certificate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def small_dopt():
    rng = np.random.default_rng(10)
    V = rng.standard_normal((12, 150))
    return V, np.full(150, 1.0 / 150)


@pytest.fixture(scope="module")
def mesh4():
    from accbpg_and_fw_tpu.parallel import data_mesh

    return data_mesh(jax.devices()[:4])


# -- the host certificate ----------------------------------------------------

_E = np.eye(3)


@pytest.mark.parametrize("V,x,F,w,slack,gap", [
    # x uniform over I_3 plus copies of e1, e2: G = diag(2/5, 2/5, 1/5)
    (np.hstack([_E, _E[:, :2]]), np.ones(5), math.log(125 / 4),
     [2.5, 2.5, 5.0, 2.5, 2.5], 2 / 3, 3 * math.log(5 / 3)),
    # the optimum: mass 1/3 on each of I_3, none on two zero columns
    (np.hstack([_E, np.zeros((3, 2))]), [1, 1, 1, 0, 0], 3 * math.log(3),
     [3.0, 3.0, 3.0, 0.0, 0.0], 0.0, 0.0),
], ids=["interior", "optimum"])
def test_certificate_hand_computed(V, x, F, w, slack, gap):
    c = dopt_certificate(V, np.asarray(x, np.float64))
    assert c["F"] == pytest.approx(F, abs=1e-14)
    np.testing.assert_allclose(c["w"], w, atol=1e-14)
    assert c["slack"] == pytest.approx(slack, abs=1e-14)
    assert c["gap_bound"] == pytest.approx(gap, abs=1e-14)


# -- the phases, small, on the CPU -------------------------------------------


def test_phase_headline(small_dopt):
    V, x0 = small_dopt
    F_star = dopt_certificate(V, acc.D_opt_FW_away(
        V, x0, eps=1e-10, maxitrs=20000, verbose=False)[0])["F"]
    out = cs.phase_headline(acc, V, x0, 1e-8, 20000, F_star, chunk=500)
    assert out["iters"] < 20000 and out["fresh_slack"] <= cs.SLACK_BAR


def test_phase_khachiyan(small_dopt):
    V, x0 = small_dopt
    out = cs.phase_khachiyan(acc, V, x0, maxitrs=300, chunk=128)
    assert out["iters"] == 300


def test_phase_bpg():
    out = cs.phase_bpg(acc, 8, 200, 10, maxitrs=300, cpu_itrs=100,
                       fw_maxitrs=50000)
    # on one backend the CPU run is the same computation
    assert out["cpu_max_rel_dev"] == 0.0
    assert out["F_minus_F_star"] >= -1e-12


def test_phase_sweep():
    out = cs.phase_sweep(acc, 3, 8, 80, 3, num_iters=3000)
    assert out["auto"]["max_iters_to_1e8"] > 0


def test_phase_engines(small_dopt):
    V, x0 = small_dopt
    out = cs.phase_engines(acc, V, x0, maxitrs=20000)
    assert set(out) == {"exact", "mixed", "ds"}


def test_phase_f32():
    out = cs.phase_f32(acc, 20, 60, 10, maxitrs=100)
    assert out["dtype"] == "float32"


def test_phase_sharded_dopt(mesh4):
    out = cs.phase_sharded_dopt(acc, mesh4, 8, 402, 10, iters=200, chunk=100)
    assert out["device_set_sizes"] == [4]


def test_phase_sharded_poisson(mesh4):
    out = cs.phase_sharded_poisson(acc, mesh4, 400, 60, 1, iters=40)
    assert out["device_set_sizes"] == [4]


def test_failed_check_raises():
    with pytest.raises(AssertionError, match="slack"):
        cs.check(False, "fresh slack too large")


# -- without a GPU: non-zero exit, no result ---------------------------------


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    out = _run([script], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert '"quality_pass"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
