"""Parity of the double-single and int8-Ozaki D-opt engines on an NVIDIA GPU.

The test suite runs on the CPU (conftest.py), where the double-single
error-free transforms are backed by float64; only the card runs them in
true float32.  So these tests run their solves in a child process that sees
the GPU, and skip when there is none.  On a GPU machine:

    python -m pytest -m chip tests/test_chip.py
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = "import jax; print(jax.devices()[0].platform)"

_PARITY = r"""
import sys
import jax
import numpy as np
jax.config.update("jax_enable_x64", True)
import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.diagnostics import dopt_certificate

mode = sys.argv[1]
rng = np.random.default_rng(7)
V = rng.standard_normal((60, 600))
x0 = np.full(600, 1.0 / 600)
kw = dict(eps=1e-8, maxitrs=20000, verbose=False)
xe, Fe, *_ = acc.D_opt_FW_away(V, x0, u_mode="exact", **kw)
x, F, *_ = acc.D_opt_FW_away(V, x0, u_mode=mode, **kw)
c, ce = dopt_certificate(V, x), dopt_certificate(V, xe)
assert c["slack"] <= 1.01e-8, c["slack"]
assert abs(c["F"] - ce["F"]) <= 60 * 1e-8, (c["F"], ce["F"])
if mode == "ds":
    assert abs(len(F) - len(Fe)) <= 2, (len(F), len(Fe))
    assert np.max(np.abs(np.asarray(x) - np.asarray(xe))) <= 1e-10
print("PARITY_OK", jax.devices()[0].platform)
"""


def _gpu_env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def gpu_env():
    """A child-process environment that sees the GPU; skips without one."""
    env = _gpu_env()
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or out.stdout.strip() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return env


@pytest.mark.chip
@pytest.mark.parametrize("mode", ["ds", "mixed"])
def test_engine_parity_on_gpu(gpu_env, mode):
    out = subprocess.run([sys.executable, "-c", _PARITY, mode], env=gpu_env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PARITY_OK gpu" in out.stdout
