"""Test configuration: CPU-only, 8 virtual devices, float64.

Tests run on a simulated 8-device CPU mesh (real multi-GPU sharding is
exercised by ``chip_smoke.py --chips 4``) and in float64 so trajectories
can be matched against the reference's stored numpy traces (SURVEY.md §4).
Tests marked ``chip`` need a GPU and skip here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: a GPU machine would pick the GPU
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_use_fusion_emitters" not in flags:
    # XLA:CPU's fusion emitters MISCOMPILE the double-single transcendental
    # + pairwise-reduction kernels (ds.exp/log feeding sum_along) into an
    # INFINITE EXECUTION LOOP — compile succeeds in ~0.5 s, then the first
    # execute spins one thread forever (root-caused 2026-08-19: minimal
    # repro is jit(sum_along(ds.exp(x))) at n=32; exp alone and the fold
    # alone are fine; --xla_cpu_use_fusion_emitters=false runs the same
    # graph correctly).  The legacy emitter path is correct and fast
    # enough for tests.
    flags = (flags + " --xla_cpu_use_fusion_emitters=false").strip()
os.environ["XLA_FLAGS"] = flags

import jax

# jax may already have been imported with another platform list; the config
# update wins over the environment.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_collection_modifyitems(session, config, items):
    """Run the reference-parity goldens FIRST.

    XLA:CPU intermittently crashes (SIGSEGV/SIGABRT inside
    backend_compile_and_load, observed 4x) when compiling an eager f64
    while_loop after the ~2000 compilations a full-suite run accumulates —
    always at the same TestMixedOracleGolden compile, never in a young
    process, and jax.clear_caches() does not prevent it.  Compiling these
    eager reference-driver loops while the process compile state is fresh
    sidesteps the crash deterministically."""
    early = [i for i in items if "test_reference_parity" in i.nodeid]
    rest = [i for i in items if "test_reference_parity" not in i.nodeid]
    items[:] = early + rest


@pytest.fixture(scope="module", autouse=True)
def _bound_jit_code_mappings():
    """Keep the process under vm.max_map_count (default 65530).

    Every live compiled executable holds ~3 mmapped JIT code regions; a
    full-suite run compiles ~2000 of them and was observed at ~60k
    mappings, where later LLVM compiles die with SIGSEGV/SIGABRT inside
    backend_compile_and_load (4 distinct crashes, position-dependent).
    jax.clear_caches() measurably returns the mappings (probe: 1430 ->
    531 maps), so drop caches at module boundaries once the count grows.
    """
    yield
    import os

    try:
        with open(f"/proc/{os.getpid()}/maps") as fh:
            n = sum(1 for _ in fh)
    except OSError:
        return
    if n > 25000:
        import jax

        from accbpg_and_fw_tpu.algorithms.driver import clear_exec_cache

        clear_exec_cache()
        jax.clear_caches()
