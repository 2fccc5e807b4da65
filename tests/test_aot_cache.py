"""Compilation caches: the driver's in-process executable cache and the
persistent-cache helper that scripts call (compile_cache.py)."""

import os
import subprocess
import sys


def test_exec_cache_lru_eviction(monkeypatch):
    """The in-process executable cache is LRU-bounded (unbounded growth
    exhausts vm.max_map_count via live JIT code mappings); evicted
    entries must transparently recompile with identical results."""
    import jax.numpy as jnp
    import numpy as np

    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.algorithms import driver

    monkeypatch.setattr(driver, "_EXEC_CACHE_CAP", 2)
    driver.clear_exec_cache()

    def solve(n):
        f, h, L, x0 = acc.D_opt_design(8, n, randseed=3)
        x0 = jnp.asarray(np.asarray(x0, np.float64))
        f = acc.DOptimalObj(H=jnp.asarray(np.asarray(f.H), jnp.float64))
        r = acc.BPG(f, h, L, x0, maxitrs=60, verbose=False)
        return float(np.asarray(r[1])[-1])

    first = solve(40)
    solve(50)
    solve(60)  # evicts the n=40 entry
    assert len(driver._EXEC_CACHE) <= 2
    assert solve(40) == first  # recompiled, same result


# -- persistent compilation cache helper (compile_cache.py) -----------------
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = r"""
import jax
from accbpg_and_fw_tpu.compile_cache import enable_compilation_cache
print("RET", enable_compilation_cache())
print("CFG", jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    """Run the helper in a fresh process; returns (returned, config)."""
    env = dict(os.environ, PYTHONPATH=_REPO, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    vals = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                if line.startswith(("RET ", "CFG ")))
    return vals["RET"], vals["CFG"]


def test_compile_cache_env_var_set(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing: JAX
    itself reads the variable."""
    ret, cfg = _probe(str(tmp_path))
    assert ret == str(tmp_path) and cfg == str(tmp_path)


def test_compile_cache_env_var_unset():
    from accbpg_and_fw_tpu.compile_cache import CACHE_DIR

    ret, cfg = _probe(None)
    assert ret == cfg == CACHE_DIR
    assert os.path.dirname(CACHE_DIR) == _REPO
    with open(os.path.join(_REPO, ".gitignore")) as fh:
        assert os.path.basename(CACHE_DIR) + "/" in fh.read().split()


def test_compile_cache_path_is_fixed():
    """The directory is the same in every process: nothing of a PID, a
    temp name or the time goes into it."""
    assert _probe(None) == _probe(None)


def test_compile_cache_not_enabled_at_import():
    import importlib

    import jax

    from accbpg_and_fw_tpu import compile_cache

    before = jax.config.jax_compilation_cache_dir
    importlib.reload(compile_cache)
    assert jax.config.jax_compilation_cache_dir == before
