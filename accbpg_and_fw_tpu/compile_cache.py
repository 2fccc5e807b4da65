"""Persistent XLA compilation cache for the scripts that drive the solvers.

Scripts (``bench.py``, ``chip_smoke.py``, the example gallery) call
``enable_compilation_cache()`` once before their first solve, so a second
process with the same shapes loads its compiled executables from disk
instead of compiling them again.  Nothing here runs at import: library
users and the test suite keep JAX's own defaults.
"""

from __future__ import annotations

import os

# A fixed path inside the checkout.  JAX keys cache entries by the
# computation, not by the directory, but a directory that moved between
# runs (a temp name, a PID, a date) would never be found again.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_compile_cache")

_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets nothing; otherwise the cache goes to ``CACHE_DIR``."""
    env = os.environ.get(_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
