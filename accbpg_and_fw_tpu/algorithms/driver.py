"""Chunked-scan execution engine for all iteration drivers.

The reference runs every algorithm as a Python ``for`` loop with per-iteration
NumPy calls (e.g. accbpg/algorithms.py:45-67).  Here every
algorithm is a *pure step function* ``step(carry, k) -> (carry, hist)`` that
is compiled once and executed on device as ``lax.scan`` chunks:

* one XLA computation per chunk of iterations — no per-iteration host
  round-trips, no retracing;
* early stopping with the reference's exact truncation semantics: a step
  records ``_stop`` in its history; iterations after the stop run through a
  frozen-carry ``where`` select (no branchy cond) and are sliced off on host;
* wall-clock ``T`` arrays measured at chunk boundaries and interpolated
  within a chunk (the reference's ``T[k] = time.time() - start`` is the same
  signal at 1-iteration granularity);
* the verbose progress tables are re-printed from device history at chunk
  boundaries with the reference's formats.

Contract for step functions (cached form):
  ``step(cfg, problem, carry, k) -> (carry, hist)`` where ``step`` is a
  MODULE-LEVEL function, ``cfg`` is hashable static config, ``problem`` is a
  traced pytree (oracles + scalars) and
  carry: a dict pytree that must contain ``done`` (bool scalar);
  hist:  a dict of scalar arrays; must contain ``_stop`` (bool: the stopping
         criterion fired at this iteration; this iteration is the last one
         recorded, matching the reference's ``break`` placement).

Because the problem is a traced ARGUMENT (not a closure constant), compiled
chunk executables are cached per (step, cfg, chunk, avals+shardings) and
REUSED across solver calls with the same shapes — repeat solves, sweeps and
line-search studies pay the compile exactly once per process (and, with
``compile_cache.enable_compilation_cache()``, once per machine).

Chunks are launched at an arbitrary starting iteration ``k0`` (a traced
argument), so the host loop tracks the NEXT GLOBAL ITERATION ``k_next``
instead of a chunk counter.  Consequences:

* drivers whose k=0 step is a special initialization run it once OUTSIDE
  the scan (jitted) and enter the driver with ``k_start=1`` — no
  ``lax.cond`` threading the full carry through every iteration (a cond
  with a large carry threads the full state through both branches every
  scan step, DESIGN.md §3);
* checkpoints store ``k_next`` + the valid history rows, NOT whole chunks —
  resuming with a different ``chunk`` or a larger ``maxitrs`` budget is
  exact (the scan restarts mid-"chunk" at the precise saved iteration).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# LRU-bounded in-process executable cache.  Each compiled XLA
# executable keeps its JIT code pages mmapped for as long as it is
# referenced; an unbounded cache in a long-lived process (a test suite, a
# service) accumulates tens of thousands of 3-mapping code objects and can
# exhaust vm.max_map_count (default 65530) — observed as SIGSEGV/SIGABRT
# inside later backend compiles at ~60k mappings.  Evicted entries
# recompile (or load from JAX's persistent compilation cache when on).
_EXEC_CACHE: OrderedDict = OrderedDict()
_EXEC_CACHE_CAP = 64


def _exec_cache_put(key, exe):
    _EXEC_CACHE[key] = exe
    _EXEC_CACHE.move_to_end(key)
    while len(_EXEC_CACHE) > _EXEC_CACHE_CAP:
        _EXEC_CACHE.popitem(last=False)


def clear_exec_cache():
    """Drop all in-process compiled-chunk executables (frees their JIT
    code mappings)."""
    _EXEC_CACHE.clear()

_CKPT_VERSION = 3

# Checkpoint saves are throttled: at most one save per this many seconds,
# plus always after the final chunk.  Unthrottled per-chunk saves rewrite
# the ENTIRE accumulated history each time (np.savez has no append), which
# is O(iterations^2 / chunk) I/O over a long run.  Set to 0 for a save
# after every chunk.
CHECKPOINT_MIN_INTERVAL_S = [10.0]

_DEVICE_OVERRIDE = [None]


def solver_device(device):
    """Context manager: run all drivers inside the block on ``device`` —
    a platform name such as ``"cpu"`` or ``"gpu"``, or a ``jax.Device``.
    Without it the drivers run where JAX places the problem's arrays.

    Also enters ``jax.default_device(device)``, so the EAGER setup ops the
    solver wrappers run before the chunked scan (initial oracle values,
    scalar coercions, problem placement) land on the target device too."""
    import contextlib

    @contextlib.contextmanager
    def _ctx():
        prev = _DEVICE_OVERRIDE[0]
        _DEVICE_OVERRIDE[0] = device
        dev = jax.devices(device)[0] if isinstance(device, str) else device
        try:
            with jax.default_device(dev):
                yield
        finally:
            _DEVICE_OVERRIDE[0] = prev

    return _ctx()


def _resolve_exec_device():
    ov = _DEVICE_OVERRIDE[0]
    if ov is None:
        return None
    return jax.devices(ov)[0] if isinstance(ov, str) else ov


def _aval_key(tree):
    return tuple(
        (leaf.shape, str(leaf.dtype), getattr(leaf, "sharding", None))
        for leaf in jax.tree_util.tree_leaves(tree)
    ) + (jax.tree_util.tree_structure(tree),)


def _stable_cfg_repr(cfg):
    """repr(cfg) if it is stable across processes (no object addresses /
    closures — e.g. LMO-carrying FW configs are process-local)."""
    r = repr(cfg)
    return None if "0x" in r else r


def _get_compiled_chunk(step, cfg, chunk, problem, carry):
    """Compiled scan-chunk executable, cached in memory across driver
    invocations within a process (keyed by step, config, chunk and the
    avals + shardings of problem and carry)."""
    key = (step, cfg, chunk, _aval_key(problem), _aval_key(carry))
    if key in _EXEC_CACHE:
        _EXEC_CACHE.move_to_end(key)
        return _EXEC_CACHE[key]

    def run(problem, carry, k0, maxitrs):
        body = _masked_scan_body(
            lambda c, k: step(cfg, problem, c, k), maxitrs)
        ks = k0 + jnp.arange(chunk, dtype=jnp.int32)
        return lax.scan(body, carry, ks)

    exe = (jax.jit(run)
           .lower(problem, carry, jnp.int32(0), jnp.int32(1))
           .compile())
    _exec_cache_put(key, exe)
    return exe


def _masked_scan_body(step_fn, limit):
    """Scan body that freezes the carry past the stop flag OR past the
    iteration budget ``limit``; only the true stop criterion persists into
    the carry (a budget freeze must not poison checkpoints resumed with
    more budget).  Masking is a per-leaf ``where`` select, NOT a
    ``lax.cond`` (see ``_wrap_step``)."""

    def body(c, k):
        frozen = c["done"] | (k >= limit)
        c2, h = step_fn(c, k)
        h = dict(h)
        h["_valid"] = jnp.logical_not(frozen)
        c2 = dict(c2)
        c2["done"] = c["done"] | c2["done"] | h["_stop"]
        out = jax.tree_util.tree_map(
            lambda old, new: jnp.where(frozen, old, new), c, c2
        )
        return out, h

    return body


def _wrap_step(step):
    """Wrap a raw step so the carry freezes once carry['done'] is set.

    Masking is a per-leaf ``where`` select, NOT a ``lax.cond``: a cond whose
    branches thread a large carry forces XLA to materialize both branch
    results through the conditional inside the scan.  The select costs one extra pass over the
    carry; compute after the stop runs on frozen values and is discarded,
    and is bounded by one chunk because the host loop stops launching chunks
    once done.
    """

    def wrapped(carry, k):
        done = carry["done"]
        c2, h = step(carry, k)
        h = dict(h)
        h["_valid"] = jnp.logical_not(done)
        c2 = dict(c2)
        c2["done"] = done | c2["done"] | h["_stop"]
        out = jax.tree_util.tree_map(
            lambda old, new: jnp.where(done, old, new), carry, c2
        )
        return out, h

    return wrapped


def _fingerprint(step, cfg) -> str:
    """Stable-across-processes identity of the algorithm being checkpointed.

    Guards against resuming a checkpoint with a different driver OR the same
    driver under different hyperparameters (linesearch flag, restart rule,
    ls_ratio, ...): the full config repr enters the fingerprint whenever it
    is stable across processes; configs carrying closures (LMOs, user
    oracles — their reprs embed object addresses) fall back to the type
    name, which the carry-key validation at load time backstops.
    """
    name = getattr(step, "__qualname__", None) or repr(step)
    mod = getattr(step, "__module__", "?")
    cfgr = _stable_cfg_repr(cfg)
    return f"{mod}.{name}|{cfgr if cfgr is not None else type(cfg).__name__}"


def _save_checkpoint(path, carry, blocks, k_next, t_spent, fp):
    """Atomically persist carry + valid history rows + progress marker."""
    import os

    payload = {
        "__v": np.asarray(_CKPT_VERSION),
        "__k_next": np.asarray(k_next),
        "__t": np.asarray(t_spent),
        "__fp": np.asarray(fp),
    }
    for k, v in jax.device_get(carry).items():
        payload[f"c::{k}"] = np.asarray(v)
    if blocks:
        for name in blocks[0][0]:
            payload[f"h::{name}"] = np.concatenate(
                [b[0][name] for b in blocks])
    tmp = path + ".tmp.npz"  # np.savez appends .npz unless already present
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_checkpoint(path, carry_proto, fp):
    """Load a checkpoint if present; returns (carry, block, k_next, t_spent).

    ``block`` holds the already-completed valid history rows (or None when
    the checkpoint predates the first chunk)."""
    import os

    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if "__v" not in z.files or int(z["__v"]) != _CKPT_VERSION:
            raise ValueError(
                f"checkpoint {path!r} has an incompatible format "
                "(saved by an older version); delete it to start fresh")
        saved_fp = str(z["__fp"])
        if saved_fp != fp:
            raise ValueError(
                f"checkpoint {path!r} was saved by a different solver "
                f"({saved_fp}); refusing to resume as {fp}. Delete the "
                "file to start fresh.")
        saved_keys = sorted(n[3:] for n in z.files if n.startswith("c::"))
        if saved_keys != sorted(carry_proto.keys()):
            raise ValueError(
                f"checkpoint {path!r} carry keys {saved_keys} do not match "
                f"this solver's state {sorted(carry_proto.keys())} — the "
                "solver's carry format changed (library upgrade or a "
                "different fast_gram/option set); delete the file to "
                "restart the run from iteration 0")
        k_next = int(z["__k_next"])
        t_spent = float(z["__t"])
        carry = {}
        for k, proto in carry_proto.items():
            proto_j = jnp.asarray(proto)
            saved = z[f"c::{k}"]
            if tuple(saved.shape) != tuple(proto_j.shape):
                raise ValueError(
                    f"checkpoint {path!r} carry leaf {k!r} has shape "
                    f"{tuple(saved.shape)} but this solve expects "
                    f"{tuple(proto_j.shape)} — different problem instance; "
                    "delete the file to start fresh")
            val = jnp.asarray(saved, proto_j.dtype)
            # restore the prototype's placement for MULTI-device leaves: a
            # mesh-sharded run compiles its chunk executable against the
            # sharded avals, so the resumed carry must carry the same
            # shardings.  Single-device leaves stay uncommitted (device_put
            # would COMMIT them, and a committed single-device scalar then
            # conflicts with an executable compiled for a replicated
            # NamedSharding; uncommitted arrays are auto-placed).
            sh = getattr(proto_j, "sharding", None)
            if sh is not None and len(getattr(sh, "device_set", ())) > 1:
                val = jax.device_put(val, sh)
            carry[k] = val
        hist_names = [n[3:] for n in z.files if n.startswith("h::")]
        block = ({name: z[f"h::{name}"] for name in hist_names}
                 if hist_names else None)
    return carry, block, k_next, t_spent


def run_driver(
    step: Callable,
    carry: Dict,
    maxitrs: int,
    *,
    verbose: bool = True,
    verbskip: int = 1,
    header: Optional[str] = None,
    print_row: Optional[Callable] = None,
    chunk: Optional[int] = None,
    between_chunks: Optional[Callable] = None,
    checkpoint: Optional[str] = None,
    problem=None,
    cfg=None,
    k_start: int = 0,
):
    """Run ``step`` for iterations ``k_start <= k < maxitrs`` in compiled
    scan chunks.

    Two step forms are supported:
    * cached (preferred): ``problem`` is a traced pytree and ``step`` a
      module-level ``step(cfg, problem, carry, k)`` — the compiled chunk is
      cached across solver calls with matching shapes/shardings;
    * legacy closure: ``problem is None`` and ``step(carry, k)`` closes over
      its data — compiled fresh per invocation.

    ``k_start``: drivers whose k=0 step is a one-off initialization run it
    jitted BEFORE the driver and pass ``k_start=1`` — keeping a branchy
    ``lax.cond(k == 0, ...)`` out of the scan body (see module docstring).
    The returned history covers ``k_start..stop`` only; callers prepend
    their init row.

    ``between_chunks(carry, k_next) -> carry``, if given, runs on host
    between chunks (e.g. periodic state refactorization) — it must preserve
    the carry structure.

    ``checkpoint``: path of an ``.npz`` checkpoint.  The full solver state
    (carry + valid history rows + next iteration + wall time consumed) is
    saved there atomically at chunk boundaries — throttled to one save per
    ``CHECKPOINT_MIN_INTERVAL_S`` seconds (every save rewrites the whole
    accumulated history), with the final chunk always saved; if the file
    already exists when the driver starts, the run RESUMES from it —
    exactly, even with a different ``chunk`` or a larger ``maxitrs``
    budget, because progress is tracked per iteration, not per chunk.  The
    file records the solver identity (step + full stable config repr) and
    carry structure/shapes and refuses to resume a mismatched run.
    Delete the file to start fresh.  (The reference has no checkpointing —
    SURVEY.md §5 — its state died with the process.)

    Returns ``(carry, hist, T)`` where ``hist`` maps each history name to a
    host numpy array truncated at the stopping iteration (inclusive), and
    ``T`` is the wall-time array with the reference's semantics.
    """
    if maxitrs <= k_start:
        raise ValueError(f"maxitrs must be > {k_start}")
    if chunk is None:
        # fixed default (not min(maxitrs, .)) so different maxitrs with the
        # same shapes share one cached executable; iterations past maxitrs
        # are masked done inside the chunk
        chunk = int(max(verbskip, 256)) if problem is not None else int(
            min(maxitrs, max(verbskip, 256)))
    chunk = max(1, chunk if problem is not None else min(chunk, maxitrs))

    fp = _fingerprint(step, cfg)
    carry = jax.tree_util.tree_map(jnp.asarray, carry)
    if problem is not None:
        try:
            problem_arrays = jax.tree_util.tree_map(jnp.asarray, problem)
        except (TypeError, ValueError):
            # the problem holds non-array leaves — e.g. user-defined
            # plain-class oracles in the reference's subclassing style
            # (functions.py:10-24/199-235).  Those cannot cross the jit
            # boundary as arguments; fall back to the closure path (correct,
            # just compiled per invocation instead of cached).
            problem_arrays = None
        if problem_arrays is None:
            raw = step
            cfg_, prob_ = cfg, problem
            step = lambda c, k: raw(cfg_, prob_, c, k)  # noqa: E731
            chunk = max(1, min(chunk, maxitrs))
            problem = None
        else:
            problem = problem_arrays
    exec_dev = _resolve_exec_device()
    if exec_dev is not None:
        carry = jax.device_put(carry, exec_dev)
        if problem is not None:
            problem = jax.device_put(problem, exec_dev)
    if problem is not None:
        exe = _get_compiled_chunk(step, cfg, chunk, problem, carry)

        def compiled(c, k0, limit):
            # limit (<= maxitrs) realigns a resumed run to the original
            # chunk grid: iterations past it freeze, so between_chunks
            # hooks fire at the same absolute k regardless of where a
            # checkpoint interrupted the run (exact-resume guarantee).
            return exe(problem, c, k0, jnp.int32(limit))
    else:
        def run_chunk(c, k0, limit):
            # same budget masking as the cached path: without it, a maxitrs
            # that is not a chunk multiple left the returned carry AHEAD of
            # the returned history (the carry ran to the end of the chunk)
            body = _masked_scan_body(step, limit)
            ks = k0 + jnp.arange(chunk, dtype=jnp.int32)
            return lax.scan(body, c, ks)

        _exe = (jax.jit(run_chunk)
                .lower(carry, jnp.int32(0), jnp.int32(1)).compile())

        def compiled(c, k0, limit):
            return _exe(c, k0, jnp.int32(limit))

    if verbose and header:
        print(header)

    # blocks: list of (valid-rows hist dict, t_a, t_b, rows_launched)
    blocks = []
    k_next = k_start
    t_spent = 0.0
    last_save = None
    if checkpoint is not None:
        state = _load_checkpoint(checkpoint, carry, fp)
        if state is not None:
            carry, block, k_next, t_spent = state
            if exec_dev is not None:
                carry = jax.device_put(carry, exec_dev)
            if block is not None:
                nrows = len(next(iter(block.values())))
                blocks.append((block, 0.0, t_spent, nrows))

    t0 = time.time() - t_spent
    while k_next < maxitrs and not bool(jax.device_get(carry["done"])):
        t_a = time.time() - t0
        limit = min(maxitrs, (k_next // chunk + 1) * chunk)
        carry, hist = compiled(carry, jnp.int32(k_next), limit)
        hist = jax.device_get(jax.block_until_ready(hist))
        t_b = time.time() - t0
        nv = int(hist["_valid"].sum())
        block = {name: v[:nv] for name, v in hist.items()}
        blocks.append((block, t_a, t_b, chunk))

        if verbose and print_row is not None:
            for j in range(nv):
                k = k_next + j
                if k % verbskip == 0:
                    row = {name: v[j] for name, v in block.items()}
                    print_row(k, row, t_a + (t_b - t_a) * j / chunk)

        k_next += nv
        done = bool(jax.device_get(carry["done"]))
        # apply the between-chunks hook BEFORE saving, so a checkpoint
        # always holds exactly the carry the next chunk will consume and
        # resume replays the uninterrupted trajectory bitwise (a save
        # followed by a post-save refresh would skip the refresh on resume)
        if between_chunks is not None and not done and k_next < maxitrs:
            carry = between_chunks(carry, k_next)
            if exec_dev is not None:
                carry = jax.device_put(carry, exec_dev)
        if checkpoint is not None:
            # throttled: every save rewrites the whole accumulated history
            # (np.savez cannot append), so cap the save rate; the final
            # chunk always saves so a completed/exhausted run is on disk
            now = time.time()
            final = done or k_next >= maxitrs
            if (final or last_save is None
                    or now - last_save >= CHECKPOINT_MIN_INTERVAL_S[0]):
                _save_checkpoint(checkpoint, carry, blocks, k_next,
                                 now - t0, fp)
                last_save = now
        if done:
            break

    # concatenate + truncate with the reference's inclusive-stop semantics
    full = {
        name: np.concatenate([b[0][name] for b in blocks])
        for name in blocks[0][0].keys()
    }
    full.pop("_valid", None)
    n = min(len(next(iter(full.values()))), maxitrs - k_start)
    out = {name: v[:n] for name, v in full.items()}
    out.pop("_stop", None)

    # wall-time interpolation at chunk granularity: each block's rows spread
    # linearly over its measured [t_a, t_b] window (frozen tail iterations
    # still execute on device, so the denominator is rows LAUNCHED)
    T = np.zeros(n)
    pos = 0
    for block, t_a, t_b, launched in blocks:
        nb = min(len(next(iter(block.values()))), n - pos)
        if nb <= 0:
            break
        T[pos:pos + nb] = t_a + (t_b - t_a) * np.arange(nb) / max(launched, 1)
        pos += nb
    out["T"] = T
    return carry, out, T


def scan_full(step, carry, num_iters: int):
    """Fully-jitted alternative: run ``num_iters`` iterations as ONE scan.

    No host loop, no early exit — the form used by benchmarks, multi-chip
    dryruns and anything that wants a single XLA computation.
    """
    carry = jax.tree_util.tree_map(jnp.asarray, carry)
    wrapped = _wrap_step(step)

    def run(c):
        return lax.scan(wrapped, c, jnp.arange(num_iters, dtype=jnp.int32))

    return jax.jit(run)(carry)
