"""Mesh construction and problem sharding.

The reference is single-process NumPy (SURVEY.md §2.6); this module is the
distributed layer.  Sharding layout for every problem family:

* D-optimal design: H is m-by-n with n >> m.  H shards column-wise
  P(None, 'data'); the iterate x, the negative-gradient w and every other
  length-n vector shard P('data'); the Gram matrix H diag(x) H^T (m-by-m),
  its Cholesky/inverse and all scalars replicate.  The per-step collectives
  are then: one psum for the Gram accumulation (inserted by XLA inside the
  (H*x) @ H.T contraction), scalar psums inside the simplex-Newton
  multiplier solve, and a global arg-reduction for LMO / FW vertex picks.
* Regressions (Poisson/KL/logistic/SVM): A is m-by-n with m samples.  For
  sample-parallel scaling A shards row-wise P('data', None), b/y shard
  P('data'), and x replicates — gradients A^T r psum over the sample axis.

Because every algorithm step in this framework is pure jnp on pytree
oracles, the SAME step functions run sharded: placing the arrays with these
shardings and jitting is all that is needed (GSPMD propagates the rest).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..struct import replace


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize the multi-process JAX runtime: the GPUs of one host are
    joined all to all by NVLink and NCCL carries the collectives, hosts
    talk over the network.  No-op when running single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def data_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """A 1-D mesh over all (or the given) devices with one named axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _pad_cols(H, x0, ndev):
    """Zero-pad design columns (and x entries) to a device-count multiple.

    Exactness: a zero column v = 0 with weight x = 0 contributes nothing to
    V diag(x) V^T, has gradient/w entry exactly 0, is never selected by the
    FW argmax (max w >= m >= 1 > 0) nor by the away argmin (masked on
    x > 1e-8), and x = 0 is a fixed point of every update (x * (1 -+ t)
    keeps 0; the Burg div_prox_map maps y = 0 to g + L/0 = inf and
    1/(inf + c) = 0).  So the padded problem's trajectory restricted to the
    first n coordinates IS the unpadded trajectory."""
    n = H.shape[1]
    rem = (-n) % ndev
    if rem:
        H = jnp.pad(jnp.asarray(H), ((0, 0), (0, rem)))
        x0 = jnp.pad(jnp.asarray(x0), (0, rem))
    return H, x0


# every column-indexed field a D-opt oracle may carry, with its sharding
# spec builder: (field name, partition spec over (leading dims..., n))
_DOPT_COL_FIELDS = (
    ("H", ("*", "data")),          # DOptimalObj / DOptimalObjMixed
    ("Vds_hi", ("*", "data")),     # DOptimalObjMixed DS planes
    ("Vds_lo", ("*", "data")),
    ("Vh", ("*", "data")),         # DOptimalObjDS DS planes
    ("Vl", ("*", "data")),
    ("Vd_rows", ("*", "*", "data")),   # (levels, m, n) int8 Gram planes
    ("V_packed", ("*", "data")),   # (m, levels*n) packed MV planes
    ("sV_cols", ("data",)),        # per-column scales
)


def shard_dopt_problem(f, x0, mesh: Mesh, axis_name: str = "data",
                       pad: bool = True):
    """Place a D-opt problem on a mesh: every column-indexed oracle field
    (the design columns AND, for the Mixed/DS oracles, their digit/DS
    planes and per-column scales) shards over ``axis_name``; returns
    ``(f_sharded, x0_sharded)``.  Works for ``DOptimalObj``,
    ``DOptimalObjMixed`` and ``DOptimalObjDS`` (round 5 — previously only
    the f64 ``H`` leaf was device_put, leaving the Mixed oracle's
    dominant digit-plane memory and contractions unsharded).

    When n is not a multiple of the mesh size and ``pad=True`` (default),
    the design is zero-padded to the next multiple — exactly neutral for
    the D-opt solvers (see ``_pad_cols``); returned arrays have the padded
    length and the padding x entries stay identically 0 (slice them off
    with ``x[:n]``).  The zero-pad argument alone does NOT extend to
    ``h.prox_map`` used directly on arbitrary g (ABDA's dual averaging),
    so the returned oracle carries ``n_valid``: padded gradient entries
    report +1e30, which every prox maps to ~0 mass (DOptimalObj
    docstring) — ABDA on a padded mesh then matches the unpadded problem
    (tests/test_parallel.py::test_abda_padded_mesh).  Padding is
    supported only for the plain ``DOptimalObj`` (the Mixed/DS digit
    planes would need re-splitting): oracles without an ``n_valid`` field
    get a clear error when padding would be required.
    """
    ndev = int(mesh.shape[axis_name])
    design = getattr(f, "H", None)
    if design is None:
        design = getattr(f, "Vh", None)  # DOptimalObjDS carries no f64 H
    if design is None:
        raise TypeError(
            f"{type(f).__name__} carries neither an H nor a Vh design "
            "field; shard_dopt_problem supports DOptimalObj, "
            "DOptimalObjMixed and DOptimalObjDS.")
    x0 = jnp.asarray(x0)
    n = design.shape[-1]
    vec_sharding = NamedSharding(mesh, P(axis_name))
    needs_pad = pad and (n % ndev != 0)
    if needs_pad:
        if not hasattr(f, "n_valid"):
            raise ValueError(
                f"{type(f).__name__} has no n_valid field, so it cannot "
                f"be padded from n={n} to a multiple of {ndev} safely "
                "(ABDA-style prox on duals would hand padded coordinates "
                "mass, and Mixed/DS digit planes would need re-splitting)."
                " Pass pad=False with a mesh-divisible n, or use "
                "DOptimalObj.")
        H, x0 = _pad_cols(jnp.asarray(f.H), x0, ndev)
        H = jax.device_put(H, NamedSharding(mesh, P(None, axis_name)))
        x0 = jax.device_put(x0, vec_sharding)
        return replace(f, H=H, n_valid=n), x0

    def spec(dims):
        return NamedSharding(mesh, P(*(None if d == "*" else axis_name
                                       for d in dims)))

    updates = {}
    for name, dims in _DOPT_COL_FIELDS:
        v = getattr(f, name, None)
        if v is not None:
            updates[name] = jax.device_put(jnp.asarray(v), spec(dims))
    x0 = jax.device_put(x0, vec_sharding)
    return replace(f, **updates), x0


def shard_dopt_design(V, x0, mesh: Mesh, axis_name: str = "data",
                      pad: bool = True):
    """Column-shard a raw design matrix + initial point for the
    ``D_opt_FW`` / ``D_opt_FW_away`` solvers, zero-padding n to a mesh-size
    multiple (exactly neutral; see ``_pad_cols``).  Returns
    ``(V_sharded, x0_sharded)``."""
    ndev = int(mesh.shape[axis_name])
    V, x0 = jnp.asarray(V), jnp.asarray(x0)
    if pad:
        V, x0 = _pad_cols(V, x0, ndev)
    V = jax.device_put(V, NamedSharding(mesh, P(None, axis_name)))
    x0 = jax.device_put(x0, NamedSharding(mesh, P(axis_name)))
    return V, x0


def shard_symnmf_problem(f, X0, mesh: Mesh, axis_name: str = "data"):
    """Place a SymNMF problem (FrobeniusSymLoss) on a mesh: the n x n
    similarity matrix M and the n x r factor X both shard row-wise over
    ``axis_name`` (M is the memory wall — n^2 entries; the factor is tiny).

    Per-step collectives under GSPMD: one all-gather of X (n*r values)
    feeding the row-local M @ X contraction, one psum for the r x r
    X^T X, and scalar psums for the kernel norms — all O(n*r + r^2)
    on the wire per iteration, never O(n^2)."""
    row_sharding = NamedSharding(mesh, P(axis_name, None))
    f = replace(f, M=jax.device_put(jnp.asarray(f.M), row_sharding))
    X0 = jax.device_put(jnp.asarray(X0), row_sharding)
    return f, X0


def shard_regression_problem(f, x0, mesh: Mesh, axis_name: str = "data"):
    """Place a row-major regression oracle (PoissonRegression, KLdivRegression,
    LogisticRegression, SVM_fun — fields A-or-X and b-or-y) on a mesh:
    samples shard over ``axis_name``, the iterate replicates."""
    row_sharding = NamedSharding(mesh, P(axis_name, None))
    vec_sharding = NamedSharding(mesh, P(axis_name))
    rep_sharding = NamedSharding(mesh, P())

    updates = {}
    for mat_field in ("A", "X"):
        if hasattr(f, mat_field) and getattr(f, mat_field) is not None:
            updates[mat_field] = jax.device_put(getattr(f, mat_field), row_sharding)
    for vec_field in ("b", "y"):
        if hasattr(f, vec_field) and getattr(f, vec_field) is not None:
            updates[vec_field] = jax.device_put(getattr(f, vec_field), vec_sharding)
    x0 = jax.device_put(x0, rep_sharding)
    return replace(f, **updates), x0
