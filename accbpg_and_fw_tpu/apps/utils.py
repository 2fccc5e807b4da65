"""Data loading, sampling and metric utilities.

JAX equivalents of the reference's accbpg/utils.py.  Problem-instance
generation keeps the reference's numpy-RNG call sequences where seeded
reproducibility against its stored traces matters (``randseed`` kwargs), and
offers PRNG-keyed JAX variants for on-device generation.
"""

from __future__ import annotations

import os.path

import numpy as np

import jax
import jax.numpy as jnp

try:
    import scipy.sparse as sparse
except ImportError:  # pragma: no cover
    sparse = None


def _open_maybe_compressed(filename):
    _, ext = os.path.splitext(filename)
    if ext == ".gz":
        import gzip

        return gzip.open(filename, "rt")
    if ext == ".bz2":
        import bz2

        return bz2.open(filename, "rt")
    return open(filename, "r")


def _load_libsvm_native(filename):
    """mmap + C++ single-pass parse (native/libsvm_parser.cpp); returns
    (data, indices, indptr, labels) numpy arrays or None if unavailable."""
    import ctypes

    from ..native import load_native_library

    lib = load_native_library("libsvm_parser")
    if lib is None:
        return None
    lib.libsvm_parse.restype = ctypes.c_void_p
    lib.libsvm_parse.argtypes = [ctypes.c_char_p]
    lib.libsvm_last_error.restype = ctypes.c_char_p
    lib.libsvm_nnz.restype = ctypes.c_int64
    lib.libsvm_nnz.argtypes = [ctypes.c_void_p]
    lib.libsvm_rows.restype = ctypes.c_int64
    lib.libsvm_rows.argtypes = [ctypes.c_void_p]
    lib.libsvm_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.libsvm_free.argtypes = [ctypes.c_void_p]

    handle = lib.libsvm_parse(os.fsencode(filename))
    if not handle:
        err = lib.libsvm_last_error().decode()
        if "sorted and unique" in err or "Invalid" in err:
            raise ValueError(err)
        return None  # e.g. cannot open -> let the python path raise cleanly
    try:
        nnz = lib.libsvm_nnz(handle)
        rows = lib.libsvm_rows(handle)
        data = np.empty(nnz, np.float64)
        indices = np.empty(nnz, np.int64)
        indptr = np.empty(rows + 1, np.int64)
        labels = np.empty(rows, np.float64)
        lib.libsvm_fill(handle,
                        data.ctypes.data_as(ctypes.c_void_p),
                        indices.ctypes.data_as(ctypes.c_void_p),
                        indptr.ctypes.data_as(ctypes.c_void_p),
                        labels.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.libsvm_free(handle)
    return data, indices, indptr, labels


def load_libsvm_file(filename, dtype=np.float64, n_features=None,
                     zero_based="auto"):
    """Parse an svmlight/LIBSVM file into (CSR matrix, labels)
    (reference: utils.py:22-95).

    Plain (uncompressed) files go through the mmapped C++ parser
    (native/libsvm_parser.cpp); compressed files and compiler-less hosts
    fall back to the single-pass Python parse.  Comments (``#``) stripped,
    indices validated as sorted per row.
    """
    _, ext = os.path.splitext(filename)
    if ext not in (".gz", ".bz2"):
        native = _load_libsvm_native(filename)
        if native is not None:
            data, indices, indptr, labels = native
            if zero_based is False and indices.size and indices.min() == 0:
                raise ValueError("Invalid index 0 in LibSVM data file.")
            if zero_based is False or (
                    zero_based == "auto" and indices.size and indices.min() > 0):
                indices = indices - 1
            nf = int(indices.max()) + 1 if indices.size else 0
            if n_features is None:
                n_features = nf
            elif n_features < nf:
                n_features = nf
                print("Warning: n_features increased to match data.")
            X = sparse.csr_matrix(
                (data.astype(dtype, copy=False), indices, indptr),
                shape=(len(labels), n_features))
            X.sort_indices()
            return X, labels

    labels, data, indices, indptr = [], [], [], [0]

    with _open_maybe_compressed(filename) as fh:
        for line in fh:
            hash_pos = line.find("#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            prev = -1
            for tok in parts[1:]:
                idx_s, val_s = tok.split(":", 1)
                idx = int(idx_s)
                if idx < 0 or (zero_based is False and idx == 0):
                    raise ValueError(f"Invalid index {idx} in LibSVM data file.")
                if idx <= prev:
                    raise ValueError(
                        "Feature indices in LibSVM data file should be sorted and unique."
                    )
                indices.append(idx)
                data.append(dtype(val_s))
                prev = idx
            indptr.append(len(data))

    data = np.asarray(data, dtype=dtype)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)

    if zero_based is False or (zero_based == "auto" and indices.min() > 0):
        indices = indices - 1
    nf = int(indices.max()) + 1
    if n_features is None:
        n_features = nf
    elif n_features < nf:
        n_features = nf
        print("Warning: n_features increased to match data.")

    X = sparse.csr_matrix((data, indices, indptr),
                          shape=(len(labels), n_features))
    X.sort_indices()
    return X, np.asarray(labels)


def shuffle_data(X, y):
    """Shuffle rows of X and y together (reference: utils.py:98-107)."""
    index = np.arange(len(y))
    np.random.shuffle(index)
    return X[index, :], y[index]


def mnist_2digits(X, y, d1, d2):
    """Binary +-1 subproblem of two digit classes (reference: utils.py:110-120)."""
    idx1 = np.nonzero(y == d1)
    idx2 = np.nonzero(y == d2)
    yy = y.copy()
    yy[idx1] = 1
    yy[idx2] = -1
    index = np.concatenate((idx1[0], idx2[0]))
    np.random.shuffle(index)
    return X[index, :], yy[index]


def binary_error_rate(X, y, w, bias=0):
    """Classification error of sign(Xw + bias) (reference: utils.py:123-129)."""
    if sparse is not None and sparse.issparse(X):
        yp = np.sign(X @ w + bias)
    else:
        yp = np.sign(np.asarray(X) @ np.asarray(w) + bias)
    return (1 - np.dot(yp, y) / len(y)) / 2


def rmse(X, y, w, bias=0):
    """Root-mean-square prediction error (reference: utils.py:132-139)."""
    if sparse is not None and sparse.issparse(X):
        yp = X @ w + bias
    else:
        yp = np.asarray(X) @ np.asarray(w) + bias
    return np.sqrt(np.mean((yp - y) ** 2))


def row_norm_squared(X):
    """Squared 2-norm of every row of a CSR matrix (reference: utils.py:142-145)."""
    X2 = sparse.csr_matrix((X.data**2, X.indices, X.indptr), X.shape)
    return np.squeeze(np.asarray(X2.sum(1)))


def load_sido(filename):
    """Load the sido0 npz-packed CSR dataset (reference: utils.py:148-158)."""
    with np.load(filename) as D:
        X = sparse.csr_matrix((D["Xdata"], D["Xindices"], D["Xindptr"]),
                              D["shape"])
        y = D["y"]
    return X, y


def generate_dataset_for_svm(m, n):
    """Random normal dataset with sign-balance labels
    (reference: utils.py:161-192)."""
    rng = np.random.default_rng()
    data = rng.standard_normal((m, n)) * 100
    labels = np.where((data > 0).sum(axis=1) < n * 0.53, 1, -1)
    return data, labels


def random_point_in_l2_ball(center, radius, spread_btm=0.1, spread_up=0.99,
                            pos_dir=False):
    """Uniform direction, uniform radius in [r*btm, r*up]
    (reference: utils.py:195-212)."""
    direction = np.random.randn(len(center))
    direction /= np.linalg.norm(direction)
    if pos_dir:
        direction = np.abs(direction)
    r = np.random.uniform(radius * spread_btm, radius * spread_up)
    point = center + r * direction
    assert np.linalg.norm(point - center) - radius <= 1e-15
    return point


def random_point_in_l2_ball_jax_version(center, radius, spread_btm=0.1,
                                        spread_up=0.99, pos_dir=False,
                                        key=None):
    """PRNG-keyed version of random_point_in_l2_ball
    (reference: utils.py:214-249)."""
    assert key is not None, "You must pass a JAX PRNG key"
    key_dir, key_radius = jax.random.split(key)
    direction = jax.random.normal(key_dir, shape=center.shape)
    direction = direction / jnp.linalg.norm(direction)
    if pos_dir:
        direction = jnp.abs(direction)
    r = jax.random.uniform(key_radius, minval=radius * spread_btm,
                           maxval=radius * spread_up)
    return center + r * direction


def random_point_on_simplex(n, radius=1, center=False):
    """Uniform-gap point on the radius-simplex (reference: utils.py:252-268)."""
    if center:
        return np.ones(n) / n
    cuts = np.sort(np.random.uniform(0.01, radius, size=n - 1))
    cuts = np.concatenate([[0.0], cuts, [radius]])
    return np.diff(cuts)


def edge_point_on_simplex(edge_index, n, radius=1, tol=1e-5):
    """Near-vertex point on the simplex (reference: utils.py:271-275)."""
    x = np.full(n, tol)
    x[edge_index] = radius - tol * (n - 1)
    return x


def get_random_float(var=1):
    """Uniform draw in (0, var]; 0 when var == 0 (reference: utils.py:278-285)."""
    if var == 0:
        return 0
    assert var > 0, "The range must be positive."
    return var * np.random.random_sample()


def get_random_vector(size, range=1):  # noqa: A002 - reference kwarg name
    """Uniform vector in (0, range]^size (reference: utils.py:288-295)."""
    if range == 0:
        return np.zeros(size)
    assert range > 0, "The range must be positive."
    return range * np.random.random_sample(size=size)
