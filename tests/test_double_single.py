"""Double-single (two-float32) arithmetic vs float64 ground truth.

The DS representation carries ~49 significand bits; all ops should be
accurate to ~1e-13 relative against f64 on the same inputs."""

import numpy as np
import pytest

import jax.numpy as jnp

from accbpg_and_fw_tpu.ops import double_single as ds

REL = 5e-13


def _vals(rng, n=4096, scale=1.0):
    # mixed magnitudes to exercise renormalization
    m = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    return (m * scale).astype(np.float64)


@pytest.fixture
def ab(rng):
    return _vals(rng), _vals(rng)


def test_from_to_roundtrip(rng):
    a = _vals(rng)
    x = ds.from_f64(jnp.asarray(a))
    back = np.asarray(ds.to_f64(x))
    np.testing.assert_allclose(back, a, rtol=2e-15)


def test_two_sum_exact(rng):
    a = np.float32(_vals(rng))
    b = np.float32(_vals(rng))
    s, e = ds.two_sum(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) + b.astype(np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_two_prod_exact(rng):
    a = np.float32(_vals(rng))
    b = np.float32(_vals(rng))
    p, e = ds.two_prod(jnp.asarray(a), jnp.asarray(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("op,ref", [
    (ds.add, np.add),
    (ds.sub, np.subtract),
    (ds.mul, np.multiply),
    (ds.div, np.divide),
])
def test_binary_ops(ab, op, ref):
    a, b = ab
    x, y = ds.from_f64(jnp.asarray(a)), ds.from_f64(jnp.asarray(b))
    out = np.asarray(ds.to_f64(op(x, y)))
    want = ref(np.asarray(ds.to_f64(x)), np.asarray(ds.to_f64(y)))
    np.testing.assert_allclose(out, want, rtol=REL)


def test_mixed_f32_ops(ab):
    a, b = ab
    b32 = np.float32(b)
    x = ds.from_f64(jnp.asarray(a))
    out = np.asarray(ds.to_f64(ds.add_f32(x, jnp.asarray(b32))))
    want = np.asarray(ds.to_f64(x)) + b32.astype(np.float64)
    np.testing.assert_allclose(out, want, rtol=REL)
    out = np.asarray(ds.to_f64(ds.mul_f32(x, jnp.asarray(b32))))
    want = np.asarray(ds.to_f64(x)) * b32.astype(np.float64)
    np.testing.assert_allclose(out, want, rtol=REL)


def test_sq(rng):
    a = _vals(rng)
    x = ds.from_f64(jnp.asarray(a))
    out = np.asarray(ds.to_f64(ds.sq(x)))
    want = np.asarray(ds.to_f64(x)) ** 2
    np.testing.assert_allclose(out, want, rtol=REL)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 1000])
def test_sum_along(rng, n):
    a = _vals(rng, n=n, scale=1.0)
    x = ds.from_f64(jnp.asarray(a))
    out = np.asarray(ds.to_f64(ds.sum_along(x, axis=0)))
    want = np.sum(np.asarray(ds.to_f64(x)))
    # cancellation can blow up RELATIVE error of any sum; compare absolutely
    # against the max-magnitude scale
    tol = REL * max(1.0, np.abs(a).max()) * np.log2(n + 1)
    assert abs(out - want) <= tol


def test_compare_and_where(rng):
    a, b = _vals(rng, 256), _vals(rng, 256)
    x, y = ds.from_f64(jnp.asarray(a)), ds.from_f64(jnp.asarray(b))
    got = np.asarray(ds.lt(x, y))
    want = np.asarray(ds.to_f64(x)) < np.asarray(ds.to_f64(y))
    np.testing.assert_array_equal(got, want)
    w = ds.where(jnp.asarray(got), x, y)
    np.testing.assert_array_equal(
        np.asarray(ds.to_f64(w)), np.minimum(*map(lambda t: np.asarray(ds.to_f64(t)), (x, y))))


def test_lt_resolves_below_f32_ulp(rng):
    """Near-ties that f32 cannot represent must still order correctly —
    this is what lets the D-opt argmax pick the right column near
    convergence (w entries cluster within ~1e-7 of each other)."""
    base = np.float64(30.0)
    a = base + 1e-12
    b = base + 3e-12
    x = ds.from_f64(jnp.asarray([a]))
    y = ds.from_f64(jnp.asarray([b]))
    assert bool(ds.lt(x, y)[0])
    assert not bool(ds.lt(y, x)[0])


def test_iterated_rank1_style_update(rng):
    """Accumulate 10k dependent mul/add/div updates (the shape of the D-opt
    w-update recurrence) and stay within ~1e-11 of f64."""
    n = 512
    # bounded magnitudes: the recurrence must stay well-conditioned so the
    # comparison measures DS accuracy, not cancellation amplification
    w64 = rng.uniform(1.0, 2.0, n).astype(np.float64)
    u64 = rng.uniform(-1.0, 1.0, n).astype(np.float64)
    w = ds.from_f64(jnp.asarray(w64))
    u = ds.from_f64(jnp.asarray(u64))
    # constants f32-rounded on BOTH sides: the comparison measures DS
    # arithmetic error, not the representation difference of the constants
    t = np.float32(0.001)
    omt = np.float32(1.0 - 0.001)
    decay = np.float32(0.999)
    for _ in range(200):
        # w = (w - t*u^2) / (1 - t) ; u = u * decay
        w = ds.div(ds.sub(w, ds.mul_f32(ds.sq(u), t)),
                   ds.from_f32(jnp.float32(omt)))
        u = ds.mul_f32(u, decay)
        w64 = (w64 - np.float64(t) * u64 ** 2) / np.float64(omt)
        u64 = u64 * np.float64(decay)
    np.testing.assert_allclose(np.asarray(ds.to_f64(w)), w64, rtol=1e-12)


def test_runtime_args_stay_exact():
    """DS ops on values passed as jit ARGUMENTS must be exact.  (The
    constant path is a documented hazard: XLA's folder nullifies EFT error
    terms on fully-constant subgraphs — see the module docstring.)"""
    import jax

    ah, al = np.float32(14.008059), np.float32(-2.2e-07)
    bh, bl = np.float32(0.08333334), np.float32(-2.4835269e-09)
    want = (float(ah) + float(al)) * (float(bh) + float(bl))
    f = jax.jit(lambda a0, a1, b0, b1: ds.mul((a0, a1), (b0, b1)))
    out = f(ah, al, bh, bl)
    got = float(np.asarray(out[0], np.float64) + np.asarray(out[1], np.float64))
    assert abs(got - want) < 1e-15


def test_add_sloppy_reduction_accuracy(rng):
    """Sloppy add in a reduction tree: ~1e-13 relative on random sums."""
    a = rng.standard_normal(1024).astype(np.float64)
    x = ds.from_f64(jnp.asarray(a))
    hi, lo = x
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        s = ds.add_sloppy((hi[:h], lo[:h]), (hi[h:], lo[h:]))
        hi, lo = s
    got = float(hi[0]) + float(lo[0])
    assert abs(got - a.sum()) <= 1e-12 * max(1.0, np.abs(a).sum())


def test_contract_matches_f64(rng):
    """Hoisted-split DS contraction vs f64 ground truth, both axes."""
    m, n = 37, 211  # odd sizes exercise the remainder path of sum_along
    a64 = rng.standard_normal(m) * np.exp(rng.standard_normal(m))
    B64 = rng.standard_normal((m, n)) * np.exp(rng.standard_normal((m, n)))
    a = ds.from_f64(jnp.asarray(a64))
    B = ds.from_f64(jnp.asarray(B64))
    u = np.asarray(ds.to_f64(ds.contract(a, B, 0)))
    want = a64 @ B64
    np.testing.assert_allclose(u, want, rtol=0, atol=5e-13 * np.abs(want).max())

    C64 = B64.T.copy()
    C = ds.from_f64(jnp.asarray(C64))
    v = np.asarray(ds.to_f64(ds.contract(a, C, 1)))
    np.testing.assert_allclose(v, C64 @ a64, rtol=0,
                               atol=5e-13 * np.abs(want).max())


def test_outer_matches_f64(rng):
    c64 = rng.standard_normal(33) * np.exp(rng.standard_normal(33))
    r64 = rng.standard_normal(65) * np.exp(rng.standard_normal(65))
    O = np.asarray(ds.to_f64(ds.outer(ds.from_f64(jnp.asarray(c64)),
                                      ds.from_f64(jnp.asarray(r64)))))
    want = np.outer(c64, r64)
    np.testing.assert_allclose(O, want, rtol=3e-14)


def test_sum_many_matches_individual_folds():
    """sum_many folds k stacked vectors exactly like k separate sum_along
    calls (same pairwise halving per row)."""
    import numpy as np

    from accbpg_and_fw_tpu.ops import double_single as ds

    rng = np.random.default_rng(3)
    vs = [ds.from_f64(rng.standard_normal(317) * 10.0 ** rng.integers(-3, 3))
          for _ in range(3)]
    got = ds.sum_many(vs)  # sloppy folds (the hot-path default)
    for v, g in zip(vs, got):
        ref = ds.sum_along(v, 0, sloppy=True)
        assert float(g[0]) == float(ref[0])
        assert float(g[1]) == float(ref[1])


def test_min_along_ds_order():
    import numpy as np

    from accbpg_and_fw_tpu.ops import double_single as ds

    rng = np.random.default_rng(4)
    a = rng.standard_normal(55)
    m = ds.min_along(ds.from_f64(a), 0)
    ref = a.min()
    assert abs((float(m[0]) + float(m[1])) - ref) < 1e-13


def _dopt_problem(m=20, n=300, seed=10):
    np.random.seed(seed)
    V = np.random.randn(m, n)
    return V, np.full(n, 1.0 / n)


class TestDoubleSingleScanEngine:
    """u_mode='ds' / precision='ds': double-single XLA scan path — f64
    accuracy from pure f32 (no jax_enable_x64 dependence, vmappable)."""

    def test_single_matches_f64_scan(self):
        import accbpg_and_fw_tpu as acc

        V, x0 = _dopt_problem(m=20, n=300, seed=10)
        r64 = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=3000,
                                verbose=False, chunk=500)
        rds = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=3000,
                                verbose=False, chunk=500, u_mode="ds")
        assert len(rds[1]) == len(r64[1])
        np.testing.assert_allclose(rds[0], np.asarray(r64[0], np.float64),
                                   atol=1e-12)
        assert abs(rds[2][-1] - float(r64[2][-1])) < 1e-11

    def test_plain_fw_ds(self):
        import accbpg_and_fw_tpu as acc

        V, x0 = _dopt_problem(m=15, n=200, seed=7)
        r64 = acc.D_opt_FW(V, x0, eps=1e-4, maxitrs=2000, verbose=False,
                           chunk=500)
        rds = acc.D_opt_FW(V, x0, eps=1e-4, maxitrs=2000, verbose=False,
                           chunk=500, u_mode="ds")
        assert len(rds[1]) == len(r64[1])
        # plain FW at loose eps amplifies the 1e-14 path difference
        # chaotically; same stopping iteration + 1e-7 iterates is the
        # meaningful equivalence here
        np.testing.assert_allclose(rds[0], np.asarray(r64[0], np.float64),
                                   atol=1e-6)
        assert abs(rds[2][-1] - float(r64[2][-1])) < 1e-6

    def test_batch_ds_reaches_target_and_certifies(self):
        """Batched DS sweeps: every instance reaches the slack target and a
        FRESH f64 factorization certifies the final iterate.

        Backend caveat: on an H100 the K=32 batch of 30x1000 certifies
        1e-8 (chip_smoke.py sweep phase).  Under XLA:CPU the K>=2 vmapped
        lowering rounds the DS chains differently and the incremental
        state drifts to ~1e-6 fresh slack, so this CPU test asserts the
        honest CPU bar."""
        from accbpg_and_fw_tpu.diagnostics import dopt_certificate
        from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

        rng = np.random.default_rng(3)
        K, m, n = 3, 30, 300
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)
        eps, bar = 1e-7, 1e-5
        xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=eps, num_iters=6000,
                                         precision="ds")
        for kk in range(K):
            ok = (np.asarray(SPb[kk]) <= eps) & (np.asarray(SNb[kk]) <= eps)
            assert ok.any(), f"instance {kk} did not reach {eps}"
            xs = xb[kk] / xb[kk].sum()
            w = dopt_certificate(Vs[kk], xs)["w"]
            assert w.max() / m - 1 <= bar
            assert 1 - w[xs > 1e-8].min() / m <= bar
