"""Double-single fast-gram engine (fast_gram="ds"): components + trajectory.

The DS engine must deliver f64-GRADE answers from pure f32/int8 ops.  On
the CPU test backend the EFT primitives are f64-backed (the XLA:CPU
miscompile escape hatch, ops/double_single.py) — bit-identical primitive
semantics to the true-f32 EFT path, so these trajectory comparisons are
meaningful for both backends; the GPU's true-f32 path is checked on the
card (tests/test_chip.py, chip_smoke.py engines phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.algorithms import fastgram as fg
from accbpg_and_fw_tpu.algorithms.theta import solve_theta, solve_theta_ds
from accbpg_and_fw_tpu.ops import double_single as ds
from accbpg_and_fw_tpu.ops import ds_linalg as dl


def tof64(t):
    return np.asarray(t[0], np.float64) + np.asarray(t[1], np.float64)


@pytest.fixture(scope="module")
def problem():
    f, h, L, x0 = acc.D_opt_design(30, 150, randseed=10)
    H64 = np.asarray(f.H, np.float64)
    fds = acc.DOptimalObjDS.from_design(H64)
    f64o = acc.DOptimalObj(H=jnp.asarray(H64))
    x064 = np.full(150, 1.0 / 150.0)
    return f64o, fds, h, L, x064, H64


class TestDSTranscendentals:
    def test_exp_log_sqrt(self, rng):
        x64 = rng.uniform(0.01, 50.0, 512)
        x = ds.from_f64(x64)
        lg = jax.jit(lambda a, b: ds.log((a, b)))(*x)
        assert np.max(np.abs(tof64(lg) - np.log(x64))) < 1e-12
        sq = jax.jit(lambda a, b: ds.sqrt((a, b)))(*x)
        assert np.max(np.abs(tof64(sq) - np.sqrt(x64))
                      / np.sqrt(x64)) < 1e-13
        e = jax.jit(lambda a, b: ds.exp(ds.mul_f32((a, b),
                                                   jnp.float32(0.02))))(*x)
        ref = np.exp(x64 * np.float64(np.float32(0.02)))
        assert np.max(np.abs(tof64(e) - ref) / ref) < 1e-13

    def test_half_sq_log_term(self, rng):
        d64 = np.concatenate([rng.uniform(-0.049, 0.049, 256),
                              rng.uniform(-0.5, 3.0, 256)])
        d = ds.from_f64(d64)
        t = jax.jit(ds.half_sq_log_term)(d)
        ref = d64 - np.log1p(d64)
        assert np.max(np.abs(tof64(t) - ref)) < 1e-13

    def test_solve_theta_matches_f64(self):
        for th, gain in ((0.9, 1.0), (0.31, 0.83), (0.05, 1.2),
                         (0.004, 0.97)):
            ref = float(solve_theta(jnp.float64(th), jnp.float64(2.0),
                                    jnp.float64(gain)))
            got = tof64(jax.jit(solve_theta_ds)(
                ds.from_f64(th), ds.from_f64(2.0), ds.from_f64(gain)))
            # both solvers stop at the first Newton iterate past the
            # |phi| <= 1e-6*theta exit, not at the exact root; the stopped
            # iterates agree to ~1e-9 relative (tiny theta: the last
            # Newton step is where arithmetic differences surface)
            assert abs(float(got) - ref) < max(1e-11, 3e-9 * ref)


class TestDSLinalg:
    def test_mm_cholesky_logdet_schulz(self, rng):
        m = 24
        A = rng.standard_normal((m, 100))
        G = A @ A.T / 100
        Gds = ds.from_f64(G)
        B = rng.standard_normal((m, m))
        P = jax.jit(dl.mm)(Gds, ds.from_f64(B))
        assert np.max(np.abs(tof64(P) - G @ B)) < 1e-12 * np.max(np.abs(G @ B))
        R = jax.jit(dl.cholesky)(Gds)
        R64 = tof64(R)
        assert np.max(np.abs(R64 @ R64.T - G)) < 1e-12
        ld = jax.jit(dl.logdet_chol)(R)
        assert abs(float(tof64(ld)) - np.linalg.slogdet(G)[1]) < 1e-11
        M32 = jnp.asarray((np.linalg.inv(G) * (1 + 1e-5)).astype(np.float32))
        Mds = jax.jit(dl.schulz_step_ds)(M32, Gds)
        Mds = jax.jit(lambda M, G: dl.schulz_step_ds(M, G))(Mds, Gds)
        assert np.max(np.abs(np.eye(m) - tof64(Mds) @ G)) < 1e-12


class TestDSOracle:
    def test_gram_logdet_grad(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        x_ds = ds.from_f64(x064)
        G = jax.jit(fds.gram_ds)(x_ds)
        Gref = (H64 * x064) @ H64.T
        assert (np.max(np.abs(tof64(G) - Gref))
                < 1e-12 * np.max(np.abs(Gref)))
        ld = jax.jit(fds.logdet_full_ds)(G)
        assert abs(float(tof64(ld))
                   - np.linalg.slogdet(Gref)[1]) < 1e-11
        M32 = jax.jit(fds.inv_seed32)(G)
        _, Mds = jax.jit(lambda G, M: fg.inv_pair_ds(fds, G, M))(G, M32)
        assert np.max(np.abs(np.eye(30) - tof64(Mds) @ Gref)) < 1e-10
        g = jax.jit(fds.grad_from_inv_ds)(Mds)
        gref = -np.einsum("ij,ij->j", H64, np.linalg.solve(Gref, H64))
        assert np.max(np.abs(tof64(g) - gref) / np.abs(gref)) < 1e-10

    def test_ill_conditioned_fallback(self, rng):
        # Gram with cond ~1e7: the f32 residual gate fails and the DS
        # column-Cholesky fallback must deliver the logdet without NaN
        m = 16
        U, _ = np.linalg.qr(rng.standard_normal((m, m)))
        w = np.logspace(0, -7, m)
        G = (U * w) @ U.T
        G = 0.5 * (G + G.T)
        fds = acc.DOptimalObjDS.from_design(rng.standard_normal((m, 50)))
        ld = jax.jit(fds.logdet_full_ds)(ds.from_f64(G))
        ref = np.linalg.slogdet(G)[1]
        assert np.isfinite(tof64(ld))
        assert abs(float(tof64(ld)) - ref) < 1e-6 * abs(ref)


class TestDSProx:
    def test_simplex_prox_matches_f64(self, rng):
        n = 300
        g64 = rng.standard_normal(n) * 3.0
        y64 = rng.uniform(0.001, 0.02, n)
        h = acc.BurgEntropySimplex()
        x_ref = np.asarray(h.div_prox_map(jnp.asarray(y64), jnp.asarray(g64),
                                          jnp.float64(1.7)))
        L_ds = ds.from_f64(1.7)
        cw = ds.from_f32(jnp.asarray(-jnp.inf, jnp.float32))
        x_ds, c = jax.jit(h.div_prox_map_ds_warm)(
            ds.from_f64(y64), ds.from_f64(g64), L_ds, cw)
        got = tof64(x_ds)
        assert abs(got.sum() - 1.0) < 1e-10
        assert np.max(np.abs(got - x_ref) / x_ref) < 1e-9
        # warm restart from the converged multiplier also lands exactly
        x_ds2, _ = jax.jit(h.div_prox_map_ds_warm)(
            ds.from_f64(y64), ds.from_f64(g64), L_ds, c)
        assert np.max(np.abs(tof64(x_ds2) - x_ref) / x_ref) < 1e-9

    def test_divergence_ds(self, rng):
        x64 = rng.uniform(0.001, 0.01, 400)
        y64 = x64 * (1 + rng.uniform(-1e-4, 1e-4, 400))
        h = acc.BurgEntropySimplex()
        got = tof64(jax.jit(h.divergence_ds)(ds.from_f64(x64),
                                             ds.from_f64(y64)))
        r = x64 / y64
        ref = np.sum(r - np.log(r) - 1.0)
        assert abs(float(got) - ref) < 1e-14 + 1e-6 * abs(ref)


class TestDSTrajectory:
    """fast_gram="ds" must TRACK the f64 fast_gram trajectory (the
    VERDICT round-2 item-2 bar: F agreement <= ~1e-9)."""

    def test_bpg_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Lr, _ = acc.BPG(f64o, h, L, jnp.asarray(x064), maxitrs=300,
                                linesearch=True, verbose=False,
                                fast_gram=True)
        xd, Fd, Ld, _ = acc.BPG(fds, h, L, x064, maxitrs=300,
                                linesearch=True, verbose=False,
                                fast_gram="ds")
        assert Fd.dtype == np.float64
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-9
        assert np.max(np.abs(np.asarray(xr) - xd)) < 1e-10

    def test_abpg_gain_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Gr, _, _, _ = acc.ABPG_gain(f64o, h, L, jnp.asarray(x064),
                                            gamma=2, maxitrs=250,
                                            verbose=False, fast_gram=True)
        xd, Fd, Gd, _, _, _ = acc.ABPG_gain(fds, h, L, x064, gamma=2,
                                            maxitrs=250, verbose=False,
                                            fast_gram="ds")
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-8
        assert np.max(np.abs(np.asarray(xr) - xd)) < 1e-9
        # identical gain line-search decisions
        assert np.max(np.abs(np.asarray(Gr) - np.asarray(Gd))) < 1e-5

    def test_abpg_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Gr, _ = acc.ABPG(f64o, h, L, jnp.asarray(x064), gamma=2,
                                 maxitrs=200, verbose=False, fast_gram=True)
        xd, Fd, Gd, _ = acc.ABPG(fds, h, L, x064, gamma=2, maxitrs=200,
                                 verbose=False, fast_gram="ds")
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-8
        assert np.max(np.abs(np.asarray(xr) - xd)) < 1e-9

    def test_abpg_restart_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Gr, _ = acc.ABPG(f64o, h, L, jnp.asarray(x064), gamma=2,
                                 maxitrs=150, restart=True, restart_rule="g",
                                 verbose=False, fast_gram=True)
        xd, Fd, Gd, _ = acc.ABPG(fds, h, L, x064, gamma=2, maxitrs=150,
                                 restart=True, restart_rule="g",
                                 verbose=False, fast_gram="ds")
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-8

    def test_abda_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Gr, _ = acc.ABDA(f64o, h, L, jnp.asarray(x064), gamma=2,
                                 maxitrs=150, verbose=False, fast_gram=True)
        xd, Fd, Gd, _ = acc.ABDA(fds, h, L, x064, gamma=2, maxitrs=150,
                                 verbose=False, fast_gram="ds")
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-8
        assert np.max(np.abs(np.asarray(xr) - xd)) < 1e-9

    def test_abpg_expo_ds_tracks_f64(self, problem):
        f64o, fds, h, L, x064, H64 = problem
        xr, Fr, Gmr, Gr, _ = acc.ABPG_expo(f64o, h, L, jnp.asarray(x064),
                                           gamma0=3.0, maxitrs=150,
                                           verbose=False, fast_gram=True)
        xd, Fd, Gmd, Gd, _ = acc.ABPG_expo(fds, h, L, x064, gamma0=3.0,
                                           maxitrs=150, verbose=False,
                                           fast_gram="ds")
        assert np.max(np.abs(np.asarray(Fr) - Fd)) < 1e-7
        # identical gamma-adaption decisions
        np.testing.assert_allclose(np.asarray(Gmr), np.asarray(Gmd),
                                   atol=1e-9)

    def test_requires_ds_protocol(self, problem):
        f64o, fds, h, L, x064, _ = problem
        with pytest.raises(ValueError, match="fast_gram='ds'"):
            acc.BPG(f64o, h, L, x064, maxitrs=10, fast_gram="ds")


class TestBatchedSeries:
    def test_anchored_pair_matches_separate_calls(self, problem, rng):
        from accbpg_and_fw_tpu.ops import double_single as ds

        f64o, fds, h, L, x064, H64 = problem
        x = ds.from_f64(x064)
        G = jax.jit(fds.gram_ds)(x)
        M32 = jax.jit(fds.inv_seed32)(G)
        _, Mds = jax.jit(lambda G, M: fg.inv_pair_ds(fds, G, M))(G, M32)
        ld0 = jax.jit(fds.logdet_full_ds)(G)
        # nearby Grams (theta-scale perturbations)
        x2 = x064 * (1 + rng.uniform(-2e-3, 2e-3, len(x064)))
        x2 = x2 / x2.sum()
        x3 = x064 * (1 + rng.uniform(-1e-3, 1e-3, len(x064)))
        x3 = x3 / x3.sum()
        Gy = jax.jit(fds.gram_ds)(ds.from_f64(x2))
        Gn = jax.jit(fds.gram_ds)(ds.from_f64(x3))
        ld_y, ld_xn, s_xn = jax.jit(
            lambda G, Gy, Gn, M, ld: fg.anchored_shift_pair_ds(
                fds, ld, M, G, Gy, Gn))(G, Gy, Gn, Mds, ld0)
        ld_y_ref = jax.jit(
            lambda G, Gy, M, ld: fg.anchored_logdet_shift_ds(
                fds, ld, -1.0, M, G, Gy)[0])(G, Gy, Mds, ld0)
        assert abs(tof64(ld_y) - tof64(ld_y_ref)) < 1e-11
        # fresh truth for the target logdet
        Gref = (H64 * x3) @ H64.T
        assert abs(float(tof64(ld_xn))
                   - np.linalg.slogdet(Gref)[1]) < 1e-10


def test_ds_checkpoint_resume_bitwise(tmp_path, problem):
    """The DS engine's flat (hi, lo) carry keys ride the driver's
    checkpoint machinery unchanged: interrupted + resumed == uninterrupted
    BITWISE (the scan engines' resume contract)."""
    f64o, fds, h, L, x064, H64 = problem
    ck = str(tmp_path / "ds.npz")
    xu, Fu, _, _ = acc.BPG(fds, h, L, x064, maxitrs=160, verbose=False,
                           fast_gram="ds", chunk=64)
    acc.BPG(fds, h, L, x064, maxitrs=80, verbose=False, fast_gram="ds",
            chunk=64, checkpoint=ck)
    x2, F2, _, _ = acc.BPG(fds, h, L, x064, maxitrs=160, verbose=False,
                           fast_gram="ds", chunk=64, checkpoint=ck)
    np.testing.assert_array_equal(np.asarray(Fu), np.asarray(F2))
    np.testing.assert_array_equal(np.asarray(xu), np.asarray(x2))


def test_ds_drivers_verbose_paths(problem, capsys):
    """The DS drivers' progress tables (print_row over the DS history
    keys) must render — exercised nowhere else (benchmarks run silent)."""
    f64o, fds, h, L, x064, H64 = problem
    acc.BPG(fds, h, L, x064, maxitrs=8, verbose=True, verbskip=4,
            fast_gram="ds")
    acc.ABPG(fds, h, L, x064, gamma=2, maxitrs=8, verbose=True, verbskip=4,
             fast_gram="ds")
    acc.ABPG_gain(fds, h, L, x064, gamma=2, maxitrs=8, verbose=True,
                  verbskip=4, fast_gram="ds")
    acc.ABPG_expo(fds, h, L, x064, gamma0=3.0, maxitrs=8, verbose=True,
                  verbskip=4, fast_gram="ds")
    acc.ABDA(fds, h, L, x064, gamma=2, maxitrs=8, verbose=True, verbskip=4,
             fast_gram="ds")
    out = capsys.readouterr().out
    assert out.count("method for min") >= 4 and "nan" not in out.lower()
