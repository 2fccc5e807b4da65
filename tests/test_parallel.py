"""Distributed-layer tests on the 8-virtual-device CPU mesh (SURVEY.md §4c):
sharded runs must match single-device runs to tolerance, and the batched
(vmapped) sweep solver must match per-instance solves."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import accbpg_and_fw_tpu as acc
from accbpg_and_fw_tpu.parallel import (
    data_mesh,
    shard_dopt_design,
    shard_dopt_problem,
    shard_regression_problem,
)
from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    return data_mesh(jax.devices()[:8])


class TestBatchedDSCertification:
    """The DS batch engine must fresh-certify 1e-8 at small m (the old
    K>=2 vmapped limit cycle is root-caused to broadcast-EFT rewriting,
    fixed by double_single._bc2; on an H100 the K=32 sweep of 30x1000
    certifies in chip_smoke.py — this is the CPU gate)."""

    @pytest.mark.parametrize("m", [12, 30])
    def test_small_m_certifies_1e8(self, m):
        rng = np.random.default_rng(7)
        K, n = 4, 300
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)
        xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=1e-8,
                                         num_iters=60000, precision="ds")
        for k in range(K):
            x = np.asarray(xb[k], np.float64)
            x = np.maximum(x, 0)
            x = x / x.sum()
            G = (Vs[k] * x) @ Vs[k].T
            w = np.einsum("ij,ij->j", Vs[k], np.linalg.solve(G, Vs[k]))
            sp = w.max() / m - 1.0
            sn = 1.0 - w[x > 1e-8].min() / m
            assert max(sp, sn) <= 1.05e-8, (k, sp, sn)


class TestShardedDOpt:
    def test_bpg_sharded_matches_single(self, mesh):
        f, h, L, x0 = acc.D_opt_design(16, 64, randseed=5)
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)

        x1, F1, Ls1, T1 = acc.BPG(f, h, L, x0, maxitrs=50, verbose=False)
        x2, F2, Ls2, T2 = acc.BPG(f_sh, h, L, x_sh, maxitrs=50, verbose=False)
        np.testing.assert_allclose(np.asarray(F1), np.asarray(F2), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-11)

    def test_bpg_sharded_non_divisible_n(self, mesh):
        """n % devices != 0: zero-padding must be exactly neutral (round-1
        verdict item — the old layout required divisibility)."""
        f, h, L, x0 = acc.D_opt_design(12, 50, randseed=5)  # 50 % 8 != 0
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        assert f_sh.H.shape == (12, 56)

        x1, F1, Ls1, T1 = acc.BPG(f, h, L, x0, maxitrs=60, verbose=False)
        x2, F2, Ls2, T2 = acc.BPG(f_sh, h, L, x_sh, maxitrs=60, verbose=False)
        assert len(F1) == len(F2)
        np.testing.assert_allclose(np.asarray(F1), np.asarray(F2), rtol=1e-10)
        x2 = np.asarray(x2)
        np.testing.assert_allclose(np.asarray(x1), x2[:50], atol=1e-11)
        np.testing.assert_array_equal(x2[50:], 0.0)  # pads never move

    def test_abda_padded_mesh(self, mesh):
        """ABDA's dual averaging calls h.prox_map on accumulated duals,
        where zero-pad neutrality does NOT hold by itself (round-3 verdict
        weak #2).  The sharded oracle's n_valid mask (+1e30 pad gradients)
        must make the padded trajectory match the unpadded one."""
        f, h, L, x0 = acc.D_opt_design(10, 44, randseed=9)  # 44 % 8 != 0
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        assert f_sh.n_valid == 44

        out1 = acc.ABDA(f, h, L, x0, gamma=2, maxitrs=40, verbose=False)
        out2 = acc.ABDA(f_sh, h, L, x_sh, gamma=2, maxitrs=40, verbose=False)
        np.testing.assert_allclose(np.asarray(out1[1]), np.asarray(out2[1]),
                                   rtol=1e-8)
        x2 = np.asarray(out2[0])
        np.testing.assert_allclose(np.asarray(out1[0]), x2[:44], atol=1e-9)
        # padded coordinates hold only the prox's ~1e-30 floor mass
        assert np.abs(x2[44:]).max() < 1e-12

    def test_abda_fastgram_padded_mesh(self, mesh):
        """Same as above but through the fast_gram engine, whose gradient
        comes from grad_from_inv — which must apply the same +1e30 pad
        mask (ADVICE r4 medium: it previously bypassed _mask_pads)."""
        f, h, L, x0 = acc.D_opt_design(10, 44, randseed=9)  # 44 % 8 != 0
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        out1 = acc.ABDA(f, h, L, x0, gamma=2, maxitrs=40, verbose=False,
                        fast_gram=True)
        out2 = acc.ABDA(f_sh, h, L, x_sh, gamma=2, maxitrs=40, verbose=False,
                        fast_gram=True)
        np.testing.assert_allclose(np.asarray(out1[1]), np.asarray(out2[1]),
                                   rtol=1e-8)
        x2 = np.asarray(out2[0])
        np.testing.assert_allclose(np.asarray(out1[0]), x2[:44], atol=1e-9)
        assert np.abs(x2[44:]).max() < 1e-12

    def test_mixed_oracle_shardable_when_divisible(self, mesh):
        """DOptimalObjMixed has no n_valid field; sharding must still work
        when no padding is needed (ADVICE r4 low: replace() previously
        required the field unconditionally)."""
        f, h, L, x0 = acc.D_opt_design(8, 64, randseed=3, oracle="mixed")
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)  # 64 % 8 == 0
        assert f_sh.H.shape == (8, 64)
        # round 5: the digit/DS planes shard too, not just the f64 H leaf
        for name in ("Vds_hi", "Vds_lo", "Vd_rows", "V_packed", "sV_cols"):
            sh = getattr(f_sh, name).sharding
            assert not sh.is_fully_replicated, name
        f2, _, _, x2 = acc.D_opt_design(8, 60, randseed=3, oracle="mixed")
        with pytest.raises(ValueError, match="n_valid"):
            shard_dopt_problem(f2, x2, mesh)  # 60 % 8 != 0 -> clear error

    def test_mixed_oracle_sharded_matches_single(self, mesh):
        """Sharded-Mixed BPG == single-device (the planes actually carry
        the contractions; parity proves the shardings are layout-safe)."""
        f, h, L, x0 = acc.D_opt_design(8, 64, randseed=3, oracle="mixed")
        import jax.numpy as jnp

        x064 = jnp.asarray(np.asarray(x0), jnp.float64)
        r1 = acc.BPG(f, h, L, x064, maxitrs=30, verbose=False)
        f_sh, x_sh = shard_dopt_problem(f, x064, mesh)
        r2 = acc.BPG(f_sh, h, L, x_sh, maxitrs=30, verbose=False)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-11)

    def test_ds_oracle_shardable(self, mesh):
        """DOptimalObjDS (no H field) shards through the same entry
        (round 5 — previously AttributeError at f.H)."""
        f, h, L, x0 = acc.D_opt_design(10, 64, randseed=7)
        V64 = np.asarray(f.H, np.float64)
        fds = acc.DOptimalObjDS.from_design(V64)
        x064 = np.full(64, 1.0 / 64)
        r1 = acc.ABPG_gain(fds, h, L, x064, gamma=2, maxitrs=15,
                           verbose=False, fast_gram="ds")
        fds_sh, x_sh = shard_dopt_problem(fds, x064, mesh)
        r2 = acc.ABPG_gain(fds_sh, h, L, x_sh, gamma=2, maxitrs=15,
                           verbose=False, fast_gram="ds")
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)

    def test_fw_away_sharded_non_divisible_n(self, mesh):
        f, h, L, x0 = acc.D_opt_design(10, 50, randseed=4)
        V = np.asarray(f.H)
        Vs, x0s = shard_dopt_design(V, x0, mesh)
        assert Vs.shape == (10, 56)

        r1 = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=800, verbose=False,
                               chunk=400)
        r2 = acc.D_opt_FW_away(Vs, x0s, eps=1e-8, maxitrs=800, verbose=False,
                               chunk=400)
        assert len(r1[1]) == len(r2[1])
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)
        x2 = np.asarray(r2[0])
        np.testing.assert_allclose(np.asarray(r1[0]), x2[:50], atol=1e-11)
        np.testing.assert_array_equal(x2[50:], 0.0)

    def test_abpg_gain_sharded_matches_single(self, mesh):
        f, h, L, x0 = acc.D_opt_design(16, 64, randseed=5)
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        r1 = acc.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=40, verbose=False)
        r2 = acc.ABPG_gain(f_sh, h, L, x_sh, gamma=2, maxitrs=40, verbose=False)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]), rtol=1e-11)

    def test_abpg_gain_fastgram_sharded_matches_single(self, mesh):
        """The linear-Gram fast path (fast_gram=True) under column sharding:
        the one O(m^2 n) contraction per trial psums over the mesh, every
        carried m x m quantity (Gram, Schulz inverse, logdet) replicates —
        GSPMD propagates it all from the input shardings alone."""
        f, h, L, x0 = acc.D_opt_design(16, 64, randseed=5)
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        r1 = acc.ABPG_gain(f, h, L, x0, gamma=2, maxitrs=40, verbose=False,
                           fast_gram=True)
        r2 = acc.ABPG_gain(f_sh, h, L, x_sh, gamma=2, maxitrs=40,
                           verbose=False, fast_gram=True)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)

    def test_bpg_fastgram_sharded_non_divisible_n(self, mesh):
        """fast_gram + zero-padded columns: pads enter the carried-Gram
        machinery as exactly-zero columns and the prox warm start excludes
        them (CLAUDE.md), so the padded sharded trajectory must equal the
        unpadded single-device one."""
        f, h, L, x0 = acc.D_opt_design(12, 50, randseed=5)  # 50 % 8 != 0
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        r1 = acc.BPG(f, h, L, x0, maxitrs=60, verbose=False, fast_gram=True)
        r2 = acc.BPG(f_sh, h, L, x_sh, maxitrs=60, verbose=False,
                     fast_gram=True)
        assert len(r1[1]) == len(r2[1])
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)
        x2 = np.asarray(r2[0])
        np.testing.assert_allclose(np.asarray(r1[0]), x2[:50], atol=1e-10)
        np.testing.assert_array_equal(x2[50:], 0.0)

    def test_dopt_fw_away_sharded_matches_single(self, mesh):
        f, h, L, x0 = acc.D_opt_design(12, 128, randseed=5)
        V = f.H
        x1, F1, SP1, SN1, T1 = acc.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=2000,
                                                 verbose=False, chunk=500)
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)
        x2, F2, SP2, SN2, T2 = acc.D_opt_FW_away(f_sh.H, x_sh, eps=1e-7,
                                                 maxitrs=2000, verbose=False,
                                                 chunk=500)
        assert len(F1) == len(F2)  # identical stopping iteration
        np.testing.assert_allclose(np.asarray(F1), np.asarray(F2), rtol=1e-9)

    def test_output_keeps_sharding(self, mesh):
        from jax.sharding import NamedSharding, PartitionSpec as P

        f, h, L, x0 = acc.D_opt_design(16, 64, randseed=5)
        f_sh, x_sh = shard_dopt_problem(f, x0, mesh)

        @jax.jit
        def step(f, x):
            fx, g = f.value_and_grad(x)
            return h.div_prox_map(x, g, 1.0)

        x1 = step(f_sh, x_sh)
        assert x1.sharding.is_equivalent_to(
            NamedSharding(mesh, P("data")), ndim=1)


class TestShardedRegression:
    def test_logreg_sharded_matches_single(self, mesh):
        key = jax.random.PRNGKey(1)
        f, h, L, L0, L1, x0, X, y = acc.hard_FW_log_reg_jax(key, 64, 10,
                                                            radius=1.5,
                                                            domain="l2")
        f_sh, x_sh = shard_regression_problem(f, x0, mesh)
        lmo = acc.lmo_l2_ball(1.5)
        r1 = acc.FW_alg_div_step(f, h, float(L), x0, 50, gamma=2.0, lmo=lmo,
                                 verbose=False)
        r2 = acc.FW_alg_div_step(f_sh, h, float(L), x_sh, 50, gamma=2.0,
                                 lmo=lmo, verbose=False)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)

    def test_poisson_sharded(self, mesh):
        f, h, L, x0 = acc.Poisson_regrL1(64, 20, noise=0.0001, randseed=2)
        f_sh, x_sh = shard_regression_problem(f, x0, mesh)
        r1 = acc.BPG(f, h, L, x0, maxitrs=50, linesearch=False, verbose=False)
        r2 = acc.BPG(f_sh, h, L, x_sh, maxitrs=50, linesearch=False, verbose=False)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)

    def test_symnmf_sharded(self, mesh):
        from accbpg_and_fw_tpu.parallel import shard_symnmf_problem

        rng = np.random.default_rng(6)
        n, r = 64, 4
        Y = np.abs(rng.standard_normal((n, r)))
        M = Y @ Y.T / r + 0.01 * np.abs(rng.standard_normal((n, n)))
        M = 0.5 * (M + M.T)
        np.random.seed(3)
        f, (h, _), L, X0 = acc.FrobeniusSymLossResMeasEx(M, r)
        f_sh, X_sh = shard_symnmf_problem(f, X0, mesh)
        r1 = acc.BPG(f, h, L, X0, maxitrs=50, linesearch=False, verbose=False)
        r2 = acc.BPG(f_sh, h, L, X_sh, maxitrs=50, linesearch=False,
                     verbose=False)
        np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]),
                                   rtol=1e-9)
        np.testing.assert_allclose(np.asarray(r1[0]), np.asarray(r2[0]),
                                   atol=1e-7)


class TestBatchedSweeps:
    def test_dopt_batch_matches_individual(self):
        K, m, n = 3, 10, 40
        rng = np.random.default_rng(0)
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)

        xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=1e-9, num_iters=300)
        assert xb.shape == (K, n) and Fb.shape == (K, 300)

        for k in range(K):
            xk, Fk, SPk, SNk, Tk = acc.D_opt_FW_away(
                Vs[k], x0s[k], eps=1e-9, maxitrs=300, verbose=False, chunk=300)
            nk = len(Fk)
            np.testing.assert_allclose(np.asarray(Fb[k][:nk]), Fk, rtol=1e-9)

    def test_dopt_batch_refresh_respects_budget(self):
        """Round-2 review finding: with refresh_every not dividing
        num_iters, the refresh path's rounded-up block grid ran the carry
        past the budget — the returned x was ahead of the histories."""
        K, m, n = 2, 10, 40
        rng = np.random.default_rng(1)
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)

        # 100 iterations in blocks of 64 -> 2 blocks = 128 raw scan steps;
        # iterations 100..127 must be frozen
        xb, Fb, SPb, SNb = dopt_fw_batch(Vs, x0s, eps=1e-12, num_iters=100,
                                         refresh_every=64)
        xr, Fr, SPr, SNr = dopt_fw_batch(Vs, x0s, eps=1e-12, num_iters=100)
        assert Fb.shape == (K, 100)
        np.testing.assert_allclose(np.asarray(xb), np.asarray(xr),
                                   rtol=0, atol=5e-7)

    def test_dopt_batch_zero_iters(self):
        K, m, n = 2, 8, 32
        rng = np.random.default_rng(2)
        Vs = rng.standard_normal((K, m, n))
        x0s = np.full((K, n), 1.0 / n)
        x, F, SP, SN = dopt_fw_batch(Vs, x0s, eps=1e-9, num_iters=0,
                                     precision="ds")
        assert F.shape == (K, 0) and x.shape == (K, n)


def test_batch_ds_packed_u_parity(monkeypatch):
    """Batch DS engine with the forced packed int8 u-update certifies and
    agrees with the non-packed batch engine (big-n fast path, auto-enabled
    above d_opt._OZAKI_U_MIN_SIZE)."""
    import numpy as np
    from accbpg_and_fw_tpu.algorithms import d_opt
    from accbpg_and_fw_tpu.parallel.batched import dopt_fw_batch

    rng = np.random.RandomState(7)
    K, m, n = 2, 25, 400
    Vs = rng.randn(K, m, n)
    x0s = np.full((K, n), 1.0 / n)

    x_ref, F_ref, SP_ref, SN_ref = dopt_fw_batch(
        Vs, x0s, eps=1e-8, num_iters=12000, precision="ds")

    monkeypatch.setattr(d_opt, "_OZAKI_U_MIN_SIZE", 1)
    x, F, SP, SN = dopt_fw_batch(Vs, x0s, eps=1e-8, num_iters=12000,
                                 precision="ds")
    for kk in range(K):
        assert SP[kk][-1] <= 1e-8 and SN[kk][-1] <= 1e-8
        xs = np.asarray(x[kk], np.float64)
        xs = xs / xs.sum()
        H = np.linalg.inv((Vs[kk] * xs) @ Vs[kk].T)
        w = np.einsum("ij,ij->j", Vs[kk], H @ Vs[kk])
        assert w.max() / m - 1 <= 2e-8
        assert 1 - w[xs > 1e-8].min() / m <= 2e-8
        # same certified objective as the non-packed engine
        xr = np.asarray(x_ref[kk], np.float64)
        xr = xr / xr.sum()
        ld = np.linalg.slogdet((Vs[kk] * xs) @ Vs[kk].T)[1]
        ldr = np.linalg.slogdet((Vs[kk] * xr) @ Vs[kk].T)[1]
        assert abs(ld - ldr) < 1e-7
