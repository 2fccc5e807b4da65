"""Exact-accumulation int8 digit contraction tests (ops/mixed_precision.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from accbpg_and_fw_tpu.ops.mixed_precision import (
    digit_split_matrix,
    digit_split_vector,
    ozaki_gemv,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300) * rng.uniform(0.1, 10, 300)
    B = rng.standard_normal((300, 700)) * rng.uniform(0.5, 2, 700)
    return a, B


def test_split_reconstructs(problem):
    a, B = problem
    digits, s = digit_split_vector(jnp.asarray(a), 7)
    recon = sum(np.asarray(digits[p], np.float64) * 64.0 ** -(p + 1)
                for p in range(7)) * float(s)
    assert np.max(np.abs(recon - a)) <= np.max(np.abs(a)) * 64.0**-7

    digitsB, sB = digit_split_matrix(jnp.asarray(B), 7)
    reconB = sum(np.asarray(digitsB[p], np.float64) * 64.0 ** -(p + 1)
                 for p in range(7)) * np.asarray(sB)
    assert np.max(np.abs(reconB - B)) <= np.max(np.abs(B)) * 64.0**-6


def test_digits_fit_int8(problem):
    a, B = problem
    digits, _ = digit_split_vector(jnp.asarray(a), 7)
    assert int(jnp.max(jnp.abs(digits.astype(jnp.int32)))) <= 64


def test_gemv_near_f64(problem):
    a, B = problem
    u_true = a @ B
    digitsB, sB = digit_split_matrix(jnp.asarray(B), 7)
    u = np.asarray(jax.jit(
        lambda a: ozaki_gemv(a, digitsB, sB, levels_a=7, max_diag=6)
    )(jnp.asarray(a)))
    rel = np.max(np.abs(u - u_true)) / np.max(np.abs(u_true))
    assert rel < 1e-10


def test_dopt_mixed_matches_exact():
    import accbpg_and_fw_tpu as acc

    f, h, L, x0 = acc.D_opt_design(20, 100, randseed=3)
    V = np.asarray(f.H)
    r_exact = acc.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=2000, verbose=False,
                                chunk=500, u_mode="exact")
    r_mixed = acc.D_opt_FW_away(V, x0, eps=1e-7, maxitrs=2000, verbose=False,
                                chunk=500, u_mode="mixed")
    # both converge; final objectives agree to the digit-truncation level
    assert abs(float(r_exact[1][-1]) - float(r_mixed[1][-1])) < 1e-8
    assert r_mixed[2][-1] <= 1e-7 and r_mixed[3][-1] <= 1e-7

def test_packed_gemv_matches_loop(problem):
    a, B = problem
    from accbpg_and_fw_tpu.ops.mixed_precision import (
        ozaki_gemv_packed,
        pack_digit_planes,
    )

    u_true = a @ B
    digitsB, sB = digit_split_matrix(jnp.asarray(B), 7)
    packed = pack_digit_planes(digitsB)
    u = np.asarray(jax.jit(
        lambda a: ozaki_gemv_packed(a, packed, sB, levels_b=7)
    )(jnp.asarray(a)))
    rel = np.max(np.abs(u - u_true)) / np.max(np.abs(u_true))
    assert rel < 1e-10


def test_packed_gemv_ds_near_f64(problem):
    """DS-combine packed GEMV (the DS D-opt w-update fast path)."""
    a, B = problem
    from accbpg_and_fw_tpu.ops.mixed_precision import (
        digit_split_matrix_np,
        digit_split_vector_ds,
        ozaki_gemv_packed_ds,
        pack_digit_planes,
    )

    dB, sB = digit_split_matrix_np(B, 7)
    packed = pack_digit_planes(jnp.asarray(dB))
    sB32 = jnp.asarray(sB, jnp.float32)
    ah = np.asarray(a, np.float32)
    al = np.asarray(a - ah.astype(np.float64), np.float32)
    a_ds = (jnp.asarray(ah), jnp.asarray(al))

    # the DS digit split reconstructs the DS value
    digits, s = jax.jit(lambda v: digit_split_vector_ds(v, 7))(a_ds)
    recon = sum(np.asarray(digits[p], np.float64) * 64.0 ** -(p + 1)
                for p in range(7)) * float(s)
    assert np.max(np.abs(recon - a)) <= np.max(np.abs(a)) * 64.0**-7

    u = jax.jit(lambda v: ozaki_gemv_packed_ds(v, packed, sB32, 7))(a_ds)
    u_ds = np.asarray(u[0], np.float64) + np.asarray(u[1], np.float64)
    u_true = a @ B
    rel = np.max(np.abs(u_ds - u_true)) / np.max(np.abs(u_true))
    assert rel < 1e-10


def test_dopt_ds_packed_u_certifies(monkeypatch):
    """The DS engine with the forced packed int8 u-update converges to the
    reference's 1e-8 slack and fresh-certifies (the big-n fast path,
    normally auto-enabled above _OZAKI_U_MIN_SIZE)."""
    import accbpg_and_fw_tpu as acc
    from accbpg_and_fw_tpu.algorithms import d_opt

    monkeypatch.setattr(d_opt, "_OZAKI_U_MIN_SIZE", 1)
    rng = np.random.RandomState(10)
    m, n = 30, 500
    V = rng.randn(m, n)
    x0 = np.full(n, 1.0 / n)
    x, F, SP, SN, T = acc.D_opt_FW_away(V, x0, eps=1e-8, maxitrs=20000,
                                        verbose=False, u_mode="ds")
    assert SP[-1] <= 1e-8 and SN[-1] <= 1e-8
    xs = np.asarray(x, np.float64)
    xs = xs / xs.sum()
    H = np.linalg.inv((V * xs) @ V.T)
    w = np.einsum("ij,ij->j", V, H @ V)
    assert w.max() / m - 1 <= 2e-8
    assert 1 - w[xs > 1e-8].min() / m <= 2e-8


def test_auto_u_mode_routing(monkeypatch):
    """u_mode="auto" is the native-dtype "exact" engine on the GPU as on
    the CPU; the int8-Ozaki "mixed" engine is only ever an explicit
    choice."""
    from accbpg_and_fw_tpu.algorithms import d_opt

    monkeypatch.setattr(d_opt.jax, "default_backend", lambda: "gpu")
    V = jnp.asarray(np.random.RandomState(1).randn(4, 9))
    prob, cfg = d_opt._dopt_problem(V, 1e-8, "auto")
    assert not cfg.mixed and "V_digits" not in prob
    prob, cfg = d_opt._dopt_problem(V, 1e-8, "exact")
    assert not cfg.mixed and "V_digits" not in prob
    prob, cfg = d_opt._dopt_problem(V, 1e-8, "mixed")
    assert cfg.mixed and "V_digits" in prob


def test_dopt_ds_f_history_full_resolution(monkeypatch):
    """The DS runner's returned F history reconstructs hi+lo to f64 grade
    (fresh-slogdet agreement well below f32 resolution)."""
    import accbpg_and_fw_tpu as acc

    rng = np.random.RandomState(3)
    m, n = 20, 200
    V = rng.randn(m, n)
    x0 = np.full(n, 1.0 / n)
    x, F, SP, SN, T = acc.D_opt_FW_away(V, x0, eps=1e-9, maxitrs=4000,
                                        verbose=False, u_mode="ds")
    assert F.dtype == np.float64
    xs = np.asarray(x, np.float64)
    xs = xs / xs.sum()
    ld = np.linalg.slogdet((V * xs) @ V.T)[1]
    # the last recorded F is evaluated at the PRE-update iterate of the
    # stopping step; after convergence stalls the iterate is frozen, so
    # they agree to DS resolution
    assert abs(float(F[-1]) - (-ld)) < 5e-7 * max(1.0, abs(ld))


def test_ozaki_mm_ds_rectangular():
    """Regression: ozaki_mm_ds reshaped the left operand's digit planes
    with its ROW count as the contraction dim — wrong for rectangular M
    (found wiring FrobeniusSymLossDS's X @ XtX with X (n, r))."""
    from accbpg_and_fw_tpu.ops import double_single as dsl
    from accbpg_and_fw_tpu.ops import mixed_precision as mp

    rng = np.random.default_rng(8)
    M = rng.standard_normal((24, 6))
    B = rng.standard_normal((6, 10))
    Mh, Ml = dsl.from_f64(jnp.asarray(M))
    dB, sB = mp.digit_split_matrix(jnp.asarray(B), 7)
    Ph, Pl = mp.ozaki_mm_ds(Mh, Ml, mp.pack_digit_planes(dB), sB,
                            levels_b=7, levels_m=7)
    ref = M @ B
    got = np.asarray(Ph, np.float64) + np.asarray(Pl, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)


def test_ozaki_mm_presplit_ds_matches_f64():
    from accbpg_and_fw_tpu.ops import mixed_precision as mp

    rng = np.random.default_rng(9)
    M = rng.standard_normal((20, 16))
    B = rng.standard_normal((16, 12))
    dM, sM = mp.digit_split_rows(jnp.asarray(M), 7)
    dB, sB = mp.digit_split_matrix(jnp.asarray(B), 7)
    Ph, Pl = mp.ozaki_mm_presplit_ds(
        dM.reshape(7 * M.shape[0], M.shape[1]), sM,
        mp.pack_digit_planes(dB), sB, 7, 7)
    ref = M @ B
    got = np.asarray(Ph, np.float64) + np.asarray(Pl, np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-11)
