"""The port's complex GEMM end to end vs the JAX package, on the same bits.

gemmul8_tpu_torch.gemm on complex128 CPU tensors runs every kernel's plain
version. Its (Re, Im) must be the f64 words of the JAX package's
gemm_complex_core(..., use_pallas=True) (Pallas in interpret mode), for
each of the three strategies in fast and in accurate mode. Both packages
get the same bits through c128_to_words / C64Bits.

Tolerance: bit equality, once the shared shifts agree. Where a shift
legally differs by 1 at a floor boundary (the joint f32 norm's summation
order in fast mode, the f32 log2 in accurate mode; asserted case by case
with the rule of tests/test_torch_complex_kernels.py), the output is held
to the exactly rounded product instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu.bench.matrices import exact_gemm_f64, phi_matrix
from gemmul8_tpu.core import complexgemm as jcg
from gemmul8_tpu.types import C64Bits, F64Bits, bits_to_f64
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.types import c128_to_words, words_to_c128

from test_torch_threads import one_torch_thread  # noqa: E402, F401

CT = gt.ComputeType
STRATS = [CT.COMPLEX_BIG_MATRIX_ENCODE, CT.COMPLEX_CLASSIC_MULT,
          CT.COMPLEX_KARATSUBA_MULT]


def _cplx(m, n, seed, phi=0.5):
    return (phi_matrix(m, n, phi, seed=seed)
            + 1j * phi_matrix(m, n, phi, seed=seed + 1))


def _both(z):
    """The same bits for both packages: (C64Bits, complex128 tensor)."""
    rw, iw = c128_to_words(z)
    bits = C64Bits(F64Bits(jnp.asarray(rw[0]), jnp.asarray(rw[1])),
                   F64Bits(jnp.asarray(iw[0]), jnp.asarray(iw[1])))
    return bits, words_to_c128(rw, iw)


def _exact(a, b):
    """The exactly rounded complex product, from real products over the
    k-concatenation: Re = [Ra, Ia] [Rb; -Ib], Im = [Ra, Ia] [Ib; Rb]
    (negation is exact)."""
    ak = np.hstack([a.real, a.imag])
    return (exact_gemm_f64(ak, np.vstack([b.real, -b.imag]))
            + 1j * exact_gemm_f64(ak, np.vstack([b.imag, b.real])))


def _jax_shifts(A, B, L, fastmode):
    if fastmode:
        return (jcg._joint_sft_pallas(A.re, A.im, L, 1),
                jcg._joint_sft_pallas(B.re, B.im, L, 0))
    return jcg._accurate_sfts_pallas(A.re, A.im, B.re, B.im, L)


def _check_against_jax(a, b, L, fastmode, strat):
    A, ta = _both(a)
    B, tb = _both(b)
    got = gt.gemm(ta, tb, num_moduli=L, fastmode=fastmode,
                  compute_type=strat)
    assert got.dtype == torch.complex128
    assert tuple(got.shape) == (a.shape[0], b.shape[1])
    got = got.numpy()
    ref_re, ref_im = jcg.gemm_complex_core(
        A.re, A.im, B.re, B.im, L, fastmode, jcg.ComputeType[strat.name],
        "f64", use_pallas=True)
    ref = (bits_to_f64(ref_re, to_numpy=True)
           + 1j * bits_to_f64(ref_im, to_numpy=True))
    parts = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (a.real, a.imag, b.real, b.imag)]
    if fastmode:
        sa = enc.joint_fast_sft(parts[0], parts[1], L, 1)
        sb = enc.joint_fast_sft(parts[2], parts[3], L, 0)
    else:
        sa, sb = cg.accurate_sfts_complex(*parts, L)
    ja, jb = _jax_shifts(A, B, L, fastmode)
    if np.array_equal(np.asarray(ja), sa.numpy()) and np.array_equal(
            np.asarray(jb), sb.numpy()):
        for x, y in ((ref.real, got.real), (ref.imag, got.imag)):
            np.testing.assert_array_equal(
                np.ascontiguousarray(x).view(np.uint64),
                np.ascontiguousarray(y).view(np.uint64))
        return
    # a floor-boundary shift: both encodings valid, both accurate
    assert np.abs(np.asarray(ja).astype(np.int64) - sa.numpy()).max() <= 1
    assert np.abs(np.asarray(jb).astype(np.int64) - sb.numpy()).max() <= 1
    exact = _exact(a, b)
    scale = (np.abs(a.real) + np.abs(a.imag)) @ (np.abs(b.real)
                                                 + np.abs(b.imag))
    assert np.all(np.abs(got - exact) <= 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("strat", STRATS)
@pytest.mark.parametrize("fastmode", [True, False])
def test_gemm_complex_matches_jax_pallas(fastmode, strat):
    _check_against_jax(_cplx(40, 72, seed=3), _cplx(72, 24, seed=5), 14,
                       fastmode, strat)


def test_gemm_complex_two_stats_chunks():
    """k = 2600 > 2048: the chunked norm merge inside each part, then the
    Re/Im merge, on both operands."""
    _check_against_jax(_cplx(16, 2600, seed=7, phi=1.0),
                       _cplx(2600, 12, seed=9, phi=1.0), 14, True,
                       CT.COMPLEX_KARATSUBA_MULT)


@pytest.mark.parametrize("fastmode", [True, False])
def test_strategies_give_identical_bits(fastmode):
    """All three strategies compute the same exact residues on the same
    shifts, so the same output bits (as tests/test_complex.py holds the
    JAX package at 20 moduli)."""
    a = torch.from_numpy(_cplx(24, 130, seed=11, phi=1.0))
    b = torch.from_numpy(_cplx(130, 20, seed=13, phi=1.0))
    outs = [gt.gemm(a, b, num_moduli=L, fastmode=fastmode, compute_type=s)
            for L in (8, 20) for s in STRATS]
    for L0 in (0, 3):
        for x in outs[L0 + 1:L0 + 3]:
            assert torch.equal(x.view(torch.float64).view(torch.int64),
                               outs[L0].view(torch.float64)
                               .view(torch.int64))


def test_complex_exact_at_20_moduli():
    """20 moduli, tiny k: the exactly rounded complex product."""
    a, b = _cplx(6, 12, seed=110, phi=1.0), _cplx(12, 6, seed=111, phi=1.0)
    got = gt.gemm(a, b, num_moduli=20, device="cpu").numpy()
    np.testing.assert_array_equal(got, _exact(a, b))


@pytest.mark.parametrize("strat", STRATS)
def test_accurate_complex_magnitude_wrap_regression(strat):
    """Maximal-mantissa Re == Im: at the real path's magnitude shift the
    |Re| + |Im| magnitude would be 64 + 64, which wraps int8 to -128 and
    corrupts the shift (tests/test_complex.py's regression for the JAX
    package). The complex path takes the magnitudes one bit lower."""
    v = float.fromhex("0x1.fffffffffffffp0")
    a = np.full((1, 64), v + v * 1j)
    b = np.full((64, 1), v + 0j)
    got = gt.gemm(a, b, num_moduli=14, fastmode=False, compute_type=strat,
                  device="cpu").numpy()
    ref = (a @ b)[0, 0]
    assert abs(got[0, 0] - ref) / abs(ref) < 1e-12
    mag, _ = cg.hk.mag7_operand_complex(torch.from_numpy(a.real.copy()),
                                        torch.from_numpy(a.imag.copy()), 1)
    assert int(mag.max()) == 64


# ---- the front end ---------------------------------------------------------

@pytest.mark.parametrize("kinds", [("c128", "c128"), ("f64", "c128"),
                                   ("c128", "f64")])
def test_gemm_complex_dtypes(kinds):
    """complex128 out for complex128 operands and for float64 mixed with
    complex128, which enters with +0.0 imaginary parts."""
    a, b = _cplx(8, 24, seed=1), _cplx(24, 6, seed=2)
    a = a.real.copy() if kinds[0] == "f64" else a
    b = b.real.copy() if kinds[1] == "f64" else b
    got = gt.gemm(a, b, num_moduli=14, device="cpu")
    assert got.dtype == torch.complex128 and tuple(got.shape) == (8, 6)
    ref = np.asarray(a, np.complex128) @ np.asarray(b, np.complex128)
    assert np.abs(got.numpy() - ref).max() <= 1e-13 * np.abs(ref).max()
    full = gt.gemm(np.asarray(a, np.complex128),
                   np.asarray(b, np.complex128), num_moduli=14,
                   device="cpu")
    assert torch.equal(got.view(torch.float64), full.view(torch.float64))


def test_real_operands_ignore_compute_type():
    a = phi_matrix(8, 24, 0.5, seed=1)
    b = phi_matrix(24, 6, 0.5, seed=2)
    ref = gt.gemm(a, b, device="cpu")
    for s in STRATS:
        got = gt.gemm(a, b, compute_type=s, device="cpu")
        assert got.dtype == torch.float64 and torch.equal(got, ref)


# complex64 operands, op T/C, alpha/beta and complex64 output run:
# tests/test_torch_complex64.py
@pytest.mark.parametrize("kwargs,match", [
    (dict(moduli_chunk=4), "real path"),
    (dict(max_workspace_bytes=1 << 20), "real path"),
    (dict(n_panel=2), "real path"),
    # complex calls have no phase times in either package (ROADMAP C1)
    (dict(return_times=True), "C1")],
    ids=["kwargs8-real path", "kwargs9-real path", "kwargs10-real path",
         "kwargs11-A8"])
def test_gemm_complex_unported_arguments(kwargs, match):
    a = torch.ones((4, 4), dtype=torch.complex128)
    with pytest.raises(NotImplementedError, match=match):
        gt.gemm(a, torch.ones((4, 4), dtype=torch.complex128), **kwargs)


@pytest.mark.parametrize("strat", STRATS)
def test_gemm_complex_k_bound(strat):
    """k above the strategy's int32-exactness bound raises before any
    work: 2^16 for the 4-dot strategies, 2^15 for Karatsuba."""
    k = cg._KMAX[strat] + 1
    assert k == (tables.MAX_K // 4 + 1 if strat == CT.COMPLEX_KARATSUBA_MULT
                 else tables.MAX_K // 2 + 1)
    a = torch.zeros((1, k), dtype=torch.complex128)
    b = torch.zeros((k, 1), dtype=torch.complex128)
    with pytest.raises(ValueError, match="bound"):
        gt.gemm(a, b, compute_type=strat)
    assert gt.gemm(a[:, :k - 1], b[:k - 1], compute_type=strat).shape == (1,
                                                                         1)


def test_c128_word_converters_round_trip():
    z = _cplx(5, 7, seed=4, phi=4.0)
    z[0, :] = complex(-0.0, 0.0)
    z[1, :] = complex(0.0, -0.0)
    z[2, ::2] = complex(5e-324, -2.5e-320)
    z[3, 0] = complex(float("nan"), float("inf"))
    rw, iw = c128_to_words(z)
    t = words_to_c128(rw, iw)
    assert t.dtype == torch.complex128
    np.testing.assert_array_equal(t.numpy().view(np.uint64),
                                  z.view(np.uint64))
    rw2, iw2 = c128_to_words(t)
    for x, y in zip(rw + iw, rw2 + iw2):
        np.testing.assert_array_equal(x, y)
    re, im = cg.canon_complex(t)
    assert re.is_contiguous() and im.is_contiguous()
    np.testing.assert_array_equal(re.numpy().view(np.uint64), rw[0].astype(
        np.uint64) << np.uint64(32) | rw[1].astype(np.uint64))
    re, im = cg.canon_complex(t.real.contiguous())
    assert torch.equal(im.view(torch.int64), torch.zeros_like(im).view(
        torch.int64))


@pytest.mark.cuda
def test_complex_kernels_on_card_match_plain():
    """On a CUDA host: the complex kernel path gives the bits of the plain
    path on the same shifts, fast and accurate, both forms. Skips without a
    card; chip_smoke.py covers more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from gemmul8_tpu_torch.hopper import build

    a = torch.from_numpy(_cplx(300, 260, seed=8))
    b = torch.from_numpy(_cplx(260, 200, seed=9))
    for fastmode in (True, False):
        for s in (CT.COMPLEX_CLASSIC_MULT, CT.COMPLEX_KARATSUBA_MULT):
            build.LAUNCHES.clear()
            got = gt.gemm(a.cuda(), b.cuda(), fastmode=fastmode,
                          compute_type=s).cpu()
            assert build.LAUNCHES["matmul_complex_mod"] == 1
            assert build.LAUNCHES["reconstruct"] == 2
            ref = gt.gemm(a, b, fastmode=fastmode, compute_type=s)
            if fastmode and not torch.equal(got.view(torch.float64),
                                            ref.view(torch.float64)):
                # a floor-boundary fast shift: held to the product instead
                exact = (a @ b).numpy()
                assert np.abs(got.numpy() - exact).max() <= (
                    1e-12 * np.abs(exact).max())
                continue
            assert torch.equal(got.view(torch.float64),
                               ref.view(torch.float64))
