"""Accurate mode of the port vs the JAX package, on the same bits.

The port's plain versions (CPU tensors) of emax, mag7, the magnitude GEMM's
row/col max, the accurate shifts and the whole accurate-mode gemm are held
to the JAX functions, with the Pallas kernels in interpret mode.

Tolerance: bit equality, with one exception. The shift's pre-floor value
-0.51 * log2(smax) + T is f32 arithmetic on an f32 log2. The port takes the
correctly rounded log2 (so the CPU and the card agree); XLA's CPU log2
misses it for many inputs. So a shift may differ by 1 where the pre-floor
value lies within 1e-4 of an integer (`accurate_sft_floor_frac`), as
fast-mode shifts may; every such difference is checked against that rule,
and the output is then held to the exact product instead of to the JAX
bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.bench.evalref import dd_gemm_f64
from gemmul8_tpu.bench.matrices import (exact_gemm_f64, phi_matrix,
                                        relerr_stats)
from gemmul8_tpu.core import encode as jenc
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu.types import F64Bits, bits_to_f64, f64_to_bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.types import f64_to_words, words_to_f64

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4


def _both(a):
    """The same bits for both packages: (F64Bits, float64 tensor)."""
    hi, lo = f64_to_words(a)
    return F64Bits(jnp.asarray(hi), jnp.asarray(lo)), words_to_f64(hi, lo)


def _edge_rows(m, n, seed=5):
    """A phi = 2 matrix whose rows 0-4 are all subnormal, all zero, all
    -0.0, partly -0.0, and spread over 2^-300 .. 2^300. Transposed, it
    gives the same columns."""
    rng = np.random.default_rng(seed)
    a = phi_matrix(m, n, 2.0, seed=seed)
    a[0, :] = rng.random(n) * 4.9e-324 * rng.integers(
        1, 1 << 40, n).astype(float)
    a[1, :] = 0.0
    a[2, :] = -0.0
    a[3, ::3] = -0.0
    a[4, :] = ((rng.random(n) + 0.5) * rng.choice([-1.0, 1.0], n)
               * 2.0 ** rng.integers(-300, 301, n).astype(float))
    return a


def _edge(shape, axis, seed=5):
    """(m, n) with the special lines along `axis` (1: rows, 0: columns)."""
    m, n = shape
    if axis == 1:
        return _edge_rows(m, n, seed)
    return _edge_rows(n, m, seed).T.copy()


def _assert_shift_rule(ref, got, smax, L):
    """Equal, or off by 1 where the pre-floor value is within
    SHIFT_RULE_FRAC of an integer. Returns the number that differ."""
    ref = np.asarray(ref).astype(np.int64)
    got = np.asarray(got).astype(np.int64)
    diff = ref != got
    if not diff.any():
        return 0
    frac = enc.accurate_sft_floor_frac(torch.as_tensor(np.asarray(smax)),
                                       L).numpy().reshape(ref.shape)
    assert np.abs(ref[diff] - got[diff]).max() <= 1
    assert frac[diff].max() < SHIFT_RULE_FRAC, \
        "shift differs away from a floor boundary"
    return int(diff.sum())


# ---- emax and mag7 -------------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("phi", [0.5, 2.0])
@pytest.mark.parametrize("shape", [(88, 272), (272, 104)])
def test_emax_mag7_match_pallas(shape, phi, axis):
    bits, t = _both(phi_matrix(*shape, phi, seed=shape[0]))
    je = pk.emax_pallas(bits, axis)
    jm = pk.mag7_pallas(bits, je, axis)
    jm2, je2 = jenc.mag7_f64(bits, axis)
    tm, te = hk.mag7_operand(t, axis)
    assert te.dtype == torch.int32 and tuple(te.shape) == je.shape
    assert tm.dtype == torch.int8 and tuple(tm.shape) == shape
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(je2), te.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(jm2), tm.numpy())
    assert int(tm.min()) >= 0 and int(tm.max()) <= 64


@pytest.mark.parametrize("axis", [0, 1])
def test_emax_mag7_edge_values(axis):
    bits, t = _both(_edge((40, 72), axis))
    je = pk.emax_pallas(bits, axis)
    jm = pk.mag7_pallas(bits, je, axis)
    te = hk.emax(t, axis)
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(jm),
                                  hk.mag7(t, te, axis).numpy())
    # all subnormal gives 1; all zero and all -0.0 give 0
    assert te.numpy().ravel()[:3].tolist() == [1, 0, 0]


# ---- the magnitude GEMM --------------------------------------------------

@pytest.mark.parametrize("mkn", [(384, 256, 384), (200, 300, 136)])
def test_magmax_matches_pallas(mkn):
    """Multi-tile grid and a ragged one, against the Pallas kernel's
    128-blocked fold and the int64 product."""
    m, k, n = mkn
    rng = np.random.default_rng(m)
    a8 = rng.integers(0, 65, (m, k), dtype=np.int8)
    b8 = rng.integers(0, 65, (k, n), dtype=np.int8)
    jr, jc = pm.magmax_matmul_pallas(jnp.asarray(a8), jnp.asarray(b8),
                                     block=(128, 128, 128))
    tr, tc = hm.magmax_matmul(torch.from_numpy(a8), torch.from_numpy(b8))
    assert tr.dtype == torch.int32 and tuple(tr.shape) == (m, 1)
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (1, n)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    s = a8.astype(np.int64) @ b8.astype(np.int64)
    np.testing.assert_array_equal(s.max(axis=1, keepdims=True), tr.numpy())
    np.testing.assert_array_equal(s.max(axis=0, keepdims=True), tc.numpy())


def test_magmax_largest_products_exact():
    """64 * 64 * k at k = 2^17 = 2^29: the plain f64 product is exact."""
    k = tables.MAX_K
    a8 = torch.full((2, k), 64, dtype=torch.int8)
    b8 = torch.full((k, 3), 64, dtype=torch.int8)
    b8[:, 1] = 0
    r, c = hm.magmax_matmul(a8, b8)
    assert r.tolist() == [[1 << 29], [1 << 29]]
    assert c.tolist() == [[1 << 29, 0, 1 << 29]]


def test_k_major_layout():
    """The card's GEMM reads rows at a stride that is a multiple of 16:
    mag7's padded K-major buffers pass as they are, other layouts are
    copied, and the values never change."""
    buf = torch.arange(6 * 32, dtype=torch.int8).reshape(6, 32)
    view = buf[:, :20]
    t, ld = hm._k_major(view)
    assert t.data_ptr() == view.data_ptr() and ld == 32
    for x in (buf[:, :20].t(), buf[:, 1:21], buf[:5, :20].contiguous()):
        t, ld = hm._k_major(x)
        assert ld % 16 == 0 and t.stride() == (ld, 1)
        assert torch.equal(t[:, :x.shape[1]], x)


# ---- shifts --------------------------------------------------------------

@pytest.mark.parametrize("L", [8, 14, 20])
def test_accurate_sfts_match_jax(L):
    a = _edge((88, 272), 1, seed=6)
    b = _edge((272, 104), 0, seed=7)
    A, B = f64_to_bits(a), f64_to_bits(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    smax_a, smax_b = hm.magmax_matmul(hk.mag7_operand(ta, 1)[0],
                                      hk.mag7_operand(tb, 0)[0])
    got_a, got_b = tg.accurate_sfts(ta, tb, L)
    assert got_a.dtype == torch.int32 and tuple(got_a.shape) == (88, 1)
    assert got_b.dtype == torch.int32 and tuple(got_b.shape) == (1, 104)
    for use_pallas in (True, False):
        ref_a, ref_b = gg.accurate_sfts(A, B, L, use_pallas=use_pallas)
        _assert_shift_rule(ref_a, got_a, smax_a, L)
        _assert_shift_rule(ref_b, got_b, smax_b, L)
    # all-zero rows and columns: T - 1 + 1023
    t_a = tables.threshold_accurate(L)
    for sft in (got_a.ravel(), got_b.ravel()):
        assert sft[1] == sft[2] == t_a - 1 + 1023


def _log2_probe_values():
    """Every integer s in [1, 2^20], and +-4096 around every step of
    floor(-0.51 * log2(s) + T) up to 2^29 (64 * 64 * k at k = 2^17). T is
    an integer, so the steps s = 2^(i / 0.51) do not depend on it."""
    top = 64 * 64 * tables.MAX_K
    parts = [np.arange(1, 2 ** 20 + 1)]
    i = 1
    while 2.0 ** (i / 0.51) <= top:
        c = int(round(2.0 ** (i / 0.51)))
        parts.append(np.arange(c - 4096, c + 4097))
        i += 1
    s = np.unique(np.concatenate(parts))
    return s[(s >= 1) & (s <= top)].astype(np.int32)


@pytest.mark.parametrize("L", range(2, 21))
def test_accurate_sft_log2_rule(L):
    """accurate_sft against the JAX package's at every probe value: equal,
    or off by 1 at a floor boundary (the f32 log2 implementations
    differ)."""
    s = _log2_probe_values()
    e = np.full((1, s.size), 1023, np.int32)
    smax = s.reshape(1, -1)
    ref = np.asarray(jenc.accurate_sft(jnp.asarray(smax), jnp.asarray(e),
                                       L, 53))
    got = enc.accurate_sft(torch.from_numpy(smax), torch.from_numpy(e), L)
    assert got.dtype == torch.int32
    n = _assert_shift_rule(ref, got.numpy(), smax, L)
    assert n < s.size // 1000, f"{n} of {s.size} shifts differ"


# ---- end to end ----------------------------------------------------------

def _check_accurate(a, b, L, ref):
    """The port's accurate gemm on CPU tensors gives `ref`'s bits when the
    shifts agree with the JAX package's; otherwise (a floor-boundary
    shift, both encodings valid) it is held to the exact product."""
    got = gt.gemm(a, b, num_moduli=L, fastmode=False, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (a.shape[0],
                                                        b.shape[1])
    got = got.numpy()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    sa, sb = tg.accurate_sfts(ta, tb, L)
    ja, jb = gg.accurate_sfts(f64_to_bits(a), f64_to_bits(b), L)
    if np.array_equal(np.asarray(ja), sa.numpy()) and np.array_equal(
            np.asarray(jb), sb.numpy()):
        np.testing.assert_array_equal(ref.view(np.uint64),
                                      got.view(np.uint64))
    else:
        smax_a, smax_b = hm.magmax_matmul(hk.mag7_operand(ta, 1)[0],
                                          hk.mag7_operand(tb, 0)[0])
        _assert_shift_rule(ja, sa, smax_a, L)
        _assert_shift_rule(jb, sb, smax_b, L)
        scale = np.abs(a) @ np.abs(b)
        assert np.all(np.abs(got - a @ b) <= 1e-12 * scale + 1e-300)


def _gemm_core_pallas(a, b, L):
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L, False, "f64",
                       use_pallas=True)
    return bits_to_f64(ref, to_numpy=True)


@pytest.mark.parametrize("L", [8, 14])
def test_gemm_accurate_matches_gemm_core_pallas(L):
    a = phi_matrix(72, 200, 0.5, seed=3)
    b = phi_matrix(200, 56, 0.5, seed=4)
    _check_accurate(a, b, L, _gemm_core_pallas(a, b, L))


@pytest.mark.parametrize("L", [8, 14])
def test_gemm_accurate_matches_public_jax_gemm(L):
    a = phi_matrix(72, 200, 0.5, seed=3)
    b = phi_matrix(200, 56, 0.5, seed=4)
    _check_accurate(a, b, L,
                    np.asarray(g8.gemm(a, b, num_moduli=L, fastmode=False)))


def test_gemm_accurate_k2600():
    a = phi_matrix(24, 2600, 1.0, seed=6)
    b = phi_matrix(2600, 20, 1.0, seed=7)
    _check_accurate(a, b, 14, _gemm_core_pallas(a, b, 14))


def test_gemm_accurate_edge_values():
    """Zero, -0.0 and subnormal rows and columns give shifts near 1050;
    encode and reconstruct take them as the JAX package does."""
    a = _edge((40, 72), 1, seed=8)
    b = _edge((72, 32), 0, seed=9)
    _check_accurate(a, b, 14, _gemm_core_pallas(a, b, 14))


def test_gemm_accurate_20_moduli_is_exact():
    """20 moduli, phi = 2: the exactly rounded product, as
    tests/test_gemm.py holds the JAX package's accurate mode."""
    a = phi_matrix(8, 16, 2.0, seed=3)
    b = phi_matrix(16, 6, 2.0, seed=4)
    got = gt.gemm(a, b, num_moduli=20, fastmode=False, device="cpu")
    np.testing.assert_array_equal(got.numpy(), exact_gemm_f64(a, b))


def test_accurate_mode_tightens():
    """At 12 moduli accurate mode is closer to the double-double oracle
    than fast mode (BASELINE.md's accu-vs-fast band at k = 8192, here at
    k = 512 as tests/test_gemm.py checks the JAX package)."""
    a = phi_matrix(32, 512, 0.5, seed=20)
    b = phi_matrix(512, 32, 0.5, seed=21)
    ref = dd_gemm_f64(a, b)
    e_fast = relerr_stats(gt.gemm(a, b, num_moduli=12, device="cpu")
                          .numpy(), ref)[0]
    e_accu = relerr_stats(gt.gemm(a, b, num_moduli=12, fastmode=False,
                                  device="cpu").numpy(), ref)[0]
    assert e_accu < e_fast, (e_fast, e_accu)


# ---- arguments -----------------------------------------------------------

def test_accurate_wrapper_argument_errors():
    x = torch.ones((4, 6), dtype=torch.float64)
    with pytest.raises(ValueError):
        hk.emax(x, 2)
    with pytest.raises(TypeError):
        hk.emax(x.half(), 1)
    with pytest.raises(ValueError):
        hk.mag7(x, torch.zeros((1, 6), dtype=torch.int32), 1)
    m8 = torch.ones((4, 6), dtype=torch.int8)
    with pytest.raises(TypeError):
        hm.magmax_matmul(m8.int(), m8.t())
    with pytest.raises(ValueError):
        hm.magmax_matmul(m8, m8)
    with pytest.raises(ValueError):
        hm.magmax_matmul(m8[:, :0], m8.t()[:0])


# ---- f32 operands and output ----------------------------------------------

def _gemm_core_pallas_kinds(a, b, L, out_dtype):
    """The JAX package's Pallas gemm_core (interpret mode) on f64 or f32
    operands, as numpy words of out_dtype."""
    ja = f64_to_bits(a) if a.dtype == np.float64 else jnp.asarray(a)
    jb = f64_to_bits(b) if b.dtype == np.float64 else jnp.asarray(b)
    ref = gg.gemm_core(ja, jb, L, False, out_dtype, use_pallas=True)
    if out_dtype == "f64":
        return bits_to_f64(ref, to_numpy=True)
    return np.asarray(ref)


@pytest.mark.parametrize("L", [8, 14])
def test_gemm_core_accurate_f32_output(L):
    """Accurate mode with f32 output (refused until the f32 reconstruct
    was ported): the JAX package's Pallas words on the same shifts."""
    a = phi_matrix(40, 96, 0.5, seed=3)
    b = phi_matrix(96, 32, 0.5, seed=4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = tg.gemm_core(ta, tb, L, fastmode=False, out_dtype="f32")
    assert got.dtype == torch.float32
    sa, sb = tg.accurate_sfts(ta, tb, L)
    ja, jb = gg.accurate_sfts(f64_to_bits(a), f64_to_bits(b), L)
    if np.array_equal(np.asarray(ja), sa.numpy()) and np.array_equal(
            np.asarray(jb), sb.numpy()):
        np.testing.assert_array_equal(
            _gemm_core_pallas_kinds(a, b, L, "f32").view(np.uint32),
            got.numpy().view(np.uint32))


@pytest.mark.parametrize("dtypes", ["f32-f32", "f32-f64", "f64-f32"])
def test_gemm_accurate_f32_operands_match_jax(dtypes):
    """Accurate mode with f32 operands (refused until the f32 forms of
    emax and mag7 were ported), each operand at its own bias: the JAX
    package's Pallas shifts (under the f32 log2 rule) and words."""
    da, db = (np.float32 if d == "f32" else np.float64
              for d in dtypes.split("-"))
    a = phi_matrix(48, 80, 1.0, seed=5).astype(da)
    b = phi_matrix(80, 40, 1.0, seed=6).astype(db)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    out = "f64" if np.float64 in (da, db) else "f32"
    got = tg.gemm_core(ta, tb, 14, fastmode=False, out_dtype=out).numpy()
    sa, sb = tg.accurate_sfts(ta, tb, 14)
    ja = f64_to_bits(a) if da == np.float64 else jnp.asarray(a)
    jb = f64_to_bits(b) if db == np.float64 else jnp.asarray(b)
    smax_a, smax_b = hm.magmax_matmul(hk.mag7_operand(ta, 1)[0],
                                      hk.mag7_operand(tb, 0)[0])
    ra, rb = gg.accurate_sfts(ja, jb, 14, use_pallas=True)
    n = _assert_shift_rule(ra, sa.numpy(), smax_a, 14)
    n += _assert_shift_rule(rb, sb.numpy(), smax_b, 14)
    if n == 0:
        np.testing.assert_array_equal(
            _gemm_core_pallas_kinds(a, b, 14, out).view(np.uint8),
            got.view(np.uint8))


def _edge32(shape, axis, seed):
    """An f32 (m, n) whose lines along `axis` (1: rows, 0: columns) are:
    subnormals only, zeros, -0.0, partly -0.0, exponents spread over
    2^-120 .. 2^120, values near FLT_MAX, and subnormals inside a normal
    line."""
    m, n = shape if axis == 1 else shape[::-1]
    rng = np.random.default_rng(seed)
    x = phi_matrix(m, n, 2.0, seed=seed).astype(np.float32)
    x[0, :] = rng.integers(1, 1 << 23, n).astype(np.uint32).view(np.float32)
    x[1, :] = 0.0
    x[2, :] = -0.0
    x[3, ::3] = -0.0
    x[4, :] = ((rng.random(n) + 0.5) * rng.choice([-1.0, 1.0], n)
               * 2.0 ** rng.integers(-120, 121, n)).astype(np.float32)
    x[5, ::5] = np.float32(3.3e38)
    x[6, ::4] = np.uint32(3).view(np.float32)
    return x if axis == 1 else np.ascontiguousarray(x.T)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["phi", "edge"])
def test_emax_mag7_f32_match_pallas(axis, kind):
    """The f32 forms: emax over f32 exponents (subnormals count as 1) and
    magnitudes below it at the 24-bit significand, bit-equal to the JAX
    kernels on f32 operands, with a subnormal-only line, zeros, -0.0 and
    values near FLT_MAX."""
    if kind == "phi":
        x = phi_matrix(88, 272, 2.0, seed=7).astype(np.float32)
    else:
        x = _edge32((40, 72), axis, seed=8)
    t = torch.from_numpy(x)
    je = np.asarray(pk.emax_pallas(jnp.asarray(x), axis))
    te = hk.emax(t, axis)
    np.testing.assert_array_equal(je, te.numpy())
    jm = np.asarray(pk.mag7_pallas(jnp.asarray(x), jnp.asarray(je), axis))
    np.testing.assert_array_equal(jm, hk.mag7(t, te, axis).numpy())
    if kind == "edge":   # the widened f64 operand gives other exponents
        assert not np.array_equal(je, hk.emax(t.double(), axis).numpy())


@pytest.mark.parametrize("L", range(2, 21))
def test_accurate_sft_f32_log2_rule(L):
    """accurate_sft at prec 24 (bias 127) against the JAX package's at
    every probe value: equal, or off by 1 at a floor boundary (C3's f32
    log2 rule)."""
    s = _log2_probe_values()
    e = np.full((1, s.size), 127, np.int32)
    smax = s.reshape(1, -1)
    ref = np.asarray(jenc.accurate_sft(jnp.asarray(smax), jnp.asarray(e),
                                       L, 24))
    got = enc.accurate_sft(torch.from_numpy(smax), torch.from_numpy(e), L,
                           mant_bits=24)
    assert got.dtype == torch.int32
    n = _assert_shift_rule(ref, got.numpy(), smax, L)
    assert n < s.size // 1000, f"{n} of {s.size} shifts differ"
    f64 = enc.accurate_sft(torch.from_numpy(smax), torch.from_numpy(e) + 896,
                           L)
    assert torch.equal(got, f64)   # the same shift, 896 bias steps apart
