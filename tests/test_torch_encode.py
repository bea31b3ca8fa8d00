"""Shift statistics and residue encode of the port vs the JAX Pallas kernels
(interpret mode on the CPU), on the same bits.

Tolerance: bit equality. The one exception is the fast-mode shift, which
may differ by 1 where its floored value lies within 1e-4 of an integer
(the two packages sum the f32 norm in different orders; see
gemmul8_tpu.core.encode.sft_floor_frac). The JAX stats kernel runs with
its real chunk width (STATS_CHUNK = 2048) so the online merge is compared
like for like; k = 2600 covers a merge of two chunks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.core import encode as jenc
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.types import f64_to_words, words_to_f64

from test_torch_threads import one_torch_thread  # noqa: E402, F401

STATS_BLOCK = (64, tables.STATS_CHUNK)


def _mk(shape, phi, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)
    a.ravel()[::13] = 0.0
    return a


def _edge(shape, seed=5):
    """Zeros, -0.0, a subnormal row (as in tests/test_encode.py:110) and a
    phi = 4 exponent spread."""
    rng = np.random.default_rng(seed)
    a = phi_matrix(shape[0], shape[1], 4.0, seed=seed)
    a[0, :] = rng.random(shape[1]) * 4.9e-324 * rng.integers(
        1, 1 << 40, shape[1]).astype(float)
    a[1, :] = 0.0
    a[2, ::3] = -0.0
    a[3, :] = (rng.random(shape[1]) - 0.5) * 1e-160
    a[:, 1] = 0.0
    return a


def _both(a):
    """The same bits for both packages: (F64Bits, float64 tensor)."""
    hi, lo = f64_to_words(a)
    bits = F64Bits(jnp.asarray(hi), jnp.asarray(lo))
    t = words_to_f64(hi, lo)
    return bits, t


def assert_sft_rule(ref, got, x, axis, L):
    diff = ref != got
    if not diff.any():
        return
    _, nrm2, _ = enc.fast_stats(x, axis)
    frac = enc.sft_floor_frac(nrm2, x.shape[axis], L).numpy()
    assert np.abs(ref[diff].astype(np.int64) - got[diff]).max() <= 1
    assert frac.reshape(ref.shape)[diff].max() < 1e-4, \
        "shift mismatch away from a floor boundary"


def test_word_converters_round_trip():
    a = _edge((6, 9))
    hi, lo = f64_to_words(a)
    t = words_to_f64(hi, lo)
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy().view(np.uint64),
                                  a.view(np.uint64))
    hi2, lo2 = f64_to_words(t)
    np.testing.assert_array_equal(hi, hi2)
    np.testing.assert_array_equal(lo, lo2)


def test_f64_fields_match():
    a = _edge((8, 40))
    bits, t = _both(a)
    jc, je, js, jn = jenc._f64_fields(bits.hi, bits.lo)
    tc, te, ts, tn = enc._f64_fields(t)
    for x, y in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())


@pytest.mark.parametrize("shape", [(96, 160), (40, 2600), (2600, 40)])
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_stats_match_pallas(shape, axis):
    """Max exponent and any-nonzero flag equal; the f32 norm agrees to
    summation-order rounding."""
    bits, t = _both(_mk(shape, 2.0))
    e, s, af = pk.fast_sft_pallas(bits, 14, axis=axis, block=STATS_BLOCK,
                                  return_stats=True)
    te, ts, taf = enc.fast_stats(t, axis)
    np.testing.assert_array_equal(np.asarray(e), te.numpy())
    np.testing.assert_array_equal(np.asarray(af) > 0, taf.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-5)


@pytest.mark.parametrize("shape", [(96, 160), (40, 2600), (2600, 40)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("L", [6, 14, 20])
def test_fast_sft_matches_pallas(shape, axis, L):
    bits, t = _both(_mk(shape, 2.0, seed=L))
    ref = np.asarray(pk.fast_sft_pallas(bits, L, axis=axis,
                                        block=STATS_BLOCK))
    got = hk.fast_sft(t, L, axis)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert_sft_rule(ref, got.numpy(), t, axis, L)


@pytest.mark.parametrize("axis", [0, 1])
def test_fast_sft_edge_values(axis):
    bits, t = _both(_edge((24, 48)))
    ref = np.asarray(pk.fast_sft_pallas(bits, 14, axis=axis,
                                        block=STATS_BLOCK))
    assert_sft_rule(ref, hk.fast_sft(t, 14, axis).numpy(), t, axis, 14)


@pytest.mark.parametrize("L", [6, 14])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["phi", "edge"])
def test_encode_matches_pallas(L, axis, kind):
    """Both packages get the JAX shifts, so the slices must be bit-equal."""
    a = _mk((80, 144), 1.0) if kind == "phi" else _edge((80, 144))
    bits, t = _both(a)
    sft = pk.fast_sft_pallas(bits, L, axis=axis, block=STATS_BLOCK)
    ref = np.asarray(pk.encode_slices_pallas(bits, sft, L, axis=axis,
                                             block=(64, 128)))
    got = hk.encode_slices(t, torch.from_numpy(np.array(sft)), L, axis)
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(ref, got.numpy())


def test_encode_clips_wide_shifts_like_pallas():
    """Shifts far outside what the stats pick: the left shift saturates at
    the static cap and the right shift at 63, as in the JAX package."""
    L = 20
    a = _mk((16, 128), 1.0, seed=9)
    bits, t = _both(a)
    rng = np.random.default_rng(3)
    sft = rng.integers(-1200, 1200, (16, 1)).astype(np.int32)
    ref = np.asarray(pk.encode_slices_pallas(bits, jnp.asarray(sft), L,
                                             axis=1, block=(64, 128)))
    got = hk.encode_slices(t, torch.from_numpy(sft), L, 1)
    np.testing.assert_array_equal(ref, got.numpy())


def test_sft_floor_frac_matches_jax():
    nrm2 = np.array([[0.0], [1.0], [3.7], [1234.5]], np.float32)
    for L in (6, 14, 20):
        ref = np.asarray(jenc.sft_floor_frac(jnp.asarray(nrm2), 300, L))
        got = enc.sft_floor_frac(torch.from_numpy(nrm2), 300, L).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)


# ---- f32 operands ----------------------------------------------------------

def _mk32(shape, phi, seed=0):
    return _mk(shape, phi, seed).astype(np.float32)


def _edge32(shape, seed=5):
    """An f32 matrix with a subnormal-only row (its max exponent 1, its
    norm taken with the implicit bit), subnormals inside a normal row, a
    zero row, -0.0, exponents spread over 2^-120 .. 2^120, values near
    FLT_MAX, and a zero column."""
    rng = np.random.default_rng(seed)
    m, n = shape
    a = _mk32(shape, 2.0, seed)
    a[0, :] = rng.integers(1, 1 << 23, n).astype(np.uint32).view(np.float32)
    a[1, :] = 0.0
    a[2, ::3] = -0.0
    a[3, ::4] = np.uint32(5).view(np.float32)
    a[4, :] = ((rng.random(n) + 0.5) * 2.0 ** rng.integers(-120, 121, n)
               ).astype(np.float32)
    a[5, ::7] = np.float32(3.2e38)
    a[:, 1] = 0.0
    return a


def test_f32_fields_match():
    a = _edge32((8, 40))
    bits = jnp.asarray(a).view(jnp.uint32)
    jc, je, js, jn = jenc._f32_fields(bits)
    tc, te, ts, tn = enc._f32_fields(torch.from_numpy(a))
    assert len(tc) == 2
    for x, y in zip(jc, tc):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    assert bool(tn[0, 0]) and int(te[0].max()) == 1   # subnormals


@pytest.mark.parametrize("shape", [(96, 160), (40, 2600), (2600, 40)])
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_stats_f32_match_pallas(shape, axis):
    """The f32 form of the statistics: max exponent and any flag equal, the
    f32 norm to summation-order rounding (k = 2600: two chunks merged)."""
    x = _mk32(shape, 2.0, seed=1)
    e, s, af = pk.fast_sft_pallas(jnp.asarray(x), 14, axis=axis,
                                  block=STATS_BLOCK, return_stats=True)
    te, ts, taf = enc.fast_stats(torch.from_numpy(x), axis)
    np.testing.assert_array_equal(np.asarray(e), te.numpy())
    np.testing.assert_array_equal(np.asarray(af) > 0, taf.numpy())
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-5)


@pytest.mark.parametrize("shape", [(96, 160), (40, 2600), (2600, 40)])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("L", [2, 8, 19])
def test_fast_sft_f32_matches_pallas(shape, axis, L):
    """The f32 shift (bias 127, 24-bit significand) against
    fast_sft_pallas on the f32 array."""
    x = _mk32(shape, 2.0, seed=L)
    t = torch.from_numpy(x)
    ref = np.asarray(pk.fast_sft_pallas(jnp.asarray(x), L, axis=axis,
                                        block=STATS_BLOCK))
    got = hk.fast_sft(t, L, axis)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert_sft_rule(ref, got.numpy(), t, axis, L)


@pytest.mark.parametrize("axis", [0, 1])
def test_fast_sft_f32_edge_values(axis):
    """Subnormal-only, zero and FLT_MAX lines: the JAX package's f32
    shifts, which differ from the shifts of the operand widened to f64
    (the widening shortcut is not the f32 form)."""
    x = _edge32((24, 48))
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    t = torch.from_numpy(x)
    ref = np.asarray(pk.fast_sft_pallas(jnp.asarray(x), 8, axis=axis,
                                        block=STATS_BLOCK))
    got = hk.fast_sft(t, 8, axis).numpy()
    assert_sft_rule(ref, got, t, axis, 8)
    line = (slice(0, 1), slice(None)) if axis == 1 else \
        (slice(None), slice(0, 1))
    assert got[line].item() != hk.fast_sft(t.double(), 8, axis)[line].item()


@pytest.mark.parametrize("L", [6, 14, 19])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["phi", "edge"])
def test_encode_f32_matches_pallas(L, axis, kind):
    """The f32 form of the encode on the JAX shifts: bit-equal slices."""
    x = _mk32((80, 144), 1.0) if kind == "phi" else _edge32((80, 144))
    sft = pk.fast_sft_pallas(jnp.asarray(x), L, axis=axis, block=STATS_BLOCK)
    ref = np.asarray(pk.encode_slices_pallas(jnp.asarray(x), sft, L,
                                             axis=axis, block=(64, 128)))
    got = hk.encode_slices(torch.from_numpy(x),
                           torch.from_numpy(np.array(sft)), L, axis)
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("L", [8, 15, 17, 20])
def test_encode_f32_wide_shifts_like_jax(L):
    """Shifts that reach the f32 left-shift cap (T_accu - 24: 34 to 53
    bits from 15 moduli on, a whole-word shift and an in-word one) and
    beyond it, and far right shifts: the JAX encode's slices."""
    x = _edge32((32, 128), seed=L)
    rng = np.random.default_rng(L)
    sft = rng.integers(-200, 260, (32, 1)).astype(np.int32)
    sft[:8, 0] = 150 - np.arange(8) + enc.q_max(L, 24)  # q at the cap
    ref = np.asarray(pk.encode_slices_pallas(jnp.asarray(x),
                                             jnp.asarray(sft), L, axis=1,
                                             block=(64, 128)))
    np.testing.assert_array_equal(
        ref, np.asarray(jenc.encode_accurate_f32(jnp.asarray(x),
                                                 jnp.asarray(sft), L)))
    got = hk.encode_slices(torch.from_numpy(x), torch.from_numpy(sft), L, 1)
    np.testing.assert_array_equal(ref, got.numpy())


def test_encode_f32_moduli_idx_and_col_tiles():
    """The f32 form with a subset of the moduli (a chunk, a tuple out of
    order) and with a range of columns, as the JAX kernel writes them."""
    L = 14
    x = _edge32((64, 1200), seed=3)
    sft = pk.fast_sft_pallas(jnp.asarray(x), L, axis=1, block=STATS_BLOCK)
    t, ts = torch.from_numpy(x), torch.from_numpy(np.array(sft))
    for idx in ((5, 6, 7, 8, 9), (13, 0, 7)):
        ref = np.asarray(pk.encode_slices_pallas(
            jnp.asarray(x), sft, L, axis=1, moduli_idx=idx,
            block=enc.ENC_BLOCK))
        np.testing.assert_array_equal(
            ref, hk.encode_slices(t, ts, L, 1, moduli_idx=idx).numpy())
    for tiles in ((0, 1), (1, 3)):
        ref = np.asarray(pk.encode_slices_pallas(
            jnp.asarray(x), sft, L, axis=1, block=enc.ENC_BLOCK,
            col_tiles=tiles))
        c0, c1 = enc.col_range(tiles, x.shape[1])
        got = hk.encode_slices(t, ts, L, 1, col_tiles=tiles).numpy()
        np.testing.assert_array_equal(ref[:, :, c0:c1], got[:, :, c0:c1])
