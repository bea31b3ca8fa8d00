"""The encode kernel's plain version vs the JAX package, on the same bits.

`core.encode.encode_slices_mxu` runs the arithmetic of csrc/encode.cu: the
shifted value's 80-bit two's complement as 10 byte planes and a sign plane,
their dot with each slot's signed weights (`encode_mxu_weights`), and one
multiply-and-shift reduction to the centred residue. It is held bit for bit
to the JAX package's `encode_slices_pallas(..., mxu=True)` (its byte-plane
MXU body, interpret mode) and to the port's `encode_slices` (one remainder
chain per modulus): f64 and f32 words, both axes, prefix, range and slots
moduli sets, a column range, zeros, -0.0, subnormals and negative values
truncated to 0, shifts at the left-shift cap. The reduction is checked on
every accumulator value it can meet.

Tolerance: bit equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.types import f64_to_words

from test_torch_threads import one_torch_thread  # noqa: E402, F401

STATS_BLOCK = (64, tables.STATS_CHUNK)


def _edge(shape, dtype, seed=0):
    """phi = 3 values with zeros, -0.0, subnormals and tiny negatives that
    the row's shift truncates to 0 (their sign must leave no trace)."""
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * 3.0)
    a = a.astype(dtype)
    tiny = np.finfo(dtype).smallest_subnormal
    a[0, :] = rng.integers(1, 1 << 20, shape[1]) * tiny
    a[1, :] = 0.0
    a[2, ::3] = -0.0
    a[3, ::2] = -tiny
    a[4, :] = -np.finfo(dtype).tiny * rng.random(shape[1])
    a[4, 0] = 1.0e4   # the row's shift then truncates the rest to 0
    a[:, 1] = 0.0
    return a


def _jax(x):
    if x.dtype == np.float64:
        hi, lo = f64_to_words(x)
        return F64Bits(jnp.asarray(hi), jnp.asarray(lo))
    return jnp.asarray(x)


def _check(x, sft, L, axis, **kw):
    """The plain version against the JAX MXU encode and encode_slices."""
    t, ts = torch.from_numpy(x), torch.from_numpy(np.array(sft))
    got = enc.encode_slices_mxu(t, ts, L, axis, **kw)
    mxu = "col_tiles" not in kw   # the JAX column range takes its VPU body
    ref = np.asarray(pk.encode_slices_pallas(_jax(x), jnp.asarray(sft), L,
                                             axis=axis, mxu=mxu, **kw))
    want = enc.encode_slices(t, ts, L, axis, **kw)
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape
    if "col_tiles" in kw:
        c0, c1 = enc.col_range(kw["col_tiles"], x.shape[1])
        ref, got, want = (v[:, :, c0:c1] for v in (ref, got, want))
    np.testing.assert_array_equal(ref, np.asarray(got))
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("L", [2, 14, 20])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_encode_mxu_matches_jax_mxu(dtype, axis, L):
    x = _edge((40, 64), dtype, seed=L)
    sft = pk.fast_sft_pallas(_jax(x), L, axis=axis, block=STATS_BLOCK)
    got = _check(x, sft, L, axis)
    if axis == 1:   # the truncated negatives of row 4 encode as 0
        assert not got[:, 4, 1:].any()


@pytest.mark.parametrize("idx", [(0, 1, 2, 3, 4), (3, 4, 5, 6, 7, 8, 9),
                                 (13, 0, 7), (19, 2, 11, 16)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_encode_mxu_moduli_sets(dtype, idx):
    """Prefix, range and slots sets: the slots are rows of the weight
    table, so every form is one contraction."""
    L = 20 if max(idx) >= 14 else 14
    x = _edge((24, 48), dtype, seed=5)
    sft = pk.fast_sft_pallas(_jax(x), L, axis=1, block=STATS_BLOCK)
    _check(x, sft, L, 1, moduli_idx=idx)


@pytest.mark.parametrize("tiles", [(0, 1), (1, 3)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_encode_mxu_column_range(dtype, tiles):
    L = 14
    x = _edge((8, 1100), dtype, seed=7)
    sft = pk.fast_sft_pallas(_jax(x), L, axis=0, block=STATS_BLOCK)
    _check(x, sft, L, 0, col_tiles=tiles)


@pytest.mark.parametrize("L", [2, 15, 20])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_encode_mxu_wide_shifts(dtype, L):
    """Shifts at and beyond the left-shift cap (24 bits f64, up to 53
    f32: the value's 77 bits fill 10 planes) and far right shifts."""
    mant = 53 if dtype == np.float64 else 24
    x = _edge((16, 48), dtype, seed=L)
    rng = np.random.default_rng(L)
    sft = rng.integers(-300, 300, (16, 1)).astype(np.int32)
    bias = 1075 if mant == 53 else 150
    sft[:6, 0] = bias - np.arange(6) + enc.q_max(L, mant)   # at the cap
    _check(x, sft, L, 1)


def test_encode_mxu_weights():
    """Each slot's weights are the centred representatives of 2^(8i) and
    of -2^80 mod m (1, 0, ..., 0 for 256), so |raw| < 2^19; off, h and
    mul as the kernel's table holds them."""
    idx = tuple(range(tables.MAX_MODULI))
    k = enc.encode_mxu_weights(idx)
    for jj, m in enumerate(tables.MODULI):
        w = k["w"][jj]
        assert np.abs(w).max() <= 127
        for i in range(enc.ENC_BYTES):
            assert (int(w[i]) - pow(2, 8 * i, m)) % m == 0
        assert (int(w[enc.ENC_BYTES]) + (1 << 80)) % m == 0
        assert 255 * np.abs(w).sum() < 1 << 19
        assert k["off"][jj] % m == 0 and k["off"][jj] >= 1 << 19
    assert list(k["w"][0]) == [1] + [0] * (enc.ENC_PLANES - 1)
    table = hk.encode_mma_table((13, 0))
    assert table.nbytes == 1024
    w = table[:512].view(np.int8).reshape(32, 16)
    np.testing.assert_array_equal(w[0, :11], enc.encode_mxu_weights((13,))
                                  ["w"][0])
    assert not w[2:].any() and not w[:, 11:].any()
    mul, hmul, off, m = table[512:].view(np.uint32).reshape(4, 32)
    assert list(m[:3]) == [tables.MODULI[13], 256, 0]
    assert hmul[0] == (m[0] - 1) // 2 * mul[0] and mul[1] == 1 << 24


def test_encode_mxu_reduction_exhaustive():
    """The multiply-and-shift reduction on every accumulator it can meet
    (|raw| < 2^19): the centred residue for odd m, raw's low byte for
    256, as the kernel computes it in uint32 arithmetic."""
    raw = np.arange(-(1 << 19), 1 << 19, dtype=np.int64)
    k = enc.encode_mxu_weights(tuple(range(tables.MAX_MODULI)))
    for jj, m in enumerate(tables.MODULI):
        t = raw + k["off"][jj]
        q = ((t + k["h"][jj]) * k["mul"][jj]) >> 32
        r = t - q * m
        if m == 256:
            assert np.array_equal(r & 0xFF, raw & 0xFF)
            continue
        want = raw - m * np.floor_divide(raw + m // 2, m)
        assert np.array_equal(r, want), m
        assert np.abs(r).max() <= (m - 1) // 2
