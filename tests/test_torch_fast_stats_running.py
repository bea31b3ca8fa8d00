"""The fast_sft kernel's column order on the CPU.

`gm8_fast_sft`'s column kernel and the fused kernel's column statistics
(csrc/fast_sft.cu, csrc/fast_encode_fused.cu; the bodies in
csrc/fast_stats.cuh) read each word of a column once: a 2048-row chunk's
16 runs of 128 rows are each summed by one thread in a running exponent
frame, the runs' sums are scaled to the chunk's max and added in thread
order, and the chunks merge in order. `core.encode.fast_stats_running(x,
axis, run, ways)` is the plain twin of that order, at the kernel's
schedule (run 128, ways 16) and at others. It is held to:

  (a) the JAX package's `fast_sft_pallas` in interpret mode, in shift mode
      and with return_stats=True, F64Bits and f32: the max exponent and the
      any flag equal, the shift equal or off by 1 where its floored value
      lies within 1e-4 of an integer (the floor rule: XLA sums the norm in
      another order);
  (b) the order the kernel had before, each reader's words summed relative
      to the chunk's max from the start (the max first, then the norm: two
      reads), bit for bit on every line whose nonzero elements all lie
      within 62 binades of their chunk's max (where no term or sum of
      either order falls below f32's normal range);
  (c) the port's plain `fast_stats` (a torch sum), under the floor rule.

Lines: random; the max last, 40, 70 and 130 binades above the rest, in the
last chunk only; the max 70 binades up in a later chunk than the first
nonzero; subnormals only; +-0, a subnormal, then normals; all zero; a line
rising by 31 binades a chunk; negative with -0.0; large; inf and NaN (f32)
or 2^-1000 (f64). k = 300 (no run width below 300 divides it) and
2 * 2048 + 5 (a ragged last chunk).

Tolerance: bit equality for (b) and for the exponents and flags
everywhere; the floor rule above on the shifts in (a) and (c).
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.types import f64_to_words

from test_torch_threads import one_torch_thread  # noqa: E402, F401

LINES = 12
KDIMS = (300, 2 * tables.STATS_CHUNK + 5)
KERNEL = (128, 16)   # the column kernel's (run, ways)
# (run, ways): the kernel's, runs of 1, 7 and 2048 rows, fewer readers
SCHEDULES = [KERNEL, (1, 16), (7, 16), (2048, 1), (7, 3), (1, 1)]
STATS_BLOCK = (64, tables.STATS_CHUNK)
L_OF = {np.float64: 14, np.float32: 8}
FLOOR_FRAC = 1e-4
WITHIN = 62          # (b): binades under the chunk's max


def _lines(dtype, kdim):
    """LINES lines of kdim elements, one case each."""
    rng = np.random.default_rng(kdim)
    f64 = dtype == np.float64
    tiny = 5e-324 if f64 else np.float32(1e-45)
    phi = (rng.random((LINES, kdim)) - 0.5) * np.exp(
        rng.standard_normal((LINES, kdim)) * 2.0)
    a = phi.astype(dtype)
    for i, d in ((1, 40), (2, 70), (3, 130)):   # the max last, d binades up
        a[i] = a[i] * 2.0 ** -d
        a[i, -1] = 1.5
    a[4] = 0.0                                  # first nonzero in chunk 0,
    a[4, 3:40] = phi[4, 3:40] * 2.0 ** -70      # the max 70 binades up in
    a[4, -3] = -3.0                             # the last chunk
    a[5] = (rng.integers(1, 1 << 20, kdim) * tiny).astype(dtype)
    a[6, :kdim // 2] = 0.0                      # +-0, a subnormal, normals
    a[6, 1:kdim // 2:3] = -0.0
    a[6, kdim // 2] = tiny
    a[7] = 0.0                                  # all zero
    rise = np.exp2((np.arange(kdim) % tables.STATS_CHUNK) // 64)
    a[8] = (np.abs(phi[8]) * rise).astype(dtype)   # 31 binades a chunk
    a[9] = -np.abs(a[9])
    a[9, ::17] = -0.0
    a[10] = a[10] * 2.0 ** (600 if f64 else 60)
    if f64:
        a[11] = a[11] * 2.0 ** -1000
    else:
        a[11, 7] = np.inf                       # an infinity, then a NaN
        a[11, kdim - 10] = np.nan
    return a


def _operand(dtype, kdim, axis):
    """The lines as rows (axis=1) or columns (axis=0) of a C-contiguous
    numpy array."""
    a = _lines(dtype, kdim)
    return a if axis == 1 else np.ascontiguousarray(a.T)


def _shift(stats, kdim, dtype):
    e, s, af = stats
    return enc.sft_from_stats(torch.tensor(np.array(e)).long(),
                              torch.tensor(np.array(s)),
                              torch.tensor(np.array(af) != 0), kdim,
                              L_OF[dtype], 53 if dtype == np.float64 else 24)


def _assert_floor_rule(ref, got, nrm2, kdim, dtype):
    """Shifts equal, or off by 1 where the floored value lies within
    FLOOR_FRAC of an integer."""
    ref, got = np.asarray(ref).astype(np.int64), np.asarray(got)
    diff = ref != got
    if not diff.any():
        return
    frac = enc.sft_floor_frac(nrm2, kdim, L_OF[dtype]).numpy()
    assert np.abs(ref[diff] - got[diff]).max() <= 1
    assert frac.reshape(ref.shape)[diff].max() < FLOOR_FRAC, \
        "shift differs away from a floor boundary"


@functools.lru_cache(maxsize=None)
def _pallas(dtype, kdim, axis):
    """fast_sft_pallas on the operand: (stats, shift) as numpy."""
    x = _operand(dtype, kdim, axis)
    if dtype == np.float64:
        hi, lo = f64_to_words(x)
        arg = F64Bits(jnp.asarray(hi), jnp.asarray(lo))
    else:
        arg = jnp.asarray(x)
    stats = pk.fast_sft_pallas(arg, L_OF[dtype], axis=axis,
                               block=STATS_BLOCK, return_stats=True)
    sft = pk.fast_sft_pallas(arg, L_OF[dtype], axis=axis, block=STATS_BLOCK)
    return tuple(np.asarray(t) for t in stats), np.asarray(sft)


def _two_read(x, axis, run, ways):
    """The order before the running frame: each chunk's max first, then
    each reader's words (dealt as in fast_stats_running) summed relative
    to it, the readers' sums added in order, the chunks merged in order."""
    lines = x if axis == 1 else x.t()
    nlines, kdim = lines.shape
    step = run * ways
    e_acc = torch.zeros((nlines, 1), dtype=torch.int64)
    s_acc = torch.zeros((nlines, 1), dtype=torch.float32)
    af_acc = torch.zeros((nlines, 1), dtype=torch.bool)
    for c0 in range(0, kdim, tables.STATS_CHUNK):
        chunk = lines[:, c0:c0 + tables.STATS_CHUNK]
        nsteps = -(-chunk.shape[1] // step)
        padded = torch.zeros((nlines, nsteps * step), dtype=x.dtype)
        padded[:, :chunk.shape[1]] = chunk
        seq = padded.reshape(nlines, nsteps, ways, run).permute(0, 2, 1, 3)
        pieces, exp, _, nz = enc._fields(seq.reshape(nlines, -1))
        e_blk = torch.where(nz, exp, 0).amax(dim=1, keepdim=True)
        xs = enc._scaled_abs_f32(pieces, exp, e_blk, nz)
        sq = (xs * xs).reshape(nlines, ways, nsteps * run)
        part = torch.zeros((nlines, ways), dtype=torch.float32)
        for t in range(nsteps * run):
            part = part + sq[:, :, t]
        s_blk = torch.zeros((nlines, 1), dtype=torch.float32)
        for w in range(ways):
            s_blk = s_blk + part[:, w:w + 1]
        e_new = torch.maximum(e_acc, e_blk)
        s_acc = (s_acc * enc._pow2_f32(2 * (e_acc - e_new))
                 + s_blk * enc._pow2_f32(2 * (e_blk - e_new)))
        e_acc, af_acc = e_new, af_acc | nz.any(dim=1, keepdim=True)
    if axis == 0:
        return e_acc.t(), s_acc.t(), af_acc.t()
    return e_acc, s_acc, af_acc


def _within(dtype, kdim):
    """Which lines have every nonzero element within WITHIN binades of its
    chunk's max (the exponent as the bodies take it: 1 for subnormals)."""
    x = torch.from_numpy(_lines(dtype, kdim))
    ok = torch.ones(LINES, dtype=torch.bool)
    for c0 in range(0, kdim, tables.STATS_CHUNK):
        _, exp, _, nz = enc._fields(x[:, c0:c0 + tables.STATS_CHUNK])
        hi = torch.where(nz, exp, 0).amax(dim=1)
        lo = torch.where(nz, exp, 1 << 20).amin(dim=1)
        ok &= ~nz.any(dim=1) | (hi - lo <= WITHIN)
    return ok


DTYPES = [np.float64, np.float32]


@pytest.mark.parametrize("schedule", [KERNEL, (7, 3)])
@pytest.mark.parametrize("kdim", KDIMS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_running_order_matches_pallas(dtype, axis, kdim, schedule):
    """(a): exponents and flags equal to fast_sft_pallas(return_stats=
    True); the shift, and the shift taken from the Pallas statistics,
    under the floor rule."""
    (pe, ps, paf), psft = _pallas(dtype, kdim, axis)
    x = torch.from_numpy(_operand(dtype, kdim, axis))
    e, s, af = enc.fast_stats_running(x, axis, *schedule)
    np.testing.assert_array_equal(e.numpy(), pe)
    np.testing.assert_array_equal(af.numpy(), paf > 0)
    got = _shift((e, s, af), kdim, dtype).numpy()
    assert got.shape == psft.shape
    _assert_floor_rule(psft, got, s, kdim, dtype)
    _assert_floor_rule(_shift((pe, ps, paf), kdim, dtype), got, s, kdim,
                       dtype)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kdim", KDIMS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_running_order_is_the_two_read_order(dtype, axis, kdim, schedule):
    """(b): bit for bit where every element lies within 62 binades of its
    chunk's max; exponents and flags on every line."""
    x = torch.from_numpy(_operand(dtype, kdim, axis))
    got = enc.fast_stats_running(x, axis, *schedule)
    want = _two_read(x, axis, *schedule)
    ok = _within(dtype, kdim)
    # the random, subnormal, zero, rising, negative and large lines
    assert bool(ok[[0, 5, 7, 8, 9, 10]].all()) and not bool(ok[[2, 3]].any())
    for g, w in zip(got, want):
        g, w = g.flatten(), w.flatten()
        if g.dtype == torch.float32:
            g, w = g[ok], w[ok]
        assert torch.equal(g.view(torch.int32) if g.is_floating_point()
                           else g,
                           w.view(torch.int32) if w.is_floating_point()
                           else w)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kdim", KDIMS)
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_running_order_matches_plain_stats(dtype, axis, kdim, schedule):
    """(c): exponents and flags equal to the plain fast_stats, the shifts
    under the floor rule."""
    x = torch.from_numpy(_operand(dtype, kdim, axis))
    e, s, af = enc.fast_stats_running(x, axis, *schedule)
    pe, ps, paf = enc.fast_stats(x, axis)
    assert torch.equal(e, pe) and torch.equal(af, paf)
    _assert_floor_rule(_shift((pe, ps, paf), kdim, dtype),
                       _shift((e, s, af), kdim, dtype), s, kdim, dtype)


def test_fast_stats_running_argument_errors():
    x = torch.ones((3, 5))
    with pytest.raises(ValueError):
        enc.fast_stats_running(x, 2)
    with pytest.raises(ValueError):
        enc.fast_stats_running(x, 1, run=0)
    with pytest.raises(ValueError):
        enc.fast_stats_running(x, 1, ways=0)
    with pytest.raises(TypeError):
        enc.fast_stats_running(x.half(), 1)


def test_kernel_schedule_is_the_twins_default():
    """The column body's constants are the twin's kernel schedule: a
    2048-row chunk (STATS_CHUNK) over 16 threads a column, 128 rows each;
    both kernels take their column statistics from that body."""
    src = (build.CSRC / "fast_stats.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kChunk"]) == tables.STATS_CHUNK
    assert int(consts["kColY"]) == KERNEL[1]
    assert "kColRun = kChunk / kColY" in src
    assert tables.STATS_CHUNK // KERNEL[1] == KERNEL[0]
    assert enc.fast_stats_running.__defaults__ == KERNEL
    assert "col_chunk_stats" in (build.CSRC / "fast_sft.cu").read_text()
    assert "col_stats<" in (build.CSRC / "fast_encode_fused.cu").read_text()
