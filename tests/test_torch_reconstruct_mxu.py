"""The reconstruct kernel's plain version vs the JAX package, on the same
bits.

`core.reconstruct.reconstruct_mxu` forms the CRT sum as csrc/reconstruct.cu
does: the centred residues contracted with the compact digit table of
`crt_mxu_weights` (`accumulate_mxu`, through the JAX package's
`crt_accumulate_mxu` with bm = 1), then the exact tail. It is held bit for
bit to the JAX package's `reconstruct_pallas(..., mxu=True)` (interpret
mode, also with `tail_chunk`) and to the port's `reconstruct` (the limb
sums of `accumulate_weighted`), for int8-centred, uint8 and raw int32
inputs and f64 and f32 output, 2 to 20 moduli, on random residues and on
sums built to hit the rounding branches. The kernel's own tail estimates
the quotient in f64, rounded to nearest: the bound its fast path rests on
is checked on sums next to every half-integer multiple of M.

Tolerance: bit equality.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import bits_to_f64
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import limbs as lb
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.hopper import kernels as hk

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def _inputs(r: np.ndarray, kind: str, seed: int = 0) -> np.ndarray:
    """Canonical residues (L, m, n) -> the matmul output form under test;
    "products": raw int32 slice products holding them, negative ones too."""
    if kind == "i8":
        return (r.astype(np.int32) - 128).astype(np.int8)
    if kind == "u8":
        return r.astype(np.uint8)
    mods = np.array(tables.MODULI[:r.shape[0]], np.int64)[:, None, None]
    k = np.random.default_rng(seed).integers(-8000, 8000, r.shape)
    return (r + mods * k).astype(np.int32)


def _residues(L, shape, seed):
    rng = np.random.default_rng(seed)
    r = np.stack([rng.integers(0, tables.MODULI[j], shape)
                  for j in range(L)])
    r[:, 0, 0] = 0                                    # X = 0
    r[:, 0, 1] = np.array(tables.MODULI[:L]) - 1      # X = M - 1: -1
    return r


def _words(c):
    a = np.asarray(c)
    return a.view(np.uint64 if a.dtype == np.float64 else np.uint32)


@pytest.mark.parametrize("out", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["i8", "u8", "products"])
@pytest.mark.parametrize("L", [2, 14, 20])
def test_reconstruct_mxu_matches_jax_mxu(L, kind, out):
    r = _residues(L, (16, 64), seed=L)
    x = _inputs(r, kind, seed=L)
    rng = np.random.default_rng(40 + L)
    sa = rng.integers(-40, 40, (16, 1)).astype(np.int32)
    sb = rng.integers(-40, 40, (1, 64)).astype(np.int32)
    ref = pk.reconstruct_pallas(jnp.asarray(x), jnp.asarray(sa),
                                jnp.asarray(sb), L, out, block=(16, 64),
                                mxu=True)
    ref = bits_to_f64(ref, to_numpy=True) if out == "f64" else ref
    args = (torch.from_numpy(x), torch.from_numpy(sa), torch.from_numpy(sb),
            L, out)
    got = rec.reconstruct_mxu(*args)
    np.testing.assert_array_equal(_words(ref), _words(got))
    np.testing.assert_array_equal(_words(rec.reconstruct(*args)),
                                  _words(got))


def test_reconstruct_mxu_tail_chunk():
    """The JAX kernel's column-strip tail gives the same words."""
    L = 14
    r = _residues(L, (16, 64), seed=3)
    x = _inputs(r, "i8")
    sa = np.full((16, 1), 7, np.int32)
    sb = np.arange(64, dtype=np.int32).reshape(1, 64) - 30
    ref = pk.reconstruct_pallas(jnp.asarray(x), jnp.asarray(sa),
                                jnp.asarray(sb), L, "f64", block=(16, 64),
                                mxu=True, tail_chunk=32)
    got = rec.reconstruct_mxu(torch.from_numpy(x), torch.from_numpy(sa),
                              torch.from_numpy(sb), L)
    np.testing.assert_array_equal(
        bits_to_f64(ref, to_numpy=True).view(np.uint64),
        got.numpy().view(np.uint64))


@pytest.mark.parametrize("L", [2, 8, 14, 15, 20])
def test_accumulate_mxu_is_the_weighted_sum(L):
    """The contraction's redundant limbs: each in [0, 2^29), and with one
    carry pass the canonical limbs of accumulate_weighted, for every
    input kind."""
    r = _residues(L, (8, 40), seed=L)
    want = rec.accumulate_weighted(torch.from_numpy(r), L)
    for kind in ("i8", "u8", "products"):
        limbs = rec.accumulate_mxu(torch.from_numpy(_inputs(r, kind)), L)
        assert len(limbs) == tables.num_limbs(L)
        for x in limbs:
            assert int(x.min()) >= 0 and int(x.max()) < 1 << 29
        for a, b in zip(lb.carry_propagate(limbs), want):
            assert torch.equal(a, b)


def _sums_residues(vals, L):
    r = np.zeros((L, 1, len(vals)), np.int64)
    for i, v in enumerate(vals):
        for j in range(L):
            r[j, 0, i] = v % tables.MODULI[j]
    return r


@pytest.mark.parametrize("out", ["f64", "f32"])
@pytest.mark.parametrize("L", [8, 14, 20])
def test_reconstruct_mxu_rounding_branches(L, out):
    """Centred values at ties, at the subnormal and overflow edges and at
    +-M/2: the kernel route's words are reconstruct's."""
    mm = tables.big_m(L)
    mant = 53 if out == "f64" else 24
    vals = [0, 1, -1, mm // 2, -(mm // 2) + 1, (1 << mant) + 1,
            -((1 << mant) + 1), (1 << (mant + 1)) + 3, (3 << mant) - 1,
            mm // 2 - 1, -(mm // 3)]
    r = _sums_residues(vals, L)
    for e_extra in (0, -1074 - mant, 1023, -1100, -150):
        for kind in ("i8", "u8", "products"):
            x = torch.from_numpy(_inputs(r, kind))
            sa = torch.zeros((1, 1), dtype=torch.int32)
            sb = torch.zeros((1, len(vals)), dtype=torch.int32)
            np.testing.assert_array_equal(
                _words(rec.reconstruct(x, sa, sb, L, out, e_extra)),
                _words(rec.reconstruct_mxu(x, sa, sb, L, out, e_extra)))


def test_crt_mma_table_layout():
    """The digit table the kernel reads: wc zero-padded to 24 x 32, CL
    and nd; the digits rebuild every CRT weight."""
    for L in (2, 14, 20):
        t = hk.crt_mma_table(L)
        assert t.nbytes == 24 * 32 + 16 * 4
        w = t[:768].view(np.int8).reshape(24, 32).astype(np.int64)
        tail = t[768:].view(np.int32)
        nl = tables.num_limbs(L)
        assert tail[12] == 2 * nl and not tail[nl:12].any()
        assert (w[2 * nl, :L] == 1).all() and not w[2 * nl + 1:].any()
        assert not w[:, L:].any()
        for j, wj in enumerate(tables.crt_weights(L)):
            digits = sum(int(w[d, j] + 128) << (8 * d) for d in range(2 * nl))
            assert digits == wj


def _estimate(x: int, L: int) -> float:
    """The kernel tail's quotient estimate (crt_tail.cuh center_rn): X's
    64-bit word pairs from the top, each converted to f64 (rounded to
    nearest), the sum scaled by 2^64 (exact) and added (rounded), times
    the table's 1 / M (correctly rounded)."""
    xd = 0.0
    for w in range(2 if L <= 14 else 4, -1, -2):
        xd = xd * 2.0 ** 64 + float((x >> (32 * w)) & (2 ** 64 - 1))
    return xd * (1 / tables.big_m(L))


@pytest.mark.parametrize("L", range(2, 21))
def test_tail_quotient_estimate_bound(L):
    """center_rn trusts t = rint(q) without a compare wherever |q - t| <
    1/2 - 2^-30; that rests on |q - X / M| <= 2^-37 for every sum of
    residues (X < 256 L M). Checked at every half-integer multiple of M
    the sums reach, a few units either side, and at random sums."""
    mm = tables.big_m(L)
    rng = np.random.default_rng(L)
    xs = []
    for t in range(0, 256 * L):
        base = (2 * t + 1) * mm // 2
        xs += [base + d for d in (-2, -1, 0, 1, 2) if base + d >= 0]
    xs += [(int(rng.integers(0, 1 << 62)) * 256 * L * mm) >> 62
           for _ in range(200)]
    for x in xs:
        if x >= 256 * L * mm:
            continue
        err = abs(Fraction(_estimate(x, L)) - Fraction(x, mm))
        assert err <= Fraction(1, 1 << 37), (L, x)
