"""CRT reconstruct of the port vs the JAX Pallas kernel (interpret mode) on
the same residues and shifts, for int8-centered (r - 128) and uint8 inputs.
Tolerance: bit equality of the f64 words (and of the f32 words for the
plain version's f32 branch). Includes the tie, subnormal and overflow
vectors of tests/test_reconstruct.py.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.core import reconstruct as jrec
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import bits_to_f64
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import limbs as lb
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.hopper import kernels as hk

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def _as_input(r: np.ndarray, kind: str) -> np.ndarray:
    """Canonical residues -> the matmul output form under test."""
    if kind == "i8":
        return (r.astype(np.int32) - 128).astype(np.int8)
    return r.astype(np.uint8)


def _both(r, sft_a, sft_b, L, kind="i8"):
    x = _as_input(r, kind)
    ref = pk.reconstruct_pallas(jnp.asarray(x), jnp.asarray(sft_a),
                                jnp.asarray(sft_b), L, "f64",
                                block=(16, 64))
    ref = bits_to_f64(ref, to_numpy=True)
    got = hk.reconstruct(torch.from_numpy(x), torch.from_numpy(sft_a),
                         torch.from_numpy(sft_b), L)
    assert got.dtype == torch.float64
    return ref, got.numpy()


def _residues_of(vals, L):
    r = np.zeros((L, 1, len(vals)), np.int64)
    for i, x in enumerate(vals):
        for j in range(L):
            r[j, 0, i] = x % tables.MODULI[j]
    return r


@pytest.mark.parametrize("L", [2, 8, 14, 20])
@pytest.mark.parametrize("kind", ["i8", "u8"])
def test_reconstruct_matches_pallas(L, kind):
    rng = np.random.default_rng(2 + L)
    r = np.stack([rng.integers(0, tables.MODULI[j], (48, 64))
                  for j in range(L)])
    sft_a = rng.integers(-40, 40, (48, 1)).astype(np.int32)
    sft_b = rng.integers(-40, 40, (1, 64)).astype(np.int32)
    ref, got = _both(r, sft_a, sft_b, L, kind)
    np.testing.assert_array_equal(ref.view(np.uint64), got.view(np.uint64))


@pytest.mark.parametrize("kind", ["i8", "u8"])
def test_reconstruct_tie_boundaries(kind):
    """Exact ties both ways, ties broken by a far sticky bit, a tie in the
    subnormal range (tests/test_reconstruct.py:80)."""
    L = 14
    vals = [(2 ** 53 + 1, 0), (2 ** 53 + 3, 0), ((2 ** 54 + 2) * 3, -1),
            (2 ** 54 + 2 + 1, 0), ((2 ** 53 + 1) * 2 ** 40 + 1, -40),
            (2 ** 53, 7), (2 ** 53 - 1, -9), ((2 ** 53 + 1) * 2 ** 50, -1100),
            (-(2 ** 53 + 1), 13)]
    r = _residues_of([x for x, _ in vals], L)
    sft_b = -np.array([e for _, e in vals], np.int32).reshape(1, -1)
    ref, got = _both(r, np.zeros((1, 1), np.int32), sft_b, L, kind)
    np.testing.assert_array_equal(ref.view(np.uint64), got.view(np.uint64))
    for i, (x, e) in enumerate(vals):
        assert got[0, i] == float(Fraction(x) * Fraction(2) ** e)


@pytest.mark.parametrize("kind", ["i8", "u8"])
def test_reconstruct_subnormal_and_overflow(kind):
    """tests/test_reconstruct.py:151: subnormal results, underflow to
    zero, overflow to inf; also a subnormal tie rounding up into the
    smallest normal, the largest finite value, and a tie rounding up past
    it into inf."""
    L = 8
    mm = tables.big_m(L)
    vals = [(3, -1080), (12345, -1100), (1, -1074), (1, -1075),
            (mm // 2 - 1, 1200), (7, 1020), (-5, -1076),
            (2 ** 53 - 1, -1075), (-(2 ** 53 - 1), -1075),
            (2 ** 53 - 1, 971), (2 ** 54 - 1, 970), (-(2 ** 54 - 1), 970)]
    r = _residues_of([x for x, _ in vals], L)
    sft_b = -np.array([e for _, e in vals], np.int32).reshape(1, -1)
    ref, got = _both(r, np.zeros((1, 1), np.int32), sft_b, L, kind)
    np.testing.assert_array_equal(ref.view(np.uint64), got.view(np.uint64))
    for i, (x, e) in enumerate(vals):
        v = Fraction(x) * Fraction(2) ** e
        expect = float(v) if abs(v) < 2 ** 1024 - 2 ** 970 else \
            float("inf") * (1 if x > 0 else -1)
        assert got[0, i] == expect


def test_reconstruct_e_extra_folds_like_jax():
    L = 14
    rng = np.random.default_rng(7)
    r = np.stack([rng.integers(0, tables.MODULI[j], (8, 16))
                  for j in range(L)])
    sa = rng.integers(-20, 20, (8, 1)).astype(np.int32)
    sb = rng.integers(-20, 20, (1, 16)).astype(np.int32)
    for e_extra in (-3, 5):
        ref = pk.reconstruct_pallas(jnp.asarray(_as_input(r, "i8")),
                                    jnp.asarray(sa), jnp.asarray(sb), L,
                                    "f64", block=(16, 64), e_extra=e_extra)
        got = hk.reconstruct(torch.from_numpy(_as_input(r, "i8")),
                             torch.from_numpy(sa), torch.from_numpy(sb), L,
                             e_extra=e_extra).numpy()
        np.testing.assert_array_equal(
            bits_to_f64(ref, to_numpy=True).view(np.uint64),
            got.view(np.uint64))


@pytest.mark.parametrize("L", [6, 15])
def test_plain_f32_branch_matches_jax(L):
    rng = np.random.default_rng(L)
    r = np.stack([rng.integers(0, tables.MODULI[j], (8, 16))
                  for j in range(L)]).astype(np.int32)
    sa = rng.integers(-60, 60, (8, 1)).astype(np.int32)
    sb = rng.integers(-60, 60, (1, 16)).astype(np.int32)
    ref = np.asarray(jrec.reconstruct(jnp.asarray(r), jnp.asarray(sa),
                                      jnp.asarray(sb), L, "f32"))
    got = hk.reconstruct(torch.from_numpy(r), torch.from_numpy(sa),
                         torch.from_numpy(sb), L, "f32").numpy()
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_limb_helpers_match_python_ints():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(0, 1 << 62, 64)] + [0, 1, 1 << 63]
    limbs = [torch.tensor([(v >> (16 * i)) & 0xFFFF for v in vals])
             for i in range(5)]
    p = lb.msb_position(limbs)
    assert p.tolist() == [v.bit_length() - 1 for v in vals]
    u = torch.tensor([int(x) for x in rng.integers(0, 81, len(vals))])
    out, rbit, sticky = lb.shift_right_round(limbs, u, 4)
    for i, v in enumerate(vals):
        s = int(u[i])
        got = sum(int(out[j][i]) << (16 * j) for j in range(4))
        assert got == (v >> s) & ((1 << 64) - 1)
        assert int(rbit[i]) == ((v >> (s - 1)) & 1 if s else 0)
        assert bool(sticky[i]) == (s > 1 and v & ((1 << (s - 1)) - 1) != 0)
        assert bool(lb.dropped_nonzero(limbs, u)[i]) == (
            v & ((1 << s) - 1) != 0)
    shifted = lb.shift_right(limbs, u, 4)
    assert all(torch.equal(x, y) for x, y in zip(shifted, out))
    c = [torch.full_like(limbs[0], int(x)) for x in (0x1234, 0xFFFF, 7, 0, 0)]
    big = sum(int(x[0]) << (16 * i) for i, x in enumerate(c))
    diff, borrow = lb.sub(limbs, c)
    for i, v in enumerate(vals):
        want = (v - big) % (1 << 80)
        assert sum(int(diff[j][i]) << (16 * j) for j in range(5)) == want
        assert int(borrow[i]) == (0 if v >= big else -1)


def test_reconstruct_argument_checks():
    r = torch.zeros((4, 3, 5), dtype=torch.int8)
    sa = torch.zeros((3, 1), dtype=torch.int32)
    sb = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        hk.reconstruct(r, sa, sb, 5)
    with pytest.raises(ValueError):
        hk.reconstruct(r, sb, sa, 4)
    with pytest.raises(ValueError):
        hk.reconstruct(r.to("meta"), sa, sb, 4)


# ---- f32 output --------------------------------------------------------------

def exact_f32(x: int, e: int) -> float:
    """x * 2^e rounded once to nearest even into f32 (subnormals, overflow
    to inf), from Python integers."""
    v = Fraction(x) * Fraction(2) ** e
    if v == 0:
        return 0.0
    a = abs(v)
    p = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** p > a:
        p -= 1                              # 2^p <= a < 2^(p+1)
    q = max(p, -126) - 23                   # the f32 step at a
    n = round(a / Fraction(2) ** q)         # round half to even
    r = n * Fraction(2) ** q
    if r >= 2 ** 128:
        return float("inf") if x > 0 else float("-inf")
    return float(r) if x > 0 else -float(r)


# (x, e): f32 ties and one away on each side, a far sticky bit, integers
# where rounding to f64 first and then to f32 would round twice, f32
# subnormals (a tie rounding up into the smallest normal among them),
# underflow to 0, the largest finite value and overflow to inf
F32_VALUES = [
    (2 ** 25 + 2, 0), (2 ** 25 + 1, 0), (2 ** 25 + 3, 0), (2 ** 25 + 6, 0),
    (2 ** 24 + 1, 0), (2 ** 24 + 3, 0), (-(2 ** 24 + 1), 5),
    ((2 ** 24 + 1) * 2 ** 40 + 1, -40),
    (2 ** 53 + 2 ** 29 + 1, -30), (2 ** 53 + 2 ** 29, -30),
    (2 ** 53 + 2 ** 29 - 1, -30), (-(2 ** 53 + 2 ** 29 + 1), 7),
    (3, -151), (1, -150), (3, -150), (12345, -160), (1, -149), (-5, -151),
    (1, -152), (2 ** 24 - 1, -150), (-(2 ** 24 - 1), -150),
    (2 ** 24 - 1, 104), (2 ** 25 - 1, 103), (7, 126), (1, 127),
    (2 ** 60, 100), (-(2 ** 25 - 1), 103)]


def test_exact_f32_oracle():
    """The oracle against numpy's own f64 -> f32 rounding where the value
    is an f64 (one rounding), and at the double-rounding trap."""
    for x, e in [(2 ** 24 + 1, 0), (3, -151), (2 ** 25 - 1, 103)]:
        with np.errstate(over="ignore"):
            assert exact_f32(x, e) == float(np.float32(x * 2.0 ** e))
    assert exact_f32(2 ** 53 + 2 ** 29 + 1, 0) == 2.0 ** 53 + 2.0 ** 30
    assert float(np.float32(float(2 ** 53 + 2 ** 29 + 1))) == 2.0 ** 53


@pytest.mark.parametrize("L", [2, 8, 14, 20])
@pytest.mark.parametrize("kind", ["i8", "u8"])
def test_reconstruct_f32_matches_pallas(L, kind):
    """f32 output against reconstruct_pallas(out_kind="f32")."""
    rng = np.random.default_rng(20 + L)
    r = np.stack([rng.integers(0, tables.MODULI[j], (48, 64))
                  for j in range(L)])
    sa = rng.integers(-40, 40, (48, 1)).astype(np.int32)
    sb = rng.integers(-40, 40, (1, 64)).astype(np.int32)
    x = _as_input(r, kind)
    ref = np.asarray(pk.reconstruct_pallas(jnp.asarray(x), jnp.asarray(sa),
                                           jnp.asarray(sb), L, "f32",
                                           block=(16, 64)))
    got = hk.reconstruct(torch.from_numpy(x), torch.from_numpy(sa),
                         torch.from_numpy(sb), L, "f32")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(ref.view(np.uint32),
                                  got.numpy().view(np.uint32))


@pytest.mark.parametrize("L", [8, 14])
@pytest.mark.parametrize("input_kind", ["i8", "u8", "products", "limbs"])
def test_reconstruct_f32_rounding_once(L, input_kind):
    """F32_VALUES from every input kind (raw int32 products holding a
    residue plus a multiple of its modulus, 16-bit limbs with a carry
    pushed back into a lower limb): the exactly rounded f32 values, and
    reconstruct_pallas' f32 words. (Values past M/2 are left out.)"""
    vals = [(v, e) for v, e in F32_VALUES if abs(v) < tables.big_m(L) // 2]
    r = _residues_of([v for v, _ in vals], L)
    sa = np.zeros((1, 1), np.int32)
    sb = -np.array([e for _, e in vals], np.int32).reshape(1, -1)
    if input_kind in ("i8", "u8"):
        x, jkind = _as_input(r, input_kind), "residues"
    elif input_kind == "products":
        mods = np.array(tables.MODULI[:L]).reshape(L, 1, 1)
        mult = (np.arange(r.shape[2]).reshape(1, 1, -1) * 7919) % 2001 - 1000
        x, jkind = (r + mods * mult).astype(np.int32), "residues"
    else:
        limbs = torch.stack(rec.accumulate_weighted(torch.from_numpy(r), L))
        back = limbs[1] > 0   # a carry pushed back into limb 0
        limbs[1][back] -= 1
        limbs[0][back] += 1 << 16
        x, jkind = limbs.to(torch.int32).numpy(), "limbs"
    got = hk.reconstruct(torch.from_numpy(x), torch.from_numpy(sa),
                         torch.from_numpy(sb), L, "f32",
                         input_kind="limbs" if jkind == "limbs"
                         else "residues").numpy()
    want = np.array([[exact_f32(v, e) for v, e in vals]], np.float32)
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    if jkind == "limbs":   # the JAX limb input takes canonical limbs
        x = torch.stack(rec.accumulate_weighted(torch.from_numpy(r), L)).to(
            torch.int32).numpy()
    ref = np.asarray(pk.reconstruct_pallas(jnp.asarray(x), jnp.asarray(sa),
                                           jnp.asarray(sb), L, "f32",
                                           input_kind=jkind))
    np.testing.assert_array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_reconstruct_f32_argument_checks():
    r = torch.zeros((4, 3, 5), dtype=torch.int8)
    sa = torch.zeros((3, 1), dtype=torch.int32)
    sb = torch.zeros((1, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="out_dtype"):
        hk.reconstruct(r, sa, sb, 4, "f16")
    with pytest.raises(ValueError, match="f64 output"):
        hk.reconstruct(r, sa, sb, 4, "f32",
                       out=torch.zeros((3, 5), dtype=torch.float64))
