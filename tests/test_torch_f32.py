"""The real front end of the port vs the JAX package: f32 and mixed
operands, f64 or f32 output, op N/T/C, alpha/beta, on the same bits.

gemmul8_tpu_torch.gemm on CPU tensors runs every kernel's plain version
(the f32 forms of fast_sft, encode_slices, emax, mag7 and reconstruct among
them); for every combination of operand dtypes (float64, float32, float16
and bfloat16 widened to float32), output dtype, mode and op it must give
the words of gemmul8_tpu.gemm on the CPU. Inputs come from a numpy seed.

Tolerance: bit equality, with two documented exceptions.
- A fast-mode shift may differ from the JAX package's by 1 where its
  pre-floor value lies within 1e-4 of an integer (the f32 norm's summation
  order), an accurate-mode shift likewise (the f32 log2, ROADMAP C3). Where
  that happens the rule is asserted and the output is held to the exact
  product instead (1e-12 of |A||B| for f64 output at 14 moduli, 2^-20 of
  it for f32 output at 8).
- The f32 epilogue with beta != 0: XLA's CPU backend contracts the JAX
  package's `out + beta * c` into one fused multiply-add (ROADMAP C9). The
  port rounds the product and the sum separately, as the JAX source says;
  its output is held bit for bit to numpy's separate f32 operations on the
  JAX package's product, and the JAX output to the fused one.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.types import f64_to_bits
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SWITCHES = ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
            "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE", "GEMMUL8_MXU_CRT",
            "GEMMUL8_FUSED_RECONSTRUCT")
SHIFT_RULE_FRAC = 1e-4


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    """Every test starts from the switches' defaults, whatever the
    environment says."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _mk(shape, dtype, seed, phi=0.5):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)
    a.ravel()[::13] = 0.0
    return a.astype(dtype)


def _subnormal32(shape, seed):
    """An f32 matrix with a row and a column whose maximum is an f32
    subnormal, subnormals inside normal rows, a zero row, -0.0 and values
    near FLT_MAX in one row."""
    rng = np.random.default_rng(seed)
    a = _mk(shape, np.float32, seed, phi=2.0)
    m, n = shape
    a[0, :] = rng.integers(1, 1 << 23, n).astype(np.uint32).view(np.float32)
    a[:, 1] = rng.integers(1, 1 << 23, m).astype(np.uint32).view(np.float32)
    a[2, ::4] = (np.uint32(7) * rng.integers(1, 9, a[2, ::4].size)
                 .astype(np.uint32)).view(np.float32)
    a[3, :] = 0.0
    a[4, ::3] = -0.0
    a[5, ::7] = np.float32(3.0e38) * rng.choice([-1, 1], a[5, ::7].size)
    return a


def _jax_operand(x):
    """The JAX package's operand of the same bits: F64Bits or f32."""
    if x.dtype == np.float64:
        return f64_to_bits(x)
    return jnp.asarray(x, jnp.float32)


def _jax_sfts(a, b, L, fastmode):
    """The shifts the JAX package's CPU gemm takes (its jnp path)."""
    ja, jb = _jax_operand(a), _jax_operand(b)
    if fastmode:
        return (np.asarray(gg._fast_sft_only(ja, L, axis=1)),
                np.asarray(gg._fast_sft_only(jb, L, axis=0)))
    sa, sb = gg.accurate_sfts(ja, jb, L)
    return np.asarray(sa), np.asarray(sb)


def _port_sfts(a, b, L, fastmode):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        return (hk.fast_sft(ta, L, 1).numpy(), hk.fast_sft(tb, L, 0).numpy())
    sa, sb = tg.accurate_sfts(ta, tb, L)
    return sa.numpy(), sb.numpy()


def _assert_rule(ref, got, frac):
    """ref and got equal, or 1 apart where frac (the pre-floor value's
    distance from an integer) is below SHIFT_RULE_FRAC."""
    diff = ref != got
    if not diff.any():
        return
    assert np.abs(ref[diff].astype(np.int64) - got[diff]).max() <= 1
    assert float(frac.numpy().reshape(ref.shape)[diff].max()) \
        < SHIFT_RULE_FRAC, "shift differs away from a floor boundary"


def _fracs(a, b, L, fastmode):
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        return (enc.sft_floor_frac(enc.fast_stats(ta, 1)[1], a.shape[1], L),
                enc.sft_floor_frac(enc.fast_stats(tb, 0)[1], b.shape[0], L))
    smax = hm.magmax_matmul(hk.mag7_operand(ta, 1)[0],
                            hk.mag7_operand(tb, 0)[0])
    return tuple(enc.accurate_sft_floor_frac(s, L) for s in smax)


def _check(a, b, L, fastmode, ref, got):
    """got (the port's words) == ref (the JAX package's) when the shifts
    agree; else the floor-boundary rule holds and got is held to the exact
    product."""
    assert ref.dtype == got.dtype and ref.shape == got.shape
    ja, jb = _jax_sfts(a, b, L, fastmode)
    pa, pb = _port_sfts(a, b, L, fastmode)
    if np.array_equal(ja, pa) and np.array_equal(jb, pb):
        np.testing.assert_array_equal(ref.view(np.uint8), got.view(np.uint8))
        return
    fa, fb = _fracs(a, b, L, fastmode)
    _assert_rule(ja, pa, fa)
    _assert_rule(jb, pb, fb)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    scale = np.abs(a64) @ np.abs(b64)
    tol = 1e-12 if got.dtype == np.float64 else 2.0 ** -20
    assert np.all(np.abs(got.astype(np.float64) - a64 @ b64)
                  <= tol * scale + 1e-300)


def _port(a, b, **kw):
    return gt.gemm(a, b, device="cpu", **kw).numpy()


# ---- every operand, output and mode combination ----------------------------

DTYPES = [(np.float32, np.float32), (np.float64, np.float32),
          (np.float32, np.float64), (np.float64, np.float64)]


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("out_dtype", [None, "f32", "f64"])
@pytest.mark.parametrize("dtypes", DTYPES,
                         ids=["f32-f32", "f64-f32", "f32-f64", "f64-f64"])
def test_gemm_matches_jax(dtypes, out_dtype, fastmode):
    a = _mk((40, 72), dtypes[0], 1)
    b = _mk((72, 24), dtypes[1], 2)
    f32_out = out_dtype == "f32" or (out_dtype is None
                                     and np.float64 not in dtypes)
    L = 8 if f32_out else 14
    ref = np.asarray(g8.gemm(a, b, num_moduli=L, fastmode=fastmode,
                             out_dtype=out_dtype))
    got = _port(a, b, num_moduli=L, fastmode=fastmode, out_dtype=out_dtype)
    assert got.dtype == (np.float32 if f32_out else np.float64)
    _check(a, b, L, fastmode, ref, got)


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("half", ["float16", "bfloat16"])
def test_half_operands_widen_to_f32(half, fastmode):
    """float16 and bfloat16 operands are widened to float32 exactly, as
    the JAX package's `_canon_real` does: the bits of the f32 call, and
    of the JAX package on the half-precision arrays."""
    a32 = _mk((24, 48), np.float32, 3)
    b = _mk((48, 16), np.float64, 4)
    ta = torch.from_numpy(a32).to(getattr(torch, half))
    ja = jnp.asarray(a32).astype(getattr(jnp, half))
    a_w = ta.float().numpy()
    got = gt.gemm(ta, torch.from_numpy(b), num_moduli=14,
                  fastmode=fastmode).numpy()
    np.testing.assert_array_equal(
        got.view(np.uint64),
        _port(a_w, b, num_moduli=14, fastmode=fastmode).view(np.uint64))
    ref = np.asarray(g8.gemm(ja, b, num_moduli=14, fastmode=fastmode))
    _check(a_w, b, 14, fastmode, ref, got)
    if half == "float16":   # a numpy float16 array is widened the same way
        got16 = _port(a32.astype(np.float16), b, num_moduli=14,
                      fastmode=fastmode)
        np.testing.assert_array_equal(got16.view(np.uint64),
                                      got.view(np.uint64))


def test_other_dtypes():
    """A numpy array of another dtype becomes float32, as in the JAX
    package; a torch tensor of another dtype is a TypeError."""
    a = np.arange(12, dtype=np.int64).reshape(3, 4)
    b = np.ones((4, 2), dtype=np.int32)
    got = gt.gemm(a, b, device="cpu")
    assert got.dtype == torch.float32
    ref = np.asarray(g8.gemm(a, b))
    np.testing.assert_array_equal(ref, got.numpy())
    with pytest.raises(TypeError):
        gt.gemm(torch.ones((3, 4), dtype=torch.int32),
                torch.ones((4, 2), dtype=torch.float32))


@pytest.mark.parametrize("op_b", ["N", "T", "C"])
@pytest.mark.parametrize("op_a", ["N", "T", "C"])
def test_ops_match_jax(op_a, op_b):
    """op T and C (C is T on a real operand) on mixed f32/f64 operands."""
    a = _mk((56, 32) if op_a == "N" else (32, 56), np.float32, 5)
    b = _mk((32, 20) if op_b == "N" else (20, 32), np.float64, 6)
    ref = np.asarray(g8.gemm(a, b, num_moduli=14, op_a=op_a, op_b=op_b))
    got = _port(a, b, num_moduli=14, op_a=op_a, op_b=op_b)
    aa = a if op_a == "N" else a.T.copy()
    bb = b if op_b == "N" else b.T.copy()
    np.testing.assert_array_equal(
        got.view(np.uint64), _port(aa, bb, num_moduli=14).view(np.uint64))
    _check(aa, bb, 14, True, ref, got)


@pytest.mark.parametrize("op", ["n", "X", "H", ""])
def test_bad_op_raises(op):
    a = torch.ones((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="N/T/C"):
        gt.gemm(a, a, op_a=op)
    with pytest.raises(ValueError, match="N/T/C"):
        gt.gemm(a, a, op_b=op)


SPELLINGS = [(torch.float32, "f32"), (np.float32, "f32"),
             (np.dtype("float32"), "f32"), ("float32", "f32"),
             ("f32", "f32"), (jnp.float32, "f32"), (torch.float64, "f64"),
             (np.float64, "f64"), (np.dtype("float64"), "f64"),
             ("float64", "f64"), ("f64", "f64")]


@pytest.mark.parametrize("spelling,kind", SPELLINGS, ids=str)
def test_out_dtype_spellings(spelling, kind):
    """Each spelling of the output dtype the JAX package's `_out_kind`
    reads ("64" or "32" in its name): the same bits as that package's
    call with it."""
    a = _mk((16, 40), np.float64, 7)
    b = _mk((40, 12), np.float32, 8)
    got = _port(a, b, num_moduli=10, out_dtype=spelling)
    assert got.dtype == (np.float32 if kind == "f32" else np.float64)
    ref = np.asarray(g8.gemm(a, b, num_moduli=10, out_dtype=spelling))
    _check(a, b, 10, True, ref, got)


def test_out_dtype_errors():
    """float16 output is no kind; a complex output for real operands is a
    ValueError too (ROADMAP C1: the JAX package reads "complex64" as
    f64)."""
    a = torch.ones((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="out_dtype"):
        gt.gemm(a, a, out_dtype="float16")
    with pytest.raises(ValueError, match="out_dtype"):
        gt.gemm(a, a, out_dtype="complex64")


# ---- f32 subnormals: the f32 forms, not the widened f64 path ---------------

@pytest.mark.parametrize("fastmode", [True, False])
def test_f32_subnormal_lines_match_jax(fastmode):
    """Rows and columns whose maximum is an f32 subnormal, subnormals
    inside normal rows and values near FLT_MAX: the JAX package's bits.
    The f32 path takes emax = 1 and a 1.m23 mantissa in the norm for a
    subnormal; widening to f64 first gives other shifts, so the widening
    shortcut is not the port."""
    a = _subnormal32((24, 40), 9)
    b = np.ascontiguousarray(_subnormal32((16, 40), 10).T)
    for out_dtype, L in (("f32", 8), ("f64", 14)):
        ref = np.asarray(g8.gemm(a, b, num_moduli=L, fastmode=fastmode,
                                 out_dtype=out_dtype))
        got = _port(a, b, num_moduli=L, fastmode=fastmode,
                    out_dtype=out_dtype)
        _check(a, b, L, fastmode, ref, got)
    sa32, sb32 = _port_sfts(a, b, 8, fastmode)
    sa64, sb64 = _port_sfts(a.astype(np.float64), b.astype(np.float64), 8,
                            fastmode)
    assert not np.array_equal(sa32, sa64) and not np.array_equal(sb32, sb64)


# ---- the schedules with f32 ------------------------------------------------

@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("chunk", [1, 3])
def test_moduli_chunk_f32(chunk, fastmode):
    """moduli_chunk with f32 operands and f32 output, reconstructed from
    the limbs: the one-shot call's bits and the JAX package's chunked
    call's."""
    a = _mk((24, 64), np.float32, 11)
    b = _mk((64, 20), np.float32, 12)
    one = _port(a, b, num_moduli=8, fastmode=fastmode)
    got = _port(a, b, num_moduli=8, fastmode=fastmode, moduli_chunk=chunk)
    np.testing.assert_array_equal(one.view(np.uint32), got.view(np.uint32))
    ref = np.asarray(g8.gemm(a, b, num_moduli=8, fastmode=fastmode,
                             moduli_chunk=chunk))
    _check(a, b, 8, fastmode, ref, got)


@pytest.mark.parametrize("out_dtype", ["f32", "f64"])
@pytest.mark.parametrize("fastmode", [True, False])
def test_n_panel_f32(fastmode, out_dtype):
    """n_panel with mixed operands: the output allocated in its dtype, the
    one-shot call's bits in fast mode, the JAX package's panels in both."""
    a = _mk((20, 48), np.float32, 13)
    b = _mk((48, 50), np.float64, 14)
    L = 8 if out_dtype == "f32" else 14
    got = _port(a, b, num_moduli=L, fastmode=fastmode, out_dtype=out_dtype,
                n_panel=16)
    if fastmode:
        one = _port(a, b, num_moduli=L, out_dtype=out_dtype)
        np.testing.assert_array_equal(one.view(np.uint8), got.view(np.uint8))
    ref = np.asarray(g8.gemm(a, b, num_moduli=L, fastmode=fastmode,
                             out_dtype=out_dtype, n_panel=16))
    if fastmode:
        _check(a, b, L, True, ref, got)
    else:   # each panel's own shifts
        for j0 in range(0, 50, 16):
            _check(a, np.ascontiguousarray(b[:, j0:j0 + 16]), L, False,
                   ref[:, j0:j0 + 16].copy(), got[:, j0:j0 + 16].copy())


# ---- the epilogue ----------------------------------------------------------

# tests/test_epilogue.py's vectors, and scalars f32 cannot hold
EPILOGUE = [(1.7, 0.0), (1.0, -0.3), (-2.5, 0.37), (0.1, 0.1), (3.0, 1.0)]


def _separate_f32(raw, alpha, beta, c):
    """The f32 epilogue as separate roundings (numpy f32 operations)."""
    out = raw.astype(np.float32)
    if alpha != 1.0:
        out = out * np.float32(alpha)
    if beta != 0.0:
        out = out + np.float32(beta) * c.astype(np.float32)
    return out


def _fused_f32(raw, alpha, beta, c):
    """The two ways XLA's CPU backend contracts the f32 epilogue into one
    fused multiply-add: fma(out, alpha, beta * c) and fma(beta, c, out *
    alpha) (it picks by the sign of alpha), emulated in f64, where each
    f32 product is exact."""
    out = raw.astype(np.float32)
    f64 = np.float64
    al, be = np.float32(alpha), np.float32(beta)
    cb = c.astype(np.float32)
    return ((out.astype(f64) * f64(al) + (be * cb).astype(f64))
            .astype(np.float32),
            ((out * al).astype(f64) + f64(be) * cb.astype(f64))
            .astype(np.float32))


def _raw(a, b, L):
    """The JAX package's alpha = 1, beta = 0 words, and whether the port's
    are the same (else the shift rule is asserted and the port's are
    returned)."""
    raw = np.asarray(g8.gemm(a, b, num_moduli=L))
    port_raw = _port(a, b, num_moduli=L)
    if np.array_equal(raw.view(np.uint8), port_raw.view(np.uint8)):
        return raw, True
    _check(a, b, L, True, raw, port_raw)
    return port_raw, False


@pytest.mark.parametrize("alpha,beta", EPILOGUE)
def test_epilogue_f64_matches_jax(alpha, beta):
    """f64 output: out * alpha, c * beta, then the sum, three roundings in
    native f64: the JAX package's softfloat bits, with c in f64 or f32
    (widened exactly)."""
    a = _mk((24, 40), np.float64, 15)
    b = _mk((40, 16), np.float32, 16)
    raw, same = _raw(a, b, 16)
    for c in (_mk((24, 16), np.float64, 17), _mk((24, 16), np.float32, 18)):
        got = _port(a, b, alpha=alpha, beta=beta, c=c, num_moduli=16)
        want = raw * alpha if alpha != 1.0 else raw
        if beta != 0.0:
            want = want + c.astype(np.float64) * beta
        np.testing.assert_array_equal(want.view(np.uint64),
                                      got.view(np.uint64))
        if same:
            ref = np.asarray(g8.gemm(a, b, alpha=alpha, beta=beta, c=c,
                                     num_moduli=16))
            np.testing.assert_array_equal(ref.view(np.uint64),
                                          got.view(np.uint64))


@pytest.mark.parametrize("alpha,beta", EPILOGUE)
def test_epilogue_f32_separate_roundings(alpha, beta):
    """f32 output: alpha and beta rounded to f32 (0.1 and -0.3 are not f32
    values), c narrowed to f32, then out * alpha and out + beta * c, each
    rounded once in f32. The JAX package's XLA graph contracts them into
    an FMA (C9): its words are the fused ones."""
    a = _mk((24, 40), np.float32, 19)
    b = _mk((40, 16), np.float32, 20)
    c = _mk((24, 16), np.float64, 21)
    raw, same = _raw(a, b, 8)
    got = _port(a, b, alpha=alpha, beta=beta, c=c, num_moduli=8)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got.view(np.uint32), _separate_f32(raw, alpha, beta, c)
        .view(np.uint32))
    if same:
        ref = np.asarray(g8.gemm(a, b, alpha=alpha, beta=beta, c=c,
                                 num_moduli=8))
        if beta == 0.0:   # nothing to contract
            np.testing.assert_array_equal(ref.view(np.uint32),
                                          got.view(np.uint32))
            return
        v1, v2 = _fused_f32(raw, alpha, beta, c)
        assert np.all((ref.view(np.uint32) == v1.view(np.uint32))
                      | (ref.view(np.uint32) == v2.view(np.uint32)))


@pytest.mark.parametrize("out_dtype", ["f32", "f64"])
@pytest.mark.parametrize("alpha", [0.25, 8.0, 2.0 ** -30, 2.0 ** 40])
def test_pow2_alpha_folds_like_jax(alpha, out_dtype):
    """A power-of-two alpha with beta == 0 folds into the reconstruct's
    exponent (one rounding of the exact product): the JAX package's bits,
    and on normal-range data the unscaled call times alpha."""
    a = _mk((16, 64), np.float32, 22)
    b = _mk((64, 24), np.float32, 23)
    L = 8 if out_dtype == "f32" else 14
    base = _port(a, b, num_moduli=L, out_dtype=out_dtype)
    got = _port(a, b, alpha=alpha, num_moduli=L, out_dtype=out_dtype)
    scale = np.float32(alpha) if out_dtype == "f32" else alpha
    np.testing.assert_array_equal(got, base * scale)
    ref = np.asarray(g8.gemm(a, b, alpha=alpha, num_moduli=L,
                             out_dtype=out_dtype))
    _check(a, b, L, True, ref, got)


@pytest.mark.parametrize("out_dtype,scale,e,word", [
    ("f32", 0, -153, 5), ("f64", -180, -900, 1)])
def test_pow2_alpha_subnormal_single_rounding(out_dtype, scale, e, word):
    """At the subnormal edge the fold rounds the exact product once at the
    target exponent, as the JAX package's test_epilogue holds it: 76 *
    2^-153 is 4.75 steps of the f32 subnormal grid and rounds to 5 (the
    f32 alpha itself would be 0); 76 * 2^-1080 is 1.1875 steps of f64's
    and rounds to 1."""
    dt = np.float32 if out_dtype == "f32" else np.float64
    a = np.array([[3.0, 5.0]], dt) * 2.0 ** scale
    b = np.array([[7.0], [11.0]], dt)   # exact product 76 * 2^scale
    got = _port(a, b, alpha=2.0 ** e, num_moduli=16)
    assert got.dtype == dt
    assert int(got.view(np.uint32 if dt == np.float32 else np.uint64)
               [0, 0]) == word
    ref = np.asarray(g8.gemm(a, b, alpha=2.0 ** e, num_moduli=16))
    np.testing.assert_array_equal(ref.view(np.uint8), got.view(np.uint8))


def test_epilogue_f32_underflow_and_overflow():
    """beta * c at the edge of f32 underflow (subnormal products, some
    rounded to zero), and a result that overflows f32 to inf while the f64
    output of the same call is finite."""
    a = _mk((8, 16), np.float32, 24)
    b = _mk((16, 6), np.float32, 25)
    c = np.full((8, 6), 1.5e-38, np.float64)
    c[0, :] = 2.0 ** -149
    c[1, :] = -3.0e-39
    raw, same = _raw(a, b, 8)
    got = _port(a, b, alpha=1e-45, beta=0.75, c=c, num_moduli=8)
    np.testing.assert_array_equal(
        got.view(np.uint32), _separate_f32(raw, 1e-45, 0.75, c)
        .view(np.uint32))
    assert np.any((got != 0) & (np.abs(got) < np.finfo(np.float32).tiny))
    big = _port(a, b, alpha=3.0e38, num_moduli=8)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(big, raw * np.float32(3.0e38))
    assert np.isinf(big).any()
    big64 = _port(a, b, alpha=3.0e38, num_moduli=8, out_dtype="f64")
    assert np.isfinite(big64).all()
    if same:
        ref = np.asarray(g8.gemm(a, b, alpha=3.0e38, num_moduli=8))
        np.testing.assert_array_equal(ref.view(np.uint32),
                                      big.view(np.uint32))


def test_epilogue_arguments():
    a = np.ones((4, 3), np.float32)
    b = np.ones((3, 5), np.float32)
    with pytest.raises(ValueError, match="requires c"):
        gt.gemm(a, b, beta=1.0, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        gt.gemm(a, b, beta=1.0, c=np.ones((5, 4)), device="cpu")
    with pytest.raises(TypeError):
        gt.gemm(a, b, beta=1.0, c=torch.ones((4, 5), dtype=torch.int32),
                device="cpu")
    # c is ignored at beta == 0; a numpy c goes to the operands' device
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(gt.gemm(ta, tb, c=np.zeros((2, 2))),
                       torch.full((4, 5), 3.0))
    got = gt.gemm(ta, tb, beta=2.0, c=np.ones((4, 5)))
    assert got.dtype == torch.float32 and torch.equal(got,
                                                      torch.full((4, 5), 5.0))


# ---- the switches ----------------------------------------------------------

# f32 calls under GEMMUL8_PIPELINE run the riders' f32 forms
# (tests/test_torch_pipelined_f32.py); FUSED_ENCODE, FUSED_MAG7 and
# FUSED_RECONSTRUCT run f32 calls (tests/test_torch_f32_variants.py)


@pytest.mark.parametrize("env", [
    {"GEMMUL8_MXU_CRT": "0"},
    {"GEMMUL8_MXU_CRT": "0", "GEMMUL8_MM_PIPELINE": "1"},
    {"GEMMUL8_MAGMAX_SCRATCH": "1"},
    {"GEMMUL8_PIPELINE": "2"}])
@pytest.mark.parametrize("fastmode", [True, False])
def test_switches_on_int8_data_run_for_f32(monkeypatch, env, fastmode):
    """The switches that act on int8 data run for f32 calls as they are,
    with the default's bits; the pipeline gives way where it finds no
    panels, so an f32 call runs the default there."""
    a = _mk((24, 40), np.float32, 30)
    b = _mk((40, 16), np.float64, 31)
    want = _port(a, b, num_moduli=8, fastmode=fastmode, out_dtype="f32")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = _port(a, b, num_moduli=8, fastmode=fastmode, out_dtype="f32")
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


# ---- on the card -----------------------------------------------------------

@pytest.mark.cuda
def test_f32_calls_on_card_match_plain():
    """On a CUDA host: f32 and mixed calls through the kernels give the
    plain path's bits on the same shifts, the f32 forms counted under
    their own keys. Skips without a card; chip_smoke.py covers more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from gemmul8_tpu_torch.hopper import build

    a = _subnormal32((300, 260), 32)
    b = _mk((260, 200), np.float64, 33)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for fastmode in (True, False):
        build.LAUNCHES.clear()
        got = gt.gemm(ta, tb, num_moduli=8, fastmode=fastmode,
                      out_dtype="f32").cpu()
        launches = dict(build.LAUNCHES)
        assert launches["encode_slices[f32]"] == 1
        assert launches["encode_slices"] == 1
        assert launches["reconstruct[f32]"] == 1
        sa, sb = _port_sfts(a, b, 8, fastmode)
        if fastmode:
            ka = hk.fast_sft(ta, 8, 1).cpu().numpy()
            kb = hk.fast_sft(tb, 8, 0).cpu().numpy()
        else:
            ka, kb = (s.cpu().numpy() for s in tg.accurate_sfts(ta, tb, 8))
        if np.array_equal(ka, sa) and np.array_equal(kb, sb):
            want = _port(a, b, num_moduli=8, fastmode=fastmode,
                         out_dtype="f32")
            np.testing.assert_array_equal(want.view(np.uint32),
                                          got.numpy().view(np.uint32))
