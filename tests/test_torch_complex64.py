"""The port's complex front end vs the JAX package: complex64 operands,
complex operands mixed with each other and with real ones, complex64 and
complex128 output, op N/T/C, complex alpha/beta, on the same bits.

gemmul8_tpu_torch.gemm on CPU tensors runs every kernel's plain version
(the f32 forms of the statistics, encode, magnitudes and reconstruct among
them). Its words must be those of gemmul8_tpu.gemm on the CPU for every
combination of operand kinds (complex128, complex64, float64, float32),
output kind, strategy, mode and op, and its core on float32 parts those of
the JAX package's gemm_complex_core(use_pallas=True) (Pallas in interpret
mode). Inputs come from a numpy seed.

Tolerance: bit equality, with two documented exceptions.
- A shift may differ from the JAX package's by 1 where its pre-floor value
  lies within 1e-4 of an integer (the f32 norm's summation order in fast
  mode; the f32 log2 in accurate mode, ROADMAP C3). Where that happens the
  rule is asserted and the output is held to the exact product instead
  (1e-12 of |A||B| for complex128 output at 14 moduli, 2^-20 of it for
  complex64 at 8).
- The complex64 epilogue with alpha != 1 or beta != 0: XLA's CPU backend
  contracts the JAX package's f32 multiplies and adds into fused
  multiply-adds (ROADMAP C9). The port rounds each step, as the JAX source
  says; its output is held bit for bit to numpy's separate f32 operations
  on its own product, and the JAX package's words to the same values
  within tests/test_epilogue.py's rtol 1e-6 / atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import api as japi
from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.core import complexgemm as jcg
from gemmul8_tpu.core import encode as jenc
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

CT = gt.ComputeType
STRATS = [CT.COMPLEX_BIG_MATRIX_ENCODE, CT.COMPLEX_CLASSIC_MULT,
          CT.COMPLEX_KARATSUBA_MULT]
SHIFT_RULE_FRAC = 1e-4
_DT = {"c128": np.complex128, "c64": np.complex64, "f64": np.float64,
       "f32": np.float32}


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    for key in ("GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MXU_CRT",
                "GEMMUL8_MM_PIPELINE"):
        monkeypatch.delenv(key, raising=False)


def _mk(shape, kind, seed, phi=0.5):
    """An operand of kind c128, c64, f64 or f32 from phi_matrix (the Im
    part from seed + 1)."""
    x = phi_matrix(*shape, phi, seed=seed)
    if kind in ("c128", "c64"):
        x = x + 1j * phi_matrix(*shape, phi, seed=seed + 1)
    return x.astype(_DT[kind])


def _words(x):
    """The IEEE words of a float or complex numpy array, Re and Im
    interleaved."""
    x = np.ascontiguousarray(x)
    return x.view(np.uint64 if x.dtype in (np.float64, np.complex128)
                  else np.uint32)


def _port_sfts(a, b, L, fastmode):
    ar, ai = cg.canon_complex(torch.from_numpy(np.asarray(a)))
    br, bi = cg.canon_complex(torch.from_numpy(np.asarray(b)))
    if fastmode:
        return (enc.joint_fast_sft(ar, ai, L, 1).numpy(),
                enc.joint_fast_sft(br, bi, L, 0).numpy())
    sa, sb = cg.accurate_sfts_complex(ar, ai, br, bi, L)
    return sa.numpy(), sb.numpy()


def _jax_sfts(a, b, L, fastmode):
    """The shifts the JAX package's CPU gemm takes (its jnp path)."""
    ar, ai, _ = jcg._canon_complex(a)
    br, bi, _ = jcg._canon_complex(b)
    if fastmode:
        return (np.asarray(jenc.encode_fast_complex(ar, ai, L, 1)[2]),
                np.asarray(jenc.encode_fast_complex(br, bi, L, 0)[2]))
    sa, sb = jcg._accurate_sfts(ar, ai, br, bi, L)
    return np.asarray(sa), np.asarray(sb)


def _fracs(a, b, L, fastmode):
    """Each shift's pre-floor distance from an integer (the port's
    statistics or magnitude maxima), for A's rows and B's columns."""
    ar, ai = cg.canon_complex(torch.from_numpy(np.asarray(a)))
    br, bi = cg.canon_complex(torch.from_numpy(np.asarray(b)))
    if fastmode:
        return tuple(
            enc.sft_floor_frac(enc.merge_stats(enc.fast_stats(re, axis),
                                               enc.fast_stats(im, axis))[1],
                               2 * re.shape[axis], L).numpy()
            for re, im, axis in ((ar, ai, 1), (br, bi, 0)))
    ma, _ = hk.mag7_operand_complex(ar, ai, 1)
    mb, _ = hk.mag7_operand_complex(br, bi, 0)
    return tuple(enc.accurate_sft_floor_frac(s, L).numpy()
                 for s in hm.magmax_matmul(ma, mb))


def _exact(a, b):
    """The complex product in f64 over the k-concatenation (each product
    and the sums of these small operands are far below the tolerance)."""
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return a @ b


def _mag(z):
    z = np.asarray(z)
    return np.abs(z.real).astype(np.float64) + np.abs(z.imag)


def _check(a, b, L, fastmode, ref, got):
    """got (the port's words) == ref (the JAX package's) when the shifts
    agree; else the floor-boundary rule holds and got is held to the
    exact product."""
    assert ref.dtype == got.dtype and ref.shape == got.shape
    ja, jb = _jax_sfts(a, b, L, fastmode)
    pa, pb = _port_sfts(a, b, L, fastmode)
    if np.array_equal(ja, pa) and np.array_equal(jb, pb):
        np.testing.assert_array_equal(_words(ref), _words(got))
        return
    for j, p, frac in zip((ja, jb), (pa, pb), _fracs(a, b, L, fastmode)):
        diff = j != p
        if diff.any():
            assert np.abs(j[diff].astype(np.int64) - p[diff]).max() <= 1
            assert frac.reshape(j.shape)[diff].max() < SHIFT_RULE_FRAC, \
                "shift differs away from a floor boundary"
    scale = _mag(a) @ _mag(b)
    tol = 1e-12 if got.dtype == np.complex128 else 2.0 ** -20
    assert np.all(np.abs(got.astype(np.complex128) - _exact(a, b))
                  <= tol * scale + 1e-300)


def _port(a, b, **kw):
    return gt.gemm(a, b, device="cpu", **kw).numpy()


# ---- complex64 through the whole front end ---------------------------------

@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("strat", STRATS)
def test_complex64_gemm_matches_jax(strat, fastmode):
    a, b = _mk((40, 72), "c64", 3), _mk((72, 24), "c64", 5)
    kw = dict(num_moduli=8, fastmode=fastmode, compute_type=strat)
    got = _port(a, b, **kw)
    assert got.dtype == np.complex64 and got.shape == (40, 24)
    ref = np.asarray(g8.gemm(a, b, num_moduli=8, fastmode=fastmode,
                             compute_type=g8.ComputeType[strat.name]))
    _check(a, b, 8, fastmode, ref, got)


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("strat", STRATS)
def test_complex_core_f32_parts_matches_pallas(strat, fastmode):
    """The core on float32 parts, f32 output, against the JAX package's
    Pallas core (interpret mode): the f32 statistics and the joint shift,
    the f32 encode, the shift-4 f32 magnitudes, the f32 reconstruct."""
    a, b = _mk((40, 72), "c64", 7, phi=1.0), _mk((72, 24), "c64", 9, phi=1.0)
    parts = [np.ascontiguousarray(x) for x in (a.real, a.imag, b.real,
                                               b.imag)]
    jre, jim = jcg.gemm_complex_core(*map(jnp.asarray, parts), 8, fastmode,
                                     jcg.ComputeType[strat.name], "f32",
                                     use_pallas=True)
    tparts = [torch.from_numpy(x) for x in parts]
    re, im = cg.gemm_complex_core(*tparts, 8, fastmode, strat, "f32")
    assert re.dtype == torch.float32 and im.dtype == torch.float32
    if fastmode:
        ja = jcg._joint_sft_pallas(*map(jnp.asarray, parts[:2]), 8, 1)
        jb = jcg._joint_sft_pallas(*map(jnp.asarray, parts[2:]), 8, 0)
        pa = enc.joint_fast_sft(*tparts[:2], 8, 1)
        pb = enc.joint_fast_sft(*tparts[2:], 8, 0)
    else:
        ja, jb = jcg._accurate_sfts_pallas(*map(jnp.asarray, parts), 8)
        pa, pb = cg.accurate_sfts_complex(*tparts, 8)
    if (np.array_equal(np.asarray(ja), pa.numpy())
            and np.array_equal(np.asarray(jb), pb.numpy())):
        np.testing.assert_array_equal(np.asarray(jre).view(np.uint32),
                                      re.numpy().view(np.uint32))
        np.testing.assert_array_equal(np.asarray(jim).view(np.uint32),
                                      im.numpy().view(np.uint32))
    else:
        _check(a, b, 8, fastmode, np.asarray(jre) + 1j * np.asarray(jim),
               (re.numpy() + 1j * im.numpy()).astype(np.complex64))


def test_joint_f32_shift_over_two_stats_chunks():
    """k = 2600 > 2048 on complex64 parts: each part's chunked norm merge,
    then the Re/Im merge, at the f32 bias, against the JAX package's
    `_joint_sft_pallas` (two f32 stats passes in interpret mode)."""
    for shape, axis in (((16, 2600), 1), ((2600, 12), 0)):
        z = _mk(shape, "c64", 11, phi=1.0)
        re, im = np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag)
        want = np.asarray(jcg._joint_sft_pallas(jnp.asarray(re),
                                                jnp.asarray(im), 8, axis))
        got = enc.joint_fast_sft(torch.from_numpy(re), torch.from_numpy(im),
                                 8, axis).numpy()
        diff = want != got
        if diff.any():
            frac = _fracs(z, z.T, 8, True)[1 - axis]
            assert np.abs(want[diff].astype(np.int64) - got[diff]).max() <= 1
            assert frac.reshape(want.shape)[diff].max() < SHIFT_RULE_FRAC
        assert got.shape == want.shape and got.dtype == np.int32


# ---- mixed operand kinds ---------------------------------------------------

MIXED = [("c128", "c64"), ("c64", "c128"), ("c64", "f32"), ("f32", "c64"),
         ("c128", "f32"), ("c64", "f64"), ("f64", "c64"), ("c128", "f64")]


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("kinds", MIXED, ids="-".join)
def test_mixed_complex_operands_match_jax(kinds, fastmode):
    """Each operand keeps its word (a c128 x c64 call is not widened); the
    output is complex128 if either operand is complex128 or float64."""
    a, b = _mk((40, 72), kinds[0], 13), _mk((72, 24), kinds[1], 15)
    wide = bool({"c128", "f64"} & set(kinds))
    L = 14 if wide else 8
    got = _port(a, b, num_moduli=L, fastmode=fastmode)
    assert got.dtype == (np.complex128 if wide else np.complex64)
    ref = np.asarray(g8.gemm(a, b, num_moduli=L, fastmode=fastmode))
    _check(a, b, L, fastmode, ref, got)


def test_c128_c64_call_takes_each_operands_forms():
    """A c128 x c64 call runs A's parts through the f64 forms and B's
    through the f32 forms (spied on the plain versions), nothing widened."""
    seen = []
    orig = hk.fast_stats_plain

    def spy(x, axis):
        seen.append((x.dtype, axis))
        return orig(x, axis)

    hk.fast_stats_plain = spy
    try:
        gt.gemm(_mk((8, 24), "c128", 1), _mk((24, 6), "c64", 2),
                device="cpu")
    finally:
        hk.fast_stats_plain = orig
    assert sorted(seen, key=str) == sorted(
        [(torch.float64, 1)] * 2 + [(torch.float32, 0)] * 2, key=str)


@pytest.mark.parametrize("kind", ["f16", "bf16", "int32"])
def test_other_real_dtypes_widen_to_f32(kind):
    """float16, bfloat16 and integer tensors in a complex call enter as
    float32 with +0.0 Im parts (the JAX package's `_canon_complex`)."""
    a = _mk((8, 24), "c64", 17)
    b = torch.from_numpy(phi_matrix(24, 6, 2.0, seed=18) * 8)
    b = {"f16": b.half(), "bf16": b.bfloat16(), "int32": b.int()}[kind]
    got = gt.gemm(a, b, num_moduli=8, device="cpu")
    assert got.dtype == torch.complex64
    want = gt.gemm(a, b.float(), num_moduli=8, device="cpu")
    assert torch.equal(torch.view_as_real(got).view(torch.int32),
                       torch.view_as_real(want).view(torch.int32))


# ---- out_dtype -------------------------------------------------------------

OUT_SPELLINGS = [(torch.complex128, "c128"), (np.complex128, "c128"),
                 ("complex128", "c128"), ("c128", "c128"),
                 (torch.complex64, "c64"), (np.complex64, "c64"),
                 (np.dtype("complex64"), "c64"), ("complex64", "c64"),
                 ("c64", "c64")]


@pytest.mark.parametrize("spelling,kind", OUT_SPELLINGS, ids=str)
def test_complex_out_dtype_spellings(spelling, kind):
    """complex64 operands to complex128 output and back: the JAX package's
    bits with the same spelling (it reads "128" in the name)."""
    a, b = _mk((24, 40), "c64", 19), _mk((40, 16), "c128", 20)
    L = 14 if kind == "c128" else 8
    got = _port(a, b, num_moduli=L, out_dtype=spelling)
    assert got.dtype == _DT[kind]
    ref = np.asarray(g8.gemm(a, b, num_moduli=L, out_dtype=str(spelling)))
    _check(a, b, L, True, ref, got)


@pytest.mark.parametrize("spelling", ["float64", "f64", torch.float64,
                                      np.float32, "float32"], ids=str)
def test_complex_call_real_out_dtype_raises(spelling):
    """ROADMAP C1: the JAX package reads any out_dtype without "128" in its
    name as complex64, so a real float64 spelling gives complex64 there;
    the port refuses a real spelling on a complex call."""
    a, b = _mk((8, 16), "c64", 21), _mk((16, 6), "c64", 22)
    with pytest.raises(ValueError, match="out_dtype"):
        _port(a, b, out_dtype=spelling)
    if spelling == "float64":
        assert np.asarray(g8.gemm(a, b, num_moduli=8,
                                  out_dtype=spelling)).dtype == np.complex64


@pytest.mark.parametrize("spelling", ["complex64", "complex128",
                                      torch.complex64, np.complex128],
                         ids=str)
def test_real_call_complex_out_dtype_raises(spelling):
    """ROADMAP C1: the JAX package's real `_out_kind` reads "complex64" as
    f64 (it finds "64") and "complex128" as an error; the port refuses
    every complex spelling on a real call."""
    a, b = _mk((8, 16), "f32", 23), _mk((16, 6), "f32", 24)
    with pytest.raises(ValueError, match="out_dtype"):
        _port(a, b, out_dtype=spelling)
    if spelling == "complex64":
        assert np.asarray(g8.gemm(a, b, num_moduli=8,
                                  out_dtype=spelling)).dtype == np.float64


# ---- op N/T/C --------------------------------------------------------------

@pytest.mark.parametrize("op_b", ["N", "T", "C"])
@pytest.mark.parametrize("op_a", ["N", "T", "C"])
def test_complex_ops_match_jax(op_a, op_b):
    """op T transposes, op C conjugates and transposes, on a complex64 A
    and a complex128 B (stored transposed where the op transposes)."""
    a, b = _mk((24, 40), "c64", 25), _mk((40, 16), "c128", 26)
    a = a if op_a == "N" else np.ascontiguousarray(a.T)
    b = b if op_b == "N" else np.ascontiguousarray(b.T)
    got = _port(a, b, num_moduli=14, op_a=op_a, op_b=op_b)
    ref = np.asarray(g8.gemm(a, b, num_moduli=14, op_a=op_a, op_b=op_b))
    _check(japi._apply_op(a, op_a, True), japi._apply_op(b, op_b, True),
           14, True, ref, got)


def _special(kind):
    """A complex operand with -0.0, +0.0, infinities and NaNs of both
    signs and several payloads in both parts."""
    z = _mk((6, 10), kind, 27)
    f = np.float64 if kind == "c128" else np.float32
    u = np.uint64 if kind == "c128" else np.uint32
    nan_words = ([0x7FF8000000000001, 0xFFF0000000000123, 0x7FF4000000000000]
                 if kind == "c128" else [0x7FC00001, 0xFF800123, 0x7FA00000])
    nans = np.array(nan_words, dtype=u).view(f)
    re, im = z.real.copy(), z.imag.copy()
    im[0, :3] = [-0.0, 0.0, -0.0]
    re[1, :3] = [-0.0, 0.0, np.inf]
    im[2, :3] = nans
    re[3, :3] = nans
    im[4, :2] = [np.inf, -np.inf]
    out = np.empty(z.shape, z.dtype)
    out.real, out.imag = re, im
    return out


@pytest.mark.parametrize("kind", ["c64", "c128"])
def test_op_c_flips_sign_bits(kind):
    """op C flips the sign bit of every Im word, as numpy's conj and the
    JAX package's `_apply_op` do: -0.0 and +0.0 swap, every NaN payload is
    kept with its sign flipped. A tensor with torch's lazy conjugate bit
    gives the parts of its value the same way."""
    z = _special(kind)
    want = np.conj(z).T
    jre = np.asarray(jnp.real(japi._apply_op(jnp.asarray(z), "C", True)))
    jim = np.asarray(jnp.imag(japi._apply_op(jnp.asarray(z), "C", True)))
    re, im = cg.canon_complex(torch.from_numpy(z), "C")
    for x, y, j in ((re, want.real, jre), (im, want.imag, jim)):
        np.testing.assert_array_equal(_words(x.numpy()), _words(y))
        np.testing.assert_array_equal(_words(x.numpy()), _words(j))
    lazy = torch.from_numpy(z).conj()
    assert lazy.is_conj()
    for op, ref in (("N", np.conj(z)), ("C", z.T), ("T", np.conj(z).T)):
        re, im = cg.canon_complex(lazy, op)
        np.testing.assert_array_equal(_words(re.numpy()), _words(ref.real))
        np.testing.assert_array_equal(_words(im.numpy()), _words(ref.imag))
    # a real operand's conjugate is itself: its Im stays +0.0
    x = np.ascontiguousarray(z.real)
    re, im = cg.canon_complex(torch.from_numpy(x), "C")
    np.testing.assert_array_equal(_words(re.numpy()), _words(x.T))
    assert not im.numpy().view(np.uint8).any()
    # the whole call: op C gives the call on the conjugated operand's bits
    b = _mk((6, 4), kind, 28)
    got = _port(z, b, num_moduli=8, op_a="C")
    np.testing.assert_array_equal(
        _words(got), _words(_port(np.ascontiguousarray(want), b,
                                  num_moduli=8)))


# ---- the complex epilogues -------------------------------------------------

C128_EPILOGUE = [(1.7, 0.0), (1.5 - 0.5j, 0.0), (1.0, 0.25 + 2j),
                 (1.5 - 0.5j, 0.25 + 2j), (-2.5, 0.75), (2j, -1j)]


@pytest.mark.parametrize("alpha,beta", C128_EPILOGUE, ids=str)
def test_c128_epilogue_matches_jax(alpha, beta):
    """complex128 output: the JAX package's softfloat `_cscale` (a real
    scalar skips the cross terms) and sums, bit for bit in native f64, c
    complex128, complex64 or real (widened exactly)."""
    a, b = _mk((24, 40), "c128", 29), _mk((40, 16), "c64", 30)
    for c in (_mk((24, 16), "c128", 31), _mk((24, 16), "c64", 32),
              _mk((24, 16), "f64", 33)):
        kw = dict(alpha=alpha, beta=beta, num_moduli=14)
        if beta != 0.0:
            kw["c"] = c
        got = _port(a, b, **kw)
        assert got.dtype == np.complex128
        ref = np.asarray(g8.gemm(a, b, **kw))
        _check(a, b, 14, True, ref, got)
        if beta == 0.0:
            break


def _separate_c64(raw, alpha, beta, c):
    """The complex64 epilogue of the JAX source as numpy's separate f32
    roundings: the full complex formula even for a real alpha."""
    f32 = np.float32
    ore, oim = raw.real.astype(f32), raw.imag.astype(f32)
    alpha, beta = complex(alpha), complex(beta)
    with np.errstate(invalid="ignore", over="ignore"):
        if alpha != 1.0:
            ar, ai = f32(alpha.real), f32(alpha.imag)
            ore, oim = ore * ar - oim * ai, ore * ai + oim * ar
        if beta != 0.0:
            cn = np.asarray(c, np.complex64)
            cr, ci = cn.real, cn.imag
            br, bi = f32(beta.real), f32(beta.imag)
            ore = ore + cr * br - ci * bi
            oim = oim + cr * bi + ci * br
    out = np.empty(raw.shape, np.complex64)
    out.real, out.imag = ore, oim
    return out


C64_EPILOGUE = [(1.7, 0.0), (1.5 - 0.5j, 0.0), (1.0, 0.1 + 2j),
                (1.5 - 0.5j, 0.25 + 2j), (-2.5, 0.3), (0.1j, -1j)]


@pytest.mark.parametrize("alpha,beta", C64_EPILOGUE, ids=str)
def test_c64_epilogue_separate_roundings(alpha, beta):
    """complex64 output: alpha and beta rounded to f32, c narrowed to
    complex64 (complex128 or float64 here), each multiply and add rounded
    once, bit for bit to numpy; the JAX package's (FMA-contracted, C9)
    words within tests/test_epilogue.py's bounds of the same values."""
    a, b = _mk((24, 40), "c64", 34), _mk((40, 16), "f32", 35)
    raw = _port(a, b, num_moduli=8)
    for c in (_mk((24, 16), "c128", 36), _mk((24, 16), "f64", 37)):
        kw = dict(alpha=alpha, beta=beta, num_moduli=8)
        if beta != 0.0:
            kw["c"] = c
        got = _port(a, b, **kw)
        want = _separate_c64(raw, alpha, beta, c)
        np.testing.assert_array_equal(_words(got), _words(want))
        ref = np.asarray(g8.gemm(a, b, **kw))
        assert ref.dtype == np.complex64
        np.testing.assert_allclose(ref.real, want.real, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(ref.imag, want.imag, rtol=1e-6, atol=1e-5)
        if beta == 0.0:
            break


def test_c64_epilogue_real_alpha_takes_the_full_formula():
    """A real alpha on complex64 output still computes out * 0 terms, as
    the JAX package's `_jit_epi_c64`: an infinite Re turns Im into NaN,
    where the complex128 epilogue (which skips the cross terms) keeps Im
    finite."""
    a = np.array([[3e38 + 1j, 1.0 + 0j]], np.complex64)
    b = np.array([[2.0 + 0j], [1.0 + 1j]], np.complex64)
    got = _port(a, b, num_moduli=8, alpha=3.0)
    assert np.isinf(got.real[0, 0]) and np.isnan(got.imag[0, 0])
    ref = np.asarray(g8.gemm(a, b, num_moduli=8, alpha=3.0))
    assert np.isinf(ref.real[0, 0]) and np.isnan(ref.imag[0, 0])
    wide = _port(a.astype(np.complex128), b, num_moduli=8, alpha=3.0)
    assert np.isfinite(wide).all()
    assert np.isfinite(_port(a, b, num_moduli=8, alpha=3.0,
                             out_dtype="complex128")).all()


@pytest.mark.parametrize("out", ["c64", "c128"])
@pytest.mark.parametrize("alpha", [0.25, 0.25 + 0j, 2.0 ** -30])
def test_complex_pow2_alpha_folds_like_jax(alpha, out):
    """A real power-of-two alpha with beta == 0 folds into the reconstruct's
    exponent: one rounding of the exact scaled product (the JAX package's
    bits, no epilogue)."""
    a, b = _mk((24, 40), out, 38), _mk((40, 16), "c64", 39)
    L = 14 if out == "c128" else 8
    got = _port(a, b, num_moduli=L, alpha=alpha)
    ref = np.asarray(g8.gemm(a, b, num_moduli=L, alpha=alpha))
    _check(a, b, L, True, ref, got)


def test_complex_epilogue_arguments():
    a, b = _mk((4, 6), "c64", 40), _mk((6, 5), "c64", 41)
    with pytest.raises(ValueError, match="requires c"):
        gt.gemm(a, b, beta=1j, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        gt.gemm(a, b, beta=1.0, c=np.ones((5, 4), np.complex64), device="cpu")
    with pytest.raises(TypeError):
        gt.gemm(a, b, beta=1.0, c=torch.ones((4, 5), dtype=torch.complex32),
                device="cpu")
    # c is ignored at beta == 0; a numpy c goes to the operands' device
    base = gt.gemm(a, b, num_moduli=8, device="cpu")
    assert torch.equal(gt.gemm(a, b, num_moduli=8, c=np.zeros((2, 2)),
                               device="cpu"), base)
    got = gt.gemm(torch.from_numpy(a), torch.from_numpy(b), num_moduli=8,
                  beta=1j, c=np.ones((4, 5)))
    assert got.dtype == torch.complex64
    assert torch.equal(got.imag, base.imag + 1)
