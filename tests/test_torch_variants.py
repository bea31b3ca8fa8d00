"""The opt-in variants of the one-shot path vs the JAX package, on the same
bits.

The JAX package's switches GEMMUL8_FUSED_ENCODE, GEMMUL8_FUSED_MAG7,
GEMMUL8_MAGMAX_SCRATCH and GEMMUL8_MM_PIPELINE (with GEMMUL8_MXU_CRT=0)
route the port to four more kernels. Their plain versions (CPU tensors) are
held to the JAX Pallas kernels in interpret mode, and gemm_core under each
switch to the JAX package's gemm_core(use_pallas=True) under the same
switch; a spy on the variant's plain version shows that the variant ran.

Tolerance: bit equality. A fast-mode shift may differ by 1 where its
floored value lies within 1e-4 of an integer (the f32 norm's summation
order; gemmul8_tpu.core.encode.sft_floor_frac), and an accurate-mode shift
likewise (the f32 log2; tests/test_torch_accurate.py); the slices are then
held to the JAX encode at the port's shifts, and a gemm to the exact
product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu.bench.matrices import exact_gemm_f64, phi_matrix
from gemmul8_tpu.core import complexgemm as jcg
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu.types import C64Bits, F64Bits, bits_to_f64, f64_to_bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.types import (c128_to_words, f64_to_words,
                                     words_to_c128, words_to_f64)

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4
SWITCHES = ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
            "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE", "GEMMUL8_MXU_CRT",
            "GEMMUL8_FUSED_RECONSTRUCT")


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    """Every test starts from the switches' defaults, whatever the
    environment says."""
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _mk(shape, phi, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)
    a.ravel()[::13] = 0.0
    return a


def _edge(shape, axis, seed=5):
    """Rows (axis 1) or columns (axis 0) that are all subnormal, all zero,
    partly -0.0, tiny, and a phi = 4 exponent spread elsewhere."""
    m, n = shape if axis == 1 else shape[::-1]
    rng = np.random.default_rng(seed)
    a = phi_matrix(m, n, 4.0, seed=seed)
    a[0, :] = rng.random(n) * 4.9e-324 * rng.integers(
        1, 1 << 40, n).astype(float)
    a[1, :] = 0.0
    a[2, ::3] = -0.0
    a[3, :] = (rng.random(n) - 0.5) * 1e-160
    a[:, 1] = 0.0
    return a if axis == 1 else a.T.copy()


def _both(a):
    """The same bits for both packages: (F64Bits, float64 tensor)."""
    hi, lo = f64_to_words(a)
    return F64Bits(jnp.asarray(hi), jnp.asarray(lo)), words_to_f64(hi, lo)


def _spy(monkeypatch, module, name):
    """Count the calls of module.name from here on."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _assert_fast_sft_rule(ref, got, x, axis, L):
    """Equal, or off by 1 where the floored value is within
    SHIFT_RULE_FRAC of an integer."""
    diff = ref != got
    if not diff.any():
        return
    _, nrm2, _ = enc.fast_stats(x, axis)
    frac = enc.sft_floor_frac(nrm2, x.shape[axis], L).numpy()
    assert np.abs(ref[diff].astype(np.int64) - got[diff]).max() <= 1
    assert frac.reshape(ref.shape)[diff].max() < SHIFT_RULE_FRAC, \
        "shift differs away from a floor boundary"


# ---- B9: fast_encode_fused -----------------------------------------------

def _check_fused_encode(a, L, axis):
    bits, t = _both(a)
    jsl, jsft = pk.fast_encode_fused_pallas(bits, L, axis=axis)
    jsl, jsft = np.asarray(jsl), np.asarray(jsft)
    sl, sft = hk.fast_encode_fused(t, L, axis)
    assert sl.dtype == torch.int8 and tuple(sl.shape) == (L, *a.shape)
    assert sft.dtype == torch.int32 and tuple(sft.shape) == jsft.shape
    _assert_fast_sft_rule(jsft, sft.numpy(), t, axis, L)
    # the same shifts and slices as the two-step path of the port
    assert torch.equal(sft, hk.fast_sft(t, L, axis))
    assert torch.equal(sl, hk.encode_slices(t, sft, L, axis))
    # the JAX encode at the port's shifts, and the fused kernel's slices
    # wherever the shifts agree
    ref = pk.encode_slices_pallas(bits, jnp.asarray(sft.numpy()), L,
                                  axis=axis, block=(64, 128))
    np.testing.assert_array_equal(np.asarray(ref), sl.numpy())
    if np.array_equal(jsft, sft.numpy()):
        np.testing.assert_array_equal(jsl, sl.numpy())


@pytest.mark.parametrize("L", [2, 6, 14, 20])
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_matches_pallas(axis, L):
    shape = (80, 144) if axis == 1 else (144, 80)
    _check_fused_encode(_mk(shape, 2.0, seed=L), L, axis)


@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_two_stats_chunks(axis):
    """k = 2600 > 2048: the chunked online norm merge."""
    shape = (40, 2600) if axis == 1 else (2600, 40)
    _check_fused_encode(_mk(shape, 1.0, seed=6), 14, axis)


@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_edge_values(axis):
    """An all-zero line encodes to zeros with shift 0; -0.0 and subnormal
    lines take the JAX package's shifts."""
    a = _edge((24, 48), axis)
    _check_fused_encode(a, 14, axis)
    sl, sft = hk.fast_encode_fused(torch.from_numpy(a), 14, axis)
    zero = sl[:, 1, :] if axis == 1 else sl[:, :, 1]
    assert int(sft.flatten()[1]) == 0 and not zero.any()


# ---- B10: mag7_fused -----------------------------------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["phi", "edge", "shift4"])
def test_mag7_fused_matches_pallas(axis, kind):
    shape = (70, 300) if axis == 1 else (300, 70)
    a = _edge(shape, axis) if kind == "edge" else _mk(shape, 2.0, seed=3)
    shift = 4 if kind == "shift4" else enc.MAG_SHIFT
    bits, t = _both(a)
    jm, je = pk.mag7_fused_pallas(bits, axis, shift)
    tm, te = hk.mag7_fused(t, axis, shift)
    assert tm.dtype == torch.int8 and tuple(tm.shape) == shape
    assert te.dtype == torch.int32 and tuple(te.shape) == je.shape
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    # the emax + mag7 pair's bits
    e = hk.emax(t, axis)
    assert torch.equal(te, e) and torch.equal(tm, hk.mag7(t, e, axis, shift))


@pytest.mark.parametrize("switch", ["0", "1"])
def test_mag7_operand_dispatch(monkeypatch, switch):
    """GEMMUL8_FUSED_MAG7=1 takes mag7_fused, else the pair; the complex
    magnitudes stay the pair under either, as in the JAX package."""
    monkeypatch.setenv("GEMMUL8_FUSED_MAG7", switch)
    fused = _spy(monkeypatch, hk, "mag7_fused_plain")
    pair = _spy(monkeypatch, hk, "emax_plain")
    x = torch.from_numpy(_mk((20, 36), 1.0, seed=2))
    m, e = hk.mag7_operand(x, 1)
    assert (len(fused), len(pair)) == ((1, 0) if switch == "1" else (0, 1))
    ref = enc.mag7_fused(x, 1)
    assert torch.equal(m, ref[0]) and torch.equal(e, ref[1])
    hk.mag7_operand_complex(x, x, 0)
    assert len(fused) == (1 if switch == "1" else 0)


# ---- B11: magmax_matmul_scratch ------------------------------------------

@pytest.mark.parametrize("mkn", [(384, 256, 384), (200, 300, 136)])
def test_magmax_scratch_matches_pallas(mkn):
    """Multi-tile and ragged grids, against the Pallas kernel's per-tile
    blocks folded in XLA, and the default magnitude GEMM."""
    m, k, n = mkn
    rng = np.random.default_rng(m)
    a8 = rng.integers(0, 65, (m, k), dtype=np.int8)
    b8 = rng.integers(0, 65, (k, n), dtype=np.int8)
    jr, jc = pm.magmax_matmul_scratch(jnp.asarray(a8), jnp.asarray(b8),
                                      block=(128, 128, 128))
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    tr, tc = hm.magmax_matmul_scratch(ta, tb)
    assert tr.dtype == torch.int32 and tuple(tr.shape) == (m, 1)
    assert tc.dtype == torch.int32 and tuple(tc.shape) == (1, n)
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    dr, dc = hm.magmax_matmul(ta, tb)
    assert torch.equal(tr, dr) and torch.equal(tc, dc)


def test_magmax_matmul_dispatch(monkeypatch):
    monkeypatch.setenv("GEMMUL8_MAGMAX_SCRATCH", "1")
    calls = _spy(monkeypatch, hm, "magmax_scratch_plain")
    m8 = torch.ones((4, 6), dtype=torch.int8)
    r, c = hm.magmax_matmul(m8, m8.t())
    assert calls == ["magmax_scratch_plain"]
    assert r.flatten().tolist() == [6] * 4 and c.flatten().tolist() == [6] * 4
    with pytest.raises(ValueError):
        hm.magmax_matmul(m8, m8)


# ---- B12: matmul_mod_u8_pipelined ----------------------------------------

@pytest.mark.parametrize("shape", [(72, 168, 88), (64, 256, 128)])
def test_matmul_mod_pipelined_matches_pallas(shape):
    """The uncentered residues, as the JAX package's pipelined kernel and
    its k-tiled kernel give them."""
    m, k, n = shape
    L = 14
    rng = np.random.default_rng(3)
    a8 = rng.integers(-128, 128, (L, m, k), dtype=np.int8)
    b8 = rng.integers(-128, 128, (L, k, n), dtype=np.int8)
    ref = np.asarray(pm.matmul_mod_u8_pipelined(
        jnp.asarray(a8), jnp.asarray(b8), L, block=(128, 128)))
    ta, tb = torch.from_numpy(a8), torch.from_numpy(b8)
    got = hm.matmul_mod_u8_pipelined(ta, tb, L)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (L, m, n)
    np.testing.assert_array_equal(ref, got.numpy())
    assert torch.equal(got, hm.matmul_mod_u8(ta, tb, L, centered=False))


@pytest.mark.parametrize("switch", ["0", "1"])
@pytest.mark.parametrize("centered", [False, True])
def test_matmul_mod_u8_dispatch(monkeypatch, switch, centered):
    """GEMMUL8_MM_PIPELINE=1 sends uncentered calls, and only those, to the
    pipelined kernel, as the JAX package's matmul_mod_u8 does."""
    monkeypatch.setenv("GEMMUL8_MM_PIPELINE", switch)
    calls = _spy(monkeypatch, hm, "matmul_mod_u8_pipelined_plain")
    rng = np.random.default_rng(1)
    a8 = torch.from_numpy(rng.integers(-128, 128, (6, 9, 40), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-128, 128, (6, 40, 7), dtype=np.int8))
    got = hm.matmul_mod_u8(a8, b8, 6, centered=centered)
    assert len(calls) == (1 if switch == "1" and not centered else 0)
    assert torch.equal(got, hm.matmul_mod_u8_plain(a8, b8, 6, centered))


# ---- gemm_core under each switch -----------------------------------------

# (env, fastmode, spied plain version, plain versions the variant replaces)
GEMM_SWITCHES = {
    "fused_encode": ({"GEMMUL8_FUSED_ENCODE": "1"}, True,
                     (hk, "fast_encode_fused_plain"),
                     [(hk, "fast_sft_plain"), (hk, "encode_slices_plain")]),
    "mm_pipeline_fast": (
        {"GEMMUL8_MM_PIPELINE": "1", "GEMMUL8_MXU_CRT": "0"}, True,
        (hm, "matmul_mod_u8_pipelined_plain"), [(hm, "matmul_mod_u8_plain")]),
    "mm_pipeline_accurate": (
        {"GEMMUL8_MM_PIPELINE": "1", "GEMMUL8_MXU_CRT": "0"}, False,
        (hm, "matmul_mod_u8_pipelined_plain"), [(hm, "matmul_mod_u8_plain")]),
    "fused_mag7": ({"GEMMUL8_FUSED_MAG7": "1"}, False,
                   (hk, "mag7_fused_plain"),
                   [(hk, "emax_plain"), (hk, "mag7_plain")]),
    "magmax_scratch": ({"GEMMUL8_MAGMAX_SCRATCH": "1"}, False,
                       (hm, "magmax_scratch_plain"), [(hm, "magmax_plain")]),
    # MXU_CRT=0 alone: uncentered residues through the default kernels
    "uncentered_fast": ({"GEMMUL8_MXU_CRT": "0"}, True, None,
                        [(hm, "matmul_mod_u8_pipelined_plain")]),
    # MM_PIPELINE=1 alone: the residues stay centered, so the JAX package
    # never reaches its pipelined kernel, and neither does the port
    "mm_pipeline_centered": ({"GEMMUL8_MM_PIPELINE": "1"}, True, None,
                             [(hm, "matmul_mod_u8_pipelined_plain")]),
}


def _port_shifts(ta, tb, L, fastmode):
    if fastmode:
        return hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0)
    return tg.accurate_sfts(ta, tb, L)


def _jax_shifts(a, b, L, fastmode):
    A, B = f64_to_bits(a), f64_to_bits(b)
    if fastmode:
        return (pk.fast_sft_pallas(A, L, axis=1),
                pk.fast_sft_pallas(B, L, axis=0))
    return gg.accurate_sfts(A, B, L, use_pallas=True)


@pytest.mark.parametrize("name", list(GEMM_SWITCHES))
def test_gemm_core_under_switch_matches_jax(monkeypatch, name):
    env, fastmode, spied, replaced = GEMM_SWITCHES[name]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    L = 14
    a, b = _mk((72, 200), 0.5, seed=3), _mk((200, 56), 0.5, seed=4)
    ref = bits_to_f64(gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L,
                                   fastmode, "f64", use_pallas=True),
                      to_numpy=True)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    taken = _spy(monkeypatch, *spied) if spied else []
    skipped = [_spy(monkeypatch, *mod_name) for mod_name in replaced]
    got = tg.gemm_core(ta, tb, L, fastmode=fastmode).numpy()
    assert bool(taken) == bool(spied), "the variant did not run"
    assert not any(skipped), "a replaced kernel ran under the switch"
    sa, sb = _port_shifts(ta, tb, L, fastmode)
    ja, jb = (np.asarray(s) for s in _jax_shifts(a, b, L, fastmode))
    if np.array_equal(ja, sa.numpy()) and np.array_equal(jb, sb.numpy()):
        np.testing.assert_array_equal(ref.view(np.uint64),
                                      got.view(np.uint64))
    else:  # a floor-boundary shift: both encodings valid, both accurate
        assert np.abs(ja.astype(np.int64) - sa.numpy()).max() <= 1
        assert np.abs(jb.astype(np.int64) - sb.numpy()).max() <= 1
        scale = np.abs(a) @ np.abs(b)
        assert np.all(np.abs(got - exact_gemm_f64(a, b))
                      <= 1e-12 * scale + 1e-300)
    # and the port's default call's bits
    for key in env:
        monkeypatch.delenv(key)
    default = tg.gemm_core(ta, tb, L, fastmode=fastmode).numpy()
    np.testing.assert_array_equal(default.view(np.uint64),
                                  got.view(np.uint64))


def test_gemm_fused_encode_two_stats_chunks(monkeypatch):
    """The public entry point under GEMMUL8_FUSED_ENCODE=1 at k = 2600."""
    monkeypatch.setenv("GEMMUL8_FUSED_ENCODE", "1")
    calls = _spy(monkeypatch, hk, "fast_encode_fused_plain")
    a, b = _mk((24, 2600), 1.0, seed=6), _mk((2600, 20), 1.0, seed=7)
    got = gt.gemm(a, b, num_moduli=14, device="cpu")
    assert len(calls) == 2
    monkeypatch.delenv("GEMMUL8_FUSED_ENCODE")
    ref = gt.gemm(a, b, num_moduli=14, device="cpu")
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))


# ---- complex accurate mode under the switches ----------------------------

def _cplx(m, n, seed):
    return (phi_matrix(m, n, 0.5, seed=seed)
            + 1j * phi_matrix(m, n, 0.5, seed=seed + 1))


@pytest.mark.parametrize("env", [{"GEMMUL8_MAGMAX_SCRATCH": "1"},
                                 {"GEMMUL8_MXU_CRT": "0"}])
def test_complex_accurate_under_switch_matches_jax(monkeypatch, env):
    """The complex magnitude GEMM takes the deferred fold, and the complex
    residues follow GEMMUL8_MXU_CRT, as in the JAX package; the bits are
    the default call's."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    L = 14
    a, b = _cplx(40, 72, seed=3), _cplx(72, 24, seed=5)
    rw, iw = c128_to_words(a)
    A = C64Bits(F64Bits(*map(jnp.asarray, rw)), F64Bits(*map(jnp.asarray, iw)))
    ta = words_to_c128(rw, iw)
    rw, iw = c128_to_words(b)
    B = C64Bits(F64Bits(*map(jnp.asarray, rw)), F64Bits(*map(jnp.asarray, iw)))
    tb = words_to_c128(rw, iw)
    strat = gt.ComputeType.COMPLEX_KARATSUBA_MULT
    ref_re, ref_im = jcg.gemm_complex_core(
        A.re, A.im, B.re, B.im, L, False, jcg.ComputeType[strat.name], "f64",
        use_pallas=True)
    scratch = _spy(monkeypatch, hm, "magmax_scratch_plain")
    got = gt.gemm(ta, tb, num_moduli=L, fastmode=False, compute_type=strat)
    assert len(scratch) == (1 if "GEMMUL8_MAGMAX_SCRATCH" in env else 0)
    parts = [torch.from_numpy(np.ascontiguousarray(x))
             for x in (a.real, a.imag, b.real, b.imag)]
    sa, sb = cg.accurate_sfts_complex(*parts, L)
    ja, jb = jcg._accurate_sfts_pallas(A.re, A.im, B.re, B.im, L)
    got = got.numpy()
    if np.array_equal(np.asarray(ja), sa.numpy()) and np.array_equal(
            np.asarray(jb), sb.numpy()):
        for ref, x in ((ref_re, got.real), (ref_im, got.imag)):
            np.testing.assert_array_equal(
                bits_to_f64(ref, to_numpy=True).view(np.uint64),
                np.ascontiguousarray(x).view(np.uint64))
    for key in env:
        monkeypatch.delenv(key)
    default = gt.gemm(ta, tb, num_moduli=L, fastmode=False,
                      compute_type=strat).numpy()
    np.testing.assert_array_equal(default.view(np.uint64),
                                  got.view(np.uint64))


# ---- GEMMUL8_PIPELINE (its levels run: tests/test_torch_pipelined.py) ----

def test_pipeline_switch_values(monkeypatch):
    """An empty GEMMUL8_PIPELINE is 0, as in the JAX package; a value
    outside 0..3 is an error."""
    a = torch.ones((4, 4), dtype=torch.float64)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "")
    assert torch.equal(tg.gemm_core(a, a, 14),
                       torch.full((4, 4), 4.0, dtype=torch.float64))
    monkeypatch.setenv("GEMMUL8_PIPELINE", "4")
    with pytest.raises(ValueError, match="GEMMUL8_PIPELINE"):
        tg.gemm_core(a, a, 14)


def test_variant_wrapper_argument_errors():
    x = torch.ones((4, 6), dtype=torch.float64)
    # float64 and float32 operands are taken (the f32 forms); others raise
    with pytest.raises(TypeError):
        hk.fast_encode_fused(x.half(), 14, 1)
    with pytest.raises(ValueError):
        hk.fast_encode_fused(x, 14, 2)
    with pytest.raises(TypeError):
        hk.mag7_fused(x.half(), 1)
    with pytest.raises(ValueError):
        hk.mag7_fused(x, 2)
    m8 = torch.ones((4, 6), dtype=torch.int8)
    with pytest.raises(ValueError):
        hm.magmax_matmul_scratch(m8, m8)
    with pytest.raises(TypeError):
        hm.matmul_mod_u8_pipelined(m8[None].int(), m8.t()[None], 1)
    with pytest.raises(ValueError):
        hm.matmul_mod_u8_pipelined(m8[None], m8[None], 1)
    with pytest.raises(ValueError):
        hm.matmul_mod_u8_pipelined(m8[None], m8.t()[None], 2)


# ---- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_on_card(axis):
    """The kernel's shifts are the fast_sft kernel's bits, its slices the
    plain encode's at those shifts."""
    _card()
    shape = (300, 4100) if axis == 1 else (4100, 300)
    x = torch.from_numpy(_edge(shape, axis)).cuda()
    for L in (2, 14, 20):
        sl, sft = hk.fast_encode_fused(x, L, axis)
        assert torch.equal(sft, hk.fast_sft(x, L, axis))
        assert torch.equal(sl, hk.encode_slices_plain(x, sft, L, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_mag7_fused_on_card(axis):
    _card()
    shape = (300, 777) if axis == 1 else (777, 300)
    x = torch.from_numpy(_edge(shape, axis)).cuda()
    m, e = hk.mag7_fused(x, axis)
    pm_, pe = hk.mag7_fused_plain(x, axis)
    assert torch.equal(m, pm_) and torch.equal(e, pe)


@pytest.mark.cuda
def test_magmax_scratch_on_card():
    _card()
    rng = np.random.default_rng(5)
    a8 = torch.from_numpy(rng.integers(0, 65, (300, 777), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(0, 65, (777, 200), dtype=np.int8))
    got = hm.magmax_matmul_scratch(a8.cuda(), b8.cuda())
    ref = hm.magmax_scratch_plain(a8, b8)
    assert all(torch.equal(x.cpu(), y) for x, y in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(300, 5, 200), (1000, 777, 1500)])
def test_matmul_mod_pipelined_on_card(mkn):
    _card()
    m, k, n = mkn
    rng = np.random.default_rng(7)
    for L in (2, 14, 20):
        a8 = torch.from_numpy(rng.integers(-128, 128, (L, m, k),
                                           dtype=np.int8)).cuda()
        b8 = torch.from_numpy(rng.integers(-128, 128, (L, k, n),
                                           dtype=np.int8)).cuda()
        got = hm.matmul_mod_u8_pipelined(a8, b8, L)
        assert torch.equal(got, hm.matmul_mod_u8_pipelined_plain(a8, b8, L))
        assert torch.equal(got, hm.matmul_mod_u8(a8, b8, L, centered=False))


@pytest.mark.cuda
def test_variant_calls_on_card_give_default_bits(monkeypatch):
    """Each variant call's launch counts show its kernel, and its output
    is the default call's bits."""
    _card()
    from gemmul8_tpu_torch.hopper import build

    a, b = _mk((300, 260), 0.5, seed=8), _mk((260, 200), 0.5, seed=9)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    for env, fastmode, kernel in (
            ({"GEMMUL8_FUSED_ENCODE": "1"}, True, "fast_encode_fused"),
            ({"GEMMUL8_MM_PIPELINE": "1", "GEMMUL8_MXU_CRT": "0"}, True,
             "matmul_mod_u8_pipelined"),
            ({"GEMMUL8_FUSED_MAG7": "1"}, False, "mag7_fused"),
            ({"GEMMUL8_MAGMAX_SCRATCH": "1"}, False,
             "magmax_matmul_scratch")):
        ref = gt.gemm(ta, tb, num_moduli=14, fastmode=fastmode)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        build.LAUNCHES.clear()
        got = gt.gemm(ta, tb, num_moduli=14, fastmode=fastmode)
        torch.cuda.synchronize()
        assert build.LAUNCHES[kernel] >= 1
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
        for key in env:
            monkeypatch.delenv(key)


def test_max_k_constant():
    """The pipelined kernel takes k up to the port's limit, as the default
    kernel does (the JAX kernel's k <= bk came from the TPU's table)."""
    rng = np.random.default_rng(2)
    k = tables.MAX_K
    a8 = torch.from_numpy(rng.integers(-128, 128, (1, 2, k), dtype=np.int8))
    b8 = torch.from_numpy(rng.integers(-128, 128, (1, k, 2), dtype=np.int8))
    got = hm.matmul_mod_u8_pipelined(a8, b8, 1)
    want = (a8[0].long() @ b8[0].long()) % tables.MODULI[0]
    assert torch.equal(got[0].long(), want)
    with pytest.raises(ValueError, match="2\\^17"):
        hm.matmul_mod_u8_pipelined(torch.zeros((1, 2, k + 1), dtype=torch.int8),
                                   torch.zeros((1, k + 1, 2), dtype=torch.int8),
                                   1)
