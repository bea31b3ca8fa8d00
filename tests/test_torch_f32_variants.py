"""The f32 forms of the one-shot variants and of the statistics mode vs the
JAX package, on the same bits.

fast_sft's statistics mode (`fast_stats`), `fast_encode_fused`,
`mag7_fused` and `matmul_reconstruct` take float32 operands (f32 output
for the last) as well as float64 ones. Their plain versions (CPU tensors)
are held to the JAX Pallas kernels in interpret mode on float32 arrays,
with f32 subnormal, zero, -0.0, infinite and NaN lines, and `gemm` on f32
and mixed calls under GEMMUL8_FUSED_ENCODE=1, GEMMUL8_FUSED_MAG7=1 and
GEMMUL8_FUSED_RECONSTRUCT=1 to the default call (and to the JAX package's
gemm), with a spy showing that the variant ran.

Tolerance: bit equality. A fast-mode shift may differ by 1 where its
floored value lies within 1e-4 of an integer (the f32 norm's summation
order; gemmul8_tpu.core.encode.sft_floor_frac), an accurate-mode shift
likewise (the f32 log2, ROADMAP C3); the slices are then held to the JAX
encode at the port's shifts, and a gemm to the exact product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import megakernel as mk
from gemmul8_tpu.types import f64_to_bits
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4
SWITCHES = ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
            "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE", "GEMMUL8_MXU_CRT",
            "GEMMUL8_FUSED_RECONSTRUCT")


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    for key in SWITCHES:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _f32(shape, axis, seed, special=True, phi=2.0):
    """An f32 operand of `shape` whose lines (rows for axis=1, columns for
    axis=0) include: all subnormal, all zero, -0.0 and subnormals among
    normals, an infinity of each sign, a NaN, values near FLT_MAX."""
    m, n = shape if axis == 1 else shape[::-1]
    rng = np.random.default_rng(seed)
    a = ((rng.random((m, n)) - 0.5)
         * np.exp(rng.standard_normal((m, n)) * phi)).astype(np.float32)
    a.ravel()[::13] = 0.0
    if special:
        a[0, :] = rng.integers(1, 1 << 23, n).astype(np.uint32).view(
            np.float32)
        a[1, :] = 0.0
        a[2, ::3] = -0.0
        a[2, 1::5] = np.uint32(9).view(np.float32)
        a[3, 2] = np.inf
        a[3, 5] = -np.inf
        a[4, 1] = np.uint32(0x7FC00123).view(np.float32)
        a[5, ::4] = np.float32(3.3e38) * rng.choice([-1, 1], a[5, ::4].size)
    return a if axis == 1 else np.ascontiguousarray(a.T)


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(args[0].dtype)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _assert_fast_rule(ref, got, x, axis, L, k_total=None):
    """Equal, or off by 1 where the floored value is within
    SHIFT_RULE_FRAC of an integer."""
    diff = ref != got
    if not diff.any():
        return
    _, nrm2, _ = enc.fast_stats(x, axis)
    frac = enc.sft_floor_frac(nrm2, k_total or x.shape[axis], L).numpy()
    assert np.abs(ref[diff].astype(np.int64) - got[diff]).max() <= 1
    assert frac.reshape(ref.shape)[diff].max() < SHIFT_RULE_FRAC, \
        "shift differs away from a floor boundary"


# ---- fast_sft's statistics mode, f32 ---------------------------------------

@pytest.mark.parametrize("case", [((40, 136), True), ((24, 2600), False),
                                  ((24, 2600), True)],
                         ids=["special", "two_chunks", "two_chunks_special"])
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_stats_f32_matches_pallas(case, axis):
    """(emax, nrm2, anyfinite) of an f32 operand: emax and the flag equal
    to fast_sft_pallas(return_stats=True)'s, the norm giving the same
    shift under the floor rule (bit-equal where the summation orders
    agree), at 8 and 14 moduli."""
    shape, special = case
    shape = shape if axis == 1 else shape[::-1]
    x = _f32(shape, axis, seed=shape[0], special=special, phi=1.0)
    je, js, ja = (np.asarray(v) for v in pk.fast_sft_pallas(
        jnp.asarray(x), 8, axis, return_stats=True))
    t = torch.from_numpy(x)
    e, s, a = hk.fast_stats(t, axis)
    assert e.dtype == torch.int64 and s.dtype == torch.float32
    assert tuple(e.shape) == je.shape
    np.testing.assert_array_equal(je, e.numpy())
    np.testing.assert_array_equal(ja.astype(bool), a.numpy())
    fin = np.isfinite(js)
    np.testing.assert_allclose(s.numpy()[fin], js[fin], rtol=1e-6)
    for L in (8, 14):
        ref = np.asarray(enc.sft_from_stats(torch.tensor(je),
                                            torch.tensor(js),
                                            torch.tensor(ja > 0),
                                            x.shape[axis], L, 24))
        got = enc.sft_from_stats(e, s, a, x.shape[axis], L, 24).numpy()
        _assert_fast_rule(ref, got, t, axis, L)
        np.testing.assert_array_equal(got, hk.fast_sft(t, L, axis).numpy())


# ---- fast_encode_fused, f32 ------------------------------------------------

def _check_fused_encode(x, L, axis):
    jsl, jsft = pk.fast_encode_fused_pallas(jnp.asarray(x), L, axis=axis)
    jsl, jsft = np.asarray(jsl), np.asarray(jsft)
    t = torch.from_numpy(x)
    sl, sft = hk.fast_encode_fused(t, L, axis)
    assert sl.dtype == torch.int8 and tuple(sl.shape) == (L, *x.shape)
    assert sft.dtype == torch.int32 and tuple(sft.shape) == jsft.shape
    _assert_fast_rule(jsft, sft.numpy(), t, axis, L)
    assert torch.equal(sft, hk.fast_sft(t, L, axis))
    assert torch.equal(sl, hk.encode_slices(t, sft, L, axis))
    ref = pk.encode_slices_pallas(jnp.asarray(x), jnp.asarray(sft.numpy()),
                                  L, axis=axis, block=(64, 128))
    np.testing.assert_array_equal(np.asarray(ref), sl.numpy())
    if np.array_equal(jsft, sft.numpy()):
        np.testing.assert_array_equal(jsl, sl.numpy())


@pytest.mark.parametrize("L", [2, 8, 14, 20])
@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_f32_matches_pallas(axis, L):
    """Shifts at bias 127 and left shifts up to 53 (20 moduli) on lines of
    f32 subnormals, zeros, -0.0, infinities, a NaN and values near
    FLT_MAX."""
    _check_fused_encode(_f32((48, 144), axis, seed=L), L, axis)


@pytest.mark.parametrize("axis", [0, 1])
def test_fast_encode_fused_f32_two_stats_chunks(axis):
    shape = (24, 2600) if axis == 1 else (2600, 24)
    _check_fused_encode(_f32(shape, axis, seed=6, special=False, phi=1.0), 8,
                        axis)


# ---- mag7_fused, f32 -------------------------------------------------------

@pytest.mark.parametrize("kind", ["phi", "special", "shift4"])
@pytest.mark.parametrize("axis", [0, 1])
def test_mag7_fused_f32_matches_pallas(axis, kind):
    shape = (70, 300) if axis == 1 else (300, 70)
    x = _f32(shape, axis, seed=3, special=kind == "special")
    shift = 4 if kind == "shift4" else enc.MAG_SHIFT
    jm, je = pk.mag7_fused_pallas(jnp.asarray(x), axis, shift)
    t = torch.from_numpy(x)
    tm, te = hk.mag7_fused(t, axis, shift)
    assert tm.dtype == torch.int8 and tuple(tm.shape) == shape
    assert te.dtype == torch.int32 and tuple(te.shape) == je.shape
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    e = hk.emax(t, axis)
    assert torch.equal(te, e) and torch.equal(tm, hk.mag7(t, e, axis, shift))
    if kind == "special":   # the subnormal-only line: max exponent 1
        assert int(te.flatten()[0]) == 1


# ---- matmul_reconstruct, f32 output ----------------------------------------

@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_matmul_reconstruct_f32_matches_pallas(L):
    """f32 output rounded once from the integer, over shifts that take the
    results from f32 subnormals (and zero) to overflow (inf)."""
    m, k, n = 136, 72, 200
    rng = np.random.default_rng(L)
    a8 = rng.integers(-128, 128, (L, m, k), dtype=np.int8)
    b8 = rng.integers(-128, 128, (L, k, n), dtype=np.int8)
    sa = (rng.integers(-90, 90, (m, 1)) + 4 * L).astype(np.int32)
    sb = (rng.integers(-90, 90, (1, n)) + 4 * L).astype(np.int32)
    ref = np.asarray(mk.matmul_reconstruct_pallas(
        *map(jnp.asarray, (a8, b8, sa, sb)), L, "f32", block=(128, 128)))
    args = [torch.from_numpy(v) for v in (a8, b8, sa, sb)]
    got = hm.matmul_reconstruct(*args, L, "f32")
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(ref.view(np.uint32),
                                  got.numpy().view(np.uint32))
    r8 = hm.matmul_mod_u8(args[0], args[1], L, centered=True)
    want = hk.reconstruct(r8, args[2], args[3], L, "f32")
    assert torch.equal(want.view(torch.int32), got.view(torch.int32))
    vals = got.numpy()
    assert np.isinf(vals).any() and (vals == 0).any()
    assert (np.abs(vals[vals != 0]) < np.finfo(np.float32).tiny).any()


# ---- gemm under each switch on f32 calls -----------------------------------

# switch -> (fastmode, the variant's plain version, the ones it replaces)
VARIANTS = {
    "GEMMUL8_FUSED_ENCODE": (True, (hk, "fast_encode_fused_plain"),
                             [(hk, "fast_sft_plain"),
                              (hk, "encode_slices_plain")]),
    "GEMMUL8_FUSED_MAG7": (False, (hk, "mag7_fused_plain"),
                           [(hk, "emax_plain"), (hk, "mag7_plain")]),
    "GEMMUL8_FUSED_RECONSTRUCT": (True, (hm, "matmul_reconstruct_plain"),
                                  [(hm, "matmul_mod_u8_plain"),
                                   (hk, "reconstruct_plain")]),
}


def _jax_operand(x):
    return f64_to_bits(x) if x.dtype == np.float64 else jnp.asarray(x)


@pytest.mark.parametrize("f32_in", ["a", "b", "out"])
@pytest.mark.parametrize("switch", list(VARIANTS))
def test_f32_call_under_switch_gives_default_bits(monkeypatch, switch,
                                                  f32_in):
    """A float32 A, a float32 B, or f32 output: the switch runs its
    variant's f32 form (a spy on its plain version), none of the kernels
    it replaces, and the call gives the default call's bits, which are the
    JAX package's default call's (under the floor rule)."""
    fastmode, variant, replaced = VARIANTS[switch]
    rng = np.random.default_rng(len(switch) + len(f32_in))
    a = (rng.random((24, 40)) - 0.5) * np.exp(rng.standard_normal((24, 40)))
    b = (rng.random((40, 16)) - 0.5) * np.exp(rng.standard_normal((40, 16)))
    kw = dict(num_moduli=8, fastmode=fastmode)
    if f32_in == "a":
        a = a.astype(np.float32)
    elif f32_in == "b":
        b = b.astype(np.float32)
    else:
        kw["out_dtype"] = "f32"
    default = gt.gemm(a, b, device="cpu", **kw).numpy()
    monkeypatch.setenv(switch, "1")
    taken = _spy(monkeypatch, *variant)
    skipped = [_spy(monkeypatch, *mod_name) for mod_name in replaced]
    got = gt.gemm(a, b, device="cpu", **kw).numpy()
    if switch == "GEMMUL8_FUSED_RECONSTRUCT":
        assert taken == [torch.int8]
    else:
        want = [torch.float32 if f32_in == "a" else torch.float64,
                torch.float32 if f32_in == "b" else torch.float64]
        assert sorted(map(str, taken)) == sorted(map(str, want))
    assert not any(skipped), "a replaced kernel ran under the switch"
    assert got.dtype == default.dtype
    np.testing.assert_array_equal(got.view(np.uint8), default.view(np.uint8))
    monkeypatch.delenv(switch)
    ref = np.asarray(g8.gemm(a, b, out_dtype=kw.get("out_dtype"),
                             num_moduli=8, fastmode=fastmode))
    ja, jb = _jax_operand(a), _jax_operand(b)
    if fastmode:
        js = (gg._fast_sft_only(ja, 8, axis=1), gg._fast_sft_only(jb, 8,
                                                                  axis=0))
        ps = (hk.fast_sft(torch.from_numpy(a), 8, 1),
              hk.fast_sft(torch.from_numpy(b), 8, 0))
    else:
        js = gg.accurate_sfts(ja, jb, 8)
        ps = tg.accurate_sfts(torch.from_numpy(a), torch.from_numpy(b), 8)
    if all(np.array_equal(np.asarray(j), p.numpy()) for j, p in zip(js, ps)):
        np.testing.assert_array_equal(ref.view(np.uint8), got.view(np.uint8))
    else:
        exact = a.astype(np.float64) @ b.astype(np.float64)
        scale = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
        tol = 2.0 ** -20 if got.dtype == np.float32 else 1e-6
        assert np.all(np.abs(got - exact) <= tol * scale)
