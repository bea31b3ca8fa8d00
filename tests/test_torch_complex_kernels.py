"""The complex path's pieces in the port vs the JAX package, on the same
bits: the complex residue GEMM, the Karatsuba sum slices, the joint
fast-mode shift and the complex accurate-mode magnitudes and shifts. The
JAX side runs its Pallas kernels in interpret mode.

Tolerance: bit equality, with the shift exception the real path has. A
fast-mode shift may differ by 1 where the pre-floor value of its joint
norm (k_total = 2k) lies within 1e-4 of an integer (`sft_floor_frac`:
the two packages sum the f32 norms in different orders); an accurate-mode
shift where -0.51 * log2(smax) + T does (`accurate_sft_floor_frac`: the
f32 log2 differs). Every such difference is checked against its rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.bench.matrices import phi_matrix
from gemmul8_tpu.core import complexgemm as jcg
from gemmul8_tpu.core import encode as jenc
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.types import f64_to_words, words_to_f64

from test_torch_threads import one_torch_thread  # noqa: E402, F401

SHIFT_RULE_FRAC = 1e-4


def _both(a):
    """The same bits for both packages: (F64Bits, float64 tensor)."""
    hi, lo = f64_to_words(a)
    return F64Bits(jnp.asarray(hi), jnp.asarray(lo)), words_to_f64(hi, lo)


def _edge_pair_rows(m, n, seed):
    """(Re, Im), phi = 2, whose rows 0-5 are: Im all zero; both parts
    subnormal only; both all -0.0; Re all zero; Re spread over
    2^-300 .. 2^300 with Im partly -0.0; Re partly -0.0 with Im
    subnormal."""
    rng = np.random.default_rng(seed)
    re = phi_matrix(m, n, 2.0, seed=seed)
    im = phi_matrix(m, n, 2.0, seed=seed + 1)

    def subnormal():
        return rng.random(n) * 4.9e-324 * rng.integers(1, 1 << 40, n)

    im[0, :] = 0.0
    re[1, :], im[1, :] = subnormal(), subnormal()
    re[2, :], im[2, :] = -0.0, -0.0
    re[3, :] = 0.0
    re[4, :] = ((rng.random(n) + 0.5) * rng.choice([-1.0, 1.0], n)
                * 2.0 ** rng.integers(-300, 301, n).astype(float))
    im[4, ::3] = -0.0
    re[5, ::2] = -0.0
    im[5, :] = subnormal()
    return re, im


def _operand(shape, axis, kind, seed):
    """(Re, Im) of an (m, n) operand; kind "edge" puts the special lines
    along `axis` (1: rows of A, 0: columns of B)."""
    m, n = shape
    if kind == "phi":
        return (phi_matrix(m, n, 0.5, seed=seed),
                phi_matrix(m, n, 0.5, seed=seed + 1))
    if axis == 1:
        return _edge_pair_rows(m, n, seed)
    re, im = _edge_pair_rows(n, m, seed)
    return re.T.copy(), im.T.copy()


def _assert_fast_rule(ref, got, re, im, axis, L):
    """Equal, or off by 1 where the joint norm's pre-floor value lies
    within SHIFT_RULE_FRAC of an integer. Returns how many differ."""
    ref = np.asarray(ref).astype(np.int64)
    got = np.asarray(got).astype(np.int64)
    diff = ref != got
    if not diff.any():
        return 0
    _, nrm2, _ = enc.merge_stats(enc.fast_stats(re, axis),
                                 enc.fast_stats(im, axis))
    frac = enc.sft_floor_frac(nrm2, 2 * re.shape[axis], L).numpy()
    assert np.abs(ref[diff] - got[diff]).max() <= 1
    assert frac.reshape(ref.shape)[diff].max() < SHIFT_RULE_FRAC, \
        "shift differs away from a floor boundary"
    return int(diff.sum())


def _assert_accurate_rule(ref, got, smax, L):
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


# ---- the complex residue GEMM ----------------------------------------------

def _slices(L, shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, (L,) + shape,
                                                dtype=np.int8)


@pytest.mark.parametrize("mkn", [(40, 72, 24), (40, 40, 24)],
                         ids=["ragged", "m_eq_k"])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("form", ["4dot", "kara"])
def test_matmul_complex_mod_matches_pallas(form, centered, L, mkn):
    """Both forms, centered and not, every moduli count the kernel may see;
    m == k != n is the shape at which a shape-keyed pad once mixed up A
    and B in the JAX kernel."""
    m, k, n = mkn
    a = [_slices(L, (m, k), seed=L + i) for i in range(3)]
    b = [_slices(L, (k, n), seed=50 + L + i) for i in range(3)]
    kara = form == "kara"
    ref = pm.matmul_complex_mod_pallas(
        *map(jnp.asarray, (a[0], a[1], b[0], b[1])), L, centered=centered,
        kara=(jnp.asarray(a[2]), jnp.asarray(b[2])) if kara else None)
    t = [torch.from_numpy(x) for x in a + b]
    got = hm.matmul_complex_mod(t[0], t[1], t[3], t[4], L, centered=centered,
                                kara=(t[2], t[5]) if kara else None)
    for r, g in zip(ref, got):
        assert g.dtype == (torch.int8 if centered else torch.uint8)
        assert tuple(g.shape) == (L, m, n)
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_matmul_complex_mod_forms_agree_on_residues():
    """On real residue slices (centered, with their Karatsuba sums) the two
    forms give the same bits, and the int8 extremes of the modulus-256
    lane stay exact."""
    L, m, k, n = 20, 33, 257, 17
    ar = np.full((L, m, k), -128, np.int8)
    ai = _slices(L, (m, k), seed=1)
    br = np.full((L, k, n), -128, np.int8)
    bi = _slices(L, (k, n), seed=2)
    ar[:, ::2, ::3] = 127
    t = [torch.from_numpy(x) for x in (ar, ai, br, bi)]
    # fold every slice into its modulus' centered range first
    t = [sg.recenter_add_int8(x, torch.zeros_like(x), L) for x in t]
    s_a = sg.recenter_add_int8(t[0], t[1], L)
    s_b = sg.recenter_add_int8(t[2], t[3], L)
    four = hm.matmul_complex_mod(*t, L)
    three = hm.matmul_complex_mod(*t, L, kara=(s_a, s_b))
    for x, y in zip(four, three):
        assert torch.equal(x, y)
    re = [a.double() for a in t]
    for l in (0, 7, 19):
        mod = tables.MODULI[l]
        want = (re[0][l] @ re[2][l] - re[1][l] @ re[3][l]).long() % mod
        assert torch.equal(four[0][l].long(), want)


def test_recenter_add_int8_exhaustive():
    """Every pair of int8 values, for every modulus: bit-equal to the JAX
    package's _recenter_add_int8."""
    L = tables.MAX_MODULI
    v = np.arange(-128, 128, dtype=np.int8)
    x = np.broadcast_to(v[:, None], (L, 256, 256)).copy()
    y = np.broadcast_to(v[None, :], (L, 256, 256)).copy()
    ref = np.asarray(jcg._recenter_add_int8(jnp.asarray(x), jnp.asarray(y),
                                            L))
    got = sg.recenter_add_int8(torch.from_numpy(x), torch.from_numpy(y), L)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(ref, got.numpy())


# ---- the joint fast-mode shift ---------------------------------------------

@pytest.mark.parametrize("case", [((96, 160), "phi"), ((40, 2600), "phi"),
                                  ((2600, 40), "phi"), ((40, 72), "edge")],
                         ids=["phi", "two_chunks_rows", "two_chunks_cols",
                              "edge"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("L", [6, 14])
def test_joint_fast_sft_matches_pallas(case, axis, L):
    """Bit-equal to _joint_sft_pallas (the JAX Pallas branch), under the
    floor-boundary rule; against encode_fast_complex (the flat jnp sum)
    under the same rule."""
    shape, kind = case
    re, im = _operand(shape, axis, kind, seed=L)
    (bre, tre), (bim, tim) = _both(re), _both(im)
    got = enc.joint_fast_sft(tre, tim, L, axis)
    assert got.dtype == torch.int32
    via_wrapper = enc.joint_fast_sft(tre, tim, L, axis, stats=hk.fast_stats)
    assert torch.equal(got, via_wrapper)
    ref = jcg._joint_sft_pallas(bre, bim, L, axis)
    assert tuple(got.shape) == ref.shape
    _assert_fast_rule(ref, got, tre, tim, axis, L)
    _, _, ref_jnp = jenc.encode_fast_complex(bre, bim, L, axis)
    _assert_fast_rule(ref_jnp, got, tre, tim, axis, L)
    if kind == "edge":
        lines = got.numpy().ravel()
        assert lines[2] == 0  # both parts -0.0: no nonzero element


def test_merge_stats_one_part_zero():
    """A part with no nonzero element leaves the other's statistics
    unchanged (scale 2^0 on it, and 0 on the empty part's zero norm)."""
    re = torch.from_numpy(phi_matrix(8, 40, 1.0, seed=3))
    im = torch.zeros_like(re)
    e, s, a = enc.merge_stats(enc.fast_stats(re, 1), enc.fast_stats(im, 1))
    e0, s0, a0 = enc.fast_stats(re, 1)
    assert torch.equal(e, e0) and torch.equal(a, a0)
    assert torch.equal(s.view(torch.int32), s0.view(torch.int32))


# ---- accurate mode: magnitudes at shift 4 and the shared shifts ------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("kind", ["phi", "edge"])
def test_mag7_shift4_and_complex_magnitudes_match(axis, kind):
    shape = (40, 72) if axis == 1 else (72, 40)
    re, im = _operand(shape, axis, kind, seed=11)
    (bre, tre), (bim, tim) = _both(re), _both(im)
    je = jnp.maximum(pk.emax_pallas(bre, axis), pk.emax_pallas(bim, axis))
    te = torch.maximum(hk.emax(tre, axis), hk.emax(tim, axis))
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    for b, t in ((bre, tre), (bim, tim)):
        jm = pk.mag7_pallas(b, je, axis, enc.MAG_SHIFT_COMPLEX)
        tm = hk.mag7(t, te, axis, enc.MAG_SHIFT_COMPLEX)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        assert int(tm.max()) <= 32
    tm, te2 = hk.mag7_operand_complex(tre, tim, axis)
    assert tm.dtype == torch.int8 and tuple(tm.shape) == shape
    assert torch.equal(te2, te)
    for jm, je3 in (jcg._mag7_complex_pallas(bre, bim, axis),
                    jenc.mag7_complex(bre, bim, axis)):
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        np.testing.assert_array_equal(np.asarray(je3), te.numpy())
    assert int(tm.min()) >= 0 and int(tm.max()) <= 64


@pytest.mark.parametrize("L", [8, 14, 20])
def test_accurate_sfts_complex_match_pallas(L):
    a_re, a_im = _operand((40, 72), 1, "edge", seed=20)
    b_re, b_im = _operand((72, 32), 0, "edge", seed=30)
    ba, ta = zip(*(_both(x) for x in (a_re, a_im)))
    bb, tb = zip(*(_both(x) for x in (b_re, b_im)))
    got_a, got_b = cg.accurate_sfts_complex(*ta, *tb, L)
    assert got_a.dtype == torch.int32 and tuple(got_a.shape) == (40, 1)
    assert got_b.dtype == torch.int32 and tuple(got_b.shape) == (1, 32)
    ref_a, ref_b = jcg._accurate_sfts_pallas(*ba, *bb, L)
    smax_a, smax_b = hm.magmax_matmul(hk.mag7_operand_complex(*ta, 1)[0],
                                      hk.mag7_operand_complex(*tb, 0)[0])
    _assert_accurate_rule(ref_a, got_a, smax_a, L)
    _assert_accurate_rule(ref_b, got_b, smax_b, L)
    # rows and columns with no nonzero element in either part: T - 1 + 1023
    t_a = tables.threshold_accurate(L)
    assert int(got_a[2]) == int(got_b[0, 2]) == t_a - 1 + 1023


def test_accurate_sft_mag_shift_offsets_the_shift():
    """mag_shift enters the shift as an offset below its T - 1 - e cap:
    one less at shift 4 unless both are capped."""
    smax = torch.tensor([[1], [4096], [1 << 20]], dtype=torch.int32)
    emax = torch.full((3, 1), 1023, dtype=torch.int32)
    for L in (6, 14, 20):
        s5 = enc.accurate_sft(smax, emax, L)
        s4 = enc.accurate_sft(smax, emax, L, enc.MAG_SHIFT_COMPLEX)
        cap = tables.threshold_accurate(L) - 1
        assert torch.equal(s4, torch.where(s5 == cap, s4, s5 - 1))
        assert bool((s5 - s4 <= 1).all() and (s4 <= s5).all())
        assert int(s4[-1]) == int(s5[-1]) - 1  # smax 2^20: below the cap
        ref = jenc.accurate_sft(jnp.asarray(smax.numpy()),
                                jnp.asarray(emax.numpy()), L, 53,
                                jenc.MAG_SHIFT_COMPLEX)
        _assert_accurate_rule(ref, s4, smax, L)


# ---- arguments -------------------------------------------------------------

def test_complex_matmul_argument_checks():
    a = torch.zeros((2, 4, 8), dtype=torch.int8)
    b = torch.zeros((2, 8, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        hm.matmul_complex_mod(a, a[:, :3], b, b, 2)
    with pytest.raises(ValueError):
        hm.matmul_complex_mod(a, a, b, b, 2, kara=(a, b[:, :, :2]))
    with pytest.raises(TypeError):
        hm.matmul_complex_mod(a, a.int(), b, b, 2)
    with pytest.raises(ValueError, match="2\\^16"):
        big = tables.MAX_K // 2 + 1
        z = torch.zeros((2, 1, big), dtype=torch.int8)
        zb = torch.zeros((2, big, 1), dtype=torch.int8)
        hm.matmul_complex_mod(z, z, zb, zb, 2)
    with pytest.raises(ValueError):
        sg.recenter_add_int8(a, a[:1], 2)
    with pytest.raises(ValueError):
        hk.mag7_operand_complex(torch.ones((3, 4), dtype=torch.float64),
                                torch.ones((4, 3), dtype=torch.float64), 1)
    x = torch.from_numpy(phi_matrix(6, 10, 1.0, seed=1))
    for got, ref in zip(hk.fast_stats(x, 0), enc.fast_stats(x, 0)):
        assert torch.equal(got, ref)
