"""The CRT-fused GEMMs, the limb and int32 inputs of reconstruct, and the
moduli subsets of encode and matmul_mod vs the JAX package, on the same bits.

CPU tensors take the kernels' plain versions; the JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas_parity.py runs them. Inputs
come from a numpy seed; limbs cross between the packages as numpy int32
(num_limbs, m, n). Tolerance: bit equality everywhere (no shift is selected
here: the shifts are given).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gemmul8_tpu.core import reconstruct as jrec
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.pallas import matmul as pm
from gemmul8_tpu.pallas import megakernel as mk
from gemmul8_tpu.types import F64Bits
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import reconstruct as rec
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.types import f64_to_words, words_to_f64

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def _slices(L, m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (L, m, k), dtype=np.int8),
            rng.integers(-128, 128, (L, k, n), dtype=np.int8))


def _shifts(m, n, seed, span=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(-span, span, (m, 1)).astype(np.int32),
            rng.integers(-span, span, (1, n)).astype(np.int32))


def _words(c: torch.Tensor):
    return f64_to_words(c)


def _assert_f64_words(ref: F64Bits, got: torch.Tensor):
    hi, lo = _words(got)
    np.testing.assert_array_equal(np.asarray(ref.hi), hi)
    np.testing.assert_array_equal(np.asarray(ref.lo), lo)


def _subsets(L):
    """A chunk in the middle, the 256 lane alone, a tuple out of order."""
    out = [(0,), tuple(dict.fromkeys(j for j in (L - 1, 0, 3, 1) if j < L))]
    if L > 5:
        out.append(tuple(range(3, min(8, L))))
    return out


# ---- B13: matmul_crt ------------------------------------------------------

@pytest.mark.parametrize("mkn", [(48, 136, 72), (200, 77, 280)])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_matmul_crt_matches_pallas(L, mkn):
    m, k, n = mkn
    a8, b8 = _slices(L, m, k, n, seed=9 + L)
    ref = np.asarray(pm.matmul_crt_pallas(jnp.asarray(a8), jnp.asarray(b8), L,
                                          block=(128, 128, 128)))
    got = hm.matmul_crt(torch.from_numpy(a8), torch.from_numpy(b8), L)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (tables.num_limbs(L), m, n)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFF
    np.testing.assert_array_equal(ref, got.numpy())


@pytest.mark.parametrize("L", [8, 14])
def test_matmul_crt_closes_the_loop(L):
    """matmul_crt -> limb-input reconstruct == matmul_mod_u8 -> reconstruct,
    the path of tests/test_pallas_parity.py:142 in the port."""
    a8, b8 = (torch.from_numpy(x) for x in _slices(L, 48, 136, 72, seed=9))
    sa, sb = (torch.from_numpy(x) for x in _shifts(48, 72, seed=1))
    limbs = hm.matmul_crt(a8, b8, L)
    want = hk.reconstruct(hm.matmul_mod_u8(a8, b8, L, centered=True), sa, sb,
                          L)
    got = hk.reconstruct(limbs, sa, sb, L, input_kind="limbs")
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def test_matmul_crt_256_lane_wraps():
    """k = 2^17 of -128 * -128: the 256 lane's product is 2^31, which an
    int32 accumulator wraps; its residue 0 must come out all the same."""
    k = tables.MAX_K
    a8 = torch.full((2, 1, k), -128, dtype=torch.int8)
    b8 = torch.full((2, k, 1), -128, dtype=torch.int8)
    limbs = hm.matmul_crt(a8, b8, 2)
    r1 = (128 * 128 * k) % tables.MODULI[1]
    x = r1 * tables.crt_weights(2)[1]
    assert [int(v) for v in limbs[:, 0, 0]] == tables.to_limbs(
        x, tables.num_limbs(2))


# ---- reconstruct: limb and int32 input ------------------------------------

@pytest.mark.parametrize("e_extra", [0, -3])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_reconstruct_from_limbs_matches_pallas(L, e_extra):
    a8, b8 = _slices(L, 40, 64, 72, seed=L)
    sa, sb = _shifts(40, 72, seed=L + 1)
    limbs = hm.matmul_crt(torch.from_numpy(a8), torch.from_numpy(b8), L)
    ref = pk.reconstruct_pallas(jnp.asarray(limbs.numpy()), jnp.asarray(sa),
                                jnp.asarray(sb), L, "f64", block=(8, 128),
                                input_kind="limbs", e_extra=e_extra)
    got = hk.reconstruct(limbs, torch.from_numpy(sa), torch.from_numpy(sb),
                         L, e_extra=e_extra, input_kind="limbs")
    _assert_f64_words(ref, got)


@pytest.mark.parametrize("L", [8, 14, 20])
def test_reconstruct_from_limbs_takes_pending_carries(L):
    """Limbs that are not canonical (a carry pushed back into a lower limb,
    every limb nonnegative and below 2^29) stand for the same integer and
    give the same bits, as the JAX package allows of its limbs."""
    a8, b8 = (torch.from_numpy(x) for x in _slices(L, 24, 40, 32, seed=3))
    sa, sb = (torch.from_numpy(x) for x in _shifts(24, 32, seed=4))
    limbs = hm.matmul_crt(a8, b8, L)
    pushed = limbs.clone()
    for i in range(1, limbs.shape[0]):
        take = pushed[i].clamp(max=8000)
        pushed[i] -= take
        pushed[i - 1] += take << 16
    assert int(pushed.max()) < 1 << 29 and not torch.equal(pushed, limbs)
    want = hk.reconstruct(limbs, sa, sb, L, input_kind="limbs")
    got = hk.reconstruct(pushed, sa, sb, L, input_kind="limbs")
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))
    ref = pk.reconstruct_pallas(jnp.asarray(pushed.numpy()),
                                jnp.asarray(sa.numpy()),
                                jnp.asarray(sb.numpy()), L, "f64",
                                block=(8, 128), input_kind="limbs")
    _assert_f64_words(ref, got)


@pytest.mark.parametrize("L", [2, 14, 20])
def test_reconstruct_from_int32_products_matches_pallas(L):
    """int32 input of kind "residues" holds raw slice products, negative
    ones too, reduced mod m_j inside."""
    a8, b8 = _slices(L, 40, 200, 72, seed=20 + L)
    sa, sb = _shifts(40, 72, seed=2)
    prod = np.einsum("lmk,lkn->lmn", a8.astype(np.int64),
                     b8.astype(np.int64)).astype(np.int32)
    assert prod.min() < 0
    ref = pk.reconstruct_pallas(jnp.asarray(prod), jnp.asarray(sa),
                                jnp.asarray(sb), L, "f64", block=(8, 128),
                                mxu=False)
    tsa, tsb = torch.from_numpy(sa), torch.from_numpy(sb)
    got = hk.reconstruct(torch.from_numpy(prod), tsa, tsb, L)
    _assert_f64_words(ref, got)
    r8 = hm.matmul_mod_u8(torch.from_numpy(a8), torch.from_numpy(b8), L)
    assert torch.equal(hk.reconstruct(r8, tsa, tsb, L).view(torch.int64),
                       got.view(torch.int64))


def test_fold_chunk_matches_accumulate_weighted():
    """The in-place int32 fold of the chunked schedule holds the integer
    `accumulate_weighted` holds (and the JAX package's), whatever the
    chunking; its limbs keep their carries pending."""
    L = 14
    rng = np.random.default_rng(5)
    r = np.stack([rng.integers(0, tables.MODULI[j], (6, 7))
                  for j in range(L)]).astype(np.uint8)
    want = torch.stack(rec.accumulate_weighted(torch.from_numpy(r).long(), L))
    jref = np.stack([np.asarray(x) for x in jrec.accumulate_weighted(
        jnp.asarray(r.astype(np.int32)), L)])
    np.testing.assert_array_equal(jref, want.numpy())
    nl = tables.num_limbs(L)
    for chunk in (1, 5, 14):
        limbs = torch.zeros((nl, 6, 7), dtype=torch.int32)
        for j0 in range(0, L, chunk):
            idx = tuple(range(j0, min(j0 + chunk, L)))
            part = torch.from_numpy(r[list(idx)])
            if j0 == 0:   # int8 residues hold r - 128
                part = (part.to(torch.int16) - 128).to(torch.int8)
            out = rec.fold_chunk_(limbs, part, L, idx)
            assert out is limbs
        assert int(limbs.min()) >= 0 and int(limbs.max()) < 1 << 29
        value = sum(limbs[i].long().numpy().astype(object) << (16 * i)
                    for i in range(nl))
        ref = sum(want[i].numpy().astype(object) << (16 * i)
                  for i in range(nl))
        assert (value == ref).all()


# ---- B14: matmul_reconstruct ---------------------------------------------

@pytest.mark.parametrize("L", [2, 8, 14])
def test_matmul_reconstruct_matches_pallas(L):
    m, k, n = 200, 136, 280
    a8, b8 = _slices(L, m, k, n, seed=11)
    sa, sb = _shifts(m, n, seed=12)
    ref = mk.matmul_reconstruct_pallas(
        jnp.asarray(a8), jnp.asarray(b8), jnp.asarray(sa), jnp.asarray(sb),
        L, "f64", block=(128, 128))
    ta8, tb8 = torch.from_numpy(a8), torch.from_numpy(b8)
    tsa, tsb = torch.from_numpy(sa), torch.from_numpy(sb)
    got = hm.matmul_reconstruct(ta8, tb8, tsa, tsb, L)
    assert got.dtype == torch.float64 and tuple(got.shape) == (m, n)
    _assert_f64_words(ref, got)
    want = hk.reconstruct(hm.matmul_mod_u8(ta8, tb8, L, centered=True), tsa,
                          tsb, L)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


def test_fused_reconstruct_ok_states_the_port_kernels_limits():
    assert hm.fused_reconstruct_ok(8192, 8192, 8192, 14)
    assert hm.fused_reconstruct_ok(1, 1, 1, 2)
    assert hm.fused_reconstruct_ok(70000, 3, tables.MAX_K, 20)
    assert not hm.fused_reconstruct_ok(8, 8, tables.MAX_K + 1, 14)
    assert not hm.fused_reconstruct_ok(8, 8, 8, 21)
    assert not hm.fused_reconstruct_ok(8, 8, 8, 1)


# ---- kernels 2 and 3 on subsets of the moduli -----------------------------

@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_encode_slices_moduli_idx_matches_pallas(L, axis):
    rng = np.random.default_rng(L)
    shape = (40, 136) if axis == 1 else (136, 40)
    x = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * 2.0)
    x.ravel()[::13] = 0.0
    hi, lo = f64_to_words(x)
    bits, t = F64Bits(jnp.asarray(hi), jnp.asarray(lo)), words_to_f64(hi, lo)
    sft = hk.fast_sft(t, L, axis)
    full = hk.encode_slices(t, sft, L, axis)
    for idx in _subsets(L):
        ref = pk.encode_slices_pallas(bits, jnp.asarray(sft.numpy()), L,
                                      axis=axis, moduli_idx=idx,
                                      block=(64, 128))
        got = hk.encode_slices(t, sft, L, axis, moduli_idx=idx)
        assert got.dtype == torch.int8
        assert tuple(got.shape) == (len(idx), *shape)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
        assert torch.equal(got, full[list(idx)])


@pytest.mark.parametrize("centered", [False, True])
@pytest.mark.parametrize("L", [2, 8, 14, 20])
def test_matmul_mod_u8_moduli_idx_matches_pallas(L, centered):
    for idx in _subsets(L):
        a8, b8 = _slices(len(idx), 40, 168, 88, seed=L)
        ref = pm.matmul_mod_u8_pallas(jnp.asarray(a8), jnp.asarray(b8), L,
                                      moduli_idx=idx, block=(128, 128, 128),
                                      centered=centered)
        ta8, tb8 = torch.from_numpy(a8), torch.from_numpy(b8)
        got = hm.matmul_mod_u8(ta8, tb8, L, centered=centered,
                               moduli_idx=idx)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
        if not centered:
            assert torch.equal(
                got, hm.matmul_mod_u8_pipelined(ta8, tb8, L, moduli_idx=idx))


def test_new_wrapper_argument_errors():
    a8 = torch.zeros((2, 4, 6), dtype=torch.int8)
    b8 = torch.zeros((2, 6, 5), dtype=torch.int8)
    sa = torch.zeros((4, 1), dtype=torch.int32)
    sb = torch.zeros((1, 5), dtype=torch.int32)
    x = torch.ones((4, 6), dtype=torch.float64)
    for idx in ((0, 0), (2,), (-1,), ()):
        with pytest.raises(ValueError, match="moduli_idx"):
            hk.encode_slices(x, sa, 2, 1, moduli_idx=idx)
    with pytest.raises(ValueError, match="slices per operand"):
        hm.matmul_mod_u8(a8, b8, 14, moduli_idx=(0, 1, 2))
    with pytest.raises(ValueError):
        hm.matmul_crt(a8, b8, 3)
    with pytest.raises(TypeError):
        hm.matmul_crt(a8.int(), b8, 2)
    with pytest.raises(ValueError, match="shifts"):
        hm.matmul_reconstruct(a8, b8, sb, sa, 2)
    with pytest.raises(ValueError, match="input_kind"):
        hk.reconstruct(a8, sa, sb, 2, input_kind="words")
    with pytest.raises(ValueError, match="limbs"):   # 2 moduli: 2 limbs
        hk.reconstruct(torch.zeros((3, 4, 5), dtype=torch.int32), sa, sb, 2,
                       input_kind="limbs")
    with pytest.raises(ValueError, match="limbs"):
        rec.fold_chunk_(torch.zeros((3, 4, 5), dtype=torch.int32),
                        torch.zeros((1, 4, 5), dtype=torch.uint8), 2, (0,))


# ---- on the card ----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", [(300, 5, 200), (1000, 777, 1500)])
def test_crt_kernels_on_card(mkn):
    """The two CRT-fused GEMMs and reconstruct's limb and int32 inputs
    against their plain versions. Skips without a card; chip_smoke.py
    covers more."""
    _card()
    m, k, n = mkn
    for L in (2, 14, 20):
        a8, b8 = (torch.from_numpy(x).cuda()
                  for x in _slices(L, m, k, n, seed=7))
        sa, sb = (torch.from_numpy(x).cuda() for x in _shifts(m, n, seed=8))
        limbs = hm.matmul_crt(a8, b8, L)
        assert torch.equal(limbs, hm.matmul_crt_plain(a8, b8, L))
        ref = hk.reconstruct_plain(limbs, sa, sb, L, "f64", 0, "limbs")
        for got in (hk.reconstruct(limbs, sa, sb, L, input_kind="limbs"),
                    hm.matmul_reconstruct(a8, b8, sa, sb, L)):
            assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
        prod = torch.stack([(a8[l].double() @ b8[l].double()).to(torch.int32)
                            for l in range(L)])
        assert torch.equal(hk.reconstruct(prod, sa, sb, L).view(torch.int64),
                           ref.view(torch.int64))


@pytest.mark.cuda
def test_moduli_idx_on_card():
    _card()
    L = 14
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((300, 200))).cuda()
    sft = hk.fast_sft(x, L, 1)
    for idx in _subsets(L):
        got = hk.encode_slices(x, sft, L, 1, moduli_idx=idx)
        assert torch.equal(got, hk.encode_slices_plain(x, sft, L, 1, idx))
        b8 = torch.from_numpy(rng.integers(
            -128, 128, (len(idx), 200, 77), dtype=np.int8)).cuda()
        r = hm.matmul_mod_u8(got, b8, L, moduli_idx=idx)
        assert torch.equal(r, hm.matmul_mod_u8_plain(got, b8, L, False, idx))
