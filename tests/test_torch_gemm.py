"""The port's main path end to end vs the JAX package, on the same bits.

gemmul8_tpu_torch.gemm on CPU tensors runs every kernel's plain version;
it must give the f64 words of gemm_core(..., use_pallas=True) (Pallas in
interpret mode) and, where k <= 2048 (one stats chunk, so both JAX paths
agree), of gemmul8_tpu.gemm. Tolerance: bit equality, once the fast-mode
shifts agree; where a shift legally differs by 1 at a floor boundary the
output is held to the exact product instead.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import bits_to_f64, f64_to_bits
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def _mk(shape, phi, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape) * phi)
    a.ravel()[::13] = 0.0
    return a


def _shifts_agree(a, b, L):
    A, B = f64_to_bits(a), f64_to_bits(b)
    ja = np.asarray(pk.fast_sft_pallas(A, L, axis=1))
    jb = np.asarray(pk.fast_sft_pallas(B, L, axis=0))
    ta = hk.fast_sft(torch.from_numpy(a), L, 1).numpy()
    tb = hk.fast_sft(torch.from_numpy(b), L, 0).numpy()
    return np.array_equal(ja, ta) and np.array_equal(jb, tb)


def _check(a, b, L, ref):
    got = gt.gemm(a, b, num_moduli=L, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (a.shape[0],
                                                        b.shape[1])
    got = got.numpy()
    if _shifts_agree(a, b, L):
        np.testing.assert_array_equal(ref.view(np.uint64),
                                      got.view(np.uint64))
    else:  # boundary shift: both encodings valid, both accurate
        scale = np.abs(a) @ np.abs(b)
        assert np.all(np.abs(got - a @ b) <= 1e-12 * scale + 1e-300)


@pytest.mark.parametrize("L", [8, 14])
def test_gemm_matches_gemm_core_pallas(L):
    a, b = _mk((72, 200), 0.5, seed=3), _mk((200, 56), 0.5, seed=4)
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L, True, "f64",
                       use_pallas=True)
    _check(a, b, L, bits_to_f64(ref, to_numpy=True))


@pytest.mark.parametrize("L", [8, 14])
def test_gemm_matches_public_jax_gemm(L):
    a, b = _mk((72, 200), 0.5, seed=3), _mk((200, 56), 0.5, seed=4)
    _check(a, b, L, np.asarray(g8.gemm(a, b, num_moduli=L)))


def test_gemm_two_stats_chunks():
    """k = 2600 > 2048: the chunked online norm merge on both operands."""
    a, b = _mk((24, 2600), 1.0, seed=6), _mk((2600, 20), 1.0, seed=7)
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), 14, True, "f64",
                       use_pallas=True)
    _check(a, b, 14, bits_to_f64(ref, to_numpy=True))


def test_gemm_20_moduli_is_exact():
    """20 moduli with subnormal inputs: the exact product rounded once
    (as tests/test_encode.py:110 holds the JAX package)."""
    rng = np.random.default_rng(0)
    a = (rng.random((12, 24)) - 0.5) * 1e-160
    b = (rng.random((24, 10)) - 0.5) * 1e-160
    a[0, :] = rng.random(24) * 4.9e-324 * rng.integers(
        1, 1 << 40, 24).astype(float)
    got = gt.gemm(torch.from_numpy(a), torch.from_numpy(b),
                  num_moduli=20).numpy()
    af = [[Fraction(x) for x in row] for row in a]
    bf = [[Fraction(x) for x in row] for row in b]
    for i in range(12):
        for j in range(10):
            want = float(sum(af[i][t] * bf[t][j] for t in range(24)))
            assert got[i, j] == want


def test_gemm_core_alpha_exponent():
    a, b = _mk((16, 40), 0.5, seed=1), _mk((40, 12), 0.5, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    base = tg.gemm_core(ta, tb, 14)
    np.testing.assert_array_equal(tg.gemm_core(ta, tb, 14, alpha_e=3),
                                  base * 8)
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), 14, True, "f64",
                       use_pallas=True, alpha_e=-2)
    if _shifts_agree(a, b, 14):
        np.testing.assert_array_equal(
            bits_to_f64(ref, to_numpy=True).view(np.uint64),
            tg.gemm_core(ta, tb, 14, alpha_e=-2).numpy().view(np.uint64))


def test_gemm_numpy_needs_device(monkeypatch):
    """numpy operands go to the card unless device= says otherwise: with
    no card the call raises and names device="cpu" (nothing falls back to
    the CPU); with the routing spied on, they are sent to "cuda"."""
    from gemmul8_tpu_torch import api

    a = np.ones((4, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.gemm(a, a)
    assert gt.gemm(a, a, device="cpu").shape == (4, 4)
    with pytest.raises(ValueError):
        gt.gemm(torch.ones((4, 4), dtype=torch.float64), a, device="meta")
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(api, "_device",
                        lambda d: asked.append(d) or torch.device("cpu"))
    assert gt.gemm(a, a).shape == (4, 4)
    assert asked[:2] == ["cuda", "cuda"]


# return_times on real calls: tests/test_torch_batched_timed.py
@pytest.mark.parametrize("kwargs,exc,match", [
    # a complex output for real operands is refused (ROADMAP C1)
    (dict(out_dtype=torch.complex128), ValueError, "out_dtype")],
    ids=["kwargs0"])
def test_gemm_unported_arguments_name_roadmap(kwargs, exc, match):
    a = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(exc, match=match):
        gt.gemm(a, a, **kwargs)


# The front end's arguments that the real path now takes (they raised
# NotImplementedError before it had them): each runs through gemm, with
# the value of alpha * op(A) @ op(B) + beta * C in the dtype it asks for.
# tests/test_torch_f32.py holds them to the JAX package's bits.
@pytest.mark.parametrize("kwargs,value,dtype", [
    (dict(alpha=2.0), 8.0, torch.float64),
    (dict(alpha=0.1), 0.4, torch.float64),
    (dict(beta=1.0, c=np.ones((4, 4))), 5.0, torch.float64),
    (dict(op_a="T"), 4.0, torch.float64),
    (dict(op_b="C"), 4.0, torch.float64),
    (dict(out_dtype=torch.float32), 4.0, torch.float32),
    (dict(alpha=-0.5, beta=0.25, c=np.full((4, 4), 8.0),
          out_dtype="f32"), 0.0, torch.float32)])
def test_gemm_front_end_arguments(kwargs, value, dtype):
    a = torch.ones((4, 4), dtype=torch.float64)
    got = gt.gemm(a, a, **kwargs)
    assert got.dtype == dtype
    assert torch.equal(got, torch.full((4, 4), value, dtype=dtype))


def test_gemm_transposes_views():
    """op_a="T" on a tensor and its transposed copy with op N give the same
    bits; so does a non-contiguous view."""
    a, b = _mk((40, 24), 0.5, seed=11), _mk((40, 16), 0.5, seed=12)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = gt.gemm(ta, tb, op_a="T")
    assert torch.equal(got.view(torch.int64),
                       gt.gemm(ta.t().contiguous(), tb).view(torch.int64))
    assert torch.equal(got.view(torch.int64),
                       gt.gemm(ta.t(), tb).view(torch.int64))


def test_gemm_argument_errors():
    a = torch.ones((4, 4), dtype=torch.float64)
    c32 = gt.gemm(a.float(), a.float())
    assert torch.equal(c32, torch.full((4, 4), 4.0, dtype=torch.float32))
    with pytest.raises(ValueError):
        gt.gemm(a, a, num_moduli=21)
    with pytest.raises(ValueError):
        gt.gemm(a, torch.ones((5, 4), dtype=torch.float64))
    with pytest.raises(ValueError):
        gt.gemm(a[:, :0], a[:0])
    c = tg.gemm_core(a, a, 14, fastmode=False)
    assert torch.equal(c, torch.full((4, 4), 4.0, dtype=torch.float64))


@pytest.mark.parametrize("shapes", [((3, 0), (0, 4)), ((0, 0), (0, 0)),
                                    ((1, 0), (0, 1))])
def test_empty_inner_dim_raises_like_jax(shapes):
    """k = 0: the JAX package's gemm raises ValueError on the CPU (its
    statistics reduce an empty axis), and so does the port, on purpose
    (ROADMAP C7)."""
    sa, sb = shapes
    with pytest.raises(ValueError):
        g8.gemm(np.ones(sa), np.ones(sb))
    with pytest.raises(ValueError, match="empty"):
        gt.gemm(np.ones(sa), np.ones(sb), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tg.gemm_core(torch.ones(sa, dtype=torch.float64),
                     torch.ones(sb, dtype=torch.float64), 14)


@pytest.mark.cuda
def test_kernels_on_card_match_plain():
    """On a CUDA host: the kernel path gives the bits of the plain path
    (same shifts), in fast and accurate mode. Skips without a card;
    chip_smoke.py covers more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from gemmul8_tpu_torch.hopper import build

    a, b = _mk((300, 260), 0.5, seed=8), _mk((260, 200), 0.5, seed=9)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    build.LAUNCHES.clear()
    got = gt.gemm(ta, tb, num_moduli=14).cpu()
    assert dict(build.LAUNCHES) == {"fast_sft": 2, "encode_slices": 2,
                                    "matmul_mod_u8": 1, "reconstruct": 1}
    sa = hk.fast_sft(ta, 14, 1).cpu()
    sb = hk.fast_sft(tb, 14, 0).cpu()
    ref_sa = hk.fast_sft(torch.from_numpy(a), 14, 1)
    ref_sb = hk.fast_sft(torch.from_numpy(b), 14, 0)
    if torch.equal(sa, ref_sa) and torch.equal(sb, ref_sb):
        ref = gt.gemm(a, b, num_moduli=14, device="cpu")
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))

    build.LAUNCHES.clear()
    got = gt.gemm(ta, tb, num_moduli=14, fastmode=False).cpu()
    assert dict(build.LAUNCHES) == {"emax": 2, "mag7": 2, "magmax_matmul": 1,
                                    "encode_slices": 2, "matmul_mod_u8": 1,
                                    "reconstruct": 1}
    sa, sb = tg.accurate_sfts(ta, tb, 14)
    ref_sa, ref_sb = tg.accurate_sfts(torch.from_numpy(a),
                                      torch.from_numpy(b), 14)
    assert torch.equal(sa.cpu(), ref_sa) and torch.equal(sb.cpu(), ref_sb)
    ref = gt.gemm(a, b, num_moduli=14, fastmode=False, device="cpu")
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
