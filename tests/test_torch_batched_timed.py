"""The batched and timed entry points of the port vs the JAX package, on
the same bits.

`gemmul8_tpu_torch.gemm_batched` on real (f64, f32, mixed, f32 output)
and complex (complex128, complex64, complex128 x complex64 under the three
compute types) batches is held to `gemmul8_tpu.gemm_batched` on the CPU and
to the port's `gemm` on each element; its errors to the JAX package's.
`gemm_timed` and `gemm(return_times=True)` give `gemmul8_tpu.gemm_timed`'s
and `gemm`'s bits and four phase times; `return_times` leaves a power-of-two
alpha unfolded, as the JAX package does (held on a subnormal result, where
the fold and the multiply differ), raises with n_panel or a moduli chunk,
and raises on a complex call (the JAX package drops it, ROADMAP C1).
Inputs come from a numpy seed.

Tolerance: bit equality. A fast-mode shift may differ from the JAX
package's by 1 where its pre-floor value lies within 1e-4 of an integer;
each input here is checked to keep its shifts 1e-4 away
(`_clear_of_floor`), so the bits must be equal.
"""

import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import tables
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as tg

from test_torch_threads import one_torch_thread  # noqa: E402, F401

CT = gt.ComputeType
STRATS = [CT.COMPLEX_BIG_MATRIX_ENCODE, CT.COMPLEX_CLASSIC_MULT,
          CT.COMPLEX_KARATSUBA_MULT]
NP = {"f64": np.float64, "f32": np.float32}
CNP = {"c128": np.complex128, "c64": np.complex64}


@pytest.fixture(autouse=True)
def _default_switches(monkeypatch):
    for key in ("GEMMUL8_FUSED_ENCODE", "GEMMUL8_FUSED_MAG7",
                "GEMMUL8_MAGMAX_SCRATCH", "GEMMUL8_MM_PIPELINE",
                "GEMMUL8_MXU_CRT", "GEMMUL8_FUSED_RECONSTRUCT"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GEMMUL8_PIPELINE", "0")


def _phi(shape, seed, phi=0.5):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) - 0.5) * np.exp(rng.standard_normal(shape)
                                              * phi)


def _words(x):
    x = np.ascontiguousarray(x.numpy() if isinstance(x, torch.Tensor)
                             else np.asarray(x))
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag])
    return x.view(np.uint64 if x.dtype == np.float64 else np.uint32)


def _clear_of_floor(parts, axis, L):
    """Every fast shift of an operand (its real parts, jointly) lies more
    than 1e-4 from a floor step."""
    ts = [torch.from_numpy(np.ascontiguousarray(p)) for p in parts]
    stats = enc.fast_stats(ts[0], axis)
    for t in ts[1:]:
        stats = enc.merge_stats(stats, enc.fast_stats(t, axis))
    frac = enc.sft_floor_frac(stats[1], len(ts) * ts[0].shape[axis], L)
    return float(frac.min()) > 1e-4


def _real_batch(kinds, seed, L, shape=(3, 24, 40, 16)):
    B, m, k, n = shape
    a = _phi((B, m, k), seed).astype(NP[kinds[0]])
    b = _phi((B, k, n), seed + 1).astype(NP[kinds[1]])
    for i in range(B):
        assert _clear_of_floor([a[i]], 1, L) and _clear_of_floor([b[i]], 0, L)
    return a, b


# ---- gemm_batched ----------------------------------------------------------

@pytest.mark.parametrize("kinds,out_dtype,L", [
    (("f64", "f64"), None, 14), (("f32", "f32"), None, 8),
    (("f64", "f32"), None, 14), (("f32", "f64"), "float32", 8),
    (("f64", "f64"), "f32", 10)])
@pytest.mark.parametrize("fastmode", [True, False])
def test_gemm_batched_real_matches_jax(kinds, out_dtype, L, fastmode):
    """Every element: the JAX package's gemm_batched bits, and the port's
    gemm on that element."""
    a, b = _real_batch(kinds, 5 + L, L)
    got = gt.gemm_batched(a, b, num_moduli=L, fastmode=fastmode,
                          out_dtype=out_dtype, device="cpu")
    ref = np.asarray(g8.gemm_batched(a, b, num_moduli=L, fastmode=fastmode,
                                     out_dtype=out_dtype))
    assert got.shape == (3, 24, 16)
    assert got.dtype == (torch.float64 if ref.dtype == np.float64
                         else torch.float32)
    np.testing.assert_array_equal(_words(ref), _words(got))
    for i in range(3):
        one = gt.gemm(a[i], b[i], num_moduli=L, fastmode=fastmode,
                      out_dtype=out_dtype, device="cpu")
        np.testing.assert_array_equal(_words(one), _words(got[i]))


def _complex_batch(kinds, seed, L):
    B, m, k, n = 2, 16, 24, 12
    a = (_phi((B, m, k), seed) + 1j * _phi((B, m, k), seed + 1)).astype(
        CNP[kinds[0]])
    b = (_phi((B, k, n), seed + 2) + 1j * _phi((B, k, n), seed + 3)).astype(
        CNP[kinds[1]])
    for i in range(B):
        assert _clear_of_floor([a[i].real, a[i].imag], 1, L)
        assert _clear_of_floor([b[i].real, b[i].imag], 0, L)
    return a, b


@pytest.mark.parametrize("strat", STRATS)
@pytest.mark.parametrize("kinds,L", [(("c128", "c128"), 14),
                                     (("c64", "c64"), 8),
                                     (("c128", "c64"), 14)])
def test_gemm_batched_complex_matches_jax(kinds, L, strat):
    a, b = _complex_batch(kinds, 40 + L, L)
    got = gt.gemm_batched(a, b, num_moduli=L, compute_type=strat,
                          device="cpu")
    ref = np.asarray(g8.gemm_batched(a, b, num_moduli=L,
                                     compute_type=g8.ComputeType[strat.name]))
    want = torch.complex64 if kinds == ("c64", "c64") else torch.complex128
    assert got.dtype == want and got.shape == (2, 16, 12)
    np.testing.assert_array_equal(_words(ref), _words(got))
    for i in range(2):
        one = gt.gemm(a[i], b[i], num_moduli=L, compute_type=strat,
                      device="cpu")
        np.testing.assert_array_equal(_words(one), _words(got[i]))


def test_gemm_batched_complex_accurate_and_out_dtype():
    """Accurate mode, a complex64 output of a complex128 batch, a real
    operand mixed into a complex batch; a real out_dtype spelling raises
    (the JAX package reads it as complex64, ROADMAP C1)."""
    a, b = _complex_batch(("c128", "c128"), 61, 10)
    for kw in (dict(fastmode=False), dict(out_dtype="complex64"),
               dict(out_dtype=torch.complex64)):
        got = gt.gemm_batched(a, b, num_moduli=10, device="cpu", **kw)
        jkw = dict(kw, out_dtype="complex64") if "out_dtype" in kw else kw
        ref = np.asarray(g8.gemm_batched(a, b, num_moduli=10, **jkw))
        np.testing.assert_array_equal(_words(ref), _words(got))
    real_b = np.ascontiguousarray(b.real)
    got = gt.gemm_batched(a, real_b, num_moduli=10, device="cpu")
    ref = np.asarray(g8.gemm_batched(a, real_b, num_moduli=10))
    np.testing.assert_array_equal(_words(ref), _words(got))
    with pytest.raises(ValueError, match="out_dtype"):
        gt.gemm_batched(a, b, out_dtype="float64", device="cpu")


@pytest.mark.parametrize("a_shape,b_shape,match", [
    ((2, 4, 8), (2, 8), "3D"), ((4, 8), (2, 8, 4), "3D"),
    ((2, 4, 8), (3, 8, 4), "mismatch"), ((2, 4, 8), (2, 7, 4), "mismatch")])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gemm_batched_shape_errors_like_jax(a_shape, b_shape, match, dtype):
    a, b = np.ones(a_shape, dtype), np.ones(b_shape, dtype)
    with pytest.raises(ValueError, match=match):
        g8.gemm_batched(a, b)
    with pytest.raises(ValueError, match=match):
        gt.gemm_batched(a, b, device="cpu")


def test_gemm_batched_errors(monkeypatch):
    """k above 2^17, num_moduli out of range, numpy without device= and
    without a card (the card is their default), operands on two
    devices."""
    k = tables.MAX_K + 1
    a = torch.zeros((1, 1, k), dtype=torch.float64)
    b = torch.zeros((1, k, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="2\\^17"):
        gt.gemm_batched(a, b)
    x = torch.ones((2, 4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="num_moduli"):
        gt.gemm_batched(x, x, num_moduli=21)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.gemm_batched(np.ones((2, 4, 4)), np.ones((2, 4, 4)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.gemm_timed(np.ones((4, 4)), np.ones((4, 4)))
    got = gt.gemm_batched(np.ones((2, 4, 4)), np.ones((2, 4, 4)),
                          device="cpu")
    assert torch.equal(got, torch.full((2, 4, 4), 4.0, dtype=torch.float64))
    got = gt.gemm_batched(x, x)
    assert torch.equal(got, torch.full((2, 4, 4), 4.0, dtype=torch.float64))


# ---- gemm_timed and return_times -------------------------------------------

@pytest.mark.parametrize("kinds,L,fastmode", [(("f64", "f64"), 14, True),
                                              (("f32", "f32"), 8, True),
                                              (("f64", "f32"), 12, False)])
def test_gemm_timed_matches_jax(kinds, L, fastmode):
    """The JAX package's gemm_timed bits and the port's gemm's; four
    non-negative phase times (iters > 1); the same from gemm(
    return_times=True)."""
    a, b = _real_batch(kinds, 70 + L, L, shape=(1, 40, 72, 24))
    a, b = a[0], b[0]
    got, times = gt.gemm_timed(a, b, num_moduli=L, fastmode=fastmode,
                               iters=3, device="cpu")
    ref, jtimes = g8.gemm_timed(a, b, num_moduli=L, fastmode=fastmode,
                                iters=2)
    np.testing.assert_array_equal(_words(np.asarray(ref)), _words(got))
    assert len(jtimes) == 4
    assert len(times) == 4 and all(isinstance(t, float) and t >= 0.0
                                   for t in times)
    assert times[0] > 0.0 and times[1] > 0.0 and times[3] > 0.0
    one = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, device="cpu")
    np.testing.assert_array_equal(_words(one), _words(got))
    c, t2 = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, return_times=True,
                    device="cpu")
    np.testing.assert_array_equal(_words(one), _words(c))
    assert len(t2) == 4 and all(t >= 0.0 for t in t2)


def test_gemm_phases_are_the_default_call():
    """gemm_phases chained gives gemm_core's bits; the mod phase is the
    identity (the mod ran in the GEMM's epilogue); the phases run the
    default kernels whatever the switches say."""
    a = torch.from_numpy(_phi((40, 72), 1))
    b = torch.from_numpy(_phi((72, 24), 2)).float()
    for fastmode in (True, False):
        enc_, mm, mod, rec = tg.gemm_phases(a, b, 9, fastmode, "f32")
        a8, sa, b8, sb = enc_(a, b)
        r = mm(a8, b8)
        assert mod(r) is r and r.dtype == torch.int8
        got = rec(r, sa, sb)
        want = tg.gemm_core(a, b, 9, fastmode, "f32")
        np.testing.assert_array_equal(_words(want), _words(got))
    with pytest.raises(ValueError, match="out_dtype"):
        tg.gemm_phases(a, b, 9, True, "f16")


def _double_rounding_case():
    """(a, b, alpha): alpha = 2^-824 and a (3, 9) x (9, 3) product whose
    diagonal holds, exactly, P = t (1 + 2^-q + 2^-q-1) - 2^-60 t, at t =
    2^70 * 2^-300 scaled per column so that alpha * t is the subnormal
    2^(-1074 + q), q = 20, 30, 40. Rounded once (the fold), alpha * P is
    2^q + 1 subnormal steps; rounded to 53 bits first, P lands on the tie
    between 2^q + 1 and 2^q + 2 steps, and the multiply rounds it to the
    even 2^q + 2."""
    s = 2.0 ** -150
    a, b = np.zeros((3, 9)), np.zeros((9, 3))
    for i, q in enumerate((20, 30, 40)):
        a[i, 3 * i:3 * i + 3] = np.array([2.0 ** 35, 3 * 2.0 ** 20,
                                          -2.0 ** 5]) * s
        b[3 * i:3 * i + 3, i] = np.array([2.0 ** 35, 2.0 ** (49 - q),
                                          2.0 ** 5]) * s * 2.0 ** (q - 20)
    return a, b, 2.0 ** -824


def test_return_times_leaves_pow2_alpha_unfolded():
    """On a subnormal result where the fold (one rounding) and the multiply
    after the call (two) differ, return_times gives the multiply's words,
    as the JAX package's _finalize does after its timed core; the plain
    call gives the fold's, as the JAX package's plain call."""
    a, b, alpha = _double_rounding_case()
    got, times = gt.gemm(a, b, alpha=alpha, return_times=True, device="cpu")
    folded = gt.gemm(a, b, alpha=alpha, device="cpu")
    unfolded = gt.gemm(a, b, device="cpu") * torch.tensor(alpha,
                                                          dtype=torch.float64)
    np.testing.assert_array_equal(_words(unfolded), _words(got))
    steps = np.diag(_words(got)).astype(np.int64)
    np.testing.assert_array_equal(steps, [2 ** q + 2 for q in (20, 30, 40)])
    np.testing.assert_array_equal(np.diag(_words(folded)).astype(np.int64),
                                  steps - 1)
    ref, jtimes = g8.gemm(a, b, alpha=alpha, return_times=True)
    np.testing.assert_array_equal(_words(np.asarray(ref)), _words(got))
    jfold = g8.gemm(a, b, alpha=alpha)
    np.testing.assert_array_equal(_words(np.asarray(jfold)), _words(folded))
    assert len(times) == len(jtimes) == 4


@pytest.mark.parametrize("kwargs", [dict(n_panel=8), dict(n_panel=100),
                                    dict(moduli_chunk=3),
                                    dict(max_workspace_bytes=1 << 30)])
def test_return_times_refuses_schedules_like_jax(kwargs):
    """With n_panel (even n_panel >= n) or a moduli chunk (also one the
    planner picks), as the JAX package, after the planner ran."""
    a, b = _phi((16, 24), 3), _phi((24, 32), 4)
    with pytest.raises(NotImplementedError, match="one-shot"):
        g8.gemm(a, b, return_times=True, **kwargs)
    with pytest.raises(NotImplementedError, match="one-shot"):
        gt.gemm(a, b, return_times=True, device="cpu", **kwargs)


def test_return_times_alpha_beta_and_f32():
    """The epilogue after the timed core: f64 alpha/beta bit-equal to the
    JAX package's; f32 output the plain call's words."""
    a, b = _phi((16, 24), 5), _phi((24, 12), 6)
    c = _phi((16, 12), 7)
    got, _ = gt.gemm(a, b, alpha=1.7, beta=-0.3, c=c, return_times=True,
                     device="cpu")
    ref, _ = g8.gemm(a, b, alpha=1.7, beta=-0.3, c=c, return_times=True)
    np.testing.assert_array_equal(_words(np.asarray(ref)), _words(got))
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    got, _ = gt.gemm(a32, b32, num_moduli=8, return_times=True, device="cpu")
    want = gt.gemm(a32, b32, num_moduli=8, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_words(want), _words(got))
    with pytest.raises(ValueError, match="c"):
        gt.gemm(a, b, beta=1.0, return_times=True, device="cpu")


def test_gemm_timed_errors(monkeypatch):
    x = np.ones((4, 4))
    with pytest.raises(ValueError, match="iters"):
        gt.gemm_timed(x, x, iters=0, device="cpu")
    # numpy operands go to the card by default: without one the call
    # raises and names device="cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.gemm_timed(x, x)
    with pytest.raises(TypeError, match="real"):
        gt.gemm_timed(x.astype(np.complex128), x, device="cpu")
    with pytest.raises(ValueError, match="num_moduli"):
        gt.gemm_timed(x, x, num_moduli=1, device="cpu")


def test_complex_return_times_raises_naming_c1():
    z = torch.ones((4, 4), dtype=torch.complex64)
    with pytest.raises(NotImplementedError, match="C1"):
        gt.gemm(z, z, return_times=True)
    assert cg.complex_kind(z) == "c64"


def test_exports():
    assert gt.gemm_batched is not None and gt.gemm_timed is not None
    assert {"gemm_batched", "gemm_timed"} <= set(gt.__all__)
