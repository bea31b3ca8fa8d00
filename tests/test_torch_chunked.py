"""The moduli-chunked schedule, the planner and the fused matmul +
reconstruct call vs the JAX package, on the same bits.

gemmul8_tpu_torch.gemm(..., moduli_chunk=c) and max_workspace_bytes= on CPU
tensors run every kernel's plain version; they must give the port's one-shot
bits and the f64 words of the JAX package's gemm_core(..., moduli_chunk=c,
use_pallas=True) (Pallas in interpret mode). GEMMUL8_FUSED_RECONSTRUCT=1
must give the default call's bits through `matmul_reconstruct` (a spy on
its plain version shows it ran). Inputs come from a numpy seed.

Tolerance: bit equality. A fast-mode shift may differ from the JAX
package's by 1 where its floored value lies within 1e-4 of an integer (the
f32 norm's summation order), an accurate-mode shift likewise (the f32
log2; tests/test_torch_accurate.py); the output is then held to the exact
product instead, as tests/test_torch_gemm.py holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
import gemmul8_tpu_torch as gt
from gemmul8_tpu import planner as jplanner
from gemmul8_tpu.bench.matrices import exact_gemm_f64
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import bits_to_f64, f64_to_bits
from gemmul8_tpu_torch import planner, tables
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

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


def _spy(monkeypatch, module, name):
    """Count the calls of module.name from here on."""
    calls = []
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _shifts_agree(a, b, L, fastmode):
    """Whether the port's shifts are the JAX package's (else one lies at a
    floor boundary, and both encodings are valid)."""
    A, B = f64_to_bits(a), f64_to_bits(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        ja = pk.fast_sft_pallas(A, L, axis=1)
        jb = pk.fast_sft_pallas(B, L, axis=0)
        sa, sb = hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0)
    else:
        ja, jb = gg.accurate_sfts(A, B, L, use_pallas=True)
        sa, sb = tg.accurate_sfts(ta, tb, L)
    ja, jb = np.asarray(ja), np.asarray(jb)
    assert np.abs(ja.astype(np.int64) - sa.numpy()).max() <= 1
    assert np.abs(jb.astype(np.int64) - sb.numpy()).max() <= 1
    return np.array_equal(ja, sa.numpy()) and np.array_equal(jb, sb.numpy())


def _hold_to_jax(got, ref_bits, a, b, L, fastmode):
    got = got.numpy()
    if _shifts_agree(a, b, L, fastmode):
        np.testing.assert_array_equal(
            bits_to_f64(ref_bits, to_numpy=True).view(np.uint64),
            got.view(np.uint64))
    else:  # a floor-boundary shift: both encodings valid, both accurate
        scale = np.abs(a) @ np.abs(b)
        assert np.all(np.abs(got - exact_gemm_f64(a, b))
                      <= 1e-12 * scale + 1e-300)


# ---- the chunked schedule -------------------------------------------------

@pytest.mark.parametrize("L", [10, 14])
@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_gemm_chunked_matches_one_shot_and_jax(chunk, fastmode, L):
    a, b = _mk((40, 136), 0.5, seed=3), _mk((136, 24), 0.5, seed=4)
    one_shot = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, device="cpu")
    got = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, moduli_chunk=chunk,
                  device="cpu")
    assert got.dtype == torch.float64 and tuple(got.shape) == (40, 24)
    assert torch.equal(one_shot.view(torch.int64), got.view(torch.int64))
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L, fastmode, "f64",
                       moduli_chunk=chunk, use_pallas=True)
    _hold_to_jax(got, ref, a, b, L, fastmode)


@pytest.mark.parametrize("fastmode", [True, False])
def test_gemm_chunked_runs_one_matmul_per_chunk(monkeypatch, fastmode):
    """The schedule's steps: per chunk one encode per operand on the chunk's
    moduli and one matmul, then one reconstruct from limbs; a chunk of
    num_moduli or more is the one-shot call."""
    L = 14
    a = torch.from_numpy(_mk((16, 40), 0.5, seed=1))
    b = torch.from_numpy(_mk((40, 12), 0.5, seed=2))
    enc_calls = _spy(monkeypatch, hk, "encode_slices_plain")
    mm_calls = _spy(monkeypatch, hm, "matmul_mod_u8_plain")
    kinds = []
    plain = hk.reconstruct_plain

    def rec_spy(*args):
        kinds.append(args[-1])
        return plain(*args)

    monkeypatch.setattr(hk, "reconstruct_plain", rec_spy)
    tg.gemm_core(a, b, L, fastmode=fastmode, moduli_chunk=5)
    assert (len(enc_calls), len(mm_calls), kinds) == (6, 3, ["limbs"])
    for chunk in (14, 20, None):
        del enc_calls[:], mm_calls[:], kinds[:]
        tg.gemm_core(a, b, L, fastmode=fastmode, moduli_chunk=chunk)
        assert (len(enc_calls), len(mm_calls), kinds) == (2, 1, ["residues"])


def test_gemm_chunked_alpha_exponent():
    a, b = _mk((16, 40), 0.5, seed=1), _mk((40, 12), 0.5, seed=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = tg.gemm_core(ta, tb, 14, alpha_e=-2)
    got = tg.gemm_core(ta, tb, 14, moduli_chunk=3, alpha_e=-2)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), 14, True, "f64",
                       moduli_chunk=3, use_pallas=True, alpha_e=-2)
    _hold_to_jax(got, ref, a, b, 14, True)


def test_gemm_chunked_under_mm_pipeline(monkeypatch):
    """GEMMUL8_MM_PIPELINE=1 sends the chunks' uncentered matmuls to the
    pipelined variant, as the JAX package's dispatcher does."""
    monkeypatch.setenv("GEMMUL8_MM_PIPELINE", "1")
    calls = _spy(monkeypatch, hm, "matmul_mod_u8_pipelined_plain")
    a = torch.from_numpy(_mk((16, 40), 0.5, seed=1))
    b = torch.from_numpy(_mk((40, 12), 0.5, seed=2))
    got = tg.gemm_core(a, b, 14, moduli_chunk=5)
    assert len(calls) == 3
    monkeypatch.delenv("GEMMUL8_MM_PIPELINE")
    want = tg.gemm_core(a, b, 14)
    assert torch.equal(want.view(torch.int64), got.view(torch.int64))


@pytest.mark.parametrize("fastmode", [True, False])
def test_gemm_max_workspace_bytes_through_api(monkeypatch, fastmode):
    """A budget the one-shot call does not fit makes the planner chunk the
    call; the bits are the one-shot call's and the JAX package's public
    gemm's at the same chunk."""
    L, (m, k, n) = 14, (40, 136, 24)
    a, b = _mk((m, k), 0.5, seed=3), _mk((k, n), 0.5, seed=4)
    budget = gt.workspace_bytes(m, n, k, L, moduli_chunk=3)
    assert budget < gt.workspace_bytes(m, n, k, L)
    assert planner.plan_schedule(m, n, k, L, budget).chunk == 3
    one_shot = gt.gemm(a, b, num_moduli=L, fastmode=fastmode, device="cpu")
    calls = _spy(monkeypatch, hm, "matmul_mod_u8_plain")
    got = gt.gemm(a, b, num_moduli=L, fastmode=fastmode,
                  max_workspace_bytes=budget, device="cpu")
    assert len(calls) == 5          # ceil(14 / 3) chunks
    assert torch.equal(one_shot.view(torch.int64), got.view(torch.int64))
    # moduli_chunk wins over the budget, as in the JAX package
    del calls[:]
    gt.gemm(a, b, num_moduli=L, fastmode=fastmode, moduli_chunk=7,
            max_workspace_bytes=budget, device="cpu")
    assert len(calls) == 2
    # a budget the one-shot call fits: one matmul
    del calls[:]
    gt.gemm(a, b, num_moduli=L, fastmode=fastmode,
            max_workspace_bytes=gt.workspace_bytes(m, n, k, L), device="cpu")
    assert len(calls) == 1
    if fastmode and _shifts_agree(a, b, L, True):
        ref = np.asarray(g8.gemm(a, b, num_moduli=L, moduli_chunk=3))
        np.testing.assert_array_equal(ref.view(np.uint64),
                                      got.numpy().view(np.uint64))


@pytest.mark.parametrize("kwargs", [
    dict(moduli_chunk=4), dict(fastmode=False, moduli_chunk=4),
    dict(max_workspace_bytes=1 << 20), dict(max_workspace_bytes=1)])
def test_gemm_schedule_arguments_work(kwargs):
    """The low-memory arguments of the public entry point (a budget too
    small for any chunk runs one modulus at a time)."""
    a = torch.ones((4, 4), dtype=torch.float64)
    want = torch.full((4, 4), 4.0, dtype=torch.float64)
    assert torch.equal(gt.gemm(a, a, **kwargs), want)


def test_gemm_core_accurate_chunked_works():
    a = torch.ones((4, 4), dtype=torch.float64)
    c = tg.gemm_core(a, a, 14, fastmode=False, moduli_chunk=4)
    assert torch.equal(c, torch.full((4, 4), 4.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="moduli_chunk"):
        tg.gemm_core(a, a, 14, moduli_chunk=0)


@pytest.mark.parametrize("kwargs", [
    dict(n_panel=2, moduli_chunk=4),
    dict(n_panel=2, max_workspace_bytes=1 << 20)])
def test_gemm_schedules_are_mutually_exclusive(kwargs):
    a = torch.ones((4, 4), dtype=torch.float64)
    with pytest.raises(ValueError, match="mutually exclusive"):
        gt.gemm(a, a, **kwargs)
    with pytest.raises(ValueError, match="mutually exclusive"):
        g8.gemm(np.ones((4, 4)), np.ones((4, 4)), **kwargs)


# ---- GEMMUL8_FUSED_RECONSTRUCT --------------------------------------------

@pytest.mark.parametrize("fused_encode", [False, True])
@pytest.mark.parametrize("fastmode", [True, False])
def test_fused_reconstruct_matches_default_and_jax(monkeypatch, fastmode,
                                                   fused_encode):
    L = 14
    a, b = _mk((72, 200), 0.5, seed=3), _mk((200, 56), 0.5, seed=4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    default = tg.gemm_core(ta, tb, L, fastmode=fastmode)
    monkeypatch.setenv("GEMMUL8_FUSED_RECONSTRUCT", "1")
    if fused_encode:
        monkeypatch.setenv("GEMMUL8_FUSED_ENCODE", "1")
    ref = gg.gemm_core(f64_to_bits(a), f64_to_bits(b), L, fastmode, "f64",
                       use_pallas=True)
    fused = _spy(monkeypatch, hm, "matmul_reconstruct_plain")
    fused_enc = _spy(monkeypatch, hk, "fast_encode_fused_plain")
    replaced = [_spy(monkeypatch, hm, "matmul_mod_u8_plain"),
                _spy(monkeypatch, hk, "reconstruct_plain")]
    got = tg.gemm_core(ta, tb, L, fastmode=fastmode)
    assert len(fused) == 1, "the fused kernel did not run"
    assert not any(replaced), "a replaced kernel ran under the switch"
    assert len(fused_enc) == (2 if fused_encode and fastmode else 0)
    assert torch.equal(default.view(torch.int64), got.view(torch.int64))
    _hold_to_jax(got, ref, a, b, L, fastmode)
    # through the public entry point too
    pub = gt.gemm(ta, tb, num_moduli=L, fastmode=fastmode)
    assert len(fused) == 2
    assert torch.equal(default.view(torch.int64), pub.view(torch.int64))


@pytest.mark.parametrize("fastmode", [True, False])
def test_fused_reconstruct_gives_way(monkeypatch, fastmode):
    """With alpha_e != 0, with a chunked schedule, or where
    fused_reconstruct_ok says no, the default kernels run under the switch,
    as in the JAX package."""
    monkeypatch.setenv("GEMMUL8_FUSED_RECONSTRUCT", "1")
    a = torch.from_numpy(_mk((16, 40), 0.5, seed=1))
    b = torch.from_numpy(_mk((40, 12), 0.5, seed=2))
    fused = _spy(monkeypatch, hm, "matmul_reconstruct_plain")
    default = _spy(monkeypatch, hm, "matmul_mod_u8_plain")
    c = tg.gemm_core(a, b, 14, fastmode=fastmode, alpha_e=3)
    assert (len(fused), len(default)) == (0, 1)
    assert torch.equal(c, tg.gemm_core(a, b, 14, fastmode=fastmode) * 8)
    assert (len(fused), len(default)) == (1, 1)
    tg.gemm_core(a, b, 14, fastmode=fastmode, moduli_chunk=7)
    assert (len(fused), len(default)) == (1, 3)
    monkeypatch.setattr(hm, "fused_reconstruct_ok", lambda *args: False)
    tg.gemm_core(a, b, 14, fastmode=fastmode)
    assert (len(fused), len(default)) == (1, 4)


# ---- the planner ----------------------------------------------------------

@pytest.mark.parametrize("L", range(2, 21))
def test_moduli_schedule_chunks_match_jax(L):
    for chunk in range(1, L + 1):
        ours = planner.ModuliSchedule(L, chunk)
        theirs = jplanner.ModuliSchedule(L, chunk)
        assert ours.chunks() == theirs.chunks()
        assert ours.num_chunks == theirs.num_chunks == len(ours.chunks())
        assert sum(w for _, w in ours.chunks()) == L


@pytest.mark.parametrize("mnk", [(8192, 8192, 8192), (1000, 1500, 777),
                                 (40, 24, 136)])
def test_plan_schedule_keeps_its_budget_and_is_monotone(mnk):
    m, n, k = mnk
    for L in (2, 8, 14, 20):
        least = planner.workspace_bytes(m, n, k, L, moduli_chunk=1)
        most = planner.workspace_bytes(m, n, k, L)
        assert planner.plan_schedule(m, n, k, L).chunk == L
        assert planner.plan_schedule(m, n, k, L, most).chunk == L
        assert planner.plan_schedule(m, n, k, L, 0).chunk == 1
        last = 1
        for budget in np.linspace(least, most + least, 97).astype(np.int64):
            sched = planner.plan_schedule(m, n, k, L, int(budget))
            assert 1 <= sched.chunk <= L and sched.num_moduli == L
            assert planner.workspace_bytes(
                m, n, k, L, moduli_chunk=sched.chunk) <= budget
            assert sched.chunk >= last
            last = sched.chunk
        assert last == L


def test_workspace_bytes_counts_what_the_port_holds():
    """The model at the headline size: the peak is in the residue GEMM,
    where per modulus the A slices, B's K-major slices and the residues
    are live, one byte an element each, and not in the reconstruct (the
    residues and the f64 output); chunked, the int32 limbs beside either;
    the shifts throughout. Each tensor counts at the most the caching
    allocator counts for it: 512-byte rounding and 1 MiB more above 1 MiB.
    The one-shot, chunk 3 and chunk 2 figures are the peaks measured on the
    card at 8192^3, 14 moduli (chip_smoke.py phase 4s, PERF.md) plus 1 MiB
    a large tensor; with B's slices K-major (no copy) a chunk of 4 or more
    holds more than the one-shot call."""
    n, L = 8192, 14
    plane = n * n
    shifts = 4 * 2 * n
    limbs = tables.num_limbs(L) * 4 * plane
    MiB = 2 ** 20
    assert gt.workspace_bytes(n, n, n, L) == L * 3 * plane + shifts + 3 * MiB \
        == 2_818_637_824 + 3 * MiB
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=5) == (
        5 * 3 * plane + limbs + shifts + 4 * MiB) == 3_154_182_144 + 4 * MiB
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=4) == \
        2_952_855_552 + 4 * MiB
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=3) == (
        3 * 3 * plane + limbs + shifts + 4 * MiB) == 2_751_528_960 + 4 * MiB
    # chunk 2: the limbs and the f64 output outweigh the chunk's buffers
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=2) == (
        limbs + 8 * plane + shifts + 2 * MiB) == 2_684_420_096 + 2 * MiB
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=3) < \
        gt.workspace_bytes(n, n, n, L) < \
        gt.workspace_bytes(n, n, n, L, moduli_chunk=4)
    assert gt.workspace_bytes(n, n, n, L, moduli_chunk=L) == \
        gt.workspace_bytes(n, n, n, L)
    # where the output outweighs the GEMM's buffers: residues + output
    assert gt.workspace_bytes(n, n, 16, 2) == (
        2 * plane + 8 * plane + shifts + 2 * MiB)
    assert gt.workspace_bytes(n, n, 16, 14, moduli_chunk=1) == (
        limbs + 8 * plane + shifts + 2 * MiB)
    # k is padded to a multiple of 16 where the GEMM reads it K-major: A's
    # slices (8 x 5), their padded copy (8 x 16), B's K-major slices
    # (8 x 16) and the residues (8 x 8) of 2 moduli, each rounded to 512
    # bytes, beside the two shifts (each 32 bytes -> 512)
    assert planner.workspace_bytes(8, 8, 5, 2) == 4 * 512 + 2 * 512
    CT = gt.ComputeType
    classic = gt.workspace_bytes(n, n, n, L, CT.COMPLEX_CLASSIC_MULT)
    assert classic == gt.workspace_bytes(n, n, n, L,
                                         CT.COMPLEX_BIG_MATRIX_ENCODE)
    # complex: the operands' four f64 parts beside the residue GEMM's
    # buffers (Karatsuba: a third slice set a side), 1 MiB more for each
    # large tensor (an allocator block it may leave unsplit): the
    # complex128 peaks measured on the card at 8192^3, 14 moduli
    # (7,784,693,760 and 12,482,315,264 bytes, PERF.md), plus 10 and 12 MiB
    parts = 4 * 8 * plane
    assert classic == parts + L * (2 * 2 + 2) * plane + 8 * n + 10 * 2**20 \
        == 7_784_693_760 + 10 * 2**20
    assert gt.workspace_bytes(n, n, n, L, CT.COMPLEX_KARATSUBA_MULT) == \
        classic + L * 5 * plane + 1024 + 2 * 2**20 \
        == 12_482_315_264 + 12 * 2**20
    with pytest.raises(ValueError, match="complex"):
        gt.workspace_bytes(n, n, n, L, CT.COMPLEX_CLASSIC_MULT, 5)
    assert planner.plan_workspace([(64, 64, 64, 8), (n, n, n, L),
                                   (64, 64, 64, 20, CT.COMPLEX_CLASSIC_MULT)
                                   ]) == gt.workspace_bytes(n, n, n, L)


def _alloc(nbytes):
    """The most bytes the caching allocator counts for one tensor."""
    b = -(-max(nbytes, 1) // 512) * 512
    return b + 2 ** 20 if b > 2 ** 20 else b


@pytest.mark.parametrize("mnkl", [(1000, 1500, 4100, 14), (3, 7, 5, 2),
                                  (65, 129, 4100, 20), (300, 200, 260, 8)])
@pytest.mark.parametrize("chunk", [None, 5, 1])
def test_workspace_bytes_at_a_ragged_k(mnkl, chunk):
    """C11: where k % 16 != 0 the residue GEMM holds A's slices padded to
    kp beside the unpadded ones; the figure counts both, tensor by tensor
    at the allocator's most, against an independent count of what the
    call holds at each moment."""
    m, n, k, L = mnkl
    kp = -(-k // 16) * 16
    c = L if chunk is None or chunk >= L else chunk
    held = [c * m * k, c * n * kp, c * m * n]
    if kp != k:
        held.append(c * m * kp)
    gemm = sum(_alloc(b) for b in held)
    shifts = _alloc(4 * m) + _alloc(4 * n)
    if c == L:
        want = shifts + max(gemm, _alloc(L * m * n) + _alloc(8 * m * n))
    else:
        want = (shifts + _alloc(tables.num_limbs(L) * 4 * m * n)
                + max(gemm, _alloc(8 * m * n)))
    got = planner.workspace_bytes(m, n, k, L, moduli_chunk=chunk)
    assert got == want
    if kp != k and c == L:
        # the padded copy is counted: above the figure without it
        assert got >= shifts + gemm - _alloc(c * m * kp) + c * m * kp


# ---- on the card ----------------------------------------------------------

@pytest.mark.cuda
def test_schedules_on_card_give_default_bits(monkeypatch):
    """On a CUDA host: the chunked call, the fused-reconstruct call and the
    matmul_crt path launch their kernels and give the default call's bits.
    Skips without a card; chip_smoke.py covers more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from gemmul8_tpu_torch.hopper import build

    L = 14
    ta = torch.from_numpy(_mk((300, 260), 0.5, seed=8)).cuda()
    tb = torch.from_numpy(_mk((260, 200), 0.5, seed=9)).cuda()
    for fastmode in (True, False):
        ref = gt.gemm(ta, tb, num_moduli=L, fastmode=fastmode)
        build.LAUNCHES.clear()
        got = gt.gemm(ta, tb, num_moduli=L, fastmode=fastmode, moduli_chunk=5)
        assert (build.LAUNCHES["encode_slices"], build.LAUNCHES[
            "matmul_mod_u8"], build.LAUNCHES["reconstruct"]) == (6, 3, 1)
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
        monkeypatch.setenv("GEMMUL8_FUSED_RECONSTRUCT", "1")
        build.LAUNCHES.clear()
        got = gt.gemm(ta, tb, num_moduli=L, fastmode=fastmode)
        assert build.LAUNCHES["matmul_reconstruct"] == 1
        assert build.LAUNCHES["matmul_mod_u8"] == 0
        assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
        monkeypatch.delenv("GEMMUL8_FUSED_RECONSTRUCT")
    sa, sb = hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0)
    limbs = hm.matmul_crt(hk.encode_slices(ta, sa, L, 1),
                          hk.encode_slices(tb, sb, L, 0), L)
    got = hk.reconstruct(limbs, sa, sb, L, input_kind="limbs")
    ref = gt.gemm(ta, tb, num_moduli=L)
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))
