"""B's residue slices K-major (`core.encode.KMajorSlices`).

The encode of a B operand writes its slices in the layout the residue
GEMM's tile reads, (L, n, kp) with kp = k rounded up to 16 and zeros in
[k, kp), and `matmul_mod_u8` / `matmul_complex_mod` read them without a
copy. Held here on the CPU:

- the K-major form of `hopper.kernels.encode_slices` against the N-major
  slices of `core.encode.encode_slices` (the plain per-modulus route),
  transposed and zero-padded: k below, at and across one 64-row tile and
  k % 16 != 0, n not a multiple of 64, one and two slot tiles (1 to 20
  slots), a moduli subset, f64 and f32 words;
- every schedule that takes the K-major form (one-shot, chunked, column
  panels, `gemm_phases`, the complex 4-dot and Karatsuba forms) against
  the N-major route through the same plain GEMM, bit for bit, with spies
  showing which layout each GEMM was given; the fused-reconstruct branch
  still fed N-major slices;
- with the card faked (the wrappers' launch branch on CPU tensors, a C
  library that records its calls): the entry points the K-major form
  reaches and what they are given, `build.B_COPIES` at 0 for a default
  real and complex call (`LAUNCHES` as before: 6 and 11), and a count per
  copy where B still arrives N-major.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch.core import complexgemm as cg
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.core import gemm as core
from gemmul8_tpu_torch.core import slicegemm as sg
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.types import ComputeType as CT

from test_torch_threads import one_torch_thread  # noqa: E402, F401


def operand(rows, cols, dtype, seed):
    """Values over many binades, with a zero column and a negative zero."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, cols, generator=g, dtype=torch.float64)
    x *= torch.exp2(torch.randint(-30, 30, (rows, cols), generator=g)
                    .double())
    x[:, -1] = 0.0
    x[0, 0] = -0.0
    return x.to(dtype)


# (k, n, num_moduli, moduli_idx, word): k 1, 17 (under one 64-row tile),
# 100, 1000 (k % 16 != 0); n ragged; 1 to 20 slots (one and two slot tiles)
FORM_CASES = [
    (1, 70, 14, (5,), torch.float64),
    (17, 130, 8, None, torch.float64),
    (100, 70, 14, None, torch.float64),
    (1000, 70, 16, None, torch.float64),
    (100, 5, 17, None, torch.float64),
    (17, 70, 20, None, torch.float64),
    (1000, 33, 14, (3, 7, 11), torch.float64),
    (1, 130, 8, None, torch.float32),
    (17, 70, 14, None, torch.float32),
    (100, 70, 16, (0, 15), torch.float32),
    (1000, 70, 20, None, torch.float32),
    (100, 9, 17, None, torch.float32),
]


@pytest.mark.parametrize("case", FORM_CASES, ids=lambda c: (
    f"k{c[0]}-n{c[1]}-L{c[2]}-{'sub' if c[3] else 'all'}-"
    f"{'f32' if c[4] == torch.float32 else 'f64'}"))
def test_k_major_form_is_the_n_major_slices_transposed(case):
    k, n, num_moduli, idx, word = case
    b = operand(k, n, word, seed=k + n)
    sft = hk.fast_sft(b, num_moduli, axis=0)
    want = enc.encode_slices(b, sft, num_moduli, 0, idx)
    got = hk.encode_slices(b, sft, num_moduli, 0, moduli_idx=idx,
                           k_major=True)
    kp = -(-k // 16) * 16
    assert isinstance(got, enc.KMajorSlices) and got.k == k
    assert got.bt.dtype == torch.int8 and got.bt.is_contiguous()
    assert tuple(got.bt.shape) == (want.shape[0], n, kp)
    assert torch.equal(got.bt[:, :, :k], want.transpose(1, 2))
    assert not got.bt[:, :, k:].any()
    assert torch.equal(got.n_major(), want)
    assert torch.equal(enc.k_major(want).bt, got.bt)


def test_k_major_takes_a_whole_b_operand():
    b = operand(40, 24, torch.float64, 1)
    sft = hk.fast_sft(b, 14, axis=0)
    with pytest.raises(ValueError, match="k_major"):
        hk.encode_slices(b, sft, 14, 0, col_tiles=(0, 1), k_major=True)
    a_sft = hk.fast_sft(b, 14, axis=1)
    with pytest.raises(ValueError, match="k_major"):
        hk.encode_slices(b, a_sft, 14, 1, k_major=True)


@pytest.fixture
def n_major_route(monkeypatch):
    """Run the schedules as before this layout existed: encode_slices
    ignores k_major, so every GEMM is given N-major B."""
    real = hk.encode_slices

    def n_major(*args, k_major=False, **kwargs):
        return real(*args, **kwargs)

    def route(on):
        monkeypatch.setattr(hk, "encode_slices", n_major if on else real)

    return route


@pytest.fixture
def b_layouts(monkeypatch):
    """The layouts B's slices reach each GEMM wrapper in: a list of
    (wrapper, 'k' or 'n') per call."""
    seen = []

    def spy(name, fn, b_at):
        def call(*args, **kwargs):
            bs = [args[i] for i in b_at]
            if name == "matmul_complex_mod" and kwargs.get("kara"):
                bs.append(kwargs["kara"][1])
            for b8 in bs:
                seen.append((name, "k" if isinstance(b8, enc.KMajorSlices)
                             else "n"))
            return fn(*args, **kwargs)
        monkeypatch.setattr(hm, name, call)

    spy("matmul_mod_u8", hm.matmul_mod_u8, (1,))
    spy("matmul_complex_mod", hm.matmul_complex_mod, (2, 3))
    spy("matmul_reconstruct", hm.matmul_reconstruct, (1,))
    return seen


M, K, N = 40, 100, 70     # k % 16 != 0, n ragged

REAL_SCHEDULES = {
    "one-shot": lambda a, b, L: core.gemm_core(a, b, L),
    "one-shot accurate": lambda a, b, L: core.gemm_core(a, b, L,
                                                        fastmode=False),
    "chunked": lambda a, b, L: core.gemm_core(a, b, L, moduli_chunk=5),
    "panels": lambda a, b, L: core.gemm_core_panels(a, b, L, n_panel=32),
    "phases": lambda a, b, L: _phases(a, b, L),
}


def _phases(a, b, L):
    encode, matmul, mod, reconstruct = core.gemm_phases(a, b, L)
    a8, sft_a, b8, sft_b = encode(a, b)
    return reconstruct(mod(matmul(a8, b8)), sft_a, sft_b)


@pytest.mark.parametrize("word,L", [(torch.float64, 14),
                                    (torch.float32, 8)], ids=["f64", "f32"])
@pytest.mark.parametrize("schedule", list(REAL_SCHEDULES))
def test_real_schedules_give_the_n_major_routes_bits(
        schedule, word, L, n_major_route, b_layouts):
    a = operand(M, K, word, 3)
    b = operand(K, N, word, 4)
    run = REAL_SCHEDULES[schedule]
    got = run(a, b, L)
    k_calls = list(b_layouts)
    b_layouts.clear()
    n_major_route(True)
    want = run(a, b, L)
    assert k_calls and all(lay == "k" for _, lay in k_calls)
    assert b_layouts and all(lay == "n" for _, lay in b_layouts)
    assert len(k_calls) == len(b_layouts)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("word,L", [(torch.float64, 14),
                                    (torch.float32, 8)], ids=["f64", "f32"])
@pytest.mark.parametrize("strategy", [CT.COMPLEX_BIG_MATRIX_ENCODE,
                                      CT.COMPLEX_KARATSUBA_MULT],
                         ids=["4-dot", "Karatsuba"])
@pytest.mark.parametrize("fastmode", [True, False],
                         ids=["fast", "accurate"])
def test_complex_core_gives_the_n_major_routes_bits(
        strategy, fastmode, word, L, n_major_route, b_layouts):
    parts = [operand(M, K, word, 5), operand(M, K, word, 6),
             operand(K, N, word, 7), operand(K, N, word, 8)]

    def run():
        return cg.gemm_complex_core(*parts, L, fastmode, strategy)

    got = run()
    k_calls = list(b_layouts)
    b_layouts.clear()
    n_major_route(True)
    want = run()
    nb = 3 if strategy == CT.COMPLEX_KARATSUBA_MULT else 2
    assert k_calls == [("matmul_complex_mod", "k")] * nb
    assert b_layouts == [("matmul_complex_mod", "n")] * nb
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_karatsuba_sum_of_k_major_parts_keeps_its_pad_zero():
    b = [operand(K, N, torch.float64, s) for s in (9, 10)]
    sft = hk.fast_sft(b[0], 14, axis=0)
    parts = [hk.encode_slices(x, sft, 14, 0, k_major=True) for x in b]
    s = sg.recenter_add_int8(*parts, 14)
    assert isinstance(s, enc.KMajorSlices) and s.k == K
    assert not s.bt[:, :, K:].any()
    assert torch.equal(s.n_major(), sg.recenter_add_int8(
        parts[0].n_major(), parts[1].n_major(), 14))


@pytest.mark.parametrize("fastmode", [True, False],
                         ids=["fast", "accurate"])
def test_fused_reconstruct_is_still_fed_n_major(fastmode, monkeypatch,
                                                b_layouts):
    a = operand(M, K, torch.float64, 11)
    b = operand(K, N, torch.float64, 12)
    want = core.gemm_core(a, b, 14, fastmode=fastmode)
    assert b_layouts == [("matmul_mod_u8", "k")]
    b_layouts.clear()
    monkeypatch.setenv("GEMMUL8_FUSED_RECONSTRUCT", "1")
    got = core.gemm_core(a, b, 14, fastmode=fastmode)
    assert b_layouts == [("matmul_reconstruct", "n")]
    assert torch.equal(got, want)


def test_gemms_without_the_k_major_form_refuse_it():
    a8 = torch.zeros((2, 4, 32), dtype=torch.int8)
    b8 = enc.k_major(torch.zeros((2, 32, 8), dtype=torch.int8))
    with pytest.raises(TypeError, match="N-major"):
        hm.matmul_crt(a8, b8, 2)
    with pytest.raises(TypeError, match="N-major"):
        hm.matmul_reconstruct(a8, b8, torch.zeros((4, 1), dtype=torch.int32),
                              torch.zeros((1, 8), dtype=torch.int32), 2)
    with pytest.raises(TypeError, match="all be K-major"):
        hm.matmul_complex_mod(a8, a8, b8, b8.n_major(), 2)


class RecordingLib:
    """A kernel library whose every entry point records its arguments and
    returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their launch branch on CPU tensors: the device
    checks pass, the launch table reads sm_90, and every C entry point is
    the RecordingLib's. Outputs are left as allocated."""
    lib = RecordingLib()
    monkeypatch.setattr(hk, "_on_cpu", lambda x, launch=None: False)
    for name in ("require_cuda", "require_device"):
        monkeypatch.setattr(build, name, lambda *t: None)
    monkeypatch.setattr(build, "lib", lambda: lib)
    monkeypatch.setattr(build, "lib_for", lambda src, entry=None: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            multi_processor_count=132))
    build.LAUNCHES.clear()
    build.B_COPIES.clear()
    yield lib
    build.LAUNCHES.clear()
    build.B_COPIES.clear()


def test_entry_points_of_the_k_major_form(fake_card):
    b = operand(K, N, torch.float64, 13)
    sft = torch.zeros((1, N), dtype=torch.int32)
    got = hk.encode_slices(b, sft, 14, 0, moduli_idx=(2, 9, 4),
                           k_major=True)
    kp = 112
    assert isinstance(got, enc.KMajorSlices) and got.k == K
    assert tuple(got.bt.shape) == (3, N, kp)
    name, args = fake_card.calls.pop()
    assert name == "gm8_encode_slices_kmajor"
    assert args[2] == got.bt.data_ptr() and args[3:6] == (K, N, kp)
    assert args[7:10] == (3, enc.q_max(14, 53), 0)
    # matmul_mod_u8 reads it in place: b8 B itself, no workspace bt
    a8 = torch.zeros((3, M, K), dtype=torch.int8)
    hm.matmul_mod_u8(a8, got, 14, moduli_idx=(2, 9, 4))
    name, args = fake_card.calls.pop()
    assert name == "gm8_matmul_mod_u8"
    assert args[1] == got.bt.data_ptr() and args[2] is None
    assert args[5:10] == (3, M, N, K, kp)
    # complex: B's parts in place, no workspace
    hm.matmul_complex_mod(a8, a8, got, got, 3)
    name, args = fake_card.calls.pop()
    assert name == "gm8_matmul_complex_mod"
    assert args[3] == args[4] == got.bt.data_ptr() and args[6] is None
    assert args[9:] == (3, M, N, K, kp, 0, 0, 0)
    assert not build.B_COPIES
    assert build.LAUNCHES == {"encode_slices": 1, "matmul_mod_u8": 1,
                              "matmul_complex_mod": 1}


def test_k_major_slices_must_be_whole(fake_card):
    t = torch.zeros((2, 24, 8), dtype=torch.int8)[:, ::2]   # not contiguous
    a8 = torch.zeros((2, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        hm.matmul_mod_u8(a8, enc.KMajorSlices(t, 8), 2)


REAL_CALL = {"fast_sft": 2, "encode_slices": 2, "matmul_mod_u8": 1,
             "reconstruct": 1}
COMPLEX_CALL = {"fast_stats[f32]": 4, "encode_slices[f32]": 4,
                "matmul_complex_mod": 1, "reconstruct[f32]": 2}


@pytest.mark.parametrize("dtype,L,want", [
    (torch.float64, 14, REAL_CALL), (torch.complex64, 8, COMPLEX_CALL)],
    ids=["dgemm", "cgemm"])
def test_default_calls_copy_no_b(fake_card, dtype, L, want):
    g = torch.Generator().manual_seed(0)
    a = torch.randn(M, K, generator=g, dtype=dtype)
    b = torch.randn(K, N, generator=g, dtype=dtype)
    gt.gemm(a, b, num_moduli=L)
    assert build.LAUNCHES == want
    assert sum(build.LAUNCHES.values()) == (6 if dtype == torch.float64
                                            else 11)
    assert not build.B_COPIES


@pytest.mark.parametrize("variant,want", [
    ({"GEMMUL8_FUSED_ENCODE": "1"}, {"matmul_mod_u8": 1}),
    ({"GEMMUL8_FUSED_ENCODE": "1", "GEMMUL8_MXU_CRT": "0",
      "GEMMUL8_MM_PIPELINE": "1"}, {"matmul_mod_u8_pipelined": 1}),
    ({"GEMMUL8_MXU_CRT": "0", "GEMMUL8_MM_PIPELINE": "1"}, {}),
], ids=["fused-encode", "fused-encode-mm-pipeline", "mm-pipeline"])
def test_copies_of_n_major_b_are_counted(fake_card, monkeypatch, variant,
                                         want):
    for key, value in variant.items():
        monkeypatch.setenv(key, value)
    g = torch.Generator().manual_seed(1)
    a = torch.randn(M, K, generator=g, dtype=torch.float64)
    b = torch.randn(K, N, generator=g, dtype=torch.float64)
    gt.gemm(a, b, num_moduli=14)
    assert build.B_COPIES == want
    assert not set(build.B_COPIES) - set(build.LAUNCHES)


def test_complex_copies_one_per_n_major_part(fake_card):
    a8 = torch.zeros((3, M, K), dtype=torch.int8)
    b8 = torch.zeros((3, K, N), dtype=torch.int8)
    hm.matmul_complex_mod(a8, a8, b8, b8, 3)
    hm.matmul_complex_mod(a8, a8, b8, b8, 3, kara=(a8, b8))
    assert build.B_COPIES == {"matmul_complex_mod": 5}
    name, args = fake_card.calls.pop()
    assert args[6] is not None and args[15] == 1     # bt, kara
