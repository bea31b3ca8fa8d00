"""The port's spans and counters (`gemmul8_tpu_torch.trace`).

On CPU tensors every wrapper runs its plain version: the span tree of a
real and a complex call, their call ids and self times, and that nothing
is recorded, and `torch.profiler.record_function` never entered, outside
`recording()`; the epilogue's span (`gm8.api.epilogue`, only where alpha
!= 1 or beta != 0) with the bytes of the tensors it made, and the operand
copies of strided views (`core.gemm.OPERAND_COPIES`). With the card faked
(`fake_card`: the wrappers take their launch branch on CPU tensors and a C
library whose entry points return 0), the launch counts in
`hopper.build.LAUNCHES` are those the card counts, and the same launches
and the bytes each wrapper made land on its span.
"""

import contextlib
import json
import threading
from types import SimpleNamespace

import pytest
import torch

import gemmul8_tpu_torch as gt
from gemmul8_tpu_torch import trace
from gemmul8_tpu_torch.api import EPILOGUE
from gemmul8_tpu_torch.core import gemm as cg
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk

from test_torch_threads import one_torch_thread  # noqa: E402, F401

M, K, N = 16, 32, 8
REAL = ["gm8.hopper.fast_sft", "gm8.hopper.fast_sft",
        "gm8.hopper.encode_slices", "gm8.hopper.encode_slices",
        "gm8.hopper.matmul_mod_u8", "gm8.hopper.reconstruct",
        "gm8.core.gemm_core", "gm8.api.gemm"]
COMPLEX = (["gm8.hopper.fast_stats"] * 4 + ["gm8.hopper.encode_slices"] * 4
           + ["gm8.hopper.matmul_complex_mod"]
           + ["gm8.hopper.reconstruct"] * 2
           + ["gm8.core.gemm_complex_core", "gm8.api.gemm"])


def operands(dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(M, K, generator=g, dtype=torch.float64).to(dtype)
    b = torch.randn(K, N, generator=g, dtype=torch.float64).to(dtype)
    return a, b


def check_tree(spans, names):
    """One call id, one root (the last to close), every other span's parent
    a span of the call, hopper spans under core under api; the self times
    add up to the root's duration."""
    assert [s.name for s in spans] == names
    root = spans[-1]
    assert root.parent is None and {s.call for s in spans} == {root.call}
    by_id = {s.id: s for s in spans}
    for s in spans[:-1]:
        parent = by_id[s.parent]
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
        want = {"hopper": "core", "core": "api"}[s.layer]
        assert parent.layer == want
    rec = trace.Recorder()
    rec.spans = list(spans)
    assert sum(rec.self_ns().values()) == root.end_ns - root.start_ns
    assert all(v >= 0 for v in rec.self_ns().values())


def test_real_call_span_tree():
    a, b = operands()
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=14)
    check_tree(rec.spans, REAL)
    layers = rec.by_layer()
    assert set(layers) == {"api", "core", "hopper"}
    total = rec.spans[-1].end_ns - rec.spans[-1].start_ns
    assert sum(x.self_ms for x in layers.values()) == pytest.approx(
        total / 1e6)


def test_complex_call_span_tree():
    a, b = operands(torch.complex64)
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=8)
    check_tree(rec.spans, COMPLEX)


@pytest.mark.parametrize("schedule,core", [
    ({"moduli_chunk": 5}, ["gm8.core.gemm_chunked", "gm8.core.gemm_core"]),
    ({"n_panel": 4}, ["gm8.core.gemm_core_panels"]),
])
def test_schedules_nest_under_their_core_spans(schedule, core):
    a, b = operands()
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=14, **schedule)
    names = [s.name for s in rec.spans]
    assert names[-1] == "gm8.api.gemm"
    assert [n for n in names if n.startswith("gm8.core.")] == core
    assert len({s.call for s in rec.spans}) == 1


def test_each_public_call_has_its_own_call_id():
    a, b = operands()
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=6)
        gt.gemm_batched(a[None], b[None], num_moduli=6)
        gt.gemm_timed(a, b, num_moduli=6)
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["gm8.api.gemm", "gm8.api.gemm_batched",
                                       "gm8.api.gemm_timed"]
    assert len({s.call for s in roots}) == 3
    for root in roots:
        under = [s for s in rec.spans if s.call == root.call]
        assert all(root.start_ns <= s.start_ns and s.end_ns <= root.end_ns
                   for s in under)
    assert set(rec.by_layer(calls={roots[1].call})) == {"api", "core",
                                                        "hopper"}


def test_threads_keep_their_own_stacks():
    a, b = operands()
    with trace.recording() as rec:
        done = []
        t = threading.Thread(
            target=lambda: done.append(gt.gemm(a, b, num_moduli=4)))
        with trace.span("gm8.api.outer"):
            t.start()
            t.join()
    assert done
    outer = next(s for s in rec.spans if s.name == "gm8.api.outer")
    other = [s for s in rec.spans if s.call != outer.call]
    assert [s.name for s in other] == REAL
    assert all(s.parent != outer.id for s in other)


def test_nothing_is_recorded_outside_recording():
    assert trace.span("gm8.api.x") is trace.span("gm8.core.y") is trace._OFF
    trace.count(3, (torch.ones(4),))   # no open recording: nothing to do
    a, b = operands()
    with trace.recording() as rec:
        pass
    gt.gemm(a, b, num_moduli=6)
    assert rec.spans == [] and trace._recorder is None
    with trace.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with trace.recording():
                pass


class CountingAnnotation:
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CountingAnnotation.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_record_function_only_under_a_profiler_while_recording(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", CountingAnnotation)
    CountingAnnotation.entered = 0
    a, b = operands()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        gt.gemm(a, b, num_moduli=6)          # recording off
    assert CountingAnnotation.entered == 0
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=6)          # no profiler running
    assert CountingAnnotation.entered == 0 and len(rec.spans) == len(REAL)
    with trace.recording() as rec:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            gt.gemm(a, b, num_moduli=6)
    assert CountingAnnotation.entered == len(rec.spans) == len(REAL)


def test_spans_land_in_the_chrome_trace(tmp_path):
    a, b = operands()
    with trace.recording() as rec:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            gt.gemm(a, b, num_moduli=6)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ours = sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("gm8.")), key=lambda e: e["ts"])
    assert sorted(e["name"] for e in ours) == sorted(REAL)
    assert ours[0]["name"] == "gm8.api.gemm"
    assert len({e["tid"] for e in ours}) == 1
    assert len(rec.spans) == len(REAL)


class FakeLib:
    """A kernel library whose every entry point returns 0 (success)."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers take their launch branch on CPU tensors: the device
    checks pass, the launch table reads sm_90, and every C entry point is
    FakeLib's. Outputs are left as allocated."""
    lib = FakeLib()
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
    yield
    build.LAUNCHES.clear()


# the card's counts of one call, as the seed's wrappers kept them
# (tests/test_torch_gemm.py, chip_smoke.py, the benchmark's
# launches_per_step: 6 and 11)
CASES = {
    "f64 fast": (torch.float64, 14, True,
                 {"fast_sft": 2, "encode_slices": 2, "matmul_mod_u8": 1,
                  "reconstruct": 1}),
    "f64 accurate": (torch.float64, 14, False,
                     {"emax": 2, "mag7": 2, "magmax_matmul": 1,
                      "encode_slices": 2, "matmul_mod_u8": 1,
                      "reconstruct": 1}),
    "f32 fast": (torch.float32, 8, True,
                 {"fast_sft[f32]": 2, "encode_slices[f32]": 2,
                  "matmul_mod_u8": 1, "reconstruct[f32]": 1}),
    "c128 fast": (torch.complex128, 14, True,
                  {"fast_stats": 4, "encode_slices": 4,
                   "matmul_complex_mod": 1, "reconstruct": 2}),
    "c64 fast": (torch.complex64, 8, True,
                 {"fast_stats[f32]": 4, "encode_slices[f32]": 4,
                  "matmul_complex_mod": 1, "reconstruct[f32]": 2}),
    "c128 accurate": (torch.complex128, 14, False,
                      {"emax": 4, "mag7": 4, "magmax_matmul": 1,
                       "encode_slices": 4, "matmul_complex_mod": 1,
                       "reconstruct": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_counts_are_the_cards_and_land_on_the_spans(fake_card, case):
    dtype, L, fast, want = CASES[case]
    a, b = operands(dtype)
    gt.gemm(a, b, num_moduli=L, fastmode=fast)
    assert dict(build.LAUNCHES) == want
    build.LAUNCHES.clear()
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=L, fastmode=fast)
    assert dict(build.LAUNCHES) == want
    hopper = [s for s in rec.spans if s.layer == "hopper"]
    assert sum(s.launches for s in hopper) == sum(want.values())
    assert all(s.launches == 0 for s in rec.spans if s.layer != "hopper")
    assert rec.by_layer()["hopper"].launches == sum(want.values())


def test_bytes_are_the_wrappers_outputs_and_workspaces(fake_card):
    a, b = operands()
    L = 14
    with trace.recording() as rec:
        gt.gemm(a, b, num_moduli=L)
    got = {s.name: s.nbytes for s in rec.spans if s.layer == "hopper"}
    # shifts (int32), slices (int8; B's K-major, K % 16 == 0), the
    # residues (int8), the f64 output
    assert got == {"gm8.hopper.fast_sft": 4 * N,
                   "gm8.hopper.encode_slices": L * N * K,
                   "gm8.hopper.matmul_mod_u8": L * M * N,
                   "gm8.hopper.reconstruct": 8 * M * N}
    per_call = 4 * (M + N) + L * (M * K + N * K) + L * M * N + 8 * M * N
    assert rec.by_layer()["hopper"].nbytes == per_call


def test_reconstruct_into_a_given_output_counts_no_bytes(fake_card):
    r = torch.zeros((4, M, N), dtype=torch.int8)
    s_a = torch.zeros((M, 1), dtype=torch.int32)
    s_b = torch.zeros((1, N), dtype=torch.int32)
    out = torch.empty((M, N), dtype=torch.float64)
    with trace.recording() as rec:
        hk.reconstruct(r, s_a, s_b, 4, out=out)
        hk.reconstruct(r, s_a, s_b, 4)
    assert [(s.launches, s.nbytes) for s in rec.spans] == [
        (1, 0), (1, 8 * M * N)]
    assert dict(build.LAUNCHES) == {"reconstruct": 2}


# the epilogue's span: (alpha, beta, c's dtype or None, output dtype) and
# the (M, N) tensors it makes: out * alpha; c widened where it is f32, c *
# beta, the sum; complex128: c's parts, both parts scaled twice, summed
EPILOGUES = {
    "alpha -1, beta 1": (-1.0, 1.0, torch.float64, torch.float64, 3 * 8),
    "alpha 2.5": (2.5, 0.0, None, torch.float64, 8),
    "beta 0.5, f32 c": (1.0, 0.5, torch.float32, torch.float64, 3 * 8),
    "f32 output": (-1.0, 1.0, torch.float32, torch.float32, 3 * 4),
    "complex128": (-1.0, 1.0, torch.complex128, torch.complex128, 8 * 8),
}


@pytest.mark.parametrize("case", list(EPILOGUES))
def test_the_epilogue_is_a_span_of_its_call_with_the_bytes_it_made(case):
    alpha, beta, c_dtype, dtype, per_element = EPILOGUES[case]
    a, b = operands(dtype)
    c = None if c_dtype is None else torch.ones(M, N, dtype=c_dtype)
    with trace.recording() as rec:
        out = gt.gemm(a, b, alpha=alpha, beta=beta, c=c, num_moduli=8)
    assert out.dtype == dtype
    names = [s.name for s in rec.spans]
    assert names.count(EPILOGUE) == 1
    epi = next(s for s in rec.spans if s.name == EPILOGUE)
    root = rec.spans[-1]
    assert names[-2:] == [EPILOGUE, "gm8.api.gemm"]
    assert epi.parent == root.id and epi.call == root.call
    assert root.start_ns <= epi.start_ns <= epi.end_ns <= root.end_ns
    assert epi.launches == 0 and epi.nbytes == per_element * M * N
    assert rec.by_layer()["api"].nbytes == epi.nbytes


@pytest.mark.parametrize("alpha", [1.0, 4.0])
def test_no_epilogue_span_without_its_work(alpha):
    """alpha 1 and beta 0, and a power-of-two alpha (folded into the
    reconstruct): the call's spans are those of a plain call."""
    a, b = operands()
    with trace.recording() as rec:
        gt.gemm(a, b, alpha=alpha, num_moduli=8)
    check_tree(rec.spans, REAL)


def test_the_epilogue_adds_no_launch(fake_card):
    a, b = operands()
    c = torch.ones(M, N, dtype=torch.float64)
    with trace.recording() as rec:
        gt.gemm(a, b, alpha=-1.0, beta=1.0, c=c, num_moduli=14)
    assert dict(build.LAUNCHES) == CASES["f64 fast"][3]
    assert sum(s.launches for s in rec.spans) == sum(CASES["f64 fast"][3]
                                                      .values())


def test_operand_copies_count_strided_views_while_recording():
    big = torch.randn(M + K, K + N, dtype=torch.float64)
    a, b = big[:M, :K], big[M:, K:]
    assert not a.is_contiguous() and not b.is_contiguous()
    cg.OPERAND_COPIES.clear()
    with trace.recording():
        gt.gemm(a.contiguous(), b.contiguous(), num_moduli=6)
    assert cg.OPERAND_COPIES == {}
    with trace.recording():
        gt.gemm(a, b.contiguous(), num_moduli=6)
        gt.gemm(a, b, num_moduli=6, n_panel=4)
        gt.gemm_timed(a.contiguous(), b, num_moduli=6)
    # gemm_timed encodes twice (its warm-up, then the timed run): two
    # copies of B
    assert cg.OPERAND_COPIES == {"a": 2, "b": 3}
    cg.OPERAND_COPIES.clear()


def test_the_epilogue_and_copies_record_nothing_outside_recording():
    assert trace.span(EPILOGUE, made=True) is trace._OFF
    assert not trace.active()
    big = torch.randn(M + K, K + N, dtype=torch.float64)
    a, b = big[:M, :K], big[M:, K:]
    with trace.recording() as rec:
        assert trace.active()
    cg.OPERAND_COPIES.clear()
    gt.gemm(a, b, alpha=-1.0, beta=1.0, c=torch.ones(M, N,
                                                     dtype=torch.float64),
            num_moduli=6)
    assert rec.spans == [] and cg.OPERAND_COPIES == {}
    assert trace._recorder is None
