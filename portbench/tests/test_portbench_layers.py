"""The program's spans read into per-layer numbers (`portbench/layers.py`):
device operations put down to the innermost program span that launched
them by correlation id, the layers' host self times over the untraced
steps, the bytes the wrappers made, the allocator's new segments, the
gaps named by the program span, and None from every reader where the
run has no recorder."""

from types import SimpleNamespace

import pytest

from gemmul8_tpu_torch import trace
from portbench import devtrace, layers, spec

from portbench.tests.tinyroot import REPO

RULES = spec.kernel_rules(REPO)


def x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def step_trace(t0=0.0, corr0=0, tid=1):
    """One step: the api span opens, launches a copy; core launches a
    shift kernel; the hopper wrapper launches the GEMM, then an aten op
    outside the wrapper; a kernel launched outside every program span."""
    c = corr0
    return [
        x("user_annotation", "portbench.gemm", t0, 100, tid),
        x("user_annotation", "gm8.api.gemm", t0 + 1, 90, tid),
        x("cuda_runtime", "cudaLaunchKernel", t0 + 2, 1, tid, c + 1),
        x("user_annotation", "gm8.core.gemm_core", t0 + 5, 80, tid),
        x("cuda_runtime", "cudaLaunchKernel", t0 + 6, 1, tid, c + 2),
        x("user_annotation", "gm8.hopper.matmul_mod_u8", t0 + 10, 20, tid),
        x("cuda_driver", "cuLaunchKernelEx", t0 + 12, 2, tid, c + 3),
        x("cpu_op", "aten::empty", t0 + 11, 1, tid),
        x("cuda_runtime", "cudaLaunchKernel", t0 + 95, 1, tid, c + 4),
        # device side
        x("gpu_memcpy", "Memcpy DtoD", t0 + 200, 7, 7, c + 1),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
          t0 + 210, 3, 7, c + 2),
        x("kernel", "void gm8::(anonymous namespace)::matmul_mod_kernel()",
          t0 + 215, 50, 7, c + 3),
        x("kernel", "void at::native::fill_kernel()", t0 + 270, 2, 7, c + 4),
    ]


def test_device_time_goes_to_the_innermost_launching_span():
    chrome = {"traceEvents": step_trace() + step_trace(1000, 10)}
    spans = layers.launching_spans(chrome)
    assert spans == {1: "gm8.api.gemm", 2: "gm8.core.gemm_core",
                     3: "gm8.hopper.matmul_mod_u8", 4: None,
                     11: "gm8.api.gemm", 12: "gm8.core.gemm_core",
                     13: "gm8.hopper.matmul_mod_u8", 14: None}
    assert layers.device_us_by_span(chrome) == {
        "gm8.api.gemm": 14, "gm8.core.gemm_core": 6,
        "gm8.hopper.matmul_mod_u8": 100, None: 4}


def test_launches_are_matched_on_their_own_thread():
    # thread 2's launch at the same time as thread 1's hopper span lies in
    # no span of its own thread
    ev = step_trace()
    ev.append(x("cuda_runtime", "cudaLaunchKernel", 13, 1, 2, 99))
    ev.append(x("kernel", "k", 300, 5, 7, 99))
    spans = layers.launching_spans({"traceEvents": ev})
    assert spans[99] is None and spans[3] == "gm8.hopper.matmul_mod_u8"


def ctx(**kw):
    """A run's context: 4 steps of one call, the first 2 traced."""
    base = dict(window=SimpleNamespace(traced_steps=2, host_ms=[1.0] * 4),
                plan=SimpleNamespace(calls=[object()]), steps=4,
                recorder=None, chrome=None, mem=None)
    base.update(kw)
    return SimpleNamespace(**base)


def recorder(steps=4, calls=1):
    """A recorder of `steps` x `calls` api calls, each 10 us long with a
    3 us core span holding a 2 us hopper span that made 1 KiB."""
    rec = trace.Recorder()
    i = 0
    for call in range(steps * calls):
        t = call * 100_000
        rec.spans += [
            trace.Span(i + 2, i + 1, call, "gm8.hopper.x", t + 2_000,
                       t + 4_000, 1, 1024),
            trace.Span(i + 1, i, call, "gm8.core.y", t + 1_000, t + 4_000,
                       0, 0),
            trace.Span(i, None, call, "gm8.api.gemm", t, t + 10_000, 0, 0)]
        i += 3
    return rec


def test_host_self_time_over_the_untraced_steps():
    c = ctx(recorder=recorder())
    assert layers.host_ms(c, "api") == pytest.approx(7e-3)
    assert layers.host_ms(c, "core") == pytest.approx(1e-3)
    assert layers.host_ms(c, "hopper") == pytest.approx(2e-3)
    # the traced steps' calls are left out: a slower first call moves
    # nothing
    rec = recorder()
    rec.spans[2] = rec.spans[2]._replace(end_ns=50_000)
    assert layers.host_ms(ctx(recorder=rec), "api") == pytest.approx(7e-3)
    # two calls a step
    c2 = ctx(recorder=recorder(calls=2), plan=SimpleNamespace(
        calls=[object(), object()]))
    assert layers.host_ms(c2, "api") == pytest.approx(14e-3)
    assert layers.host_ms(c, "nothing") == 0.0


def test_device_readers_per_traced_step():
    chrome = {"traceEvents": step_trace() + step_trace(1000, 10)}
    c = ctx(recorder=recorder(), chrome=chrome)
    assert layers.device_ms(c, "api") == pytest.approx(7e-3)
    assert layers.device_ms(c, "core") == pytest.approx(3e-3)
    assert layers.device_ms(c, "hopper") == pytest.approx(50e-3)
    assert layers.device_ms(c, None) == pytest.approx(2e-3)


def test_alloc_and_mallocs():
    c = ctx(recorder=recorder(),
            mem=({"segment.all.allocated": 5, "num_alloc_retries": 0},
                 {"segment.all.allocated": 7, "num_alloc_retries": 1}))
    assert layers.alloc_gib(c) == pytest.approx(1024 / 2**30)
    assert layers.device_mallocs(c) == pytest.approx(750.0)
    steady = ctx(mem=({"segment.all.allocated": 5},
                      {"segment.all.allocated": 5}))
    assert layers.device_mallocs(steady) == 0.0


def test_every_reader_is_none_without_a_recorder():
    chrome = {"traceEvents": step_trace()}
    c = ctx(chrome=chrome)
    assert layers.host_ms(c, "api") is None
    assert layers.device_ms(c, "api") is None
    assert layers.alloc_gib(c) is None
    assert layers.device_mallocs(c) is None
    # a context without the new keys at all, as an older harness makes
    old = SimpleNamespace(window=c.window, plan=c.plan, steps=4)
    assert layers.host_ms(old, "core") is None
    assert layers.device_ms(old, "core") is None
    assert layers.alloc_gib(old) is None
    assert layers.device_mallocs(old) is None


def test_recording_without_the_program_yields_none():
    with layers.recording(None) as rec:
        assert rec is None
    with layers.recording(object()) as rec:
        assert isinstance(rec, trace.Recorder)
    assert trace._recorder is None


def test_gaps_are_named_by_the_program_span():
    dev = [("void gm8::(anonymous namespace)::matmul_mod_kernel()", 0, 100),
           ("void gm8::(anonymous namespace)::reconstruct_kernel()", 130,
            10),
           ("void gm8::(anonymous namespace)::reconstruct_kernel()", 141,
            10)]
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
          for n, t, d in dev]
    ev += [x("user_annotation", "portbench.gemm", 90, 60),
           x("user_annotation", "gm8.api.gemm", 91, 55),
           x("user_annotation", "gm8.hopper.matmul_complex_mod", 94, 20),
           x("cpu_op", "aten::empty", 95, 10),
           x("cpu_op", "aten::copy_", 120, 5)]
    tr = devtrace.Trace({"traceEvents": ev}, RULES, 1, [])
    gaps = layers.top_gaps(tr)
    assert [g[0] for g in gaps] == [
        "portbench.gemm > gm8.hopper.matmul_complex_mod > aten::empty",
        "portbench.gemm > gm8.api.gemm"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 1e-6])
