"""The trace's phases, their merge where one kernel does two phases' work,
torch operations, busy time, gaps and their names."""

import pytest

from portbench import devtrace, spec
from portbench import work as W

from portbench.tests.tinyroot import REPO

RULES = spec.kernel_rules(REPO)
WORK = W.call_work(64, 64, 64, 14, 8, 8, False)
NS = "void gm8::(anonymous namespace)::"


def chrome(device, host=()):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
          for n, t, d in device]
    ev += [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d}
           for c, n, t, d in host]
    ev.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 0})
    return {"traceEvents": ev}


def kernel(name):
    return f"{NS}{name}<(int)14, true>(const signed char *, int)"


def test_unfused_phases():
    dev = [(kernel("sft_rows"), 0, 10), (kernel("sft_cols"), 10, 10),
           (kernel("encode_kernel"), 20, 30),
           (kernel("transpose_b_kernel"), 50, 5),
           (kernel("matmul_mod_kernel"), 55, 200),
           (kernel("reconstruct_kernel"), 260, 40),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 300, 7)]
    tr = devtrace.Trace(chrome(dev), RULES, 1, [WORK])
    assert tr.group("gemm") == {"gemm"} and tr.group("crt") == {"crt"}
    gemm_ms = W.bound_ms(WORK["gemm"])[0]
    assert tr.roofline("gemm") == pytest.approx(100 * gemm_ms * 1e3 / 205)
    crt_ms = W.bound_ms(WORK["crt"])[0]
    assert tr.roofline("crt") == pytest.approx(100 * crt_ms * 1e3 / 40)
    assert tr.torch_ops_us() == 7
    assert tr.busy_us() == 302 and tr.window_us() == 307
    assert tr.gaps() == [(255, 5)]
    top = tr.top_ops(2)
    assert [t[0] for t in top] == [
        "gm8::(anonymous namespace)::matmul_mod_kernel",
        "gm8::(anonymous namespace)::reconstruct_kernel"]
    assert [t[1] for t in top] == pytest.approx([200e-6, 40e-6])


def test_one_kernel_doing_two_phases_merges_them():
    dev = [(kernel("transpose_b_kernel"), 0, 5),
           (kernel("matmul_reconstruct_kernel"), 5, 100)]
    tr = devtrace.Trace(chrome(dev), RULES, 3, [WORK])
    assert tr.group("gemm") == tr.group("crt") == {"gemm", "crt"}
    merged = W.bound_ms(W.merge(WORK, {"gemm", "crt"}))[0]
    assert tr.roofline("gemm") == tr.roofline("crt") == pytest.approx(
        100 * 3 * merged * 1e3 / 105)
    # no share above 100% from stale counts: the merged bound is below the
    # sum of the parts'
    assert merged < W.bound_ms(WORK["gemm"])[0] + W.bound_ms(WORK["crt"])[0]


def test_a_phase_no_kernel_did_reads_nothing():
    tr = devtrace.Trace(chrome([(kernel("encode_kernel"), 0, 10)]), RULES, 1,
                        [WORK])
    assert tr.roofline("gemm") is None and tr.roofline("crt") is None
    empty = devtrace.Trace(chrome([]), RULES, 1, [WORK])
    assert empty.window_us() == 0 and empty.busy_us() == 0


def test_gaps_are_named_by_the_open_span():
    dev = [(kernel("matmul_mod_kernel"), 0, 100),
           (kernel("reconstruct_kernel"), 130, 10),
           (kernel("reconstruct_kernel"), 141, 10)]
    host = [("user_annotation", "portbench.gemm", 90, 60),
            ("cpu_op", "aten::empty", 95, 10),
            ("cpu_op", "aten::copy_", 120, 5)]
    tr = devtrace.Trace(chrome(dev, host), RULES, 1, [WORK])
    gaps = tr.top_gaps()
    assert [g[0] for g in gaps] == ["portbench.gemm > aten::empty",
                                    "portbench.gemm"]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 1e-6])


def test_every_kernel_file_names_known_phases():
    assert RULES and all(set(r.phases) <= set(W.PHASES) for r in RULES)
    names = ["sft_rows", "sft_cols", "encode_kernel", "transpose_b_kernel",
             "matmul_mod_kernel", "matmul_complex_kernel",
             "reconstruct_kernel", "matmul_reconstruct_kernel"]
    for name in names:
        hits = [r.name for r in RULES if r.pattern.search(kernel(name))]
        assert hits == [name]
