"""Whole runs of the cells on the CPU at a tiny size, past the harness's
look for a card: sound runs are correct; runs with the timed path broken
underneath are not; the control fails the limits; and new files are taken
with no edit to those there."""

import json
import time

import pytest
import torch

from gemmul8_tpu_torch import gemm as program_gemm
from portbench import calibrate, devtrace, harness, reference, spec

from portbench.tests import tinyroot
from portbench.tests.tinyroot import CELLS

SEEDS = (1, 2**31 + 7, 4_000_000_123)
SETTLE = 0.05


def run(root, cell, seed=SEEDS[1], gemm=None, trace=False):
    return harness.run_cell(root, cell, seed, 0.3, trace, time.time(),
                            device="cpu", gemm=gemm, settle_seconds=SETTLE)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tinyroot.make(tmp_path_factory.mktemp("cells"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    result, checks, notes = run(root, cell)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"tflops", "step_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"
    assert [c[0] for c in checks] == ["err", "nonfinite"]
    assert all(v <= lim for _, v, lim in checks)
    assert any(n.startswith("judged: 2 steps") for n in notes)


def alter_one_answer(a, b, **kw):
    out = program_gemm(a, b, **kw).clone()
    out[out.shape[0] // 2, 3] *= 1.001
    return out


def half_the_sum_doubled(a, b, **kw):
    k = a.shape[1] // 2
    return 2 * program_gemm(a[:, :k].contiguous(), b[:k].contiguous(), **kw)


def unchanged_output(a, b, **kw):
    return torch.zeros((a.shape[0], b.shape[1]), dtype=a.dtype)


def nan_answer(a, b, **kw):
    out = program_gemm(a, b, **kw).clone()
    out[0, 0] = float("nan")
    return out


@pytest.mark.parametrize("fault", [alter_one_answer, half_the_sum_doubled,
                                   unchanged_output, nan_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(root, cell, fault):
    result, checks, _ = run(root, cell, gemm=fault)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit_the_program_meets(root, cell):
    """The control in the program's place, through the whole run, reads
    `correct` false; the program's runs of the same seeds read true."""
    rows, cfg = calibrate.readings(root, cell, SEEDS, SEEDS, seconds=0.3,
                                   device="cpu", settle_seconds=SETTLE)
    limit = cfg["check"]["err"]
    prog = [r for r in rows if r["side"] == "program"]
    ctrl = [r for r in rows if r["side"] == "control"]
    assert len(prog) == len(ctrl) == 3
    assert [r["correct"] for r in prog] == [True] * 3
    assert [r["correct"] for r in ctrl] == [False] * 3
    assert max(r["err"] for r in prog) < limit < min(r["err"] for r in ctrl)
    assert all(r["nonfinite"] == 0 for r in rows)
    control = reference.control_gemm(cfg["check"]["control"])
    result, checks, _ = run(root, cell, gemm=control)
    assert result["correct"] is False and checks[0][1] > limit


def test_same_seed_same_operands():
    from portbench import gen

    cfg = {"dtype": "complex64", "num_moduli": 8, "fastmode": True,
           "m": 8, "n": 5, "k": 6, "phi": 0.5}
    mix = {"calls": [{}, {"m": 3}]}
    p1 = gen.make_plan(cfg, mix, 2**31 + 3, "cpu")
    p2 = gen.make_plan(cfg, mix, 2**31 + 3, "cpu")
    p3 = gen.make_plan(cfg, mix, 2**31 + 4, "cpu")
    assert torch.equal(p1.calls[1].a, p2.calls[1].a)
    assert not torch.equal(p1.calls[0].a, p3.calls[0].a)
    assert p1.calls[1].a.shape == (3, 6) and p1.calls[1].a.dtype == torch.complex64
    assert p1.flops_per_step == 8 * (8 * 5 * 6 + 3 * 5 * 6)


def test_new_files_are_taken_without_an_edit(tmp_path):
    """A new configuration, mix, per-layer metric and kernel file, each in
    a file of its own and an entry of BENCHMARK.json, run."""
    root = tinyroot.make(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "dgemm-os2-fast14.json").read_text())
    cfg.update(name="sgemm-new", dtype="float32", num_moduli=8, m=40)
    cfg["check"]["err"] = 1e-6
    (pb / "configs" / "sgemm-new.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "pairs.json").write_text(json.dumps(
        {"calls": [{}, {"n": 24, "alpha": 0.5}]}))
    (pb / "metrics" / "calls_per_step.py").write_text(
        "def read(ctx):\n    return float(len(ctx.plan.calls))\n")
    (pb / "kernels" / "new_kernel.json").write_text(json.dumps(
        {"pattern": "new_kernel", "phases": ["gemm"]}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sgemm-new", "source": "x",
                             "file": "portbench/configs/sgemm-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "sgemm8-pairs", "config": "sgemm-new",
                               "traffic": "pairs", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_per_step", "unit": "calls",
                               "better": "lower", "source": "program_counter",
                               "layer": "x", "moves": "tflops",
                               "workloads": ["sgemm8-pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, _, notes = run(root, "sgemm8-pairs")
    assert result["correct"] is True and result["attempted"] % 2 == 0
    assert {"tflops", "step_ms_p95", "setup_s"} <= set(result["metrics"])
    result, _, _ = run(root, "sgemm8-pairs", trace=True)
    assert result["metrics"]["calls_per_step"]["value"] == 2.0
    assert "host_ms" not in result["metrics"]   # listed for the two cells only
    rules = spec.kernel_rules(root)
    tr = devtrace.Trace({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void new_kernel<1>()",
         "ts": 0, "dur": 10}]}, rules, 1, [])
    assert tr.phases_of["void new_kernel<1>()"] == {"gemm"}
    for path, data in before.items():
        assert path.read_bytes() == data, path
