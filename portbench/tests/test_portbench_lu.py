"""The LU cell (`dgemm14-lu16384`): its traffic is dgetrf's trailing
updates; at a tiny N and nb on the CPU a sound run is correct and the
control and two faults are not; `epilogue_roofline` on synthetic traces."""

import json
import re
import time

import pytest
import torch

from gemmul8_tpu_torch import gemm as program_gemm
from portbench import devtrace, epilogue_work, gen, harness, reference, spec
from portbench import work as W

from portbench.tests import tinyroot
from portbench.tests.tinyroot import REPO

CELL = "dgemm14-lu16384"
SEED = 2**31 + 11


def dgetrf_updates(n_rows: int, n_cols: int, nb: int) -> list:
    """The trailing DGEMMs of LAPACK dgetrf's blocked loop (1-based, as in
    dgetrf.f): DO J = 1, MIN(M, N), NB; JB = MIN(MIN(M, N) - J + 1, NB);
    IF (J + JB <= N) ... IF (J + JB <= M) DGEMM(M-J-JB+1, N-J-JB+1, JB,
    -ONE, ..., ONE, ...)."""
    out = []
    for j in range(1, min(n_rows, n_cols) + 1, nb):
        jb = min(min(n_rows, n_cols) - j + 1, nb)
        if j + jb <= n_cols and j + jb <= n_rows:
            out.append({"m": n_rows - j - jb + 1, "n": n_cols - j - jb + 1,
                        "k": jb, "alpha": -1.0, "beta": 1.0})
    return out


def test_the_traffic_is_dgetrfs_updates():
    mix = spec.traffic(REPO, "lu16384")
    assert (mix["N"], mix["nb"]) == (16384, 512)
    assert mix["calls"] == dgetrf_updates(16384, 16384, 512)
    assert len(mix["calls"]) == 31
    assert [c["m"] for c in mix["calls"]] == list(range(15872, 511, -512))
    bench = spec.load(REPO)
    cell = spec.cell(bench, CELL)
    assert (cell["traffic"], cell["chips"]) == ("lu16384", 1)
    cfg = spec.config(REPO, bench, cell["config"])
    square = spec.config(REPO, bench, "dgemm-os2-fast14")
    for key in ("dtype", "num_moduli", "fastmode", "phi"):
        assert cfg[key] == square[key]
    assert {k: v for k, v in cfg["check"].items() if k != "why"} == {
        k: v for k, v in square["check"].items() if k != "why"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A tiny checkout whose lu16384.json is dgetrf's updates at N = 128,
    nb = 4: 31 calls of m = n = 4 (31 - j), k = 4."""
    root = tinyroot.make(tmp_path_factory.mktemp("lu"))
    path = root / "portbench" / "traffic" / "lu16384.json"
    mix = json.loads(path.read_text())
    mix.update(N=128, nb=4, calls=dgetrf_updates(128, 128, 4))
    path.write_text(json.dumps(mix))
    return root


def run(root, gemm=None, trace=False):
    return harness.run_cell(root, CELL, SEED, 0.3, trace, time.time(),
                            device="cpu", gemm=gemm, settle_seconds=0.05)


def test_a_sound_run_is_correct(root):
    result, checks, notes = run(root)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] % 31 == 0 and result["attempted"] >= 31
    assert set(result["metrics"]) == {"tflops", "step_ms_p95", "setup_s"}
    err, nonfinite = checks
    assert err[1] <= err[2] and nonfinite[1] == 0


def test_the_control_fails_the_limit(root):
    cfg = tinyroot.config(root, CELL)
    control = reference.control_gemm(cfg["check"]["control"])
    result, checks, _ = run(root, gemm=control)
    assert result["correct"] is False
    assert checks[0][1] > cfg["check"]["err"] and checks[1][1] == 0


def half_of_k(a, b, **kw):
    k = a.shape[1] // 2
    return program_gemm(a[:, :k].contiguous(), b[:k].contiguous(), **kw)


def never_written(a, b, **kw):
    return torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype).fill_(0.0)


@pytest.mark.parametrize("fault", [half_of_k, never_written])
def test_a_broken_update_is_not_correct(root, fault):
    result, _, _ = run(root, gemm=fault)
    assert result["correct"] is False and result["failed"] >= 1


def test_a_traced_run_reports_the_epilogue_roofline_only_on_the_card(root):
    """On the CPU the profiler sees no device operation: the metric is
    left out, as every device_trace metric is."""
    result, _, _ = run(root, trace=True)
    assert result["correct"] is True
    assert "epilogue_roofline" not in result["metrics"]


# synthetic traces

RULES = spec.kernel_rules(REPO)
NS = "void gm8::(anonymous namespace)::"


def kernel(name):
    return f"{NS}{name}<(int)14, true>(const signed char *, int)"


TORCH_MUL = "void at::native::vectorized_elementwise_kernel<4>(int)"
TORCH_ADD = "void at::native::elementwise_kernel<128, 2>(int)"


def plan(calls, dtype="float64"):
    cfg = {"dtype": dtype, "num_moduli": 14, "fastmode": True, "m": 8,
           "n": 8, "k": 8, "phi": 0.5}
    return gen.make_plan(cfg, {"calls": calls}, 1, "cpu")


def chrome(device):
    return {"traceEvents": [{"ph": "X", "cat": "kernel", "name": n, "ts": t,
                             "dur": d} for n, t, d in device]}


def test_epilogue_bytes_for_every_alpha_and_beta():
    for complex_, parts in ((False, 1), (True, 2)):
        for word in (8, 4):
            size = parts * word * 24 * 40
            cases = {(-1.0, 1.0): 3 * size, (1.0, 0.5): 3 * size,
                     (2.5, 0.0): 2 * size, (1.0, 0.0): 0,
                     (1j, 0.0): 2 * size, (1.0, 2j): 3 * size}
            for (alpha, beta), want in cases.items():
                w = epilogue_work.epilogue_work(24, 40, word, complex_,
                                                alpha, beta)
                assert w.nbytes == want and w.ops == 0
    # the plan's calls: real f64 and complex64 (4 bytes a part)
    p = plan([{"m": 16, "n": 12, "k": 4, "alpha": -1.0, "beta": 1.0},
              {"m": 8, "n": 8, "k": 8}, {"alpha": 3.0}])
    got = [ph["epilogue"].nbytes for ph in epilogue_work.call_phases(p)]
    assert got == [3 * 8 * 16 * 12, 0, 2 * 8 * 64]
    p = plan([{"m": 16, "n": 12, "k": 4, "alpha": -1.0, "beta": 1.0}],
             "complex64")
    got = epilogue_work.call_phases(p)[0]["epilogue"].nbytes
    assert got == 3 * 2 * 4 * 16 * 12


def test_the_roofline_is_the_bound_over_the_unassigned_ops():
    calls = [{"m": 64, "n": 48, "k": 16, "alpha": -1.0, "beta": 1.0},
             {"m": 32, "n": 32, "k": 16}]
    p = plan(calls)
    dev = [(kernel("sft_rows"), 0, 10), (kernel("encode_kernel"), 10, 20),
           (kernel("matmul_mod_kernel"), 30, 100),
           (kernel("reconstruct_kernel"), 130, 30),
           (TORCH_MUL, 160, 4), (TORCH_MUL, 164, 3), (TORCH_ADD, 167, 5)]
    tr = devtrace.Trace(chrome(dev), RULES, 2, p.work_per_step)
    bound_ms = W.bound_ms(epilogue_work.epilogue_work(64, 48, 8, False,
                                                      -1.0, 1.0))[0]
    assert bound_ms == pytest.approx(3 * 8 * 64 * 48 / W.HBM_BYTES_PER_S
                                     * 1e3)
    got = epilogue_work.roofline(tr, p)
    assert got == pytest.approx(100 * 2 * bound_ms * 1e3 / 12)


def test_no_epilogue_ops_or_no_epilogue_work_reads_none():
    p = plan([{"m": 64, "n": 48, "k": 16, "alpha": -1.0, "beta": 1.0}])
    dev = [(kernel("matmul_mod_kernel"), 0, 100),
           (kernel("reconstruct_kernel"), 100, 30)]
    tr = devtrace.Trace(chrome(dev), RULES, 1, p.work_per_step)
    assert epilogue_work.roofline(tr, p) is None
    square = plan([{}])
    tr = devtrace.Trace(chrome(dev + [(TORCH_MUL, 130, 4)]), RULES, 1,
                        square.work_per_step)
    assert epilogue_work.roofline(tr, square) is None


def test_a_kernel_naming_the_epilogue_merges_its_phases():
    """A reconstruct that also does the epilogue: the merged crt and
    epilogue work (C neither written nor read) over its time."""
    rules = RULES + [spec.KernelRule(
        "reconstruct_epilogue_kernel",
        re.compile("reconstruct_epilogue_kernel"),
        ("crt", "epilogue"))]
    p = plan([{"m": 64, "n": 48, "k": 16, "alpha": -1.0, "beta": 1.0}])
    dev = [(kernel("matmul_mod_kernel"), 0, 100),
           (kernel("reconstruct_epilogue_kernel"), 100, 40)]
    tr = devtrace.Trace(chrome(dev), rules, 1, p.work_per_step)
    phases = epilogue_work.call_phases(p)[0]
    merged = W.merge(phases, {"crt", "epilogue"})
    assert set(merged.reads) == {"residues", "sft", "C0"}
    assert set(merged.writes) == {"out"}
    assert epilogue_work.roofline(tr, p) == pytest.approx(
        100 * W.bound_ms(merged)[0] * 1e3 / 40)
