"""The port's timed drivers, the evidence driver, the examples and weak
scaling on the CPU.

`scale_bench`, `profile_phases`, `time_sweep` and `evidence card` exit
nonzero without a card (they time nothing on the CPU); `evidence` runs
every step, names the failed ones and exits nonzero; `profile_one_call`
writes its trace on the CPU; `one_accuracy` and `one_accuracy_complex`
print the relerrs of `gemmul8_tpu.gemm` on the same inputs; the weak
scaling driver and the distributed example run on two gloo CPU ranks,
bit-equal to `gemm`, and the weak-scaling CSV has the JAX script's
columns.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gemmul8_tpu as g8
from gemmul8_tpu.bench.matrices import relerr_stats
from gemmul8_tpu.bench.native import dd_gemm
from gemmul8_tpu_torch.bench.matrices import phi_matrix
from gemmul8_tpu_torch.examples import (one_accuracy, one_accuracy_complex,
                                        profile_one_call)
from gemmul8_tpu_torch.parallel.smoke import free_port
from gemmul8_tpu_torch.scripts import (evidence, profile_phases, scale_bench,
                                       time_sweep, weak_scaling)

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("main,argv", [
    (scale_bench.main, []), (scale_bench.main, ["256", "128", "8", "1"]),
    (profile_phases.main, []), (profile_phases.main, ["256", "8"]),
    (time_sweep.main, ["256", "all"]),
    (profile_one_call.main, ["--n", "128"])],
    ids=["scale_bench", "scale_bench_small", "profile_phases",
         "profile_phases_small", "time_sweep", "profile_one_call_card"])
def test_timed_drivers_exit_without_a_card(no_card, capsys, main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_evidence_card_exits_without_a_card(no_card, monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: ran.append(cmd))
    with pytest.raises(SystemExit) as e:
        evidence.main(["card"])
    assert e.value.code == 1 and ran == []
    assert "no CUDA device" in capsys.readouterr().err


def test_evidence_steps():
    cpu = [name for name, _ in evidence.steps("cpu")]
    card = [name for name, _ in evidence.steps("card")]
    assert cpu == ["accuracy_sweep all --device cpu",
                   "weak_scaling --device cpu", "pytest tests/test_torch_*.py"]
    assert card == ["time_sweep 4096,8192 all", "accuracy_sweep all",
                    "scale_bench"]
    assert [n for n, _ in evidence.steps("all")] == cpu + card
    (_, pytest_argv), = [s for s in evidence.steps("cpu") if "pytest" in s[0]]
    assert "tests/test_torch_scale_examples.py" in pytest_argv


def test_evidence_runs_every_step_and_names_the_failed(monkeypatch, tmp_path,
                                                       capsys):
    marker = tmp_path / "after"
    py = sys.executable
    monkeypatch.setattr(evidence, "steps", lambda mode: [
        ("first", [py, "-c", "pass"]),
        ("broken", [py, "-c", "raise SystemExit(3)"]),
        ("after", [py, "-c", f"open({str(marker)!r}, 'w')"])])
    with pytest.raises(SystemExit) as e:
        evidence.main(["cpu"])
    assert e.value.code == 1
    assert marker.exists()            # a failure does not stop the run
    out = capsys.readouterr()
    assert "!! step failed (continuing): broken" in out.out
    assert "failed steps: broken" in out.err
    monkeypatch.setattr(evidence, "steps", lambda mode: [
        ("first", [py, "-c", "pass"])])
    assert evidence.main(["cpu"]) == []


def test_profile_one_call_writes_its_trace_on_the_cpu(tmp_path, capsys):
    out = profile_one_call.main(["--device", "cpu", "--n", "128",
                                 "--iters", "2", "--trace-dir",
                                 str(tmp_path)])
    trace = tmp_path / profile_one_call.TRACE_NAME
    assert out["trace"] == str(trace) and trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())
    assert out["ms"] > 0 and out["device_us"] == 0.0
    text = capsys.readouterr().out
    assert "Self CPU time total" in text and "host clock" in text


def test_one_accuracy_matches_jax(capsys):
    n = 128
    got = one_accuracy.main(["--device", "cpu", "--n", str(n)])
    a = phi_matrix(n, n, 0.5, seed=123456).astype(np.float32)
    b = phi_matrix(n, n, 0.5, seed=123457).astype(np.float32)
    ref = dd_gemm(a.astype(np.float64), b.astype(np.float64))[0]
    c = np.asarray(g8.gemm(a, b, num_moduli=15, fastmode=True))
    assert got["OS2"] == relerr_stats(c.astype(np.float64), ref)
    assert got["SGEMM"] == relerr_stats((a @ b).astype(np.float64), ref)
    text = capsys.readouterr().out
    assert f"OS2-15  max relerr {got['OS2'][0]:.3e}" in text


def test_one_accuracy_complex_matches_jax(capsys):
    n = 64
    got = one_accuracy_complex.main(["--device", "cpu", "--n", str(n)])
    a = (phi_matrix(n, n, 0.5, 1) + 1j * phi_matrix(n, n, 0.5, 2)).astype(
        np.complex64)
    b = (phi_matrix(n, n, 0.5, 3) + 1j * phi_matrix(n, n, 0.5, 4)).astype(
        np.complex64)
    ref = a.astype(np.complex128) @ b.astype(np.complex128)
    c = np.asarray(g8.gemm(
        a, b, num_moduli=15, fastmode=False,
        compute_type=g8.ComputeType.COMPLEX_KARATSUBA_MULT))
    err = np.abs(c.astype(np.complex128) - ref) / np.abs(ref)
    assert got["OS2"] == (float(err.max()), float(np.median(err)))
    assert "OS2-kara-15  max relerr" in capsys.readouterr().out


def test_weak_scaling_two_gloo_ranks(tmp_path, capfd):
    path = tmp_path / "ws.csv"
    rows = weak_scaling.main(["--device", "cpu", "--ranks", "2", "--base",
                              "32", "--iters", "1", "--repeats", "2",
                              "--csv", str(path)])
    assert [(r["devices"], r["mesh"]) for r in rows] == [(1, "1x1"),
                                                         (2, "1x2")]
    assert [(r["m"], r["n"], r["k"]) for r in rows] == [(32, 32, 256),
                                                        (32, 64, 256)]
    out = capfd.readouterr().out
    for mesh, n in (("1x1", 32), ("1x2", 64)):
        assert (f"mesh {mesh}: every tile bit-equal to gemm on the whole 32 "
                f"x 256 x {n} problem") in out
    with open(path) as f, open(REPO / "results_committed" /
                               "weak_scaling_virtual16_cpu.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))
    assert all(r["metric"] == "sharded_vs_unsharded" for r in rows)
    assert weak_scaling.ladder(6) == [1, 2, 4, 6]


def test_distributed_gemm_two_gloo_ranks():
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, GEMMUL8_COORD=f"127.0.0.1:{port}",
                   GEMMUL8_NPROC="2", GEMMUL8_PROC_ID=str(rank),
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "gemmul8_tpu_torch.examples.distributed_gemm", "--device",
             "cpu"], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    text = outs[0][0]
    assert "ranks: 2 (gloo), mesh 1x2" in text
    assert "sharded emulated DGEMM (64x512x128)" in text
    assert "bit-equal to gemm: True" in text
    rel = float(text.split("max relerr ")[1].split(";")[0])
    assert rel < 1e-8
