"""The port's comparison harness against the JAX package's.

`gemmul8_tpu_torch.bench` on the CPU: `evalref`, `matrices` and the replay
format bit for bit against `gemmul8_tpu.bench`; `accuracy_check` and
`accuracy_check_complex` row for row against the JAX rows on the same
seeds (the same func list; relative errors within 1e-12 relative, both
packages taking the same bits to the dd oracle); the timing half exiting
nonzero without a card, never timing the CPU; `watt_check` refusing rows=
with sweep arguments; the CLI.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gemmul8_tpu.bench import evalref as jev
from gemmul8_tpu.bench import harness as jh
from gemmul8_tpu.bench import matrices as jmat
from gemmul8_tpu.bench import replay as jrep
from gemmul8_tpu_torch.bench import evalref as pev
from gemmul8_tpu_torch.bench import harness as ph
from gemmul8_tpu_torch.bench import matrices as pmat
from gemmul8_tpu_torch.bench import replay as prep

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent
REL = 1e-12


def _same_bits(x, y):
    x, y = np.asarray(x), np.asarray(y)
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x.view(np.uint8), y.view(np.uint8)))


# ---- evalref, matrices --------------------------------------------------------

@pytest.mark.parametrize("shape,phi", [((7, 33, 5), 0.5), ((16, 64, 9), 3.0)])
def test_dd_gemm_matches_jax(shape, phi):
    m, k, n = shape
    a = pmat.phi_matrix(m, k, phi, seed=1)
    b = pmat.phi_matrix(k, n, phi, seed=2)
    a[0, :3] = [0.0, -0.0, 5e-324]
    for got, want in zip(pev.dd_gemm(a, b), jev.dd_gemm(a, b)):
        assert _same_bits(got, want)
    assert _same_bits(pev.dd_gemm_f64(a, b), jev.dd_gemm_f64(a, b))


def test_dd_gemm_agrees_with_the_native_oracle():
    from gemmul8_tpu_torch.bench.native import dd_gemm

    a = pmat.phi_matrix(12, 40, 1.0, seed=3)
    b = pmat.phi_matrix(40, 10, 1.0, seed=4)
    hi, lo = pev.dd_gemm(a, b)
    nhi, nlo = dd_gemm(a, b)
    assert np.array_equal(hi, nhi)
    # two dd summation orders: the pairs agree to dd precision
    assert np.all(np.abs(lo - nlo) <= 1e-29 * (np.abs(a) @ np.abs(b)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_matrices_match_jax(dtype):
    assert _same_bits(pmat.phi_matrix(9, 13, 1.5, 7, dtype),
                      jmat.phi_matrix(9, 13, 1.5, 7, dtype))
    assert _same_bits(pmat.latms_matrix(12, 9, 1e6, 3, dtype),
                      jmat.latms_matrix(12, 9, 1e6, 3, dtype))
    a = pmat.phi_matrix(5, 7, 4.0, 11)
    b = pmat.phi_matrix(7, 4, 4.0, 12)
    a[1, 2] = 5e-324
    assert _same_bits(pmat.exact_gemm_f64(a, b), jmat.exact_gemm_f64(a, b))
    c = a @ b
    c[0, 0] = 0.0
    ref = pmat.exact_gemm_f64(a, b)
    ref[1, 1] = 0.0
    assert pmat.relerr_stats(c, ref) == jmat.relerr_stats(c, ref)
    assert pmat.relerr_stats(c.astype(np.float32), ref) == \
        jmat.relerr_stats(c.astype(np.float32), ref)


def test_latms_condition_number():
    a = pmat.latms_matrix(64, 48, cond=1e8, seed=3)
    s = np.linalg.svd(a, compute_uv=False)
    assert 0.5e8 < s[0] / s[-1] < 2e8


def test_exact_gemm_checks_inner_dims():
    with pytest.raises(ValueError):
        pmat.exact_gemm_f64(np.ones((2, 3)), np.ones((2, 3)))


# ---- replay --------------------------------------------------------------------

def test_replay_round_trip(tmp_path):
    a = pmat.phi_matrix(32, 64, 0.5, seed=1)
    b = pmat.phi_matrix(64, 24, 0.5, seed=2)
    p = str(tmp_path / "case.npz")
    prep.save_case(p, a, b, phi=0.5, note=123)
    a2, b2, meta = prep.load_case(p)
    assert _same_bits(a, a2) and _same_bits(b, b2)
    assert int(meta["note"]) == 123 and float(meta["phi"]) == 0.5
    c, mx, med = prep.replay(p, num_moduli=14, device="cpu")
    assert med < 1e-12
    # the JAX package reads the port's file, and replays it to the bits
    ja, jb, jmeta = jrep.load_case(p)
    assert _same_bits(ja, a) and jmeta == meta
    jc, jmx, jmed = jrep.replay(p, num_moduli=14)
    assert _same_bits(c, jc) and (mx, med) == (jmx, jmed)


def test_replay_of_a_case_saved_by_jax(tmp_path):
    a = pmat.phi_matrix(40, 96, 1.0, seed=5).astype(np.float32)
    b = pmat.phi_matrix(96, 16, 1.0, seed=6)
    p = str(tmp_path / "jax_case.npz")
    jrep.save_case(p, a, b, seed=5, kind="f32 x f64")
    a2, b2, meta = prep.load_case(p)
    assert a2.dtype == np.float32 and _same_bits(a2, a)
    assert str(meta["kind"]) == "f32 x f64" and int(meta["seed"]) == 5
    for fast in (True, False):
        c, mx, med = prep.replay(p, num_moduli=12, fastmode=fast,
                                 device="cpu")
        jc, jmx, jmed = jrep.replay(p, num_moduli=12, fastmode=fast)
        assert _same_bits(c, jc) and (mx, med) == (jmx, jmed)


# ---- accuracy_check ----------------------------------------------------------

def _close(x, y):
    return abs(x - y) <= REL * max(abs(x), abs(y))


def _same_rows(got, want):
    assert [r["func"] for r in got] == [r["func"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("phi", "m", "n", "k"):
            assert g[key] == w[key]
        for key in ("max_relerr", "med_relerr"):
            assert _close(g[key], w[key]), (g, w)


ACCURACY_CASES = [
    ("d", dict(sizes=(128,), moduli=(8, 14, 20), m=32)),
    ("f", dict(sizes=(128,), moduli=(6, 8, 19, 20), m=32)),
    ("md", dict(sizes=(256,), moduli=(10, 14), m=64)),
    ("mf", dict(sizes=(256,), moduli=(8, 14), m=64)),
]


@pytest.mark.parametrize("dtype,kw", ACCURACY_CASES,
                         ids=[c[0] for c in ACCURACY_CASES])
def test_accuracy_check_matches_jax(tmp_path, dtype, kw):
    got, path = ph.accuracy_check(dtype=dtype, phis=(0.5, 2.0),
                                  outdir=str(tmp_path / "port"),
                                  device="cpu", **kw)
    want, jpath = jh.accuracy_check(dtype=dtype, phis=(0.5, 2.0),
                                    outdir=str(tmp_path / "jax"), **kw)
    _same_rows(got, want)
    assert os.path.basename(path).startswith(
        f"oz2_results_{dtype}_accuracy_cpu_")
    with open(path) as f, open(jpath) as g:
        assert f.readline() == g.readline()
        assert len(list(csv.reader(f))) == len(got)


def test_accuracy_check_curves():
    rows, path = ph.accuracy_check(dtype="f", sizes=(128,), phis=(0.5,),
                                   moduli=(6, 8), fastmodes=(True,), m=32,
                                   write_csv=False, device="cpu")
    assert path is None
    e = {r["func"]: r["max_relerr"] for r in rows}
    assert e["OS2-fast-8"] < e["OS2-fast-6"]
    rows, _ = ph.accuracy_check(dtype="mf", sizes=(256,), phis=(0.5,),
                                moduli=(14,), m=64, fastmodes=(True,),
                                write_csv=False, device="cpu")
    e = {r["func"]: r["max_relerr"] for r in rows}
    assert e["OS2-fast-14"] < 1e-6 and e["OS2-fast-14"] < e["SGEMM"]
    with pytest.raises(ValueError):
        ph.accuracy_check(dtype="z", write_csv=False, device="cpu")


def test_accuracy_check_complex_matches_jax(tmp_path):
    kw = dict(sizes=(128,), phis=(0.5,), moduli=(4, 8), m=48)
    got, path = ph.accuracy_check_complex(outdir=str(tmp_path), device="cpu",
                                          **kw)
    want, _ = jh.accuracy_check_complex(write_csv=False, **kw)
    _same_rows(got, want)
    assert "oz2_results_c_accuracy_cpu_" in path
    nat = [r for r in got if r["func"] == "CGEMM"][0]
    for ct in ("big", "kara", "classic"):
        emu = [r for r in got if r["func"] == f"OS2C-{ct}-fast-8"][0]
        assert emu["max_relerr"] < nat["max_relerr"]


# ---- the timing half: the card only -----------------------------------------

@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: ph.time_check("d", sizes=(64,), iters=1, write_csv=False),
    lambda: ph.time_check("f", sizes=(64,), iters=1, write_csv=False),
    lambda: ph.time_check_complex(sizes=(64,), iters=1, write_csv=False),
    lambda: ph._fused_gemm_seconds(np.ones((64, 64)), np.ones((64, 64)),
                                   8, True, 1),
    lambda: ph.watt_check("d", sizes=(64,)),
    lambda: ph.watt_check(rows=[{"func": "DGEMM", "n": 64, "phi": 0.5}]),
    lambda: ph.watt_check("f", rows=[{"func": "SGEMM", "n": 64, "phi": 0.5}]),
], ids=["time_d", "time_f", "time_complex", "fused", "watt", "watt_rows",
        "watt_rows_dtype"])
def test_timing_exits_without_a_card(no_card, capsys, call):
    with pytest.raises(SystemExit) as e:
        call()
    assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_int8_peak_probe_exits_without_a_card(no_card):
    from gemmul8_tpu_torch.core import slicegemm as sg

    with pytest.raises(SystemExit) as e:
        sg.int8_peak_probe(64, iters=1)
    assert e.value.code != 0


def test_int8_probe_step_chains():
    from gemmul8_tpu_torch.core import slicegemm as sg

    step, (a, b) = sg.int8_probe_step(32, seed=3, device="cpu")
    a0 = a.clone()
    want = a0 ^ (a0.to(torch.int32) @ b.to(torch.int32)).to(torch.int8)
    a1, b1 = step((a, b))
    assert torch.equal(a1, want) and b1 is b
    step2, (c, _) = sg.int8_probe_step(32, seed=3, device="cpu")
    assert torch.equal(c, a0)


def test_clock_sampler_reads_only_the_block():
    """nvidia-smi's lines parse to (MHz, W); [N/A] and partial lines are
    dropped; the first line (taken before the block) is left out of the
    medians, which are NaN with no sample in the block."""
    from gemmul8_tpu_torch.bench import power

    assert power._sample("1980, 452.61") == (1980.0, 452.61)
    assert power._sample("1980, [N/A]") is None
    assert power._sample("") is None

    class Proc:
        def terminate(self):
            pass

        def communicate(self, timeout):
            return self.out, None

    clock = power.ClockSampler()
    clock.proc, clock.first = Proc(), "1980, 70.0\n"
    clock.proc.out = "1575, 650.0\n1590, [N/A]\n1605, 690.0\n"
    clock.__exit__(None, None, None)
    assert clock.medians() == (1590.0, 670.0)
    assert clock.watts() == 670.0
    clock.proc.out = ""
    clock.__exit__(None, None, None)
    assert all(np.isnan(v) for v in clock.medians())
    with pytest.raises(RuntimeError, match="no power.draw.instant sample"):
        clock.watts()


def test_watt_check_refuses_rows_with_sweep_arguments():
    rows = [{"func": "OS2-fast-14", "n": 64, "phi": 0.5}]
    with pytest.raises(ValueError, match="not both"):
        ph.watt_check(rows=rows, sizes=(64,))
    with pytest.raises(ValueError, match="not both"):
        ph.watt_check("d", rows=rows, iters=3)


def test_time_rows_specs():
    """The rows a size times, and their order (no card needed to list
    them: the operands are made on the card only when timed)."""
    names = {
        "d": ["DGEMM", "INT8-GEMM", "OS2-fast-8", "OS2-fast-14",
              "OS2-fast-14-axpby", "OS2-accu-8", "OS2-accu-14", "OS1-EF-8",
              "OS1-EF-9"],
        "f": ["SGEMM", "INT8-GEMM", "OS2-fast-8", "OS2-fast-14",
              "OS2-accu-8", "OS2-accu-14", "BF16X3-SCALING"],
        "md": ["MIXED-DGEMM", "INT8-GEMM", "OS2-fast-8", "OS2-fast-14",
               "OS2-accu-8", "OS2-accu-14"],
    }
    for dtype, want in names.items():
        specs = ph._time_row_names(dtype, (8, 14), (True, False), (8, 9))
        assert specs == want


# ---- the CLI -------------------------------------------------------------------

def _cli(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "gemmul8_tpu_torch.bench",
                           *args, "--outdir", str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=tmp_path)


def test_cli_accuracy_check_on_the_cpu(tmp_path):
    r = _cli(tmp_path, "f", "accuracy_check", "--sizes", "64", "--moduli",
             "4,8", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-800:]
    assert "accuracy_check ->" in r.stdout
    (path,) = tmp_path.glob("oz2_results_f_accuracy_cpu_*.csv")
    _, jpath = jh.accuracy_check(dtype="f", sizes=(64,), moduli=(4,),
                                 fastmodes=(True,), m=8,
                                 outdir=str(tmp_path / "jax"))
    with open(path) as f, open(jpath) as g:
        assert f.readline() == g.readline()
    with open(path) as f:
        funcs = [row["func"] for row in csv.DictReader(f)]
    assert funcs == ["SGEMM", "OS2-fast-4", "OS2-fast-8", "OS2-accu-4",
                     "OS2-accu-8"]


@pytest.mark.parametrize("mode", ["flops_check", "watt_check", "all"])
def test_cli_timing_modes_exit_without_a_card(tmp_path, mode):
    r = _cli(tmp_path, "d", mode, "--sizes", "64", "--moduli", "8",
             "--device", "cpu")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    if mode != "all":
        assert not list(tmp_path.glob("*time*.csv"))
