"""The port's sweep drivers (`gemmul8_tpu_torch.scripts`) against the JAX
package's `scripts/`.

Protocol parity: the JAX scripts' `main` and the port's drivers run with
the harness functions replaced by recorders; every call's keywords must be
equal but for `outdir` (results_committed there, results_torch here) and
the port's `device`. Small-size accuracy: the port's accuracy sweep on
the CPU against `gemmul8_tpu.bench.harness.accuracy_check`, row for row.
band_seed_sweep at a small m and k; the port's CSVs through
`scripts/plot_results.py`. Nothing in `scripts/` is edited.
"""

import csv
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import gemmul8_tpu.bench.harness as jh
import gemmul8_tpu.bench.timing as jtiming
from gemmul8_tpu.core import gemm as gg
from gemmul8_tpu.pallas import kernels as pk
from gemmul8_tpu.types import f64_to_bits
from gemmul8_tpu_torch.bench import harness as ph
from gemmul8_tpu_torch.bench import matrices as pmat
from gemmul8_tpu_torch.bench import timing as ptiming
from gemmul8_tpu_torch.core import gemm as tg
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.scripts import accuracy_sweep, band_seed_sweep
from gemmul8_tpu_torch.scripts import compare_csvs, time_sweep

from test_torch_threads import one_torch_thread  # noqa: E402, F401

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def _jax_script(monkeypatch, name: str):
    """scripts/<name>.py as a module (its sys.path insertions undone after
    the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}",
                                                  SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorders(monkeypatch, module, names, calls):
    """Replace module.<name> for each name by a recorder of its keywords
    that returns no rows."""
    for name in names:
        def rec(*args, _name=name, **kw):
            assert not args, f"{_name} called with positional arguments"
            calls.append((_name, kw))
            return [], f"{_name}.csv"

        monkeypatch.setattr(module, name, rec)


HARNESS = ("accuracy_check", "accuracy_check_complex", "time_check")


def _run_jax(monkeypatch, script, argv):
    """The JAX script's harness calls for argv: jax.config.update recorded
    and not applied (nothing a script sets outlives it)."""
    calls = []
    _recorders(monkeypatch, jh, HARNESS, calls)
    monkeypatch.setattr(jtiming, "require_tpu", lambda *a, **k: None)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    _jax_script(monkeypatch, script).main()
    return calls


def _run_port(monkeypatch, main, argv):
    calls = []
    _recorders(monkeypatch, ph, HARNESS, calls)
    monkeypatch.setattr(ptiming, "require_gpu", lambda: None)
    main(argv)
    return calls


def _strip(calls, outdir, device=None):
    """The calls without outdir (which must be `outdir`) and, on the
    port's side, without device (which must be `device`)."""
    out = []
    for name, kw in calls:
        kw = dict(kw)
        assert kw.pop("outdir") == outdir, (name, kw)
        if device is not None:
            assert kw.pop("device") == device, (name, kw)
        out.append((name, kw))
    return out


@pytest.mark.parametrize("which", ["d", "f", "c", "md", "mf", "all"])
def test_card_accuracy_protocols_match_the_tpu_script(monkeypatch, which):
    want = _run_jax(monkeypatch, "accuracy_sweep_tpu", [which])
    got = _run_port(monkeypatch, accuracy_sweep.main, [which])
    assert want, "the JAX script made no call"
    assert (_strip(got, "results_torch", "cuda")
            == _strip(want, "results_committed"))


@pytest.mark.parametrize("which", ["d", "f", "md", "mf", "all"])
def test_cpu_accuracy_protocols_match_the_cpu_script(monkeypatch, which):
    want = _run_jax(monkeypatch, "accuracy_sweep_cpu", [which])
    got = _run_port(monkeypatch, accuracy_sweep.main,
                    [which, "--device", "cpu"])
    assert want
    assert (_strip(got, "results_torch", "cpu")
            == _strip(want, "results_committed"))


@pytest.mark.parametrize("argv", [[], ["4096,8192", "d"], ["1024", "f"],
                                  ["2048,4096", "md"], ["1024", "mf"],
                                  ["1024,2048,4096,8192", "all"]],
                         ids=["default", "d", "f", "md", "mf", "all"])
def test_time_protocols_match_the_tpu_script(monkeypatch, argv):
    want = _run_jax(monkeypatch, "time_sweep_tpu", argv)
    got = _run_port(monkeypatch, time_sweep.main, argv)
    assert want
    assert _strip(got, "results_torch") == _strip(want, "results_committed")


def test_card_drivers_need_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((accuracy_sweep.main, ["d"]),
                       (band_seed_sweep.main, ["--seeds", "1"])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


# ---- the accuracy sweep on the CPU against the JAX harness -----------------

SMALL = dict(m=64, k=256, phis=(0.5, 2.0), moduli=(2, 8, 14, 20))


def _shifts(a, b, L, fastmode):
    """(port's, JAX's) shifts of A's rows and B's columns, int64."""
    A, B = f64_to_bits(a), f64_to_bits(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if fastmode:
        port = (hk.fast_sft(ta, L, 1), hk.fast_sft(tb, L, 0))
        jax_ = (pk.fast_sft_pallas(A, L, axis=1),
                pk.fast_sft_pallas(B, L, axis=0))
    else:
        port = tg.accurate_sfts(ta, tb, L)
        jax_ = gg.accurate_sfts(A, B, L, use_pallas=True)
    return ([p.numpy().astype(np.int64) for p in port],
            [np.asarray(j).astype(np.int64) for j in jax_])


def test_accuracy_sweep_on_the_cpu_matches_jax(tmp_path):
    m, k = SMALL["m"], SMALL["k"]
    out = accuracy_sweep.main([
        "d", "--device", "cpu", "--m", str(m), "--sizes", str(k),
        "--phis", ",".join(map(str, SMALL["phis"])),
        "--moduli", ",".join(map(str, SMALL["moduli"])),
        "--outdir", str(tmp_path)])
    want, jpath = jh.accuracy_check(dtype="d", sizes=(k,),
                                    phis=SMALL["phis"],
                                    moduli=SMALL["moduli"],
                                    fastmodes=(True, False), m=m,
                                    outdir=str(tmp_path / "jax"))
    got = out["rows"]
    assert [r["func"] for r in got] == [r["func"] for r in want]
    assert len(got) == 2 * (1 + 2 * len(SMALL["moduli"]))
    assert out["bands"] == []       # no row at the band point (k 8192)
    (path,) = out["paths"]
    assert Path(path).name.startswith("oz2_results_d_accuracy_cpu_")
    differ = 0
    for g, w in zip(got, want):
        assert [g[key] for key in ("phi", "m", "n", "k")] == \
            [w[key] for key in ("phi", "m", "n", "k")]
        if (g["max_relerr"], g["med_relerr"]) == (w["max_relerr"],
                                                  w["med_relerr"]):
            continue
        differ += 1
        # a row may differ only by a shift at a floor boundary: the two
        # packages' shifts differ, by at most 1
        tag, _, L = g["func"].rpartition("-")
        assert tag.startswith("OS2"), (g, w)
        a = pmat.phi_matrix(m, k, g["phi"], 123456)
        b = pmat.phi_matrix(k, m, g["phi"], 123457)
        port, jax_ = _shifts(a, b, int(L), tag == "OS2-fast")
        assert any(not np.array_equal(p, j) for p, j in zip(port, jax_))
        assert all(np.abs(p - j).max() <= 1 for p, j in zip(port, jax_))
    # the same count by the CSV comparison PERF.md's counts come from
    cmp = compare_csvs.compare(path, jpath)
    assert cmp["emulated"]["shared"] == len(got) - 2
    assert cmp["emulated"]["equal"] + differ == len(got) - 2
    assert cmp["native"]["shared"] == 2


def _band_rows(scale):
    rows = [dict(phi=0.5, m=1024, n=1024, k=8192, func="DGEMM",
                 max_relerr=1e-12, med_relerr=1e-16)]
    for tag, bands in (("OS2-fast", accuracy_sweep.REF_FAST),
                       ("OS2-accu", accuracy_sweep.REF_ACCU)):
        for L, band in bands.items():
            rows.append(dict(phi=0.5, m=1024, n=1024, k=8192,
                             func=f"{tag}-{L}", max_relerr=band * scale,
                             med_relerr=band * scale / 100))
    return rows


def test_band_rule_of_test_scale_bands():
    checks = accuracy_sweep.band_checks(_band_rows(1.0))
    # 9 moduli counts and 8 monotone steps a mode
    assert len(checks) == 2 * (9 + 8) and all(ok for _, ok in checks)
    checks = accuracy_sweep.band_checks(_band_rows(5.0))
    bad = [what for what, ok in checks if not ok]
    assert bad and all("monotone" not in what for what in bad)
    rows = _band_rows(1.0)
    rows[3]["max_relerr"] = rows[2]["max_relerr"] * 2   # 12 above 10 x 1.5
    assert any(not ok and "monotone 10 -> 12" in what
               for what, ok in accuracy_sweep.band_checks(rows))


def test_accuracy_sweep_exits_nonzero_outside_the_bands(monkeypatch, capsys):
    monkeypatch.setattr(ph, "accuracy_check",
                        lambda **kw: (_band_rows(5.0), "d.csv"))
    with pytest.raises(SystemExit) as e:
        accuracy_sweep.main(["d", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "band FAILED" in out.out and "band ok" in out.out
    assert "test_scale_bands" in out.err


# ---- band_seed_sweep --------------------------------------------------------

def test_band_seed_sweep_small(monkeypatch, tmp_path, capsys):
    from gemmul8_tpu_torch import gemm
    from gemmul8_tpu_torch.bench.native import dd_gemm, relerr_vs_dd

    monkeypatch.setattr(band_seed_sweep, "M", 48)
    monkeypatch.setattr(band_seed_sweep, "K", 160)
    path = tmp_path / "band.csv"
    rows, worst = band_seed_sweep.main(
        ["--seeds", "2", "--moduli", "10", "14", "--device", "cpu",
         "--csv", str(path)])
    assert [(r["seed"], r["mode"], r["moduli"]) for r in rows] == [
        (s, mode, L) for s in (123456, 123466) for mode in ("fast", "accu")
        for L in (10, 14)]
    assert worst >= 1.0
    assert "worst spread above the 1e-13 floor" in capsys.readouterr().out
    a = pmat.phi_matrix(48, 160, 0.5, seed=123466)
    b = pmat.phi_matrix(160, 48, 0.5, seed=123467)
    c = gemm(a, b, num_moduli=14, fastmode=False, device="cpu").numpy()
    assert (rows[-1]["max_relerr"], rows[-1]["med_relerr"]) == \
        relerr_vs_dd(c, *dd_gemm(a, b))
    with open(path) as f, open(REPO / "results_committed" /
                               "band_seed_sweep_cpu.csv") as g:
        assert next(csv.reader(f)) == next(csv.reader(g))


# ---- plotting by scripts/plot_results.py ------------------------------------

def test_port_csvs_render_through_plot_results(monkeypatch, tmp_path):
    plot = _jax_script(monkeypatch, "plot_results")
    rows, path = ph.accuracy_check(dtype="d", sizes=(128,), phis=(0.5,),
                                   moduli=(8, 14), m=32,
                                   outdir=str(tmp_path), device="cpu")
    png = tmp_path / "acc.png"
    plot.plot_accuracy(plot._read(path), str(png))
    assert png.stat().st_size > 0
    # every column plot_time reads is one of the time CSV's columns
    read = {"m", "func", "tflops", "t_scale", "t_int8gemm", "t_mod",
            "t_invscale"}
    assert read <= set(ph.TIME_FIELDS)
    tpath = tmp_path / "time.csv"
    with open(tpath, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=ph.TIME_FIELDS)
        w.writeheader()
        for n in (1024, 2048):
            w.writerow(dict(phi=0.5, m=n, n=n, k=n, func="OS2-fast-14",
                            seconds=1.0, tflops=2.0, t_scale=0.1,
                            t_int8gemm=0.7, t_mod=0.0, t_invscale=0.2,
                            sm_mhz=1980.0, power_draw_w=500.0))
    tpng = tmp_path / "time.png"
    plot.plot_time(plot._read(str(tpath)), str(tpng))
    assert tpng.stat().st_size > 0


# ---- the L sweep through the bench CLI --------------------------------------

@pytest.mark.parametrize("argv,fastmodes", [
    ([], (True,)), (["--modes", "fast,accu"], (True, False)),
    (["--modes", "accu"], (False,))], ids=["default", "both", "accu"])
def test_bench_cli_modes(monkeypatch, argv, fastmodes):
    """`python -m gemmul8_tpu_torch.bench d flops_check --moduli 2-20
    --modes fast,accu` fills OS2-{fast,accu}-L for every L; the default
    stays the JAX CLI's fast rows."""
    from gemmul8_tpu_torch.bench.__main__ import main as bench_main

    calls = []
    _recorders(monkeypatch, ph, ("time_check",), calls)
    bench_main(["d", "flops_check", "--sizes", "1024,2048", "--moduli",
                "2-20", *argv])
    ((name, kw),) = calls
    assert kw["fastmodes"] == fastmodes
    assert kw["num_moduli"] == tuple(range(2, 21))
    assert kw["sizes"] == (1024, 2048)
    with pytest.raises(SystemExit) as e:
        bench_main(["d", "flops_check", "--modes", "slow"])
    assert e.value.code == 2
