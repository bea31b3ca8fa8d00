"""The rest of the launch table, the candidate libraries and the tuners:
what of them the CPU can hold.

- The launch entries of fast_sft.cu, encode.cu, reconstruct.cu, mag7.cu
  and fast_encode_fused.cu (the JAX table's stats, encode, reconstruct
  and mag7 entries): their defines, the build flags that carry them, each
  source refusing to build without them and reading every one, the
  table's values the constants the sources had; the constants that set
  a sum's order (the statistics chunk, the row block's threads, a
  column's 16 runs of 128 rows) stay literal in the sources and in no
  entry; every JAX `launch.get` name maps to an entry or to a recorded
  "no counterpart".
- The tuners' candidates: each passes its source's `static_assert`s by
  `launch.fits` (shared memory within what a block holds among them),
  each sweep holds the table's entry, and the candidates that cannot
  build are the ones the formulas drop.
- The candidate libraries: one name per (source, entry), apart from the
  table library's; the compile command of one source and its defines; a
  library in place loaded with its ptxas report and no compile; only the
  source's entry points bound; the CRT constants set once per library.
- `launch=` on a CPU tensor raises in every wrapper that takes it.
- The tuners: the JAX scripts' arguments and defaults, no run without a
  card, the word comparison and the rows.

The card builds, runs and times the candidates (chip_smoke.py phase 7,
`python -m gemmul8_tpu_torch.scripts.tune_kernels`).
"""

import json
import re
from pathlib import Path

import pytest
import torch

from gemmul8_tpu.pallas import launch as jax_launch
from gemmul8_tpu_torch.core import encode as enc
from gemmul8_tpu_torch.hopper import build
from gemmul8_tpu_torch.hopper import kernels as hk
from gemmul8_tpu_torch.hopper import launch
from gemmul8_tpu_torch.hopper import matmul as hm
from gemmul8_tpu_torch.scripts import tune_kernels as tk
from gemmul8_tpu_torch.scripts import tune_matmul as tm

from test_torch_threads import one_torch_thread  # noqa: E402, F401

ROOT = Path(__file__).resolve().parent.parent
NEW = {"fast_sft.cu": "fast_sft", "encode.cu": "encode",
       "reconstruct.cu": "reconstruct", "mag7.cu": "mag7",
       "fast_encode_fused.cu": "fast_encode_fused"}
# the constants the sources were built with before the table held them
PARENT_VALUES = {
    "fast_sft": {"GM8_SFT_COL_LOAD_BYTES": 32,
                 "GM8_SFT_COL_BLOCKS_PER_SM": 3},
    "encode": {"GM8_ENC_THREADS": 256, "GM8_ENC_BLOCKS_PER_SM": 8},
    "reconstruct": {"GM8_REC_THREADS": 128, "GM8_REC_CHUNK": 128,
                    "GM8_REC_BLOCKS_PER_SM": 16},
    "mag7": {"GM8_MAG_COL_STRIP": 32, "GM8_MAG_COL_THREADS": 8,
             "GM8_MAG_COL_ROWS": 256, "GM8_MAG_TILE": 64,
             "GM8_MAG_FUSED_STEPS": 4, "GM8_MAG_FUSED_K": 128},
    "fast_encode_fused": {"GM8_FUSED_STAGE_BYTES": 65536,
                          "GM8_FUSED_COL_LOAD_BYTES": 8}}
# what the sweeps changed: a candidate that beat the table's entry in two
# card runs by more than the spread of its rounds, with no spill
SWEPT = {"mag7": {"GM8_MAG_TILE": 32},
         "encode": {"GM8_ENC_BLOCKS_PER_SM": 16}}


def _defines(entry) -> dict:
    return {k[2:]: int(v) for k, v in (f.split("=") for f in entry.defines())}


# ---- the entries ------------------------------------------------------------

@pytest.mark.parametrize("src,name", sorted(NEW.items()))
def test_entry_defines_and_build_flags(src, name):
    """The table's entry is the constants the source had (but what the
    sweeps changed); the build passes its defines with `-Xptxas -v`; the
    source refuses to build without them and reads every one."""
    entry = launch.get(name, (9, 0))
    assert _defines(entry) == {**PARENT_VALUES[name], **SWEPT.get(name, {})}
    assert build.LAUNCH_SOURCES[src] == name
    assert build.SOURCE_FLAGS[src] == ("-Xptxas", "-v", *entry.defines())
    text = (build.CSRC / src).read_text()
    assert "#error" in text
    for macro in PARENT_VALUES[name]:
        assert f"!defined({macro})" in text and f"= {macro};" in text


def test_every_launch_source_has_flags_and_ptxas():
    """Every source with a launch entry is built with its entry's defines
    and `-Xptxas -v`, and no other source takes flags."""
    assert set(build.SOURCE_FLAGS) == set(build.LAUNCH_SOURCES)
    for src, name in build.LAUNCH_SOURCES.items():
        assert build.SOURCE_FLAGS[src] == build.launch_flags(
            launch.get(name, (9, 0)))
        assert (build.CSRC / src).exists()


def test_the_sum_order_stays_out_of_the_table():
    """The statistics chunk, the row block's threads and a column's 16
    runs of 128 rows set the order of the norm's sums: literal in
    fast_stats.cuh, named by no entry, and the columns' plain twin's
    defaults."""
    stats = (build.CSRC / "fast_stats.cuh").read_text()
    for const in ("kChunk = 2048;", "kRowThreads = 256;", "kColY = 16;",
                  "kColRun = kChunk / kColY;"):
        assert f"constexpr int {const}" in stats
    assert launch.STATS_CHUNK == 2048
    macros = {m for entry in launch.TABLE[(9, 0)].values()
              for m in _defines(entry)}
    assert not any(m in stats for m in macros)
    names = {f for entry in launch.TABLE[(9, 0)].values()
             for f in entry.__dataclass_fields__}
    assert not names & {"stats_chunk", "row_threads", "ways", "run"}
    import inspect
    sig = inspect.signature(enc.fast_stats_running).parameters
    assert (sig["run"].default * sig["ways"].default) == launch.STATS_CHUNK
    assert sig["ways"].default == 16


@pytest.mark.parametrize("jax_name", sorted(jax_launch._V5E))
def test_jax_launch_names_map_to_entries(jax_name):
    """Every name the JAX table gives `launch.get` has a port entry, or is
    recorded as having none (the VPU encode and reconstruct bodies)."""
    port = launch.JAX_NAMES[jax_name]
    if port is None:
        assert jax_name in ("enc_vpu", "rec_vpu")
    else:
        assert launch.get(port, (9, 0)) is not None
    assert set(launch.JAX_NAMES) == set(jax_launch._V5E)


def test_table_entries_fit_their_formulas():
    """Every table entry with a formula passes it; the shared-memory
    figures of the wgmma entries are the launch table's."""
    for name in ("matmul_mod", "matmul_mod_pipelined", *NEW.values()):
        assert launch.fits(name, launch.get(name, (9, 0))), name
    assert launch.smem_bytes("matmul_mod",
                             launch.get("matmul_mod", (9, 0))) == 230464
    assert launch.smem_bytes(
        "matmul_mod_pipelined",
        launch.get("matmul_mod_pipelined", (9, 0))) == 230496
    with pytest.raises(KeyError):
        launch.fits("matmul_rider", launch.get("matmul_rider", (9, 0)))


# ---- the tuners' candidates -------------------------------------------------

@pytest.mark.parametrize("sweep", tk.SWEEPS, ids=lambda s: s.entry)
def test_every_candidate_fits_and_the_table_leads(sweep):
    run, dropped = tk.candidates(sweep)
    assert run[0] == launch.get(sweep.entry, (9, 0))
    assert len(run) == len(set(run))
    for e in run:
        assert launch.fits(sweep.entry, e)
        assert launch.smem_bytes(sweep.entry, e) <= 232448
        assert type(e) is type(run[0])
    for e, why in dropped:
        assert not launch.fits(sweep.entry, e) and "static_assert" in why
    assert 3 <= len(run) - 1


def test_the_formulas_drop_what_cannot_build():
    """The candidates over a limit: mag7's 64-column strip (its k-tile
    records past a block's shared memory), reconstruct's 256 threads (its
    limb rows past the static 48 KB), matmul_mod's fifth stage."""
    assert launch.smem_bytes("mag7", launch.Mag7Launch(
        64, 8, 256, 64, 4, 64)) > 232448
    assert launch.smem_bytes("reconstruct", launch.ReconstructLaunch(
        256, 128, 16)) > 49152
    assert not launch.fits("matmul_mod", launch.MatmulModLaunch(256, 5, 16))
    assert not launch.fits("matmul_mod", launch.MatmulModLaunch(128, 4, 16))
    assert not launch.fits("matmul_mod_pipelined",
                           launch.MatmulModLaunch(128, 7, 16))
    assert not launch.fits("mag7", launch.Mag7Launch(32, 8, 256, 64, 4, 64))
    assert not launch.fits("fast_encode_fused",
                           launch.FastEncodeFusedLaunch(1000, 8))
    assert not launch.fits("encode", launch.EncodeLaunch(100, 8))
    assert not launch.fits("fast_sft", launch.FastSftLaunch(12, 3))
    dropped = [e for sw in tk.SWEEPS for e, _ in tk.candidates(sw)[1]]
    assert dropped == [launch.Mag7Launch(64, 8, 256, 64, 4, 64),
                       launch.ReconstructLaunch(256, 128, 16)]


def test_sections_hold_the_jax_scripts_sections():
    assert tk.SECTIONS == ("stats", "encode", "fusedenc", "mmpipe", "recon",
                           "matmul")
    assert [s.entry for s in tk.sweeps("stats")] == ["fast_sft", "mag7"]
    with pytest.raises(ValueError):
        tk.sweeps("vpu")
    mm = tk.sweeps("matmul")[0]
    assert {(e.stages, e.raster_group) for e in tk.candidates(mm)[0]} == {
        (s, g) for s in (2, 3, 4) for g in (1, 4, 8, 16, 32)}
    pipe = tk.sweeps("mmpipe")[0]
    assert {(e.tile_n, e.stages, e.raster_group)
            for e in tk.candidates(pipe)[0]} == {
        (128, s, g) for s in range(2, 7) for g in (4, 8, 16, 32)}


# ---- the candidate libraries ------------------------------------------------

def test_candidate_name_differs_from_the_table_library(tmp_path, monkeypatch):
    """A candidate builds into a library named by its source and flags:
    another name than the table library's and than another candidate's,
    the same name for the same candidate."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    e1 = launch.EncodeLaunch(128, 16)
    e2 = launch.EncodeLaunch(512, 4)
    table = build._library(build.sources())
    a = build.candidate_library("encode.cu", e1)
    assert a == build.candidate_library("encode.cu", e1)
    assert len({table, a, build.candidate_library("encode.cu", e2),
                build.candidate_library(
                    "encode.cu", launch.get("encode", (9, 0)))}) == 4
    assert a.parent == tmp_path and a.name.startswith("libgemmul8_encode_")


def test_candidate_compile_command_is_one_source_and_its_defines():
    e = launch.ReconstructLaunch(64, 128, 32)
    cmd = build.candidate_command("nvcc", "reconstruct.cu", e, "x.o")
    assert [c for c in cmd if c.endswith((".cu", ".cuh"))] == [
        str(build.CSRC / "reconstruct.cu")]
    assert [c for c in cmd if c.startswith("-D")] == list(e.defines())
    assert cmd[:len(build.NVCC_FLAGS) + 1] == ["nvcc", *build.NVCC_FLAGS]
    assert "-v" in cmd and cmd[-2:] == ["-o", "x.o"]
    # the table library compiles each source with the same command
    assert build.compile_command(
        "nvcc", build.CSRC / "reconstruct.cu", "x.o",
        build.SOURCE_FLAGS["reconstruct.cu"]) == build.candidate_command(
            "nvcc", "reconstruct.cu", launch.get("reconstruct", (9, 0)),
            "x.o")


def test_candidate_in_place_loads_without_compiling(tmp_path, monkeypatch):
    """A candidate library already built comes back with its ptxas
    report, no compile; a second call returns the same object."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_candidates", {})
    monkeypatch.setattr(build, "_nvcc", lambda: pytest.fail("compiled"))
    loaded = []

    class Fake:
        def __init__(self, src, entry, path, ptxas):
            self.src, self.entry, self.path, self.ptxas = (src, entry, path,
                                                          ptxas)
            loaded.append(self)

    monkeypatch.setattr(build, "Candidate", Fake)
    e = launch.FastSftLaunch(16, 3)
    path = build.candidate_library("fast_sft.cu", e)
    path.write_bytes(b"")
    path.with_suffix(".ptxas.json").write_text(
        json.dumps("ptxas info    : Used 40 registers"))
    got = build.build_candidates([("fast_sft.cu", e)])
    cand = got[("fast_sft.cu", e)]
    assert cand.ptxas == "ptxas info    : Used 40 registers"
    assert build.candidate("fast_sft.cu", e) is cand and len(loaded) == 1
    assert build.registers(cand.ptxas) == [40]


FAKE_NVCC = """#!/usr/bin/env python3
import sys
args = sys.argv[1:]
if "-DGM8_ENC_THREADS=96" in args:
    print("encode.cu(1): error: static assertion failed", file=sys.stderr)
    sys.exit(2)
if "-c" in args:
    print("ptxas info    : Used 40 registers, 0 bytes spill stores")
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
"""


def test_candidates_compile_in_parallel_and_fail_alone(tmp_path,
                                                       monkeypatch):
    """build_candidates compiles and links each candidate (here through a
    stand-in for nvcc), keeps its ptxas report beside the library, and
    returns a failed compile as an error whose first line is nvcc's first
    error line, without stopping the others."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_candidates", {})
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))

    class Fake:
        def __init__(self, src, entry, path, ptxas):
            assert path.read_text() == "built"
            self.ptxas = ptxas

    monkeypatch.setattr(build, "Candidate", Fake)
    good, bad = launch.EncodeLaunch(128, 16), launch.EncodeLaunch(96, 8)
    got = build.build_candidates([("encode.cu", good), ("encode.cu", bad)])
    assert build.registers(got[("encode.cu", good)].ptxas) == [40]
    path = build.candidate_library("encode.cu", good)
    assert json.loads(path.with_suffix(".ptxas.json").read_text()) == \
        got[("encode.cu", good)].ptxas
    err = got[("encode.cu", bad)]
    assert isinstance(err, RuntimeError)
    assert str(err).splitlines()[0] == (
        "encode.cu(1): error: static assertion failed")
    assert not build.candidate_library("encode.cu", bad).exists()
    with pytest.raises(RuntimeError, match="static assertion"):
        build.candidate("encode.cu", bad)


def test_candidate_entry_must_be_its_sources_type():
    with pytest.raises(TypeError):
        build.build_candidates([("encode.cu", launch.FastSftLaunch(16, 3))])
    with pytest.raises(KeyError):
        build.build_candidates([("crt.cuh", launch.EncodeLaunch(128, 8))])


def test_lib_for_the_table_entry_is_the_table_library(monkeypatch):
    monkeypatch.setattr(build, "lib", lambda: "the table library")
    assert build.lib_for("encode.cu") == "the table library"
    assert build.lib_for("encode.cu", None) == "the table library"


@pytest.mark.parametrize("src", sorted(build.LAUNCH_SOURCES))
def test_a_candidate_binds_its_sources_entry_points(src):
    """The entry points a candidate binds are those its source defines,
    each with the table library's signature."""
    names = build.exports(src)
    assert names and set(names) <= set(build._SIGNATURES)
    text = (build.CSRC / src).read_text()
    assert len(names) == text.count("GM8_EXPORT")


def test_crt_tables_are_set_once_per_library(monkeypatch):
    """Each library has its own __constant__ CRT table: a candidate's is
    set even after the table library's was, and each only once."""
    monkeypatch.setattr(hk, "_tables_on", set())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullDevice())

    class Lib:
        def __init__(self):
            self.sets = 0

        def gm8_set_crt_tables(self, ptr, nbytes):
            assert nbytes == len(hk.crt_table_bytes())
            self.sets += 1
            return 0

    table, cand = Lib(), Lib()
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for lib in (table, cand, table, cand):
        hk._ensure_crt_tables(lib, dev0)
    assert (table.sets, cand.sets) == (1, 1)
    hk._ensure_crt_tables(cand, dev1)
    assert cand.sets == 2
    assert hk._tables_on == {(table, 0), (cand, 0), (cand, 1)}


class _NullDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# ---- launch= on the CPU -----------------------------------------------------

def _x():
    return torch.ones((4, 8), dtype=torch.float64)


CPU_CALLS = {
    "fast_sft": lambda e: hk.fast_sft(_x(), 4, 1, launch=e),
    "fast_stats": lambda e: hk.fast_stats(_x(), 0, launch=e),
    "emax": lambda e: hk.emax(_x(), 1, launch=e),
    "mag7": lambda e: hk.mag7(_x(), hk.emax(_x(), 1), 1, launch=e),
    "mag7_fused": lambda e: hk.mag7_fused(_x(), 0, launch=e),
    "encode_slices": lambda e: hk.encode_slices(
        _x(), hk.fast_sft(_x(), 4, 1), 4, 1, launch=e),
    "fast_encode_fused": lambda e: hk.fast_encode_fused(_x(), 4, 1,
                                                        launch=e),
    "reconstruct": lambda e: hk.reconstruct(
        torch.zeros((4, 4, 8), dtype=torch.uint8),
        torch.zeros((4, 1), dtype=torch.int32),
        torch.zeros((1, 8), dtype=torch.int32), 4, launch=e),
    "matmul_mod_u8": lambda e: hm.matmul_mod_u8(
        torch.ones((2, 4, 16), dtype=torch.int8),
        torch.ones((2, 16, 8), dtype=torch.int8), 2, launch=e),
    "matmul_mod_u8_pipelined": lambda e: hm.matmul_mod_u8_pipelined(
        torch.ones((2, 4, 16), dtype=torch.int8),
        torch.ones((2, 16, 8), dtype=torch.int8), 2, launch=e),
    "magmax_matmul": lambda e: hm.magmax_matmul(
        torch.ones((4, 16), dtype=torch.int8),
        torch.ones((16, 8), dtype=torch.int8), launch=e),
    "magmax_matmul_scratch": lambda e: hm.magmax_matmul_scratch(
        torch.ones((4, 16), dtype=torch.int8),
        torch.ones((16, 8), dtype=torch.int8), launch=e),
}
ENTRY_OF = {"fast_sft": "fast_sft", "fast_stats": "fast_sft",
            "emax": "mag7", "mag7": "mag7", "mag7_fused": "mag7",
            "encode_slices": "encode",
            "fast_encode_fused": "fast_encode_fused",
            "reconstruct": "reconstruct", "matmul_mod_u8": "matmul_mod",
            "matmul_mod_u8_pipelined": "matmul_mod_pipelined",
            "magmax_matmul": "magmax", "magmax_matmul_scratch": "magmax"}


@pytest.mark.parametrize("name", sorted(CPU_CALLS))
def test_launch_on_a_cpu_tensor_raises(name, monkeypatch):
    """The plain version takes no launch entry: given one, a CPU call
    raises ValueError; without one it runs the plain version."""
    monkeypatch.delenv("GEMMUL8_MM_PIPELINE", raising=False)
    monkeypatch.delenv("GEMMUL8_MAGMAX_SCRATCH", raising=False)
    entry = launch.get(ENTRY_OF[name], (9, 0))
    with pytest.raises(ValueError, match="launch"):
        CPU_CALLS[name](entry)
    CPU_CALLS[name](None)


def test_a_launch_entry_names_matmul_mods_kernel(monkeypatch):
    """Under GEMMUL8_MM_PIPELINE=1 an uncentered call given a launch entry
    stays matmul_mod_u8's (the entry is its source's); without one it
    takes the pipelined variant."""
    monkeypatch.setenv("GEMMUL8_MM_PIPELINE", "1")
    seen = []
    monkeypatch.setattr(hm, "matmul_mod_u8_pipelined",
                        lambda *a, **k: seen.append("pipelined"))
    a8 = torch.ones((2, 4, 16), dtype=torch.int8)
    b8 = torch.ones((2, 16, 8), dtype=torch.int8)
    hm.matmul_mod_u8(a8, b8, 2)
    assert seen == ["pipelined"]
    with pytest.raises(ValueError, match="launch"):
        hm.matmul_mod_u8(a8, b8, 2, launch=launch.get("matmul_mod", (9, 0)))
    assert seen == ["pipelined"]


# ---- the tuners -------------------------------------------------------------

def _jax_defaults(script: str) -> list:
    text = (ROOT / "scripts" / script).read_text()
    return re.findall(r"sys\.argv\[(\d)\]\) if len\(sys\.argv\) > \d else "
                      r"(\w+)|sys\.argv\[(\d)\] if len\(sys\.argv\) > \d "
                      r"else \"(\w+)\"", text)


def test_argv_defaults_are_the_jax_scripts():
    jk = _jax_defaults("tune_kernels.py")
    assert [(i, v) for i, v, _, _ in jk if i] == [("1", "8192"), ("2", "14")]
    assert [(i, v) for _, _, i, v in jk if i] == [("3", "all")]
    jm = _jax_defaults("tune_matmul.py")
    assert [(i, v) for i, v, _, _ in jm] == [("1", "8192"), ("2", "14")]
    assert tk.parse([]) == (8192, 14, "all")
    assert tk.parse(["1024", "8", "recon"]) == (1024, 8, "recon")
    with pytest.raises(SystemExit):
        tk.parse(["1024", "8", "vpu"])


@pytest.mark.parametrize("main", [tk.main, tm.main],
                         ids=["tune_kernels", "tune_matmul"])
def test_tuners_exit_nonzero_without_a_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["64", "2"])
    assert exc.value.code not in (0, None)


def test_differing_words_counts_bits():
    x = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float64)
    y = torch.tensor([-0.0, 1.0, 3.0], dtype=torch.float64)
    assert tk.differing_words(x, x.clone()) == 0
    assert tk.differing_words(x, y) == 2      # -0.0 is another word
    i8 = torch.arange(6, dtype=torch.int8).reshape(2, 3)
    assert tk.differing_words((i8, x), (i8.t().contiguous().t(), x)) == 0
    assert tk.differing_words((i8.t(), x), (i8.t() + 1, y)) == 6 + 2
    flags = torch.tensor([True, False])
    assert tk.differing_words(flags, ~flags) == 2
    assert tk.differing_words(x, x[:2]) == 3


def test_rows_and_the_runs_verdict():
    e = launch.EncodeLaunch(128, 16)
    ok = tk.Row("encode_slices", e, False, ms=1.0, rounds=[1.0, 1.1],
                ratio=0.9, bound_ms=0.5, bound_by="bytes",
                registers=[40, 56], clock="SM clock median 1980 MHz")
    line = tk.format_row("encode", ok)
    assert "1.000 ms" in line and "share 0.500" in line and "1675 GB/s" in line
    assert "ratio 0.900" in line and "40-56 registers" in line
    assert "0 spill bytes" in line and "1980 MHz" in line
    bad = tk.Row("encode_slices", e, False, differing=7)
    assert "FAIL 7 words differ" in tk.format_row("encode", bad)
    err = tk.Row("encode_slices", e, False, error="RuntimeError: nvcc")
    assert "FAIL RuntimeError: nvcc" in tk.format_row("encode", err)
    table = tk.Row("encode_slices", launch.get("encode", (9, 0)), True,
                   ms=2.0, rounds=[1.9, 2.0, 2.1], ratio=1.0, bound_ms=1.0,
                   bound_by="operations")
    assert "TOPS" in tk.format_row("encode", table)
    assert "rounds spread 0.100" in tk.format_row("encode", table)
    assert not tk.failed([ok, err])       # a candidate that did not build
    assert tk.failed([ok, bad])           # bits that differ
    assert tk.failed([tk.Row("x", e, True, error="boom")])
