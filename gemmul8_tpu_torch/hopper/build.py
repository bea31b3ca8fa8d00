"""Lazy build and ctypes binding of the Hopper kernels.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c <source>.cu      (one per source, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared <objects>

`-fmad=false` keeps every f32 multiply and add a separate rounding, as in
the plain versions (the Barrett and quotient-estimate budgets assume it).
A source may take flags of its own (`SOURCE_FLAGS`): the thirteen sources
with a launch entry (`LAUNCH_SOURCES`: the eight on the wgmma tile,
matmul_mod.cu, matmul_rider.cu, matmul_mod_pipelined.cu,
matmul_complex.cu, matmul_reconstruct.cu, matmul_crt.cu, magmax.cu, and
probe_deaddep.cu on matmul_mod's entry; and fast_sft.cu, encode.cu,
reconstruct.cu, mag7.cu, fast_encode_fused.cu) get the launch table's
constants of their entry (`-DGM8_MM_TILE_N=256 ...`, hopper/launch.py)
and `-Xptxas -v`, whose report is kept in `PTXAS_REPORT`. The library
lands in `build/kernels/` under the checkout, named by a hash of the
sources and flags, so an edited source or launch entry never loads a
stale build; the ptxas report is saved beside it and read back with it.
Nothing runs at import: the first kernel launch builds and loads.

`lib()` is the one library the main path loads. A tuner builds one more
library per candidate entry (`candidate`, `build_candidates`: one
source, its defines, the same nvcc flags, compiled in parallel), which
binds only that source's entry points; a wrapper given `launch=` runs
its kernel from there (`lib_for`).

The C entry points act on the current CUDA device: a wrapper calls them
inside `torch.cuda.device(x.device)`, which restores the caller's device.
Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on a nonzero code. `LAUNCHES` counts C entry calls, one per call
under the wrapper's key (`launched`), not kernels. An entry given B's
slices N-major (L, k, n) also launches the copy of B into a K-major
workspace (`transpose_b_kernel`): matmul_mod_u8 and its pipelined form
(which read B in place when it comes K-major, `core.encode.KMajorSlices`,
as the main path's encode writes it), matmul_crt, matmul_reconstruct, a
rider step given B, the rider pair (one copy before its two GEMM
launches, which count two) and the deaddep probe; matmul_complex_mod one
copy per N-major B part (two, three for Karatsuba). `B_COPIES` counts
those copies by the wrapper's key (`copied_b`), apart from `LAUNCHES`, so
that 1 - copies / B operands is the share of B operands read in place.
A kernel's f32 form (f32 operand, or f32 output for reconstruct and
matmul_reconstruct) counts under its own key, the name with "[f32]"; the
pipeline's rider step and pair, which have two words each, count each
combination under its own key (`form`). While `trace.recording()` is on,
`launched` also puts the count and the bytes of the tensors the wrapper
made on the wrapper's span.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from .. import trace
from . import launch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
ARCH_CAPABILITY = (9, 0)  # the compute capability ARCH_FLAGS builds for
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")

# C entry calls, one count per call under the wrapper's key (`launched`);
# reset by the caller that reads them
LAUNCHES: collections.Counter = collections.Counter()
# copies of B into a K-major workspace (`transpose_b_kernel`), one count
# per copy under the wrapper's key (`copied_b`); reset by their reader
B_COPIES: collections.Counter = collections.Counter()
# flags of single sources: the sources on the wgmma tile take their
# launch constants from the launch table's entry of their name (source ->
# entry below); their ptxas reports, those of the two main-path kernels
# redesigned on the tensor cores and those of the statistics
# sources (`-Xptxas -v`: each kernel's registers, shared memory and
# spills) are kept by source name in PTXAS_REPORT, saved beside the
# library and read back with it
WGMMA_SOURCES = {"matmul_mod.cu": "matmul_mod",
                 "matmul_rider.cu": "matmul_rider",
                 "matmul_mod_pipelined.cu": "matmul_mod_pipelined",
                 "matmul_complex.cu": "matmul_complex",
                 "matmul_reconstruct.cu": "matmul_reconstruct",
                 "matmul_crt.cu": "matmul_crt",
                 "magmax.cu": "magmax",
                 "probe_deaddep.cu": "matmul_mod"}
LAUNCH_SOURCES = {**WGMMA_SOURCES,
                  "fast_sft.cu": "fast_sft",
                  "encode.cu": "encode",
                  "reconstruct.cu": "reconstruct",
                  "mag7.cu": "mag7",
                  "fast_encode_fused.cu": "fast_encode_fused"}


def launch_flags(entry) -> tuple:
    """The flags of a source built under launch entry `entry`."""
    return ("-Xptxas", "-v", *entry.defines())


SOURCE_FLAGS = {src: launch_flags(launch.get(entry, ARCH_CAPABILITY))
                for src, entry in LAUNCH_SOURCES.items()}
PTXAS_REPORT: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, out_sft, rows, kdim, axis, t_f, guard, f32, stream
    "gm8_fast_sft": [_P, _P, _I, _I, _I, _I, _F, _I, _P],
    # x, out_emax, out_nrm2, out_any, rows, kdim, axis, f32, stream
    "gm8_fast_stats": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, sft, out, d0, d1, axis, table (host), n_idx, q_max, c0, c1, f32,
    # stream
    "gm8_encode_slices": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I,
                          _P],
    # x, sft, out, k, n, kp, table (host), n_idx, q_max, f32, stream
    "gm8_encode_slices_kmajor": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I,
                                 _P],
    # a8, b8, bt (workspace, null for a K-major b8), out, moduli_idx
    # (host), L, m, n, k, kp, centered, stream
    "gm8_matmul_mod_u8": [_P] * 5 + [_I] * 6 + [_P],
    # moduli_idx (host), L, lo, hi, bad, stream
    "gm8_mod_div_check": [_P, _I, ctypes.c_longlong, ctypes.c_longlong, _P,
                          _P],
    # table (host), nbytes
    "gm8_set_crt_tables": [_P, _I],
    # r, kind, planes, sft_a, sft_b, out, mma_table (host), L, m, n,
    # e_extra, out_f32, stream
    "gm8_reconstruct": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, out_emax, rows, kdim, axis, f32, stream
    "gm8_emax": [_P, _P, _I, _I, _I, _I, _P],
    # x, emax, out, rows, kdim, axis, ld, mag_shift, f32, stream
    "gm8_mag7": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, lda, bt, ldb, row_max, col_max, m, n, k, stream
    "gm8_magmax_matmul": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    # ar, ai, sa, br, bi, sb, bt (workspaces, null for K-major parts),
    # out_re, out_im, L, m, n, k, kp, centered, kara, stream
    "gm8_matmul_complex_mod": [_P] * 9 + [_I] * 7 + [_P],
    # x, out, sft, rows, kdim, axis, table (host), num_moduli, t_f, guard,
    # q_max, f32, sync (workspace), stream
    "gm8_fast_encode_fused": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _I,
                              _I, _P, _P],
    # x, emax, out, rows, kdim, axis, ld, mag_shift, f32, stream
    "gm8_mag7_fused": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, lda, bt, ldb, row_part, col_part, m, n, k, stream
    "gm8_magmax_matmul_scratch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    # a8, b8, bt (workspace, null for a K-major b8), out, moduli_idx
    # (host), L, m, n, k, kp, stream
    "gm8_matmul_mod_u8_pipelined": [_P] * 5 + [_I] * 5 + [_P],
    # a8, b8, bt, scratch (workspaces), out, table (host), L, nl, m, n, k,
    # kp, nblocks, stream
    "gm8_matmul_crt": [_P] * 6 + [_I] * 7 + [_P],
    # a8, b8, bt, scratch (workspaces), sft_a, sft_b, out, table (host), L,
    # m, n, k, kp, nblocks, out_f32, stream
    "gm8_matmul_reconstruct": [_P] * 8 + [_I] * 7 + [_P],
    # a8, b8 (or null), bt, res, r_prev, r_sa, sb, r_out, a_src, a_sft,
    # a_out, table (host), a_rows, a_row0, L, pm, n, k, a_q_max, a_f32,
    # out_f32, stream
    "gm8_matmul_rider_step": [_P] * 12 + [_I] * 9 + [_P],
    # a8, b8, bt, res, b_src, b_sft, a_src, a_sft, a_out, L, pm, n, k,
    # a_q_max, b_q_max, a_f32, b_f32, stream
    "gm8_matmul_bsplit_pair": [_P] * 9 + [_I] * 8 + [_P],
    # blob (host), nbytes
    "gm8_set_rider_tables": [_P, _I],
    # the probes (hopper/probes.py). x, out, n, form, stream
    "gm8_probe_clz": [_P, _P, _I, _I, _P],
    # x, out, n, case, steps, stream
    "gm8_probe_vpu_ops": [_P, _P, _I, _I, _I, _P],
    # r, out, table (host), L, m, n, bm, variant, stream
    "gm8_probe_mxu_crt": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a8, b8, bt, out, rin, rout, aux, rec_out, crt_table (host),
    # mma_table (host), L, n, variant, reps, stamps, stream
    "gm8_probe_deaddep": [_P] * 10 + [_I] * 4 + [_P, _P],
}

_lock = threading.Lock()
_lib = None
_candidates: dict = {}   # (source, entry) -> Candidate


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def exports(src: str) -> list:
    """The C entry points that source `src` defines (`GM8_EXPORT`)."""
    return re.findall(r"GM8_EXPORT\s+int\s+(gm8_\w+)\s*\(",
                      (CSRC / src).read_text())


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the Hopper kernels cannot be "
                           "built (add the CUDA toolkit's bin/ to PATH)")
    return nvcc


def _library(srcs: list, flags: dict | None = None,
             stem: str = "gemmul8_kernels") -> Path:
    """Where the library of srcs under `flags` (source name -> its own
    flags; the current SOURCE_FLAGS by default) lands."""
    flags = SOURCE_FLAGS if flags is None else flags
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(" ".join(flags.get(s.name, ())).encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def compile_command(nvcc: str, src: Path, obj: str, flags: tuple) -> list:
    """The nvcc command that compiles one source into an object."""
    return [nvcc, *NVCC_FLAGS, *flags, "-I", str(CSRC), "-c", str(src),
            "-o", obj]


def _build() -> Path:
    srcs = sources()
    out = _library(srcs)
    report = out.with_suffix(".ptxas.json")
    if out.exists():
        PTXAS_REPORT.update(json.loads(report.read_text()))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs, procs = [], []
        for src in (s for s in srcs if s.suffix == ".cu"):
            obj = os.path.join(tmpdir, src.stem + ".o")
            cmd = compile_command(nvcc, src, obj,
                                  SOURCE_FLAGS.get(src.name, ()))
            objs.append(obj)
            procs.append((src.name, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # wait for every compile before raising, so none is left running
        errors, ptxas = [], {}
        for name, cmd, proc in procs:
            error, output = _wait(cmd, proc)
            if error:
                errors.append(error)
            elif "-v" in SOURCE_FLAGS.get(name, ()):
                ptxas[name] = output
        if errors:
            raise RuntimeError("\n".join(errors))
        lib_tmp = os.path.join(tmpdir, out.name)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, *objs]
        error, _ = _wait(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        if error:
            raise RuntimeError(error)
        # the report first: a library in place always has its report
        report_tmp = os.path.join(tmpdir, report.name)
        Path(report_tmp).write_text(json.dumps(ptxas))
        os.replace(report_tmp, report)
        os.replace(lib_tmp, out)
    PTXAS_REPORT.update(ptxas)
    return out


def spill_bytes(src: str, report: str | None = None) -> list:
    """The spill store and spill load byte counts of every function of
    source `src` in its ptxas report (`-Xptxas -v`; the table library's,
    or `report`), in the report's order; KeyError when the source has no
    report."""
    text = PTXAS_REPORT[src] if report is None else report
    return [int(x) for x in re.findall(r"(\d+) bytes spill", text)]


def registers(report: str) -> list:
    """The registers of every function in a ptxas report, in its order."""
    return [int(x) for x in re.findall(r"Used (\d+) registers", report)]


def _wait(cmd: list, proc: subprocess.Popen) -> tuple:
    """(error, output): ('', stdout + stderr) once proc has exited with 0,
    else its command and output as the error."""
    stdout, stderr = proc.communicate()
    if proc.returncode == 0:
        return "", stdout + stderr
    return (f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{stdout}\n{stderr}"), ""


def library_path() -> Path:
    """The built kernel library (built first if needed): what `cuobjdump
    -sass` reads to count a kernel's instructions."""
    with _lock:
        return _build()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(_build())), _SIGNATURES)
        return _lib


class Candidate:
    """The library of one source built under a candidate launch entry:
    its path, its ptxas report and the loaded handle, which binds only
    the source's entry points."""

    def __init__(self, src: str, entry, path: Path, ptxas: str):
        self.src, self.entry, self.path, self.ptxas = src, entry, path, ptxas
        self.lib = _bind(ctypes.CDLL(str(path)), exports(src))


def _bind(handle: ctypes.CDLL, names) -> ctypes.CDLL:
    for name in names:
        fn = getattr(handle, name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def _check_candidate(src: str, entry) -> None:
    name = LAUNCH_SOURCES.get(src)
    if name is None:
        raise KeyError(f"{src} has no launch entry")
    table = launch.get(name, ARCH_CAPABILITY)
    if type(entry) is not type(table):
        raise TypeError(f"{src} takes a {type(table).__name__}, not "
                        f"{entry!r}")


def candidate_library(src: str, entry) -> Path:
    """Where source `src`'s library under launch entry `entry` lands: a
    name hashed from the headers, the source and its flags, beside the
    table library in BUILD_DIR."""
    srcs = [s for s in sources() if s.suffix == ".cuh" or s.name == src]
    return _library(srcs, {src: launch_flags(entry)},
                    stem=f"gemmul8_{Path(src).stem}")


def candidate_command(nvcc: str, src: str, entry, obj: str) -> list:
    """The nvcc command of source `src`'s candidate under `entry`: that
    source alone, the table library's flags and the entry's defines."""
    return compile_command(nvcc, CSRC / src, obj, launch_flags(entry))


def build_candidates(pairs) -> dict:
    """Build the library of each (source, entry) in pairs (cached ones are
    loaded, the rest compiled in parallel and linked), each from that
    source alone with `launch_flags(entry)` and the table library's nvcc
    flags. Returns (source, entry) -> `Candidate`, or the RuntimeError of
    one that failed to compile, link or load (its first line says what),
    so a sweep goes on past it."""
    pairs = list(dict.fromkeys(pairs))
    for src, entry in pairs:
        _check_candidate(src, entry)
    out = {}
    with _lock:
        todo = []
        for pair in pairs:
            if pair in _candidates:
                out[pair] = _candidates[pair]
                continue
            path = candidate_library(*pair)
            report = path.with_suffix(".ptxas.json")
            if path.exists() and report.exists():
                out[pair] = _load_candidate(pair, path,
                                            json.loads(report.read_text()))
            else:
                todo.append((pair, path))
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
                out.update(_compile_candidates(nvcc, todo, tmpdir))
    return {pair: out[pair] for pair in pairs}


def _load_candidate(pair, path: Path, ptxas: str):
    try:
        cand = Candidate(*pair, path, ptxas)
    except OSError as exc:
        return RuntimeError(f"loading {path.name} failed: {exc}")
    _candidates[pair] = cand
    return cand


def _compile_candidates(nvcc: str, todo: list, tmpdir: str) -> dict:
    """Compile every (pair, path) of todo at once, then link each that
    compiled; (pair -> Candidate or RuntimeError)."""
    out, procs = {}, []
    for i, ((src, entry), path) in enumerate(todo):
        obj = os.path.join(tmpdir, f"{i}.o")
        cmd = candidate_command(nvcc, src, entry, obj)
        procs.append(((src, entry), path, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    links = []
    for pair, path, obj, cmd, proc in procs:
        error, ptxas = _wait(cmd, proc)
        if error:
            out[pair] = _candidate_error(error)
            continue
        lib_tmp = os.path.join(tmpdir, path.name)
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, obj]
        links.append((pair, path, lib_tmp, ptxas, link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    for pair, path, lib_tmp, ptxas, link, proc in links:
        error, _ = _wait(link, proc)
        if error:
            out[pair] = _candidate_error(error)
            continue
        report = path.with_suffix(".ptxas.json")
        report_tmp = lib_tmp + ".ptxas.json"
        Path(report_tmp).write_text(json.dumps(ptxas))
        os.replace(report_tmp, report)
        os.replace(lib_tmp, path)
        out[pair] = _load_candidate(pair, path, ptxas)
    return out


def _candidate_error(error: str) -> RuntimeError:
    """nvcc's failure with its first error line first."""
    lines = [line.strip() for line in error.splitlines()]
    first = next((line for line in lines if "error" in line.lower()),
                 lines[0])
    return RuntimeError(f"{first}\n{error}")


def candidate(src: str, entry) -> Candidate:
    """The library of source `src` under launch entry `entry`, built
    first if needed; raises RuntimeError if it does not build."""
    got = build_candidates([(src, entry)])[(src, entry)]
    if isinstance(got, Exception):
        raise got
    return got


def lib_for(src: str, entry=None) -> ctypes.CDLL:
    """The library a wrapper launches source `src`'s kernel from: the
    table library for entry None, else the candidate library of
    `entry`."""
    return lib() if entry is None else candidate(src, entry).lib


def form(name: str, *f32: bool) -> str:
    """The `LAUNCHES` key of a kernel's form, from whether each of its words
    is f32: the name alone when none is; "name[f32]" for a kernel with one
    word; for one with several (the rider step's A source and output, the
    pair's A and B sources) each word in order, e.g.
    "matmul_rider_step[f32,f64]"."""
    if not any(f32):
        return name
    if len(f32) == 1:
        return f"{name}[f32]"
    return f"{name}[{','.join('f32' if f else 'f64' for f in f32)}]"


def launched(key: str, *made: torch.Tensor, count: int = 1) -> None:
    """Count a wrapper's C entry call (`count` for an entry that launches
    a kernel several times) in `LAUNCHES` under `key`, and, while
    recording, on the wrapper's span with the device bytes of the tensors
    it made (outputs and workspaces)."""
    LAUNCHES[key] += count
    trace.count(count, made)


def copied_b(key: str, count: int = 1) -> None:
    """Count `count` copies of B into a K-major workspace, made by the C
    entry of the wrapper `key`, in `B_COPIES`."""
    B_COPIES[key] += count


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def card_unless(device):
    """`device`, or the current card when it is None: a numpy operand, or
    an entry point given no device, runs on the card unless the caller
    asks for the CPU. Raises RuntimeError when no card is present; nothing
    falls back to the CPU."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is present (torch.cuda.is_available() is false), "
            "and without device= this runs on the card: pass device=\"cpu\" "
            "to run the kernels' plain versions on the CPU")
    return "cuda"


def require_device(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{t.device} and {dev}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device."""
    require_device(*tensors)
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
