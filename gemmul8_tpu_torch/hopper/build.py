"""Lazy build and ctypes binding of the Hopper kernels.

Each `csrc/*.cu` file compiles with its own nvcc process, all started
together, and the objects link into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c <source>.cu      (one per source, in parallel)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared <objects>

`-fmad=false` keeps every f32 multiply and add a separate rounding, as in
the plain versions (the Barrett and quotient-estimate budgets assume it).
A source may take flags of its own (`SOURCE_FLAGS`): the eight sources on
the wgmma tile (matmul_mod.cu, matmul_rider.cu, matmul_mod_pipelined.cu,
matmul_complex.cu, matmul_reconstruct.cu, matmul_crt.cu, magmax.cu, and
probe_deaddep.cu on matmul_mod's entry) get the launch table's
constants of their entry (`-DGM8_MM_TILE_N=256 ...`, hopper/launch.py)
and `-Xptxas -v`, whose report is kept in `PTXAS_REPORT` (as are those
of encode.cu, reconstruct.cu, fast_sft.cu, fast_encode_fused.cu and
mag7.cu). The library
lands in `build/kernels/` under the checkout, named by a hash of the
sources and flags, so an edited source or launch entry never loads a
stale build; the ptxas report is saved beside it and read back with it.
Nothing runs at import: the first kernel launch builds and loads.

The C entry points act on the current CUDA device: a wrapper calls them
inside `torch.cuda.device(x.device)`, which restores the caller's device.
Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on a nonzero code. `LAUNCHES` counts kernel launches per wrapper;
a kernel's f32 form (f32 operand, or f32 output for reconstruct and
matmul_reconstruct) counts under its own key, the name with "[f32]"; the
pipeline's rider step and pair, which have two words each, count each
combination under its own key (`form`).
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

from . import launch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
ARCH_CAPABILITY = (9, 0)  # the compute capability ARCH_FLAGS builds for
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
              "-fPIC")

# launches of each kernel wrapper; reset by the caller that reads them
LAUNCHES: collections.Counter = collections.Counter()
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
SOURCE_FLAGS = {
    **{src: ("-Xptxas", "-v", *launch.get(entry, ARCH_CAPABILITY).defines())
       for src, entry in WGMMA_SOURCES.items()},
    "encode.cu": ("-Xptxas", "-v"),
    "reconstruct.cu": ("-Xptxas", "-v"),
    "fast_sft.cu": ("-Xptxas", "-v"),
    "fast_encode_fused.cu": ("-Xptxas", "-v"),
    "mag7.cu": ("-Xptxas", "-v")}
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
    # a8, b8, bt (workspace), out, moduli_idx (host), L, m, n, k, kp,
    # centered, stream
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
    # ar, ai, sa, br, bi, sb, bt (workspaces), out_re, out_im, L, m, n, k,
    # kp, centered, kara, stream
    "gm8_matmul_complex_mod": [_P] * 9 + [_I] * 7 + [_P],
    # x, out, sft, rows, kdim, axis, table (host), num_moduli, t_f, guard,
    # q_max, f32, sync (workspace), stream
    "gm8_fast_encode_fused": [_P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _I,
                              _I, _P, _P],
    # x, emax, out, rows, kdim, axis, ld, mag_shift, f32, stream
    "gm8_mag7_fused": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # a, lda, bt, ldb, row_part, col_part, m, n, k, stream
    "gm8_magmax_matmul_scratch": [_P, _I, _P, _I, _P, _P, _I, _I, _I, _P],
    # a8, b8, bt (workspace), out, moduli_idx (host), L, m, n, k, kp, stream
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


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the Hopper kernels cannot be "
                           "built (add the CUDA toolkit's bin/ to PATH)")
    return nvcc


def _library(srcs: list) -> Path:
    """Where the library of srcs under the current flags lands."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(s.name, ())).encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libgemmul8_kernels_{h.hexdigest()[:16]}.so"


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
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-I",
                   str(CSRC), "-c", str(src), "-o", obj]
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


def spill_bytes(src: str) -> list:
    """The spill store and spill load byte counts of every function of
    source `src` in its ptxas report (`-Xptxas -v`), in the report's
    order; KeyError when the source has no report."""
    return [int(x) for x in re.findall(r"(\d+) bytes spill",
                                       PTXAS_REPORT[src])]


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
            handle = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


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


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


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
