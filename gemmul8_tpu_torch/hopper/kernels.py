"""Wrappers of the non-matmul Hopper kernels, beside their plain versions.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its CUDA kernel for a CUDA tensor; it never moves data between devices and
never falls back. The plain versions (`*_plain`) are the functions of
`gemmul8_tpu_torch.core` the kernels are held to; those of encode_slices
and reconstruct take the kernels' route (`encode_slices_mxu`,
`reconstruct_mxu`: the byte-plane and CRT contractions as int64 and f64
products) and give the bits of `encode_slices` and `reconstruct`.

    fast_sft       csrc/fast_sft.cu     <- pallas/kernels.py fast_sft_pallas
    fast_stats     csrc/fast_sft.cu     <- the same, with return_stats=True
    emax           csrc/mag7.cu         <- pallas/kernels.py emax_pallas
    mag7           csrc/mag7.cu         <- pallas/kernels.py mag7_pallas
    mag7_fused     csrc/mag7.cu         <- pallas/kernels.py mag7_fused_pallas
                   (the operand read once: magnitudes below a running max,
                   rewritten below the final one; core.encode.
                   mag7_fused_chunked is that arithmetic's plain twin)
    encode_slices  csrc/encode.cu       <- pallas/kernels.py encode_slices_pallas
                   (its residue dots on the int8 tensor cores, encode_mma.cuh)
    fast_encode_fused  csrc/fast_encode_fused.cu
                   <- pallas/kernels.py fast_encode_fused_pallas
                   (fast_sft's statistics bodies, fast_stats.cuh, then
                   encode_slices' tensor-core body on the same rows, staged
                   in shared memory, or columns, read again)
    reconstruct    csrc/reconstruct.cu  <- pallas/kernels.py reconstruct_pallas
                   (the CRT sum on the int8 tensor cores, crt_mma.cuh; the
                   tail of crt_tail.cuh)

`encode_slices` takes a subset of the moduli (`moduli_idx`, the chunks of
the moduli-chunked schedule) and a range of columns (`col_tiles`, the panel
pipeline's B split); for a B operand it writes, with `k_major=True`, the
K-major layout the residue GEMMs read without a copy
(`core.encode.KMajorSlices`: its plain version is the N-major plain slices
transposed and zero-padded, `core.encode.k_major`). `reconstruct` takes,
besides int8 and uint8
residues, raw int32 slice products and the weighted CRT sum as 16-bit limbs
(`input_kind="limbs"`: what `hopper.matmul.matmul_crt` and the chunked
schedule's fold produce), and writes into a given output (`out=`, rows of
the panel pipeline's full-size output).

Every wrapper here takes a float64 or a float32 operand and launches that
dtype's form of its kernel; `reconstruct` writes float64 or float32
(`out_dtype`). An f32 form's launches count under its own key
(`build.form`: "encode_slices[f32]").

`mag7_operand` reads GEMMUL8_FUSED_MAG7 at call time, as the JAX package's
`mag7_operand_pallas` does: "1" takes mag7_fused, anything else the emax +
mag7 pair.

The kernel wrappers take `launch=`, the counterpart of the JAX functions'
`block=`: None runs the kernel of the launch table's entry (the library
`build.lib()` loads), an entry of the source's type (hopper/launch.py)
runs the kernel built under it (`build.candidate`), counted under the
same `LAUNCHES` key. Launch entries are the card's: a CPU tensor given
one raises ValueError, and the plain version never takes one.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import tables, trace
from ..core import encode as enc
from ..core import reconstruct as rec
from . import build

fast_sft_plain = enc.fast_sft
fast_stats_plain = enc.fast_stats
emax_plain = enc.emax
mag7_plain = enc.mag7
mag7_fused_plain = enc.mag7_fused
encode_slices_plain = enc.encode_slices_mxu
fast_encode_fused_plain = enc.fast_encode_fused
reconstruct_plain = rec.reconstruct_mxu


def _on_cpu(x: torch.Tensor, launch=None) -> bool:
    """Whether x lies on the CPU (its wrapper takes the plain version);
    raises ValueError for a CPU tensor given a launch entry, and for a
    device that is neither the CPU nor a CUDA card."""
    if x.device.type == "cpu":
        if launch is not None:
            raise ValueError(
                f"launch={launch!r} is a launch entry of the card's "
                "kernels: a CPU tensor takes the plain version, which has "
                "no launch shape")
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _is_f32(x: torch.Tensor) -> bool:
    """Whether x is a float32 operand (else float64); other dtypes and
    shapes raise TypeError."""
    return enc.mant_bits_of(x) == 24


def _rows_kdim(x: torch.Tensor, axis: int):
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    d0, d1 = x.shape
    return (d0, d1) if axis == 1 else (d1, d0)


@trace.traced("gm8.hopper.fast_sft")
def fast_sft(x: torch.Tensor, num_moduli: int, axis: int,
             launch=None) -> torch.Tensor:
    """Fast-mode shifts of a float64 or float32 operand: (m, 1) int32 for
    axis=1, (1, n) for axis=0."""
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    if _on_cpu(x, launch):
        return fast_sft_plain(x, num_moduli, axis)
    build.require_cuda(x)
    out = torch.empty((rows, 1) if axis == 1 else (1, rows),
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = build.lib_for("fast_sft.cu", launch).gm8_fast_sft(
            x.data_ptr(), out.data_ptr(), rows, kdim, axis,
            tables.threshold_fast(num_moduli), enc._norm_guard(kdim),
            int(f32), build.stream_ptr(x.device))
    build.check(code, "fast_sft")
    build.launched(build.form("fast_sft", f32), out)
    return out


@trace.traced("gm8.hopper.fast_stats")
def fast_stats(x: torch.Tensor, axis: int, launch=None):
    """Fast-mode statistics (emax int64, nrm2 f32, anyfinite bool) of a
    float64 or float32 operand, each (m, 1) for axis=1 or (1, n) for
    axis=0: what fast_sft takes its shift from, for the complex path to
    merge over Re and Im (the shift's bias is the operand's)."""
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    if _on_cpu(x, launch):
        return fast_stats_plain(x, axis)
    build.require_cuda(x)
    shape = (rows, 1) if axis == 1 else (1, rows)
    out = (torch.empty(shape, dtype=torch.int64, device=x.device),
           torch.empty(shape, dtype=torch.float32, device=x.device),
           torch.empty(shape, dtype=torch.bool, device=x.device))
    with torch.cuda.device(x.device):
        code = build.lib_for("fast_sft.cu", launch).gm8_fast_stats(
            x.data_ptr(), *(t.data_ptr() for t in out), rows, kdim, axis,
            int(f32), build.stream_ptr(x.device))
    build.check(code, "fast_stats")
    build.launched(build.form("fast_stats", f32), *out)
    return out


@trace.traced("gm8.hopper.emax")
def emax(x: torch.Tensor, axis: int, launch=None) -> torch.Tensor:
    """Max biased exponent over the nonzero elements of each row (axis=1,
    (m, 1)) or column (axis=0, (1, n)) of a float64 or float32 operand,
    int32."""
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    if _on_cpu(x, launch):
        return emax_plain(x, axis)
    build.require_cuda(x)
    # zero-filled: the column kernel folds its pieces with atomicMax
    out = torch.zeros((rows, 1) if axis == 1 else (1, rows),
                      dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        code = build.lib_for("mag7.cu", launch).gm8_emax(
            x.data_ptr(), out.data_ptr(), rows, kdim, axis, int(f32),
            build.stream_ptr(x.device))
    build.check(code, "emax")
    build.launched(build.form("emax", f32), out)
    return out


def _check_emax(x: torch.Tensor, emax: torch.Tensor, axis: int):
    rows, _ = _rows_kdim(x, axis)
    want = (rows, 1) if axis == 1 else (1, rows)
    if tuple(emax.shape) != want:
        raise ValueError(f"emax shape {tuple(emax.shape)}, expected {want}")


def _mag7_buffer(x: torch.Tensor, emax: torch.Tensor, axis: int,
                 mag_shift: int, launch=None) -> torch.Tensor:
    """The mag7 kernel's output: (rows, ld) int8, K-major for both axes,
    ld = k rounded up to 16, zeros in the padding."""
    if emax.dtype != torch.int32:
        raise TypeError("emax must be int32")
    build.require_cuda(x, emax)
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    ld = -(-kdim // 16) * 16
    out = torch.empty((rows, ld), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        code = build.lib_for("mag7.cu", launch).gm8_mag7(
            x.data_ptr(), emax.data_ptr(), out.data_ptr(), rows, kdim, axis,
            ld, mag_shift, int(f32), build.stream_ptr(x.device))
    build.check(code, "mag7")
    build.launched(build.form("mag7", f32), out)
    return out


def _mag7_view(buf: torch.Tensor, kdim: int, axis: int) -> torch.Tensor:
    """x's shape over a `_mag7_buffer`: for axis=0 the transposed view."""
    mag = buf[:, :kdim]
    return mag if axis == 1 else mag.t()


@trace.traced("gm8.hopper.mag7")
def mag7(x: torch.Tensor, emax: torch.Tensor, axis: int,
         mag_shift: int = enc.MAG_SHIFT, launch=None) -> torch.Tensor:
    """Round-up magnitudes (int8 of x's shape, in [0, 2^(mag_shift + 1)])
    of a float64 or float32 operand below the row (axis=1) or column
    (axis=0) max exponents `emax`.

    On the card the values sit K-major in a buffer whose rows are padded
    to a multiple of 16 bytes: for axis=0 the result is the transposed
    view of an (n, k) buffer. That is the layout `magmax_matmul` reads
    without a copy; the values are those of the plain version."""
    _is_f32(x)
    _check_emax(x, emax, axis)
    if _on_cpu(x, launch):
        return mag7_plain(x, emax, axis, mag_shift)
    return _mag7_view(_mag7_buffer(x, emax, axis, mag_shift, launch),
                      x.shape[axis], axis)


@trace.traced("gm8.hopper.mag7_fused")
def mag7_fused(x: torch.Tensor, axis: int, mag_shift: int = enc.MAG_SHIFT,
               launch=None):
    """(magnitudes, emax) of a float64 or float32 operand in one kernel:
    the values of `emax` and `mag7`, the magnitudes in the same padded
    K-major buffer `mag7` writes on the card."""
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    if _on_cpu(x, launch):
        return mag7_fused_plain(x, axis, mag_shift)
    build.require_cuda(x)
    ld = -(-kdim // 16) * 16
    buf = torch.empty((rows, ld), dtype=torch.int8, device=x.device)
    e = torch.empty((rows, 1) if axis == 1 else (1, rows), dtype=torch.int32,
                    device=x.device)
    with torch.cuda.device(x.device):
        code = build.lib_for("mag7.cu", launch).gm8_mag7_fused(
            x.data_ptr(), e.data_ptr(), buf.data_ptr(), rows, kdim, axis, ld,
            mag_shift, int(f32), build.stream_ptr(x.device))
    build.check(code, "mag7_fused")
    build.launched(build.form("mag7_fused", f32), buf, e)
    return _mag7_view(buf, kdim, axis), e


def mag7_operand(x: torch.Tensor, axis: int):
    """(magnitudes, emax) of one float64 or float32 operand: the emax
    kernel, then mag7; or mag7_fused under GEMMUL8_FUSED_MAG7=1."""
    if os.environ.get("GEMMUL8_FUSED_MAG7", "0") == "1":
        return mag7_fused(x, axis)
    e = emax(x, axis)
    return mag7(x, e, axis), e


@trace.traced("gm8.hopper.mag7_operand_complex")
def mag7_operand_complex(re: torch.Tensor, im: torch.Tensor, axis: int):
    """(magnitudes, emax) of a complex operand whose Re and Im parts are
    both float64 or both float32: emax of each part, their max, then |Re| +
    |Im| of the parts' magnitudes at MAG_SHIFT_COMPLEX (each <= 32, so the
    int8 sum <= 64). On the card the sum is taken in place on the padded
    K-major buffer, whatever the parts' word, so `magmax_matmul` still
    reads it without a copy. The counterpart of the JAX package's
    `_mag7_complex_pallas`."""
    if _is_f32(re) != _is_f32(im) or re.shape != im.shape:
        raise ValueError("Re and Im must have one shape and one dtype")
    e = torch.maximum(emax(re, axis), emax(im, axis))
    shift = enc.MAG_SHIFT_COMPLEX
    if _on_cpu(re):
        return mag7(re, e, axis, shift) + mag7(im, e, axis, shift), e
    buf = _mag7_buffer(re, e, axis, shift)
    buf += _mag7_buffer(im, e, axis, shift)
    return _mag7_view(buf, re.shape[axis], axis), e


def host_idx(idx) -> np.ndarray:
    """A moduli index list as the int32 array a C entry point reads on the
    host (pass `.ctypes.data`; keep the array alive over the call)."""
    return np.asarray(idx, dtype=np.int32)


ENC_SLOTS = 32  # kEncSlots of csrc/encode_mma.cuh


@functools.lru_cache(maxsize=None)
def encode_mma_table(moduli_idx: tuple) -> np.ndarray:
    """The `EncMmaTable` of csrc/encode_mma.cuh for the slots of moduli_idx
    (bytes on the host): each slot's 16 plane weights (int8; the last 5
    zero), mul = ceil(2^32 / m), h mul, off and m, from
    `core.encode.encode_mxu_weights`; zeros past the call's slots."""
    k = enc.encode_mxu_weights(moduli_idx)
    L = len(moduli_idx)
    w = np.zeros((ENC_SLOTS, 16), np.int8)
    w[:L, :enc.ENC_PLANES] = k["w"]
    cols = np.zeros((4, ENC_SLOTS), np.uint32)
    cols[0, :L] = k["mul"]
    cols[1, :L] = k["h"] * k["mul"]
    cols[2, :L] = k["off"]
    cols[3, :L] = k["m"]
    return np.concatenate([w.view(np.uint8).ravel(),
                           cols.view(np.uint8).ravel()])


@trace.traced("gm8.hopper.encode_slices")
def encode_slices(x: torch.Tensor, sft: torch.Tensor, num_moduli: int,
                  axis: int, moduli_idx=None, col_tiles=None,
                  launch=None, k_major: bool = False):
    """(L', *x.shape) int8 centered residues of trunc(x * 2^sft) of a
    float64 or float32 operand: slice l for modulus moduli_idx[l], any
    tuple of distinct indices below num_moduli (default: all of them in
    order). col_tiles (j0, j1): only x's columns [j0, j1) x
    enc.ENC_BLOCK[1] (clipped to its width) are written, the rest of the
    full-shape output is left as allocated. k_major (a B operand, axis=0,
    all its columns): the same residues as a `core.encode.KMajorSlices`,
    (L', n, kp) with zeros in [k, kp), from the K-major form of the
    kernel, counted under the same `LAUNCHES` key."""
    f32 = _is_f32(x)
    want = (x.shape[0], 1) if axis == 1 else (1, x.shape[1])
    if tuple(sft.shape) != want or axis not in (0, 1):
        raise ValueError(f"sft shape {tuple(sft.shape)}, expected {want}")
    if k_major and (axis != 0 or col_tiles is not None):
        raise ValueError("k_major takes a B operand (axis=0), all its "
                         "columns")
    idx = enc.check_moduli_idx(moduli_idx, num_moduli)
    d0, d1 = x.shape
    c0, c1 = (0, d1) if col_tiles is None else enc.col_range(col_tiles, d1)
    if _on_cpu(x, launch):
        out = encode_slices_plain(x, sft, num_moduli, axis, idx, col_tiles)
        return enc.k_major(out) if k_major else out
    if sft.dtype != torch.int32:
        raise TypeError("sft must be int32")
    build.require_cuda(x, sft)
    table = encode_mma_table(idx)
    q_max = enc.q_max(num_moduli, enc.mant_bits_of(x))
    lib = build.lib_for("encode.cu", launch)
    if k_major:
        kp = -(-d0 // 16) * 16
        out = torch.empty((len(idx), d1, kp), dtype=torch.int8,
                          device=x.device)
        with torch.cuda.device(x.device):
            code = lib.gm8_encode_slices_kmajor(
                x.data_ptr(), sft.data_ptr(), out.data_ptr(), d0, d1, kp,
                table.ctypes.data, len(idx), q_max, int(f32),
                build.stream_ptr(x.device))
    else:
        out = torch.empty((len(idx), d0, d1), dtype=torch.int8,
                          device=x.device)
        with torch.cuda.device(x.device):
            code = lib.gm8_encode_slices(
                x.data_ptr(), sft.data_ptr(), out.data_ptr(), d0, d1, axis,
                table.ctypes.data, len(idx), q_max, c0, c1, int(f32),
                build.stream_ptr(x.device))
    build.check(code, "encode_slices")
    build.launched(build.form("encode_slices", f32), out)
    return enc.KMajorSlices(out, d0) if k_major else out


@trace.traced("gm8.hopper.fast_encode_fused")
def fast_encode_fused(x: torch.Tensor, num_moduli: int, axis: int,
                      launch=None):
    """(slices (L, *x.shape) int8, sft int32) of a float64 or float32
    operand in one kernel: the shifts of `fast_sft` ((m, 1) for axis=1,
    (1, n) for axis=0) and the residues of `encode_slices` with them."""
    f32 = _is_f32(x)
    rows, kdim = _rows_kdim(x, axis)
    if _on_cpu(x, launch):
        return fast_encode_fused_plain(x, num_moduli, axis)
    build.require_cuda(x)
    out = torch.empty((num_moduli, *x.shape), dtype=torch.int8,
                      device=x.device)
    sft = torch.empty((rows, 1) if axis == 1 else (1, rows),
                      dtype=torch.int32, device=x.device)
    table = encode_mma_table(tuple(range(num_moduli)))
    # the column form's grid-wide barrier counts its blocks here
    sync = torch.zeros(1, dtype=torch.int32, device=x.device) \
        if axis == 0 else None
    with torch.cuda.device(x.device):
        code = build.lib_for("fast_encode_fused.cu",
                             launch).gm8_fast_encode_fused(
            x.data_ptr(), out.data_ptr(), sft.data_ptr(), rows, kdim, axis,
            table.ctypes.data, num_moduli, tables.threshold_fast(num_moduli),
            enc._norm_guard(kdim), enc.q_max(num_moduli, enc.mant_bits_of(x)),
            int(f32), None if sync is None else sync.data_ptr(),
            build.stream_ptr(x.device))
    build.check(code, "fast_encode_fused")
    made = (out, sft) if sync is None else (out, sft, sync)
    build.launched(build.form("fast_encode_fused", f32), *made)
    return out, sft


@functools.lru_cache(maxsize=None)
def crt_table_bytes() -> bytes:
    """The CRT constants (`CrtTable` in csrc/moduli.cuh), one entry per
    moduli count 0..20: the CRT weights, M and floor(M/2) + 1 as 32-bit
    words, and 1/M. The reconstruct kernel keeps the whole table in
    __constant__ memory; the CRT-fused GEMMs and the rider step take one
    entry by value."""
    dt = np.dtype([("w", "<u4", (tables.MAX_MODULI, 6)), ("m", "<u4", 6),
                   ("half1", "<u4", 6), ("rinv", "<f8"), ("pad", "<i4", 2)])
    tab = np.zeros(tables.MAX_MODULI + 1, dtype=dt)

    def words(v: int):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(6)]

    for L in range(2, tables.MAX_MODULI + 1):
        mm = tables.big_m(L)
        for j, w in enumerate(tables.crt_weights(L)):
            tab[L]["w"][j] = words(w)
        tab[L]["m"] = words(mm)
        tab[L]["half1"] = words(mm // 2 + 1)
        tab[L]["rinv"] = 1 / mm
    return tab.tobytes()


def crt_table_entry(num_moduli: int) -> np.ndarray:
    """The `CrtTable` of one moduli count, as bytes on the host."""
    blob = np.frombuffer(crt_table_bytes(), dtype=np.uint8)
    size = len(blob) // (tables.MAX_MODULI + 1)
    return blob[num_moduli * size:(num_moduli + 1) * size]


# CrtMmaTable of csrc/crt_mma.cuh: w[24][32] int8, cl[12], nd, pad[3]
CRT_DIGITS, CRT_K, CRT_LIMBS = 24, 32, 12


@functools.lru_cache(maxsize=None)
def crt_mma_table(num_moduli: int) -> np.ndarray:
    """The CRT contraction's constants as the kernels read them (bytes on
    the host): the compact table wc[d][j] of `core.reconstruct.
    crt_mxu_weights` zero-padded to 24 x 32, the limb corrections CL and
    nd."""
    wc, cl = rec.crt_mxu_weights(num_moduli)
    w = np.zeros((CRT_DIGITS, CRT_K), np.int8)
    w[:wc.shape[0], :wc.shape[1]] = wc
    tail = np.zeros(CRT_LIMBS + 4, np.int32)
    tail[:len(cl)] = cl
    tail[CRT_LIMBS] = wc.shape[0] - 1
    return np.concatenate([w.view(np.uint8).ravel(),
                           tail.view(np.uint8)])


# (library, device index) pairs whose __constant__ CRT table is set: each
# library (the table's, each candidate's) has its own constant memory
_tables_on = set()


def _ensure_crt_tables(lib, device: torch.device) -> None:
    """Copy the CRT constants into library `lib`'s __constant__ table on
    `device`, once per library and device."""
    if (lib, device.index) in _tables_on:
        return
    blob = crt_table_bytes()
    buf = np.frombuffer(blob, dtype=np.uint8)
    with torch.cuda.device(device):
        code = lib.gm8_set_crt_tables(buf.ctypes.data, len(blob))
    build.check(code, "set_crt_tables")
    _tables_on.add((lib, device.index))


# the reconstruct kernel's input kinds (csrc/reconstruct.cu)
_KIND_U8, _KIND_CENTERED, _KIND_PRODUCTS, _KIND_LIMBS = range(4)


@trace.traced("gm8.hopper.reconstruct")
def reconstruct(r: torch.Tensor, sft_a: torch.Tensor, sft_b: torch.Tensor,
                num_moduli: int, out_dtype: str = "f64", e_extra: int = 0,
                input_kind: str = "residues",
                out: torch.Tensor | None = None,
                launch=None) -> torch.Tensor:
    """Residues and shifts (m, 1), (1, n) -> the (m, n) result. r is
    (L, m, n): int8 holding r - 128, uint8, or int32 raw slice products
    (reduced mod m_j in the kernel); or, with input_kind="limbs", the
    weighted CRT sum itself as (num_limbs, m, n) int32 16-bit limbs,
    canonical or with each limb nonnegative and below 2^29 (what
    `hopper.matmul.matmul_crt` and the chunked schedule's fold give).
    out_dtype "f64" writes float64, "f32" float32 (the integer rounded
    once to 24 bits). out: a contiguous (m, n) tensor in the output's
    dtype (rows of a larger output) to write into and return, instead of a
    new one."""
    return reconstruct_launch("reconstruct", r, sft_a, sft_b, num_moduli,
                              out_dtype, e_extra, input_kind, out, launch)


def reconstruct_launch(name: str, r, sft_a, sft_b, num_moduli: int,
                       out_dtype: str = "f64", e_extra: int = 0,
                       input_kind: str = "residues", out=None, launch=None):
    """`reconstruct`, its launch counted under `name` (the panel
    pipeline's last reconstruct counts as its own kernel), or under its
    f32 form's key for f32 output."""
    if input_kind not in ("residues", "limbs"):
        raise ValueError(f"input_kind {input_kind!r}")
    if out_dtype not in ("f64", "f32"):
        raise ValueError(f"out_dtype {out_dtype!r}")
    f32 = out_dtype == "f32"
    limbs = input_kind == "limbs"
    planes = tables.num_limbs(num_moduli) if limbs else num_moduli
    if r.dim() != 3 or r.shape[0] != planes:
        raise ValueError(f"expected ({planes}, m, n) {input_kind}")
    _, m, n = r.shape
    if tuple(sft_a.shape) != (m, 1) or tuple(sft_b.shape) != (1, n):
        raise ValueError("shifts must be (m, 1) and (1, n)")
    dtype = torch.float32 if f32 else torch.float64
    if out is not None and (tuple(out.shape) != (m, n)
                            or out.device != r.device or out.dtype != dtype
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({m}, {n}) tensor on "
                         f"{r.device} in the output's dtype: float64 for f64 "
                         "output, float32 for f32")
    if _on_cpu(r, launch):
        c = reconstruct_plain(r, sft_a, sft_b, num_moduli, out_dtype,
                              e_extra, input_kind)
        return c if out is None else out.copy_(c)
    if limbs:
        if r.dtype != torch.int32:
            raise TypeError("limbs must be int32")
        kind = _KIND_LIMBS
    elif r.dtype in (torch.int8, torch.uint8, torch.int32):
        kind = {torch.uint8: _KIND_U8, torch.int8: _KIND_CENTERED,
                torch.int32: _KIND_PRODUCTS}[r.dtype]
    else:
        raise TypeError(f"residues must be int8, uint8 or int32, not "
                        f"{r.dtype}")
    if sft_a.dtype != torch.int32 or sft_b.dtype != torch.int32:
        raise TypeError("shifts must be int32")
    build.require_cuda(r, sft_a, sft_b)
    if not -(1 << 20) < e_extra < (1 << 20):
        raise ValueError("e_extra out of range")
    lib = build.lib_for("reconstruct.cu", launch)
    _ensure_crt_tables(lib, r.device)
    made = ()
    if out is None:
        out = torch.empty((m, n), dtype=dtype, device=r.device)
        made = (out,)
    with torch.cuda.device(r.device):
        code = lib.gm8_reconstruct(
            r.data_ptr(), kind, planes, sft_a.data_ptr(), sft_b.data_ptr(),
            out.data_ptr(), crt_mma_table(num_moduli).ctypes.data,
            num_moduli, m, n, e_extra, int(f32), build.stream_ptr(r.device))
    build.check(code, name)
    build.launched(build.form(name, f32), *made)
    return out
