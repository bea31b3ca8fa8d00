"""Wrappers of the panel pipeline's Hopper kernels, beside their plain
versions.

    matmul_rider_step   csrc/matmul_rider.cu (gm8_matmul_rider_step)
        <- pallas/pipelined.py matmul_rider_step
    matmul_bsplit_pair  csrc/matmul_rider.cu (gm8_matmul_bsplit_pair,
                        two launches) <- pallas/pipelined.py matmul_bsplit_pair
    reconstruct_into    csrc/reconstruct.cu on the last panel, into its rows
                        of the output <- pallas/pipelined.py _reconstruct_into

Each takes the JAX function's word kinds: an encode rider's source f64 or
f32 (`a_kind`, `b_kind`; each with its own left-shift cap), the output f64
or f32 (`out_kind`, `kind`). A CPU tensor takes the plain version
(`gemmul8_tpu_torch.core.riders`); a CUDA tensor launches the kernel.
`build.LAUNCHES` counts each kernel launch under the wrapper's name and its
words (`build.form`; the pair adds two). The panel GEMMs read B
K-major, (L, n, k); k must be a multiple of 16 (the pipeline's gates ask
128), so A's slices need no padding. The kernel's GEMM is matmul_mod.cu's
wgmma tile, whose tensor maps want A's slices and the K-major B 16-byte
aligned and k >= 16; a CUDA call that breaks one of its limits raises
(`_check_kernel_args`), it never falls back. The riders' tables
(`rider_tables`) go to the library once per process.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .. import tables, trace
from ..core import encode as enc
from ..core import riders
from . import build
from . import kernels as hk

matmul_rider_step_plain = riders.matmul_rider_step
matmul_bsplit_pair_plain = riders.matmul_bsplit_pair
reconstruct_into_plain = riders.reconstruct_into


def _check_slices(a8, bt, num_moduli: int, panel_m: int):
    """(L, k, n) of a panel GEMM's operands: a8 (L, rows, k), a multiple of
    panel_m rows; bt (L, n, k) K-major."""
    if a8.dtype != torch.int8 or bt.dtype != torch.int8:
        raise TypeError("slices must be int8")
    if a8.dim() != 3 or bt.dim() != 3:
        raise ValueError("slices must be (L, rows, k) and (L, n, k)")
    L, rows, k = a8.shape
    if L != num_moduli or bt.shape[0] != L or bt.shape[2] != k:
        raise ValueError(f"expected ({num_moduli}, rows, k) and "
                         f"({num_moduli}, n, k) slices")
    if k % 16 or panel_m < 1 or rows % panel_m:
        raise ValueError(f"k={k} must be a multiple of 16 and the rows "
                         f"{rows} of panel_m={panel_m}")
    return L, k, bt.shape[1]


def _check_shifts(sft_a, sft_b, m: int, n: int):
    if sft_a.dim() != 2 or sft_a.shape[1] != 1 or sft_a.shape[0] < m \
            or tuple(sft_b.shape) != (1, n):
        raise ValueError("shifts must be (m, 1) and (1, n)")


def _check_kernel_args(k: int, n: int, pair: bool, **slices) -> None:
    """The rider kernel's own limits on a CUDA call, each a ValueError:
    each named tensor's start 16-byte aligned (its tensor maps), k >= 16
    (k % 16 is checked for every call), and the GEMM's column window not
    empty: [0, n) for the step, both halves [0, n/2) and [n/2, n) for the
    pair."""
    for name, x in slices.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned for the "
                             "kernel's tensor maps")
    if k < 16:
        raise ValueError(f"k={k}: the kernel takes k >= 16")
    if n < (2 if pair else 1):
        raise ValueError(f"n={n}: the GEMM's column window is empty")


@functools.lru_cache(maxsize=None)
def rider_tables() -> np.ndarray:
    """The riders' tables as csrc/matmul_rider.cu's gm8_set_rider_tables
    takes them (bytes on the host): the EncMmaTable of moduli 0..19
    (`hk.encode_mma_table`; slot l for modulus l, so one table serves every
    moduli count), then the CrtMmaTable of each moduli count 0..20
    (`hk.crt_mma_table`; zeros below 2)."""
    crt = [np.zeros_like(hk.crt_mma_table(2))] * 2 + [
        hk.crt_mma_table(L) for L in range(2, tables.MAX_MODULI + 1)]
    return np.concatenate(
        [hk.encode_mma_table(tuple(range(tables.MAX_MODULI)))] + crt)


_tables_lock = threading.Lock()
_tables_set = False


def _ensure_rider_tables() -> None:
    """Hands the library the riders' tables, once per process (host
    memory: every device's launches read them)."""
    global _tables_set
    with _tables_lock:
        if not _tables_set:
            blob = rider_tables()
            build.check(build.lib().gm8_set_rider_tables(
                blob.ctypes.data, blob.nbytes), "set_rider_tables")
            _tables_set = True


def _new(shape, dtype, like):
    return torch.empty(shape, dtype=dtype, device=like.device)


def _q_max(num_moduli: int, src) -> int:
    """The encode's left-shift cap for a rider source's word (0 for a rider
    that is off)."""
    return 0 if src is None else enc.q_max(num_moduli,
                                           enc.mant_bits_of(src))


@trace.traced("gm8.hopper.matmul_rider_step")
def matmul_rider_step(a8, bt, panel: int, r_prev, prev_panel: int, sft_a,
                      sft_b, num_moduli: int, panel_m: int, *, b8=None,
                      a_src=None, next_panel: int = -1, out=None,
                      a_kind: str = "f64", out_kind: str = "f64"):
    """One pipeline stage, `riders.matmul_rider_step`'s function: the
    (L, panel_m, n) uint8 residues of A-panel `panel` with, as riders, the
    reconstruct of panel `prev_panel` from r_prev (into rows of out when
    given) in out_kind's word and the encode of A-panel `next_panel` from
    a_src, whose word a_kind names ("f64" or "f32"). Launches the kernel's
    (a_kind, out_kind) instance, counted under `build.form(name, a_kind ==
    "f32", out_kind == "f32")`. Returns (res, rec_rows or None, a8_next or
    None)."""
    L, k, n = _check_slices(a8, bt, num_moduli, panel_m)
    m = sft_a.shape[0]
    _check_shifts(sft_a, sft_b, m, n)
    riders.check_kind(a_src, a_kind, "a_src")
    riders.check_kind(out, out_kind, "out")
    a_row0 = 0 if a8.shape[1] == panel_m else panel * panel_m
    if not 0 <= a_row0 <= a8.shape[1] - panel_m:
        raise ValueError(f"panel {panel} out of range")
    if b8 is not None and tuple(b8.shape) != (L, k, n):
        raise ValueError(f"b8 must be ({L}, {k}, {n})")
    if r_prev is not None:
        if tuple(r_prev.shape) != (L, panel_m, n) or r_prev.dtype != \
                torch.uint8:
            raise ValueError(f"r_prev must be ({L}, {panel_m}, {n}) uint8")
        if not 0 <= prev_panel < m // panel_m:
            raise ValueError(f"prev_panel {prev_panel} out of range")
    if a_src is not None:
        if a_src.dim() != 2 or a_src.shape[1] != k:
            raise ValueError(f"a_src must be (m, {k})")
        if not 0 <= next_panel < min(a_src.shape[0], m) // panel_m:
            raise ValueError(f"next_panel {next_panel} out of range")
    if out is not None and tuple(out.shape) != (m, n):
        raise ValueError(f"out must be ({m}, {n})")
    operands = [a8, bt, sft_a, sft_b] + [
        x for x in (b8, r_prev, a_src, out) if x is not None]
    if all(x.device.type == "cpu" for x in operands):
        return matmul_rider_step_plain(
            a8, bt, panel, r_prev, prev_panel, sft_a, sft_b, num_moduli,
            panel_m, b8=b8, a_src=a_src, next_panel=next_panel, out=out,
            a_kind=a_kind, out_kind=out_kind)
    if sft_a.dtype != torch.int32 or sft_b.dtype != torch.int32:
        raise TypeError("shifts must be int32")
    build.require_cuda(*operands)
    _check_kernel_args(k, n, False, a8=a8, bt=bt)
    _ensure_rider_tables()
    res = _new((L, panel_m, n), torch.uint8, a8)
    made = [res]
    # the riders' pointers, null for a rider that is off
    rec = [None] * 4      # residues, row shifts, rows out, CRT table
    nxt = [None] * 3      # source rows, row shifts, slices out
    rec_rows = a8_next = None
    if r_prev is not None:
        if out is None:
            rec_rows = _new((panel_m, n), riders.KINDS[out_kind], a8)
            made.append(rec_rows)
        else:
            rec_rows = riders.panel_rows(out, prev_panel, panel_m)
        table = hk.crt_table_entry(L)   # alive until the call returns
        rec = [r_prev.data_ptr(),
               riders.panel_rows(sft_a, prev_panel, panel_m).data_ptr(),
               rec_rows.data_ptr(), table.ctypes.data]
    if a_src is not None:
        a8_next = _new((L, panel_m, k), torch.int8, a8)
        made.append(a8_next)
        nxt = [riders.panel_rows(a_src, next_panel, panel_m).data_ptr(),
               riders.panel_rows(sft_a, next_panel, panel_m).data_ptr(),
               a8_next.data_ptr()]
    a_f32, out_f32 = a_kind == "f32", out_kind == "f32"
    with torch.cuda.device(a8.device):
        code = build.lib().gm8_matmul_rider_step(
            a8.data_ptr(), None if b8 is None else b8.data_ptr(),
            bt.data_ptr(), res.data_ptr(), rec[0], rec[1], sft_b.data_ptr(),
            rec[2], *nxt, rec[3], a8.shape[1], a_row0, L, panel_m, n, k,
            _q_max(L, a_src), int(a_f32), int(out_f32),
            build.stream_ptr(a8.device))
    build.check(code, "matmul_rider_step")
    key = build.form("matmul_rider_step", a_f32, out_f32)
    build.launched(key, *made)
    if b8 is not None:
        build.copied_b(key)
    return res, rec_rows, a8_next


@trace.traced("gm8.hopper.matmul_bsplit_pair")
def matmul_bsplit_pair(a8_p0, b8_left, b_src, sft_a, sft_b, num_moduli: int,
                       panel_m: int, *, a_src=None, a_kind: str = "f64",
                       b_kind: str = "f64"):
    """Panel 0 as two launches over B's column halves,
    `riders.matmul_bsplit_pair`'s function: the left half's GEMM carries
    the encode of B's right half from b_src into the K-major B, the right
    half's the encode of A-panel 1 from a_src; a_kind and b_kind name the
    sources' words ("f64" or "f32"). Launches the kernel's (a_kind, b_kind)
    instance twice, counted under `build.form(name, a_kind == "f32", b_kind
    == "f32")`. Returns (res0 (L, panel_m, n) uint8, bt (L, n, k) int8
    K-major, a8_next or None)."""
    if b8_left.dtype != torch.int8 or b8_left.dim() != 3:
        raise ValueError("b8_left must be (L, k, n) int8")
    L, k, n = b8_left.shape
    _check_slices(a8_p0, b8_left.transpose(1, 2), num_moduli, panel_m)
    if a8_p0.shape[1] != panel_m or n % 2:
        raise ValueError(f"expected panel 0's ({L}, {panel_m}, {k}) slices "
                         "and an even n")
    riders.check_kind(b_src, b_kind, "b_src")
    riders.check_kind(a_src, a_kind, "a_src")
    if tuple(b_src.shape) != (k, n):
        raise ValueError(f"b_src must be ({k}, {n})")
    _check_shifts(sft_a, sft_b, 2 * panel_m if a_src is not None else
                  panel_m, n)
    if a_src is not None and (a_src.dim() != 2 or a_src.shape[1] != k
                              or a_src.shape[0] < 2 * panel_m):
        raise ValueError(f"a_src must be (m >= {2 * panel_m}, {k})")
    operands = [a8_p0, b8_left, b_src, sft_a, sft_b] + (
        [a_src] if a_src is not None else [])
    if all(x.device.type == "cpu" for x in operands):
        return matmul_bsplit_pair_plain(a8_p0, b8_left, b_src, sft_a, sft_b,
                                        num_moduli, panel_m, a_src=a_src,
                                        a_kind=a_kind, b_kind=b_kind)
    if sft_a.dtype != torch.int32 or sft_b.dtype != torch.int32:
        raise TypeError("shifts must be int32")
    build.require_cuda(*operands)
    _check_kernel_args(k, n, True, a8_p0=a8_p0)
    _ensure_rider_tables()
    res = _new((L, panel_m, n), torch.uint8, a8_p0)
    bt = _new((L, n, k), torch.int8, a8_p0)
    a8_next = None
    src = sft = None
    if a_src is not None:
        a8_next = _new((L, panel_m, k), torch.int8, a8_p0)
        src = riders.panel_rows(a_src, 1, panel_m).data_ptr()
        sft = riders.panel_rows(sft_a, 1, panel_m).data_ptr()
    a_f32, b_f32 = a_kind == "f32", b_kind == "f32"
    with torch.cuda.device(a8_p0.device):
        code = build.lib().gm8_matmul_bsplit_pair(
            a8_p0.data_ptr(), b8_left.data_ptr(), bt.data_ptr(),
            res.data_ptr(), b_src.data_ptr(), sft_b.data_ptr(), src, sft,
            None if a8_next is None else a8_next.data_ptr(), L, panel_m, n,
            k, _q_max(L, a_src), _q_max(L, b_src), int(a_f32), int(b_f32),
            build.stream_ptr(a8_p0.device))
    build.check(code, "matmul_bsplit_pair")
    made = (res, bt) if a8_next is None else (res, bt, a8_next)
    key = build.form("matmul_bsplit_pair", a_f32, b_f32)
    build.launched(key, *made, count=2)
    build.copied_b(key)   # B's left half
    return res, bt, a8_next


@trace.traced("gm8.hopper.reconstruct_into")
def reconstruct_into(r8, sft_a, sft_b, num_moduli: int, out,
                     last_panel: int, panel_m: int, kind: str = "f64"):
    """The last panel's reconstruct from (L, panel_m, n) residues, written
    into its rows of the (m, n) output `out`, float64 (kind "f64") or
    float32 ("f32"): the reconstruct kernel with `out=`, counted as
    reconstruct_into (reconstruct_into[f32] for f32 output); returns
    out."""
    m, n = out.shape
    if not 0 <= last_panel < m // panel_m:
        raise ValueError(f"last_panel {last_panel} out of range")
    _check_shifts(sft_a, sft_b, m, n)
    riders.check_kind(out, kind, "out")
    if r8.device.type == "cpu" and out.device.type == "cpu":
        return reconstruct_into_plain(r8, sft_a, sft_b, num_moduli, out,
                                      last_panel, panel_m, kind)
    hk.reconstruct_launch("reconstruct_into", r8,
                          riders.panel_rows(sft_a, last_panel, panel_m),
                          sft_b, num_moduli, kind,
                          out=riders.panel_rows(out, last_panel, panel_m))
    return out
