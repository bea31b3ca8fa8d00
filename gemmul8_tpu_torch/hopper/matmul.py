"""Wrappers of the int8 tensor-core GEMM kernels, all on the wgmma tile of
csrc/wgmma_s8.cuh (each with its launch from hopper/launch.py).

    matmul_mod_u8       csrc/matmul_mod.cu
        <- pallas/matmul.py matmul_mod_u8_pallas
    matmul_mod_u8_pipelined  csrc/matmul_mod_pipelined.cu (the wgmma tile
                        in a ping-pong schedule)
        <- pallas/matmul.py matmul_mod_u8_pipelined
    magmax_matmul       csrc/magmax.cu (one slice, a row and column max
                        epilogue)
        <- pallas/matmul.py magmax_matmul_pallas
    magmax_matmul_scratch    csrc/magmax.cu (deferred fold)
        <- pallas/matmul.py magmax_matmul_scratch
    matmul_complex_mod  csrc/matmul_complex.cu (products chained)
        <- pallas/matmul.py matmul_complex_mod_pallas
    matmul_crt          csrc/matmul_crt.cu (each tile's CRT sum on the
                        tensor-core bodies after its products, stored as
                        canonical limbs)
        <- pallas/matmul.py matmul_crt_pallas
    matmul_reconstruct  csrc/matmul_reconstruct.cu (each tile's CRT on the
                        tensor-core bodies after its products)
        <- pallas/megakernel.py matmul_reconstruct_pallas

A CPU tensor takes the plain version (exact f64 products, then the mod or
the row/col max); a CUDA tensor launches the kernel. The GEMM kernels with
a mod first copy each B operand into a K-major workspace the wrapper
allocates; the magnitude GEMMs read both operands K-major in place where
their layout allows (as `hopper.kernels.mag7` writes them), through tensor
maps whose extent along k is k (`k_major_map`). The two CRT-fused GEMMs
also get a scratch of residues sized by the blocks in flight
(`reconstruct_scratch_shape`: one 128 x tile_n tile's for each block of
the persistent grid). `matmul_crt` has no switch, as in the JAX package:
it is called directly, and its limbs go to
`hopper.kernels.reconstruct(..., input_kind="limbs")`.

The wgmma epilogues divide by each slot's modulus with a multiplier and a
shift (`mod_divisor`, `mod_div`: the host arithmetic, exact for every
int32; with a bias, the residue of x - bias, for the complex kernel's Im
chain, which starts at `COMPLEX_IM_BIAS`); `mod_div_mismatches` holds the
card's division to its remainder. Each kernel is built with its launch
table entry for sm_90; its wrapper raises on any other card.

Two dispatchers read the JAX package's switches at call time:
`matmul_mod_u8` sends uncentered calls to `matmul_mod_u8_pipelined` under
GEMMUL8_MM_PIPELINE=1, and `magmax_matmul` goes to `magmax_matmul_scratch`
under GEMMUL8_MAGMAX_SCRATCH=1. Each variant gives the default's bits.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import torch
import torch.nn.functional as F

from .. import tables
from ..core import slicegemm as sg
from . import build
from . import kernels as hk
from . import launch

matmul_mod_u8_plain = sg.matmul_mod
matmul_mod_u8_pipelined_plain = functools.partial(sg.matmul_mod,
                                                  centered=False)
magmax_plain = sg.magmax
magmax_scratch_plain = sg.magmax
matmul_complex_mod_plain = sg.matmul_complex_mod
matmul_crt_plain = sg.matmul_crt
matmul_reconstruct_plain = sg.matmul_reconstruct

# csrc/matmul_complex.cu kImBias: the Im chain's accumulator starts here, so
# that IR + RI (up to 2^31 at k = 2^16) stays inside int32
COMPLEX_IM_BIAS = -(1 << 24)
_TILE_M = 128  # kBM of csrc/wgmma_s8.cuh: a wgmma tile's rows


def _pad_k(a8: torch.Tensor, kp: int) -> torch.Tensor:
    """(L, m, k) int8 as the GEMM tile reads A: k zero-padded to kp (exact:
    zero terms) and a 16-byte aligned start."""
    if kp != a8.shape[2]:
        return F.pad(a8, (0, kp - a8.shape[2]))
    return a8.clone() if a8.data_ptr() % 16 else a8


def matmul_mod_u8(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int,
                  centered: bool = False, moduli_idx=None) -> torch.Tensor:
    """(L', m, k) int8 x (L', k, n) int8 -> (L', m, n) residues, slice l
    mod MODULI[moduli_idx[l]] (any tuple of distinct indices below
    num_moduli; default: all of them in order): canonical uint8, or r - 128
    as int8 when centered. Uncentered calls take `matmul_mod_u8_pipelined`
    under GEMMUL8_MM_PIPELINE=1, as the JAX package's `matmul_mod_u8`
    dispatches (its k and VMEM limits are the TPU's; the port's kernel
    takes any k <= 2^17)."""
    if not centered and os.environ.get("GEMMUL8_MM_PIPELINE") == "1":
        return matmul_mod_u8_pipelined(a8, b8, num_moduli, moduli_idx)
    idx = sg._check_matmul_args(a8, b8, num_moduli, moduli_idx)
    if a8.device.type == "cpu" and b8.device.type == "cpu":
        return matmul_mod_u8_plain(a8, b8, num_moduli, centered, idx)
    build.require_cuda(a8, b8)
    # the kernel is built with the table's sm_90 entry; any other card raises
    launch.get("matmul_mod", torch.cuda.get_device_capability(a8.device))
    return _launch_mod("matmul_mod_u8", a8, b8, idx, centered, int(centered))


def matmul_mod_u8_pipelined(a8: torch.Tensor, b8: torch.Tensor,
                            num_moduli: int, moduli_idx=None) -> torch.Tensor:
    """(L', m, k) int8 x (L', k, n) int8 -> (L', m, n) canonical uint8
    residues, the bits of `matmul_mod_u8(..., centered=False)`, with each
    tile's mod run while the next tile's product is formed (the kernel's
    two consumer warpgroups take alternate tiles)."""
    idx = sg._check_matmul_args(a8, b8, num_moduli, moduli_idx)
    if a8.device.type == "cpu" and b8.device.type == "cpu":
        return matmul_mod_u8_pipelined_plain(a8, b8, num_moduli,
                                             moduli_idx=idx)
    build.require_cuda(a8, b8)
    launch.get("matmul_mod_pipelined",
               torch.cuda.get_device_capability(a8.device))
    return _launch_mod("matmul_mod_u8_pipelined", a8, b8, idx, False)


def mod_divisor(d: int, bias: int = 0) -> tuple:
    """(mul, sh, off) of csrc/moduli.cuh `mod_divisor`, the per-slot
    constants of the wgmma epilogues: Granlund and Montgomery's multiplier
    for dividing a uint32 by d (l = ceil(log2 d), mul = floor(2^32 (2^l -
    d) / d) + 1, sh = l - 1) and off = (-2^31 - bias) mod d, which turns
    the residue of x + 2^31 into that of the int32 x - bias."""
    if not 2 <= d <= 1 << 31:
        raise ValueError(f"divisor {d}: expected 2 <= d <= 2^31")
    l = (d - 1).bit_length()
    return (((1 << 32) * ((1 << l) - d)) // d + 1, l - 1,
            (-(1 << 31) - bias) % d)


def mod_div(x, d: int, bias: int = 0) -> np.ndarray:
    """Canonical residues mod d of int32 values x - bias, in numpy int64 by
    the arithmetic of csrc/moduli.cuh `mod_div`: u = x + 2^31, t =
    mulhi(mul, u) (the 64-bit product taken in 16-bit halves of u, so every
    step stays below 2^63), q = (t + ((u - t) >> 1)) >> sh = floor(u / d),
    then u - q d + off reduced once."""
    x = np.asarray(x, dtype=np.int64)
    if x.size and (x.min() < -(1 << 31) or x.max() >= 1 << 31):
        raise ValueError("mod_div takes int32 values")
    mul, sh, off = mod_divisor(d, bias)
    u = x + (1 << 31)
    t = (mul * (u >> 16) + ((mul * (u & 0xFFFF)) >> 16)) >> 16
    q = (t + ((u - t) >> 1)) >> sh
    r = u - q * d + off
    return np.where(r >= d, r - d, r)


def mod_div_mismatches(lo: int, hi: int, num_moduli: int = tables.MAX_MODULI,
                       moduli_idx=None, device=None) -> torch.Tensor:
    """(L,) int64: per modulus MODULI[moduli_idx[l]], the x in [lo, hi]
    (int32) whose residue by matmul_mod_u8's multiply-and-shift division
    differs from the remainder. On a CUDA device the card's `mod_div`
    against its `mod_canon` (csrc/matmul_mod.cu mod_div_check_kernel;
    all 2^32 int32 values of 20 moduli in 0.12 s on an H100); on the CPU
    (device="cpu") `mod_div` against numpy's remainder, for small ranges.
    With no device it runs on the current card (RuntimeError without
    one)."""
    idx = sg.check_moduli_idx(moduli_idx, num_moduli)
    if not -(1 << 31) <= lo <= hi < 1 << 31:
        raise ValueError(f"[{lo}, {hi}]: expected -2^31 <= lo <= hi < 2^31")
    device = torch.device(build.card_unless(device))
    if device.type == "cpu":
        x = np.arange(lo, hi + 1, dtype=np.int64)
        return torch.tensor([int((mod_div(x, tables.MODULI[j])
                                  != x % tables.MODULI[j]).sum())
                             for j in idx], dtype=torch.int64)
    bad = torch.zeros(len(idx), dtype=torch.int64, device=device)
    idx_host = hk.host_idx(idx)
    with torch.cuda.device(device):
        code = build.lib().gm8_mod_div_check(
            idx_host.ctypes.data, len(idx), lo, hi, bad.data_ptr(),
            build.stream_ptr(device))
    build.check(code, "mod_div_check")
    build.LAUNCHES["mod_div_check"] += 1
    return bad


def _k_workspace(a8: torch.Tensor, n: int):
    """(a8 as the GEMM tile reads it, kp, the (L, n, kp) workspace the
    kernel copies B into K-major): the kernel reads A in 16-byte chunks
    along k, so k is padded to a multiple of 16 with zeros (exact: zero
    terms) and A starts on a 16-byte boundary."""
    L, _, k = a8.shape
    kp = -(-k // 16) * 16
    return (_pad_k(a8, kp), kp,
            torch.empty((L, n, kp), dtype=torch.int8, device=a8.device))


def _launch_mod(name: str, a8: torch.Tensor, b8: torch.Tensor, idx: tuple,
                centered: bool, *flags) -> torch.Tensor:
    """Launch gm8_<name>, a batched GEMM with the mod in its epilogue, on
    CUDA slices of the moduli idx: B is copied into a K-major workspace by
    the kernel; flags go between kp and the stream."""
    build.require_cuda(a8, b8)
    L, m, k = a8.shape
    n = b8.shape[2]
    a8, kp, bt = _k_workspace(a8, n)
    out = torch.empty((L, m, n), dtype=torch.int8 if centered else torch.uint8,
                      device=a8.device)
    idx_host = hk.host_idx(idx)
    with torch.cuda.device(a8.device):
        code = getattr(build.lib(), f"gm8_{name}")(
            a8.data_ptr(), b8.data_ptr(), bt.data_ptr(), out.data_ptr(),
            idx_host.ctypes.data, L, m, n, k, kp, *flags,
            build.stream_ptr(a8.device))
    build.check(code, name)
    build.LAUNCHES[name] += 1
    return out


def reconstruct_scratch_shape(L: int, m: int, n: int, tile_n: int,
                              sms: int) -> tuple:
    """(nblocks, the scratch's shape) of `matmul_reconstruct` and
    `matmul_crt`: their persistent grid, one block per SM or one per 128 x
    tile_n tile if fewer, and each block's L residue planes of its
    tile."""
    tiles = -(-m // _TILE_M) * -(-n // tile_n)
    nblocks = min(tiles, sms)
    return nblocks, (nblocks, L, _TILE_M * tile_n)


def matmul_crt(a8: torch.Tensor, b8: torch.Tensor,
               num_moduli: int) -> torch.Tensor:
    """(L, m, k) int8 x (L, k, n) int8 -> (num_limbs, m, n) int32 canonical
    16-bit limbs of X = sum_l w_l * ((a8[l] @ b8[l]) mod m_l), the weighted
    CRT sum `reconstruct(..., input_kind="limbs")` finishes: the residues
    never leave the kernel."""
    sg._check_matmul_args(a8, b8, num_moduli)
    if a8.device.type == "cpu" and b8.device.type == "cpu":
        return matmul_crt_plain(a8, b8, num_moduli)
    build.require_cuda(a8, b8)
    # the kernel is built with the table's sm_90 entry; any other card raises
    cfg = launch.get("matmul_crt", torch.cuda.get_device_capability(a8.device))
    L, m, k = a8.shape
    n = b8.shape[2]
    nl = tables.num_limbs(L)
    a8, kp, bt = _k_workspace(a8, n)
    nblocks, shape = reconstruct_scratch_shape(
        L, m, n, cfg.tile_n,
        torch.cuda.get_device_properties(a8.device).multi_processor_count)
    scratch = torch.empty(shape, dtype=torch.uint8, device=a8.device)
    out = torch.empty((nl, m, n), dtype=torch.int32, device=a8.device)
    table = hk.crt_table_entry(L)
    with torch.cuda.device(a8.device):
        code = build.lib().gm8_matmul_crt(
            a8.data_ptr(), b8.data_ptr(), bt.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), table.ctypes.data, L, nl, m, n, k, kp, nblocks,
            build.stream_ptr(a8.device))
    build.check(code, "matmul_crt")
    build.LAUNCHES["matmul_crt"] += 1
    return out


def fused_reconstruct_ok(m: int, n: int, k: int, num_moduli: int) -> bool:
    """Whether `matmul_reconstruct` takes the problem (the gate `gemm_core`
    asks under GEMMUL8_FUSED_RECONSTRUCT=1; where it says no the default
    kernels run). The JAX function of this name fits tiles into the TPU's
    VMEM; the port's kernel parks its residues in a scratch sized by the
    blocks in flight, so its only limits are the residue GEMM's own:
    k <= 2^17 and 2 to 20 moduli."""
    return (m > 0 and n > 0 and 0 < k <= tables.MAX_K
            and 2 <= num_moduli <= tables.MAX_MODULI)


def matmul_reconstruct(a8: torch.Tensor, b8: torch.Tensor,
                       sft_a: torch.Tensor, sft_b: torch.Tensor,
                       num_moduli: int,
                       out_dtype: str = "f64") -> torch.Tensor:
    """(L, m, k) int8 x (L, k, n) int8 + shifts (m, 1), (1, n) -> the (m, n)
    float64 (out_dtype "f64") or float32 ("f32", the integer rounded once
    to 24 bits) result of `matmul_mod_u8` + `reconstruct` from one kernel,
    with no (L, m, n) residues stored."""
    sg._check_matmul_args(a8, b8, num_moduli)
    if out_dtype not in ("f64", "f32"):
        raise ValueError(f"out_dtype {out_dtype!r}")
    f32 = out_dtype == "f32"
    L, m, k = a8.shape
    n = b8.shape[2]
    if tuple(sft_a.shape) != (m, 1) or tuple(sft_b.shape) != (1, n):
        raise ValueError("shifts must be (m, 1) and (1, n)")
    if a8.device.type == "cpu" and b8.device.type == "cpu":
        return matmul_reconstruct_plain(a8, b8, sft_a, sft_b, num_moduli,
                                        out_dtype)
    if sft_a.dtype != torch.int32 or sft_b.dtype != torch.int32:
        raise TypeError("shifts must be int32")
    build.require_cuda(a8, b8, sft_a, sft_b)
    # the kernel is built with the table's sm_90 entry; any other card raises
    cfg = launch.get("matmul_reconstruct",
                     torch.cuda.get_device_capability(a8.device))
    a8, kp, bt = _k_workspace(a8, n)
    nblocks, shape = reconstruct_scratch_shape(
        L, m, n, cfg.tile_n,
        torch.cuda.get_device_properties(a8.device).multi_processor_count)
    scratch = torch.empty(shape, dtype=torch.uint8, device=a8.device)
    out = torch.empty((m, n), dtype=torch.float32 if f32 else torch.float64,
                      device=a8.device)
    table = hk.crt_table_entry(L)
    with torch.cuda.device(a8.device):
        code = build.lib().gm8_matmul_reconstruct(
            a8.data_ptr(), b8.data_ptr(), bt.data_ptr(), scratch.data_ptr(),
            sft_a.data_ptr(), sft_b.data_ptr(), out.data_ptr(),
            table.ctypes.data, L, m, n, k, kp, nblocks, int(f32),
            build.stream_ptr(a8.device))
    build.check(code, "matmul_reconstruct")
    build.LAUNCHES[build.form("matmul_reconstruct", f32)] += 1
    return out


def matmul_complex_mod(a8r: torch.Tensor, a8i: torch.Tensor,
                       b8r: torch.Tensor, b8i: torch.Tensor, num_moduli: int,
                       centered: bool = False, kara=None):
    """Re and Im residues of (a8r + i a8i)(b8r + i b8i) mod MODULI[l]:
    (L, m, k) and (L, k, n) int8 parts -> two (L, m, n), canonical uint8 or
    r - 128 int8 when centered. kara = (s_a, s_b), the recentered sum
    slices, selects the 3-product Karatsuba form; both forms give the same
    bits. k <= 2^16."""
    sg.check_complex_args(a8r, a8i, b8r, b8i, num_moduli, kara)
    a_ops = [a8r, a8i] + ([kara[0]] if kara is not None else [])
    b_ops = [b8r, b8i] + ([kara[1]] if kara is not None else [])
    if all(x.device.type == "cpu" for x in a_ops + b_ops):
        return matmul_complex_mod_plain(a8r, a8i, b8r, b8i, num_moduli,
                                        centered, kara)
    build.require_cuda(*a_ops, *b_ops)
    launch.get("matmul_complex", torch.cuda.get_device_capability(a8r.device))
    L, m, k = a8r.shape
    n = b8r.shape[2]
    kp = -(-k // 16) * 16
    # each operand padded by its own shape: A's parts along k, B's parts
    # into their own K-major workspaces (L, n, kp) by the kernel
    a_ops = [_pad_k(x, kp) for x in a_ops]
    bt = torch.empty((len(b_ops), L, n, kp), dtype=torch.int8,
                     device=a8r.device)
    odt = torch.int8 if centered else torch.uint8
    out_re = torch.empty((L, m, n), dtype=odt, device=a8r.device)
    out_im = torch.empty((L, m, n), dtype=odt, device=a8r.device)
    sa = a_ops[2].data_ptr() if kara is not None else None
    sb = b_ops[2].data_ptr() if kara is not None else None
    with torch.cuda.device(a8r.device):
        code = build.lib().gm8_matmul_complex_mod(
            a_ops[0].data_ptr(), a_ops[1].data_ptr(), sa, b_ops[0].data_ptr(),
            b_ops[1].data_ptr(), sb, bt.data_ptr(), out_re.data_ptr(),
            out_im.data_ptr(), L, m, n, k, kp, int(centered),
            int(kara is not None), build.stream_ptr(a8r.device))
    build.check(code, "matmul_complex_mod")
    build.LAUNCHES["matmul_complex_mod"] += 1
    return out_re, out_im


def _k_major(x: torch.Tensor):
    """(rows, k) int8 -> (t, ld): t holds x's rows at stride ld, with
    ld % 16 == 0 and a 16-byte aligned start, as the GEMM tile loads them.
    x itself where its layout is already so, else a copy."""
    rows, k = x.shape
    ld = x.stride(0)
    if (x.stride(1) == 1 and ld % 16 == 0 and ld >= k
            and x.data_ptr() % 16 == 0):
        return x, ld
    ld = -(-k // 16) * 16
    t = torch.empty((rows, ld), dtype=torch.int8, device=x.device)
    t[:, :k] = x
    return t, ld


def k_major_map(rows: int, k: int, ld: int) -> tuple:
    """(dims, strides in bytes) of the 3-D tensor map csrc/magmax.cu reads
    a K-major (rows, ld) int8 operand through (wgmma_s8.cuh
    make_tensor_map at one slice): its extent along k is k, not ld, so the
    bytes between k and ld, which a caller's buffer may hold anything in,
    read as zeros, as rows past `rows` do. Raises ValueError where the
    card could not encode the map (strides multiples of 16, ld >= k)."""
    if not 0 < k <= ld or ld % 16 or rows < 1:
        raise ValueError(f"K-major operand ({rows}, {k}) at stride {ld}: "
                         "expected 0 < k <= ld and ld % 16 == 0")
    return (k, rows, 1), (ld, rows * ld)


def magmax_scratch_shapes(m: int, n: int, tile_n: int) -> tuple:
    """The shapes of `magmax_matmul_scratch`'s two int32 buffers: each
    128 x tile_n tile's row maxima in its own column of (m, n_tiles), its
    column maxima in its own row of (m_tiles, n)."""
    return (m, -(-n // tile_n)), (-(-m // _TILE_M), n)


def _magmax_operands(mag_a: torch.Tensor, mag_b: torch.Tensor):
    """(a, lda, bt, ldb, the launch entry) of a magnitude GEMM on the card:
    both operands K-major (`_k_major`), their tensor maps checked
    (`k_major_map`); any card but sm_90 raises."""
    build.require_device(mag_a, mag_b)
    cfg = launch.get("magmax", torch.cuda.get_device_capability(mag_a.device))
    m, k = mag_a.shape
    n = mag_b.shape[1]
    a, lda = _k_major(mag_a)
    bt, ldb = _k_major(mag_b.t())
    k_major_map(m, k, lda)
    k_major_map(n, k, ldb)
    return a, lda, bt, ldb, cfg


def magmax_matmul(mag_a: torch.Tensor, mag_b: torch.Tensor):
    """(m, k) x (k, n) int8 magnitudes -> (smax_row (m, 1), smax_col
    (1, n)) int32, the row and column maxima of their product; the (m, n)
    product is never stored. GEMMUL8_MAGMAX_SCRATCH=1 takes
    `magmax_matmul_scratch`, as the JAX package's `magmax_matmul_pallas`
    dispatches."""
    if os.environ.get("GEMMUL8_MAGMAX_SCRATCH", "0") == "1":
        return magmax_matmul_scratch(mag_a, mag_b)
    sg.check_magmax_args(mag_a, mag_b)
    if mag_a.device.type == "cpu" and mag_b.device.type == "cpu":
        return magmax_plain(mag_a, mag_b)
    m, k = mag_a.shape
    n = mag_b.shape[1]
    a, lda, bt, ldb, _ = _magmax_operands(mag_a, mag_b)
    # zero-filled: tiles fold their maxima in with atomicMax
    row = torch.zeros((m, 1), dtype=torch.int32, device=a.device)
    col = torch.zeros((1, n), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        code = build.lib().gm8_magmax_matmul(
            a.data_ptr(), lda, bt.data_ptr(), ldb, row.data_ptr(),
            col.data_ptr(), m, n, k, build.stream_ptr(a.device))
    build.check(code, "magmax_matmul")
    build.LAUNCHES["magmax_matmul"] += 1
    return row, col


def magmax_matmul_scratch(mag_a: torch.Tensor, mag_b: torch.Tensor):
    """`magmax_matmul`'s values with the cross-tile fold deferred: the
    kernel stores each 128 x tile_n tile's row and column maxima plainly
    into its own column of an (m, n_tiles) and its own row of an
    (m_tiles, n) int32 buffer (`magmax_scratch_shapes`), and two torch.amax
    calls finish the fold."""
    sg.check_magmax_args(mag_a, mag_b)
    if mag_a.device.type == "cpu" and mag_b.device.type == "cpu":
        return magmax_scratch_plain(mag_a, mag_b)
    m, k = mag_a.shape
    n = mag_b.shape[1]
    a, lda, bt, ldb, cfg = _magmax_operands(mag_a, mag_b)
    # every entry is stored by one tile: no zero fill
    row_shape, col_shape = magmax_scratch_shapes(m, n, cfg.tile_n)
    row = torch.empty(row_shape, dtype=torch.int32, device=a.device)
    col = torch.empty(col_shape, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        code = build.lib().gm8_magmax_matmul_scratch(
            a.data_ptr(), lda, bt.data_ptr(), ldb, row.data_ptr(),
            col.data_ptr(), m, n, k, build.stream_ptr(a.device))
    build.check(code, "magmax_matmul_scratch")
    build.LAUNCHES["magmax_matmul_scratch"] += 1
    return (torch.amax(row, dim=1, keepdim=True),
            torch.amax(col, dim=0, keepdim=True))
