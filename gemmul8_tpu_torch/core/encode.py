"""Residue-slice encoding (Ozaki Scheme II) on f64 and f32 bit fields.

Counterpart of `gemmul8_tpu/core/encode.py` for f64 and f32 operands, fast
and accurate mode. Every function that takes an operand dispatches on its
dtype: float64 has a 53-bit significand (bias 1023), float32 a 24-bit one
(bias 127), the JAX package's `mant_bits` 53 and 24. For an operand X and
per-row (A, axis=1) or per-column (B, axis=0) shifts sft, slice j holds the
centered residue of trunc(X * 2^sft) mod m_j as int8.

In fast mode the shift comes from the "vecnorm" statistics: the maximum
biased exponent, and the squared norm of the magnitudes scaled by that
maximum, summed in f32. As in the JAX package's Pallas kernel, the norm is
summed over STATS_CHUNK-wide chunks of the contraction axis and the chunks
are merged online, rescaled by exact powers of two. In accurate mode it
comes from the maximum exponent and the row/col maxima of the int8 product
of 7-bit magnitudes (`emax`, `mag7`, `accurate_sft`). A complex operand's
Re and Im parts share one shift per row or column: its fast statistics are
merged over both parts (`joint_fast_sft`), its magnitudes are taken one bit
lower (`MAG_SHIFT_COMPLEX`) and summed.

These are the plain PyTorch versions the Hopper kernels are held to
(`gemmul8_tpu_torch.hopper.kernels`). They run on any device; integers are
int64 tensors and the uint32 words of the JAX package are int64 values
masked to 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from .modmath import mod_u26

_M32 = 0xFFFFFFFF
_BIAS = {53: 1023, 24: 127}
_MANT_SHIFT = {53: 1075, 24: 150}   # bias + stored mantissa bits


def _f64_fields(x: torch.Tensor):
    """Bit fields of an f64 tensor: (chunks, exp_eff, sign, nonzero).

    value = (-1)^sign * mant53 * 2^(exp_eff - 1075), mant53 the sum of four
    16-bit chunks; exact for normals and subnormals (exp_eff = 1, no
    implicit bit). Inf and NaN are undefined, as in the JAX package."""
    bits = x.contiguous().view(torch.int64)
    hi = (bits >> 32) & _M32
    lo = bits & _M32
    exp = (hi >> 20) & 0x7FF
    sign = (hi >> 31) & 1
    is_normal = exp > 0
    nonzero = is_normal | (((hi & 0xFFFFF) | lo) != 0)
    chunks = [lo & 0xFFFF, lo >> 16, hi & 0xFFFF,
              ((hi >> 16) & 0xF) | torch.where(is_normal, 0x10, 0)]
    return chunks, torch.clamp(exp, min=1), sign, nonzero


def _f32_fields(x: torch.Tensor):
    """Bit fields of an f32 tensor: (chunks, exp_eff, sign, nonzero).

    value = (-1)^sign * mant24 * 2^(exp_eff - 150), mant24 = chunks[0] +
    chunks[1] * 2^16; exact for normals and subnormals (exp_eff = 1, no
    implicit bit, but nonzero)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    exp = (bits >> 23) & 0xFF
    sign = (bits >> 31) & 1
    is_normal = exp > 0
    nonzero = is_normal | ((bits & 0x7FFFFF) != 0)
    chunks = [bits & 0xFFFF,
              ((bits >> 16) & 0x7F) | torch.where(is_normal, 0x80, 0)]
    return chunks, torch.clamp(exp, min=1), sign, nonzero


def mant_bits_of(x: torch.Tensor) -> int:
    """53 for a float64 operand, 24 for a float32 one; other dtypes and
    shapes raise."""
    if x.dim() != 2 or x.dtype not in (torch.float64, torch.float32):
        raise TypeError("expected a 2-D float64 or float32 tensor")
    return 53 if x.dtype == torch.float64 else 24


def _fields(x: torch.Tensor):
    """The bit fields of a float64 or float32 operand (its dtype's)."""
    return _f64_fields(x) if mant_bits_of(x) == 53 else _f32_fields(x)


def _scaled_abs_f32(chunks, exp, emax, nonzero):
    """|x| * 2^-(emax - bias) as f32 in [0, 2): exponent arithmetic and the
    top 23 stored mantissa bits; 0 where the f32 exponent would underflow.
    A subnormal gets the implicit bit here (rounded up into the normal
    form with the same mantissa bits), as in the JAX package."""
    eb = exp - emax + 127
    if len(chunks) == 4:
        m23 = ((chunks[3] & 0xF) << 19) | (chunks[2] << 3) | (chunks[1] >> 13)
    else:
        m23 = ((chunks[1] & 0x7F) << 16) | chunks[0]
    keep = nonzero & (eb >= 1)
    f32bits = torch.where(keep, (eb << 23) | m23, 0).to(torch.int32)
    return f32bits.view(torch.float32)


def _pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as f32 for integer e <= 0; 0 below the normal range (the
    JAX package's exp2 flushes those, and they only scale terms far below
    the norm's rounding)."""
    bits = torch.where(e >= -126, (e + 127) << 23, 0).to(torch.int32)
    return bits.view(torch.float32)


def fast_stats(x: torch.Tensor, axis: int):
    """Fast-mode statistics (emax, nrm2, anyfinite), keepdims shaped, of a
    float64 or float32 operand.

    emax: max biased exponent over nonzero elements (int64); nrm2: f32
    squared norm relative to 2^(emax - bias), summed per STATS_CHUNK chunk
    and merged online; anyfinite: any nonzero element (bool)."""
    mant_bits_of(x)
    rows = x if axis == 1 else x.t()
    kdim = rows.shape[1]
    e_acc = s_acc = af_acc = None
    for c0 in range(0, kdim, tables.STATS_CHUNK):
        chunks, exp, _, nz = _fields(rows[:, c0:c0 + tables.STATS_CHUNK])
        e_blk = torch.where(nz, exp, 0).amax(dim=1, keepdim=True)
        xs = _scaled_abs_f32(chunks, exp, e_blk, nz)
        s_blk = (xs * xs).sum(dim=1, keepdim=True, dtype=torch.float32)
        af_blk = nz.any(dim=1, keepdim=True)
        if e_acc is None:
            e_acc, s_acc, af_acc = e_blk, s_blk, af_blk
            continue
        e_new = torch.maximum(e_acc, e_blk)
        s_acc = (s_acc * _pow2_f32(2 * (e_acc - e_new))
                 + s_blk * _pow2_f32(2 * (e_blk - e_new)))
        e_acc, af_acc = e_new, af_acc | af_blk
    if axis == 0:
        return e_acc.t(), s_acc.t(), af_acc.t()
    return e_acc, s_acc, af_acc


def fast_stats_running(x: torch.Tensor, axis: int, run: int = 128,
                       ways: int = 16):
    """`fast_stats` summed in the fast_sft kernel's column order: the
    plain twin of that order, in f32 step by step, for the tests.

    Each STATS_CHUNK-wide chunk of a line is cut into `run`-wide runs
    along the contraction axis, dealt in turn to `ways` readers (run i to
    reader i % ways). A reader reads its words once, in order, keeping a
    frame: the max biased exponent e of the nonzero words read so far and
    the f32 sum s of their squares relative to it (each |x| scaled to
    2^-(e - bias) as `_scaled_abs_f32` scales it); where a word raises e
    by d, s is first multiplied by 2^-2d (exact, or 0 below the normal
    range). At the chunk's end its max is the readers' largest e, and the
    readers' sums, each multiplied by 2^(2 (e_reader - e_chunk)), are
    added in reader order from 0. Chunks merge in order as in
    `fast_stats`, from a zero accumulator. Without subnormal terms or sums
    these are the bits of summing each reader's words relative to the
    chunk's max from the start; they can differ where an element lies 63
    or more binades under its chunk's max. The kernel's columns form is
    run 128 and ways 16 (a 2048-row chunk over 16 threads a column)."""
    mant_bits_of(x)
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if run < 1 or ways < 1:
        raise ValueError("run and ways must be positive")
    lines = x if axis == 1 else x.t()
    nlines, kdim = lines.shape
    step = run * ways
    zero_i = torch.zeros((nlines, 1), dtype=torch.int64, device=x.device)
    zero_f = torch.zeros((nlines, 1), dtype=torch.float32, device=x.device)
    e_acc, s_acc, af_acc = zero_i, zero_f, zero_i.bool()
    for c0 in range(0, kdim, tables.STATS_CHUNK):
        chunk = lines[:, c0:c0 + tables.STATS_CHUNK]
        clen = chunk.shape[1]
        nsteps = -(-clen // step)
        padded = torch.zeros((nlines, nsteps * step), dtype=x.dtype,
                             device=x.device)
        padded[:, :clen] = chunk
        # (line, reader, its words in order): word (t, j) of reader w is
        # run t * ways + w, element j
        seq = (padded.reshape(nlines, nsteps, ways, run).permute(0, 2, 1, 3)
               .reshape(nlines * ways, nsteps * run))
        pieces, exp, _, nz = _fields(seq)
        e = torch.zeros((nlines * ways,), dtype=torch.int64,
                        device=x.device)
        s = torch.zeros((nlines * ways,), dtype=torch.float32,
                        device=x.device)
        for t in range(nsteps * run):
            e_new = torch.where(nz[:, t], torch.maximum(e, exp[:, t]), e)
            s = s * _pow2_f32(2 * (e - e_new))
            xs = _scaled_abs_f32([p[:, t] for p in pieces], exp[:, t], e_new,
                                 nz[:, t])
            s = s + xs * xs
            e = e_new
        e, s = e.reshape(nlines, ways), s.reshape(nlines, ways)
        e_blk = e.amax(dim=1, keepdim=True)
        s_blk = zero_f
        for w in range(ways):
            s_blk = s_blk + s[:, w:w + 1] * _pow2_f32(2 * (e[:, w:w + 1]
                                                           - e_blk))
        af_blk = nz.reshape(nlines, -1).any(dim=1, keepdim=True)
        e_new = torch.maximum(e_acc, e_blk)
        s_acc = (s_acc * _pow2_f32(2 * (e_acc - e_new))
                 + s_blk * _pow2_f32(2 * (e_blk - e_new)))
        e_acc, af_acc = e_new, af_acc | af_blk
    if axis == 0:
        return e_acc.t(), s_acc.t(), af_acc.t()
    return e_acc, s_acc, af_acc


def _norm_guard(k_total: int) -> float:
    """f32 round-up factor (1 + k * 2^-23) on the squared norm."""
    return float(np.float32(1.0 + k_total * 2.0 ** -23))


def sft_from_stats(emax, nrm2, anyfinite, k_total: int, num_moduli: int,
                   mant_bits: int = 53):
    """Fast-mode shift from the raw statistics, in f32 step by step:
    min(T-1, floor(-0.51 * log2(max(nrm2 * guard, 1)) + T)) - (emax - bias),
    bias 1023 for an f64 operand (mant_bits 53), 127 for f32 (24)."""
    t_f = tables.threshold_fast(num_moduli)
    n2 = torch.clamp(nrm2 * _norm_guard(k_total), min=1.0)
    v = torch.floor(torch.log2(n2) * -0.51 + float(t_f)).to(torch.int64)
    sft = torch.clamp(v, max=t_f - 1) - (emax - _BIAS[mant_bits])
    return torch.where(anyfinite, sft, 0).to(torch.int32)


def sft_floor_frac(nrm2, k_total: int, num_moduli: int):
    """Distance of sft_from_stats' pre-floor value from its nearest integer.
    Where it is tiny, two summation orders of the norm may legally give
    shifts that differ by 1 (both are valid encodings)."""
    t_f = tables.threshold_fast(num_moduli)
    n2 = torch.clamp(nrm2.float() * _norm_guard(k_total), min=1.0)
    v = torch.log2(n2) * -0.51 + float(t_f)
    return torch.minimum(v - torch.floor(v), torch.ceil(v) - v)


def fast_sft(x: torch.Tensor, num_moduli: int, axis: int) -> torch.Tensor:
    """Fast-mode shifts of a float64 or float32 operand: (m, 1) int32 for
    axis=1, (1, n) for axis=0."""
    emax, nrm2, anyfinite = fast_stats(x, axis)
    return sft_from_stats(emax, nrm2, anyfinite, x.shape[axis], num_moduli,
                          mant_bits_of(x))


def merge_stats(re_stats, im_stats):
    """Joint (emax, nrm2, anyfinite) of a complex operand from those of its
    Re and Im parts: the larger exponent, each norm rescaled to it by an
    exact power of two (two products, then one add, each rounded in f32)
    and the flags or-ed; the counterpart of the JAX package's
    `_joint_sft_pallas` merge."""
    er, sr, ar = re_stats
    ei, si, ai = im_stats
    emax = torch.maximum(er, ei)
    nrm2 = sr * _pow2_f32(2 * (er - emax)) + si * _pow2_f32(2 * (ei - emax))
    return emax, nrm2, ar | ai


def joint_fast_sft(re: torch.Tensor, im: torch.Tensor, num_moduli: int,
                   axis: int, stats=fast_stats) -> torch.Tensor:
    """The fast-mode shift Re and Im of a complex operand share: each row
    (axis=1) or column (axis=0) gets the shift of its joint norm over both
    parts, with the norm guard of 2k terms, at the parts' exponent bias
    (both float64 or both float32). `stats` takes the per-part statistics
    (the plain `fast_stats`, or the kernel's wrapper)."""
    mant_bits = mant_bits_of(re)
    if mant_bits_of(im) != mant_bits or im.shape != re.shape:
        raise ValueError("Re and Im must have one shape and one dtype")
    emax, nrm2, anyfinite = merge_stats(stats(re, axis), stats(im, axis))
    return sft_from_stats(emax, nrm2, anyfinite, 2 * re.shape[axis],
                          num_moduli, mant_bits)


def _shifted_value_words(chunks, q, q_max_static: int):
    """32-bit words (int64, masked) of v = trunc(mant * 2^q), mant the
    53-bit (4 chunks) or 24-bit (2 chunks) significand.

    q < 0 truncates; 0 <= q <= q_max_static scales up. f64 operands need at
    most q_max_static = 24 (20 moduli), f32 operands up to 53, so the left
    shift is a whole-word shift (0 or 1 words) and an in-word one."""
    if len(chunks) == 2:
        w = chunks[0] | (chunks[1] << 16)
        ur = torch.clamp(-q, 0, 63)
        rw = [torch.where(ur <= 31, w >> torch.clamp(ur, max=31), 0)]
        mbits = 24
    else:
        words = [chunks[0] | (chunks[1] << 16), chunks[2] | (chunks[3] << 16)]
        ur = torch.clamp(-q, 0, 63)
        u1 = torch.clamp(ur, max=31)
        lo, hi = words
        lo_sh = (lo >> u1) | ((((hi << (31 - u1)) & _M32) << 1) & _M32)
        u2 = torch.clamp(ur - 32, 0, 31)
        rw = [torch.where(ur < 32, lo_sh, hi >> u2),
              torch.where(ur < 32, hi >> u1, 0)]
        mbits = 53
    if q_max_static <= 0:
        return rw
    nw_out = (mbits + 1 + q_max_static + 31) // 32
    ql = torch.clamp(q, 0, q_max_static)
    b = ql & 31
    zero = torch.zeros_like(rw[0])
    padded = [zero, zero] + rw + [zero] * max(nw_out - len(rw), 0)

    def at(i):  # logical word i (i may be < 0)
        return padded[i + 2]

    def funnel(lo, hi):
        return ((lo << b) & _M32) | ((hi >> (31 - b)) >> 1)

    if q_max_static < 32:
        return [funnel(at(i), at(i - 1)) for i in range(nw_out)]
    one = (ql >> 5) == 1
    return [funnel(torch.where(one, at(i - 1), at(i)),
                   torch.where(one, at(i - 2), at(i - 1)))
            for i in range(nw_out)]


def _residues_from_chunks(chunks, q, sign, moduli_idx, q_max_static: int):
    """(len(moduli_idx), ...) int8 centered residues of sign * mant * 2^q."""
    words = _shifted_value_words(chunks, q, q_max_static)
    d = []
    for w in words:
        d += [w & 0xFFFF, w >> 16]
    mbits = 53 if len(chunks) == 4 else 24
    d = d[: (mbits + 1 + max(q_max_static, 0) + 15) // 16]
    bound = 26 if len(d) <= 4 else 27
    neg = sign == 1
    out = []
    for j in moduli_idx:
        m = tables.MODULI[j]
        if m == 256:
            # the centered residue mod 256 is the signed value's low byte
            lob = d[0] & 0xFF
            sv = torch.where(neg, (256 - lob) & 0xFF, lob)
            out.append(((sv ^ 0x80) - 0x80).to(torch.int8))
            continue
        acc = torch.zeros_like(d[0])
        for i, di in enumerate(d):
            p = pow(2, 16 * i, m)
            acc = acc + (di if p == 1 else di * p)
        base = mod_u26(acc, m, bound)
        # odd m: the centered range is symmetric, so negating the centered
        # residue of |v| gives the residue of -|v|
        rc = base - torch.where(base >= (m + 1) // 2, m, 0)
        out.append(torch.where(neg, -rc, rc).to(torch.int8))
    return torch.stack(out, dim=0)


def q_max(num_moduli: int, mant_bits: int = 53) -> int:
    """The static left-shift cap of the encode: max(T_accu - mant_bits,
    0), 24 at most for f64 and 53 for f32 operands (20 moduli)."""
    return max(tables.threshold_accurate(num_moduli) - mant_bits, 0)


def _encode_with_sft(chunks, exp, sign, sft, num_moduli: int,
                     moduli_idx=None):
    mbits = 53 if len(chunks) == 4 else 24
    q = exp - _MANT_SHIFT[mbits] + sft
    q_max_static = q_max(num_moduli, mbits)
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    return _residues_from_chunks(chunks, q, sign, moduli_idx, q_max_static)


def check_moduli_idx(moduli_idx, num_moduli: int) -> tuple:
    """moduli_idx as a tuple of distinct indices below num_moduli (None:
    all of them in order)."""
    if moduli_idx is None:
        return tuple(range(num_moduli))
    idx = tuple(int(j) for j in moduli_idx)
    if (not idx or len(set(idx)) != len(idx)
            or not all(0 <= j < num_moduli for j in idx)):
        raise ValueError(f"moduli_idx {idx}: expected distinct indices "
                         f"below {num_moduli}")
    return idx


# The JAX package's encode block; its second entry is the unit of
# `encode_slices`' col_tiles (the panel pipeline's B split).
ENC_BLOCK = (64, 512)


def col_range(col_tiles, width: int):
    """The columns [c0, c1) of col_tiles (j0, j1), in units of
    ENC_BLOCK[1] columns, within an operand `width` columns wide."""
    j0, j1 = (int(j) for j in col_tiles)
    c0, c1 = j0 * ENC_BLOCK[1], min(j1 * ENC_BLOCK[1], width)
    if not 0 <= c0 < c1:
        raise ValueError(f"col_tiles {tuple(col_tiles)} select no column of "
                         f"{width}")
    return c0, c1


def encode_slices(x: torch.Tensor, sft: torch.Tensor, num_moduli: int,
                  axis: int, moduli_idx=None,
                  col_tiles=None) -> torch.Tensor:
    """(L', *x.shape) int8 centered residues of trunc(x * 2^sft) of a
    float64 or float32 operand: slice l for modulus moduli_idx[l] (default:
    all num_moduli in order). sft is (m, 1) for axis=1 (rows of A), (1, n)
    for axis=0 (columns of B). col_tiles (j0, j1) encodes only x's columns
    in `col_range`; the other columns of the full-shape result hold zeros
    here (the kernel leaves them unwritten)."""
    mant_bits_of(x)
    want = (x.shape[0], 1) if axis == 1 else (1, x.shape[1])
    if tuple(sft.shape) != want:
        raise ValueError(f"sft shape {tuple(sft.shape)}, expected {want}")
    idx = check_moduli_idx(moduli_idx, num_moduli)
    if col_tiles is not None:
        c0, c1 = col_range(col_tiles, x.shape[1])
        out = torch.zeros((len(idx), *x.shape), dtype=torch.int8,
                          device=x.device)
        out[:, :, c0:c1] = encode_slices(
            x[:, c0:c1], sft if axis == 1 else sft[:, c0:c1], num_moduli,
            axis, idx)
        return out
    chunks, exp, sign, _ = _fields(x)
    return _encode_with_sft(chunks, exp, sign, sft.to(torch.int64),
                            num_moduli, idx)


class KMajorSlices(NamedTuple):
    """A B operand's residue slices in the layout the GEMM tile reads: `bt`
    (L, n, kp) int8, slice l's row j the residues of B's column j down k,
    kp = k rounded up to 16, zeros in [k, kp). What
    `hopper.kernels.encode_slices(..., k_major=True)` returns; the residue
    GEMMs tell it from N-major (L, k, n) slices by its type and read it
    without a copy."""
    bt: torch.Tensor
    k: int

    def n_major(self) -> torch.Tensor:
        """The (L, k, n) slices, a view of `bt`."""
        return self.bt[:, :, :self.k].transpose(1, 2)


def k_major(b8: torch.Tensor) -> KMajorSlices:
    """(L, k, n) int8 slices in their K-major form: transposed, and
    zero-padded along k to a multiple of 16."""
    L, k, n = b8.shape
    t = torch.zeros((L, n, -(-k // 16) * 16), dtype=b8.dtype,
                    device=b8.device)
    t[:, :, :k] = b8.transpose(1, 2)
    return KMajorSlices(t, k)


# The byte-plane contraction of the encode kernel (csrc/encode_mma.cuh): the
# shifted value |v| < 2^77 of an element is written as the 10 bytes of its
# 80-bit two's complement where it is negative (and not truncated to 0),
# plus a sign plane holding 0 or 1: v == sum_i b_i 2^(8i) - s 2^80. Each
# modulus's residue is one dot of these 11 unsigned planes with signed
# weights (the centred representatives of 2^(8i) and of -2^80 mod m), then
# one round-to-nearest reduction in integer multiply-and-shift.
ENC_PLANES = 11
ENC_BYTES = 10
_ENC_RAW_BITS = 19   # |raw| <= 10 * 255 * 127 + 127 < 2^19


_ENC_CHUNK = 1 << 22   # elements a contraction of encode_slices_mxu takes


def encode_mxu_weights(moduli_idx) -> dict:
    """The contraction's constants for the slots of moduli_idx (slot l for
    modulus MODULI[moduli_idx[l]]), each an int64 ndarray over the slots:
    "w" (L, ENC_PLANES) the signed plane weights; "m"; "off" = ceil(2^19 /
    m) m, which makes raw + off positive; "h" = (m - 1) // 2; "mul" =
    ceil(2^32 / m). With t = raw + off, q = ((t + h) mul) >> 32 is floor((t
    + h) / m) for every t + h < 2^24, so t - q m is the centred residue of
    raw (odd m), or a value with raw's low byte (m = 256)."""
    L = len(moduli_idx)
    w = np.zeros((L, ENC_PLANES), np.int64)
    m = np.array([tables.MODULI[j] for j in moduli_idx], np.int64)
    for jj, mj in enumerate(m.tolist()):
        def centred(r, mj=mj):
            return r - mj if r > mj // 2 else r
        for i in range(ENC_BYTES):
            w[jj, i] = centred(pow(2, 8 * i, mj))
        w[jj, ENC_BYTES] = centred(-(1 << (8 * ENC_BYTES)) % mj)
    off = -(-(1 << _ENC_RAW_BITS) // m) * m
    return {"w": w, "m": m, "off": off, "h": (m - 1) // 2,
            "mul": -(-(1 << 32) // m)}


def _byte_planes(chunks, q, sign, q_max_static: int) -> torch.Tensor:
    """(ENC_PLANES, ...) int64: the 10 bytes of trunc(mant * 2^q), in 80-bit
    two's complement where sign is set and the value is not 0, and the sign
    plane (that condition as 0 or 1)."""
    words = _shifted_value_words(chunks, q, q_max_static)
    c16 = []
    for k in range(ENC_BYTES // 2):
        w = words[k // 2] if k // 2 < len(words) else torch.zeros_like(
            words[0])
        c16.append((w >> (16 * (k % 2))) & 0xFFFF)
    nonzero = torch.zeros_like(c16[0], dtype=torch.bool)
    for c in c16:
        nonzero = nonzero | (c != 0)
    neg = (sign == 1) & nonzero
    carry = torch.ones_like(c16[0])
    planes = []
    for c in c16:
        s = (c ^ 0xFFFF) + carry
        carry = s >> 16
        c = torch.where(neg, s & 0xFFFF, c)
        planes += [c & 0xFF, c >> 8]
    return torch.stack(planes + [neg.to(torch.int64)])


def encode_slices_mxu(x: torch.Tensor, sft: torch.Tensor, num_moduli: int,
                      axis: int, moduli_idx=None,
                      col_tiles=None) -> torch.Tensor:
    """`encode_slices` (the same arguments and bits) by the encode kernel's
    arithmetic: byte planes, their dot with each row of
    `encode_mxu_weights`' table (an f64 product, exact), and the
    multiply-and-shift reduction. The
    plain version of csrc/encode.cu; the JAX package's
    `encode_slices_pallas(..., mxu=True)` takes the same route with
    centred planes."""
    mant_bits_of(x)
    want = (x.shape[0], 1) if axis == 1 else (1, x.shape[1])
    if tuple(sft.shape) != want:
        raise ValueError(f"sft shape {tuple(sft.shape)}, expected {want}")
    idx = check_moduli_idx(moduli_idx, num_moduli)
    if col_tiles is not None:
        c0, c1 = col_range(col_tiles, x.shape[1])
        out = torch.zeros((len(idx), *x.shape), dtype=torch.int8,
                          device=x.device)
        out[:, :, c0:c1] = encode_slices_mxu(
            x[:, c0:c1], sft if axis == 1 else sft[:, c0:c1], num_moduli,
            axis, idx)
        return out
    chunks, exp, sign, _ = _fields(x)
    mbits = 53 if len(chunks) == 4 else 24
    q = exp - _MANT_SHIFT[mbits] + sft.to(torch.int64)
    planes = _byte_planes(chunks, q, sign, q_max(num_moduli, mbits))
    k = encode_mxu_weights(idx)

    def col(a):
        return torch.as_tensor(a, device=x.device).reshape(-1, 1)

    w = torch.as_tensor(k["w"], device=x.device).double()
    flat = planes.reshape(ENC_PLANES, -1)
    out = []
    for e0 in range(0, flat.shape[1], _ENC_CHUNK):  # bounds the f64 copies
        # the contraction in f64, exact: |raw| < 2^19
        t = (w @ flat[:, e0:e0 + _ENC_CHUNK].double()).to(torch.int64)
        t += col(k["off"])
        quo = (t + col(k["h"])).mul_(col(k["mul"])).bitwise_right_shift_(32)
        out.append(t.sub_(quo.mul_(col(k["m"]))).bitwise_and_(0xFF).to(
            torch.uint8))
    return torch.cat(out, dim=1).view(torch.int8).reshape(len(idx),
                                                           *x.shape)


def fast_encode_fused(x: torch.Tensor, num_moduli: int, axis: int):
    """(slices (L, *x.shape) int8, sft int32): the fast-mode shift and the
    residues encoded with it, the function of the JAX package's
    `fast_encode_fused_pallas` (the same STATS_CHUNK merge, so the same
    shifts as `fast_sft`)."""
    sft = fast_sft(x, num_moduli, axis)
    return encode_slices(x, sft, num_moduli, axis), sft


# ---------------------------------------------------------------------------
# Accurate mode: 7-bit round-up magnitudes -> one int8 GEMM |A| x |B| ->
# per-row/col shifts from the product-magnitude maxima.
# ---------------------------------------------------------------------------

MAG_SHIFT = 5   # magnitudes ceil(|x| * 2^(5 - ilogb(amax))) lie in [0, 64]
# complex: parts lie in [0, 32], so |Re| + |Im| <= 64 cannot wrap int8
MAG_SHIFT_COMPLEX = 4


def _extract_mag7(chunks, exp, emax, mag_shift: int = MAG_SHIFT):
    """ceil(|x| * 2^(mag_shift - (emax - bias))) as int8 in
    [0, 2^(mag_shift + 1)] for f64 (4 chunks) or f32 (2 chunks) fields.

    |x| = mant * 2^(exp - bias - (mant_bits - 1)), so the scaled value is
    mant >> u with u = emax + mant_bits - 1 - mag_shift - exp, rounded up
    when any dropped bit is set. The JAX package works on 32-bit words; a
    64-bit word gives the same bits (u is clipped to [0, 63] in both)."""
    mant = chunks[0] | (chunks[1] << 16)
    if len(chunks) == 4:
        mant = mant | (chunks[2] << 32) | (chunks[3] << 48)
    stored = 52 if len(chunks) == 4 else 23
    u = torch.clamp(emax + (stored - mag_shift) - exp, 0, 63)
    v = mant >> u
    sticky = (v << u) != mant
    return (v + sticky.to(torch.int64)).to(torch.int8)


def emax(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Max biased exponent over the nonzero elements of each row (axis=1)
    or column (axis=0) of a float64 or float32 tensor, keepdims int32;
    subnormals count as 1, an all-zero row or column gives 0."""
    _, exp, _, nonzero = _fields(x)
    return torch.where(nonzero, exp, 0).amax(dim=axis, keepdim=True).to(
        torch.int32)


def mag7(x: torch.Tensor, emax: torch.Tensor, axis: int,
         mag_shift: int = MAG_SHIFT) -> torch.Tensor:
    """Round-up 7-bit magnitudes of x (float64 or float32) below its row
    (axis=1) or column (axis=0) max exponent `emax`: int8 of x's shape,
    values in [0, 2^(mag_shift + 1)] ([0, 64] at the real path's shift
    5)."""
    mant_bits_of(x)
    want = (x.shape[0], 1) if axis == 1 else (1, x.shape[1])
    if tuple(emax.shape) != want:
        raise ValueError(f"emax shape {tuple(emax.shape)}, expected {want}")
    chunks, exp, _, _ = _fields(x)
    return _extract_mag7(chunks, exp, emax.to(torch.int64), mag_shift)


def mag7_fused(x: torch.Tensor, axis: int, mag_shift: int = MAG_SHIFT):
    """(magnitudes, emax): `emax`, then `mag7` below it, the function of
    the JAX package's `mag7_fused_pallas`."""
    e = emax(x, axis)
    return mag7(x, e, axis, mag_shift), e


def mag7_fused_chunked(x: torch.Tensor, axis: int,
                       mag_shift: int = MAG_SHIFT, chunk: int = 64,
                       ways: int = 1):
    """`mag7_fused` with its operand read once, as the fused kernel reads
    it: the bits of `mag7_fused` by another route.

    Each line is cut into `chunk`-wide pieces along the contraction axis,
    dealt in turn to `ways` readers (piece i to reader i % ways). A reader
    keeps the running max exponent e_run of the pieces it has read, the
    current one included, and takes that piece's magnitudes below it:
    every element's exponent is <= e_run, so the byte m = ceil(|x| *
    2^(mag_shift - (e_run - bias))) is <= 2^(mag_shift + 1). At the line's
    end emax is the readers' largest e_run, and each piece taken below it
    is rewritten as ceil(m / 2^d), d = emax - e_run: ceil(ceil(y) / 2^d) =
    ceil(y / 2^d) for an integer d >= 0, and where the shift's clamp at 63
    applies the answer is 1 for a nonzero element (0 for a zero) either
    way; m < 2^8, so d >= 8 gives m != 0. The kernel's rows form is chunk
    64 (f64) or 128 (f32) and ways 8 (a 256-thread block's warps, 16-byte
    loads), its columns form chunk 128 and ways 1."""
    mant_bits_of(x)
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    if chunk < 1 or ways < 1:
        raise ValueError("chunk and ways must be positive")
    chunks, exp, _, nonzero = _fields(x)
    e_nz = torch.where(nonzero, exp, 0)
    lines = e_nz if axis == 1 else e_nz.t()          # (rows, kdim)
    rows, kdim = lines.shape
    npiece = -(-kdim // chunk)
    padded = torch.zeros((rows, npiece * chunk), dtype=torch.int64,
                         device=x.device)
    padded[:, :kdim] = lines
    pmax = padded.reshape(rows, npiece, chunk).amax(dim=2)
    e_piece = torch.empty_like(pmax)
    for w in range(ways):     # each reader's running max over its pieces
        if w < npiece:
            e_piece[:, w::ways] = torch.cummax(pmax[:, w::ways], dim=1)[0]
    e_line = e_piece.amax(dim=1, keepdim=True)        # (rows, 1)
    piece = torch.arange(kdim, device=x.device) // chunk
    e_run = e_piece[:, piece]                         # (rows, kdim)
    if axis == 0:
        e_run, e_line = e_run.t(), e_line.t()
    m = _extract_mag7(chunks, exp, e_run, mag_shift).to(torch.int64) & 0xFF
    d = e_line - e_run
    ds = torch.clamp(d, max=7)
    fixed = torch.where(d >= 8, (m != 0).to(torch.int64),
                        (m + (1 << ds) - 1) >> ds)
    return fixed.to(torch.int8), e_line.to(torch.int32)


def _accurate_pre_floor(smax: torch.Tensor, num_moduli: int):
    """-0.51 * log2(max(smax, 1)) + T_accu in f32, step by step.

    The f32 log2 is the correctly rounded one (taken in f64 and rounded
    once), so every device gives the same bits; XLA's and torch's own f32
    log2 each miss it for some inputs. Against the JAX package a shift can
    therefore differ by 1 where this value lies within f32 rounding of an
    integer (see accurate_sft_floor_frac)."""
    s = torch.clamp(smax, min=1).to(torch.float32)
    log2s = torch.log2(s.double()).to(torch.float32)
    return log2s * -0.51 + float(tables.threshold_accurate(num_moduli))


def accurate_sft(smax: torch.Tensor, emax: torch.Tensor, num_moduli: int,
                 mag_shift: int = MAG_SHIFT, *,
                 mant_bits: int = 53) -> torch.Tensor:
    """Accurate-mode shift from the |A| x |B| row/col max `smax` of
    magnitudes taken at `mag_shift` and the operand's max exponent, in f32
    as the JAX package takes it:
    min(s - e + floor(-0.51 * log2(max(smax, 1)) + T), T - 1 - e) with
    e = emax - bias (1023 for an f64 operand, mant_bits 53; 127 for f32,
    24) and s = mag_shift. All-zero rows and columns get T - 1 + bias."""
    t_a = tables.threshold_accurate(num_moduli)
    e = emax.to(torch.int64) - _BIAS[mant_bits]
    v = torch.floor(_accurate_pre_floor(smax, num_moduli)).to(torch.int64)
    sft = torch.minimum(mag_shift - e + v, t_a - 1 - e)
    return sft.to(torch.int32)


def accurate_sft_floor_frac(smax: torch.Tensor, num_moduli: int):
    """Distance of accurate_sft's pre-floor value from its nearest integer.
    Where it is tiny, two implementations of the f32 log2 may legally give
    shifts that differ by 1 (both are valid encodings). The magnitude shift
    only offsets the floored value, so this holds for either."""
    v = _accurate_pre_floor(smax, num_moduli)
    return torch.minimum(v - torch.floor(v), torch.ceil(v) - v)
