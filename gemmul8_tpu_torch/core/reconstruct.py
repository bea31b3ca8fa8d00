"""Exact CRT reconstruction, inverse scaling and IEEE rounding.

Counterpart of `gemmul8_tpu/core/reconstruct.py`: the integer
X = sum_j w_j * r_j is accumulated in 16-bit limbs, reduced mod M with an
f32 quotient estimate and one exact correction, centered to (-M/2, M/2],
scaled by 2^(e_extra - sft_a - sft_b) and rounded to nearest even into the
bits of an f64 (or f32), subnormals and overflow to inf included.

This is the plain PyTorch version the reconstruct kernel is held to. The
moduli-chunked schedule adds each chunk's weighted residues into one int32
limb tensor in place (`fold_chunk_`) and hands it to `reconstruct` as
input_kind="limbs".
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from . import limbs as lb
from .modmath import mod_reduce


def accumulate_weighted(r, num_moduli: int, moduli_idx=None, acc=None):
    """acc + sum_j w_j * r[j] as canonical 16-bit limbs (int64 tensors).
    r: (len(moduli_idx), ...) canonical residues in [0, m_j)."""
    nl = tables.num_limbs(num_moduli)
    w = tables.crt_weight_limbs(num_moduli)
    if moduli_idx is None:
        moduli_idx = tuple(range(num_moduli))
    out = ([torch.zeros(r[0].shape, dtype=torch.int64, device=r[0].device)
            for _ in range(nl)] if acc is None else list(acc))
    for jj, j in enumerate(moduli_idx):
        rj = r[jj].to(torch.int64)
        for l in range(nl):
            wl = int(w[j, l])
            if wl:
                out[l] = out[l] + (rj if wl == 1 else rj * wl)
    return lb.carry_propagate(out)


def crt_mxu_weights(num_moduli: int):
    """(wc ((nd+1), L) int64, CL limb-correction tuple[int]), nd = 2 *
    num_limbs: the compact table of the CRT contraction. Row d < nd holds
    byte-digit d of each weight minus 128 (d = 2l: the low byte of limb l,
    2l+1: its high byte), row nd is all ones (it yields S = sum_j (r_j -
    128)). On centered residues rc_j = r_j - 128, Y[d] = sum_j wc[d, j]
    rc_j gives X[d] = sum_j r_j wbyte[j, d] = Y[d] + 128 S + C[d], and limb
    l of the weighted sum is Y[2l] + (Y[2l+1] << 8) + 32896 S + CL[l]."""
    w16 = np.asarray(tables.crt_weight_limbs(num_moduli), dtype=np.int64)
    L, nl = w16.shape
    nd = 2 * nl
    wb = np.zeros((nd + 1, L), np.int64)
    for l in range(nl):
        wb[2 * l] = w16[:, l] & 0xFF
        wb[2 * l + 1] = (w16[:, l] >> 8) & 0xFF
    wc = wb - 128
    wc[nd] = 1
    c = 128 * wc[:nd].sum(axis=1) + 128 * 128 * L
    cl = tuple(int(c[2 * l] + (c[2 * l + 1] << 8)) for l in range(nl))
    return wc, cl


def crt_mxu_consts(num_moduli: int, bm: int):
    """(W' ((nd+1)*bm, L*bm) int8 ndarray, CL): the JAX package's
    block-diagonal form of `crt_mxu_weights` (W' = wc kron I_bm), which
    contracts a block of bm rows of every modulus at once."""
    wc, cl = crt_mxu_weights(num_moduli)
    return np.kron(wc, np.eye(bm, dtype=np.int64)).astype(np.int8), cl


def crt_accumulate_mxu(rc2: torch.Tensor, w, num_moduli: int, cl, bm: int,
                       bn: int):
    """The 16-bit limbs of X = sum_j w_j r_j from the centered residues rc2
    (L*bm, bn) int8 through the contraction Y = W' rc2, W' from
    `crt_mxu_consts`: redundant (each nonnegative and below 2^29; one
    `carry_propagate` gives `accumulate_weighted`'s limbs), as int64
    tensors. The product runs in f64, exact: |Y| <= L * 128^2 < 2^53.

    The JAX package's `_crt_accumulate_mxu`; with bm = 1 (W' = wc) the sum
    of `reconstruct_mxu`, the reconstruct kernel's plain version."""
    nd = 2 * len(cl)
    w = torch.as_tensor(np.asarray(w), device=rc2.device)
    y = (w.double() @ rc2.double()).to(torch.int64).reshape(nd + 1, bm, bn)
    t = y[nd] * 32896
    return [y[2 * l] + (y[2 * l + 1] << 8) + t + cl[l]
            for l in range(len(cl))]


def centered_residue_block(c: torch.Tensor,
                           num_moduli: int) -> torch.Tensor:
    """(L*bm, bn) int8 centered canonical residues r_j - 128 from a (L, bm,
    bn) block of int8 residues already centered, uint8 canonical residues,
    or int32 raw slice products (reduced mod m_j first): the JAX package's
    `_centered_residues`, the input of `crt_accumulate_mxu`. (Not the
    switch `core.gemm.centered_residues`.)"""
    L, bm, bn = c.shape
    if c.dtype == torch.int8:
        return c.reshape(L * bm, bn)
    if c.dtype == torch.uint8:
        return (c ^ 0x80).view(torch.int8).reshape(L * bm, bn)
    r = mod_reduce(c.to(torch.int64), num_moduli)
    return (r - 128).to(torch.int8).reshape(L * bm, bn)


_MXU_CHUNK = 1 << 22   # elements a contraction of accumulate_mxu takes


def accumulate_mxu(r: torch.Tensor, num_moduli: int):
    """The redundant 16-bit limbs (int64, each in [0, 2^29)) of X = sum_j
    w_j r_j from (L, m, n) residues (int8 holding r - 128, uint8, or raw
    int32 products), through the compact contraction of
    `crt_mxu_weights` on the centred residues, as the reconstruct kernel
    forms it on the tensor cores."""
    L = num_moduli
    wc, cl = crt_mxu_weights(L)
    flat = r.reshape(L, 1, -1)
    parts = []
    for e0 in range(0, flat.shape[2], _MXU_CHUNK):  # bounds the f64 copies
        rc = centered_residue_block(flat[:, :, e0:e0 + _MXU_CHUNK], L)
        parts.append(crt_accumulate_mxu(rc, wc, L, cl, 1, rc.shape[1]))
    return [torch.cat([p[l] for p in parts], dim=1).reshape(r.shape[1:])
            for l in range(len(cl))]


def fold_chunk_(limbs: torch.Tensor, r: torch.Tensor, num_moduli: int,
                moduli_idx) -> torch.Tensor:
    """limbs[l] += sum_jj w[j, l] * r[jj], j = moduli_idx[jj], in place:
    the sums of `accumulate_weighted` on one (num_limbs, ...) int32 tensor
    instead of a list of int64 tensors (0.54 GB a limb at 8192^2), and
    without its carry pass. Over all of a call's moduli a limb stays below
    20 * 255 * 65535 < 2^29, the JAX package's bound for its int32 limbs,
    so the carries can wait for the reconstruct, whose limb input takes
    such limbs. r: uint8 canonical residues, or int8 holding r - 128.
    Plain tensor ops on limbs' device."""
    nl = tables.num_limbs(num_moduli)
    if limbs.dtype != torch.int32 or limbs.shape[0] != nl:
        raise ValueError(f"expected ({nl}, ...) int32 limbs")
    if r.dtype == torch.int8:
        r = (r.to(torch.int16) + 128).to(torch.uint8)
    elif r.dtype != torch.uint8:
        raise TypeError("residues must be uint8 or int8")
    w = tables.crt_weight_limbs(num_moduli)
    for jj, j in enumerate(moduli_idx):
        for l in range(nl):
            if int(w[j, l]):
                # the uint8 residues are promoted to int32 inside the add
                limbs[l].add_(r[jj], alpha=int(w[j, l]))
    return limbs


def _const_limbs(v: int, n: int):
    return [(v >> (16 * i)) & 0xFFFF for i in range(n)]


def _mod_m_centered(x, num_moduli: int):
    """Reduce limbs x (0 <= x < 255*L*M) mod M and center.
    Returns (mag_limbs, neg) with value = (-1)^neg * mag, mag <= M/2."""
    nl = len(x)
    mm = tables.big_m(num_moduli)
    m_limbs = [int(v) for v in tables.big_m_limbs(num_moduli)]
    top = (mm.bit_length() - 1) // 16
    scale = 16 * (top - 1)
    # f32 estimate of X / M from the top limbs, biased low so that the
    # quotient estimate t_est satisfies t - 1 <= t_est <= t
    xf = torch.zeros(x[0].shape, dtype=torch.float32, device=x[0].device)
    for l in range(max(top - 1, 0), nl):
        xf = xf + x[l].float() * float(2.0 ** (16 * l - scale))
    mf = float((mm >> scale) + 1) if scale >= 0 else float(mm << -scale)
    rinv = float(np.nextafter(np.float32((1.0 - 2.0 ** -18) / mf),
                              np.float32(0.0)))
    t_est = torch.floor(xf * rinv).to(torch.int64)
    x, _ = lb.scale_const_sub(x, t_est, m_limbs)
    d1, b1 = lb.sub_const(x, m_limbs)
    r = lb.select(b1 != 0, x, d1)                       # r in [0, M)
    bh = lb.sub_const_borrow(r, _const_limbs(mm // 2 + 1, nl))
    neg = bh == 0                                        # r > M/2
    mag = lb.select(neg, lb.const_minus(m_limbs, r), r)
    n_mag = (mm.bit_length() - 1 + 15) // 16
    return mag[:n_mag], neg


def _round_to_float(mag, neg, e_fix, mant_bits: int):
    """Round (-1)^neg * mag * 2^e_fix to nearest even. Returns
    (biased_exp, mant_chunks) with the implicit bit stripped; handles
    subnormals, zero and overflow to inf."""
    emax_field = 0x7FF if mant_bits == 53 else 0xFF
    bias = 1023 if mant_bits == 53 else 127
    n_mant_chunks = 4 if mant_bits == 53 else 2
    p = lb.msb_position(mag)
    is_zero = p < 0
    eb = p + e_fix + bias
    sr = p - (mant_bits - 1) + torch.clamp(1 - eb, min=0)
    pre = n_mant_chunks
    u = torch.clamp(sr + 16 * pre, max=16 * (len(mag) + pre) + 1)
    mant, rbit, sticky = lb.shift_right_round(mag, u, n_mant_chunks,
                                              pre_zero_limbs=pre)
    inc = (rbit == 1) & (sticky | ((mant[0] & 1) == 1))
    mant = lb.carry_propagate([mant[0] + inc.to(torch.int64)] + mant[1:])
    ovf_chunk, ovf_bit = mant_bits // 16, mant_bits % 16
    overflowed = (mant[ovf_chunk] >> ovf_bit) & 1
    mant[ovf_chunk] = mant[ovf_chunk] & ((1 << ovf_bit) - 1)
    top_chunk, top_bit = (mant_bits - 1) // 16, (mant_bits - 1) % 16
    top_clear = ~(1 << top_bit) & 0xFFFF
    eb_eff = torch.where(eb <= 0, 0, eb) + overflowed
    subnormal_now = eb_eff == 0
    mant[top_chunk] = torch.where(subnormal_now, mant[top_chunk],
                                  mant[top_chunk] & top_clear)
    # a subnormal that rounds up into the implicit bit becomes the
    # smallest normal
    sub_carry = subnormal_now & (((mant[top_chunk] >> top_bit) & 1) == 1)
    eb_eff = eb_eff + sub_carry.to(torch.int64)
    mant[top_chunk] = torch.where(sub_carry, mant[top_chunk] & top_clear,
                                  mant[top_chunk])
    is_inf = eb_eff >= emax_field
    eb_eff = torch.where(is_inf, emax_field, eb_eff)
    mant = [torch.where(is_inf | is_zero, 0, c) for c in mant]
    eb_eff = torch.where(is_zero, 0, eb_eff)
    return eb_eff, mant


def _assemble_f64(neg, eb, mant) -> torch.Tensor:
    lo = mant[0] | (mant[1] << 16)
    hi = (mant[2] | ((mant[3] & 0xF) << 16) | (eb << 20)
          | (neg.to(torch.int64) << 31))
    return ((hi << 32) | lo).view(torch.float64)


def _assemble_f32(neg, eb, mant) -> torch.Tensor:
    bits = (mant[0] | ((mant[1] & 0x7F) << 16) | (eb << 23)
            | (neg.to(torch.int64) << 31))
    return bits.to(torch.int32).view(torch.float32)


def finalize(x, sft_a, sft_b, num_moduli: int, out_dtype: str,
             e_extra: int = 0) -> torch.Tensor:
    """Mod-M centering, inverse scaling and rounding from weighted limbs."""
    mag, neg = _mod_m_centered(x, num_moduli)
    e_fix = e_extra - (sft_a.to(torch.int64) + sft_b.to(torch.int64))
    if out_dtype == "f64":
        eb, mant = _round_to_float(mag, neg, e_fix, 53)
        return _assemble_f64(neg, eb, mant)
    if out_dtype == "f32":
        eb, mant = _round_to_float(mag, neg, e_fix, 24)
        return _assemble_f32(neg, eb, mant)
    raise ValueError(out_dtype)


def canonical_residues(r: torch.Tensor) -> torch.Tensor:
    """Canonical residues in [0, m_j) from the matmul's output: int8 holds
    r - 128 (centered epilogue), uint8 and wider integers hold r."""
    if r.dtype == torch.int8:
        return r.to(torch.int64) + 128
    return r.to(torch.int64)


def reconstruct(r: torch.Tensor, sft_a: torch.Tensor, sft_b: torch.Tensor,
                num_moduli: int, out_dtype: str = "f64", e_extra: int = 0,
                input_kind: str = "residues") -> torch.Tensor:
    """(L, m, n) residues (see canonical_residues; int32 holds raw slice
    products, reduced here) + shifts (m, 1), (1, n) -> (m, n) float64
    ('f64') or float32 ('f32') tensor. input_kind="limbs": r is the
    weighted sum itself as (num_limbs, m, n) 16-bit limbs, canonical or
    with each limb nonnegative and below 2^29."""
    if input_kind == "limbs":
        x = [r[i].to(torch.int64) for i in range(r.shape[0])]
    elif input_kind != "residues":
        raise ValueError(f"input_kind {input_kind!r}")
    elif r.dtype == torch.int32:
        x = accumulate_weighted(mod_reduce(r.to(torch.int64), num_moduli),
                                num_moduli)
    else:
        x = accumulate_weighted(canonical_residues(r), num_moduli)
    return finalize(x, sft_a, sft_b, num_moduli, out_dtype, e_extra)


def reconstruct_mxu(r: torch.Tensor, sft_a: torch.Tensor,
                    sft_b: torch.Tensor, num_moduli: int,
                    out_dtype: str = "f64", e_extra: int = 0,
                    input_kind: str = "residues") -> torch.Tensor:
    """`reconstruct` (the same arguments and bits) with the weighted sum
    of residues formed by `accumulate_mxu`, the reconstruct kernel's route;
    limb input skips the sum. Its plain version."""
    if input_kind == "limbs":
        return reconstruct(r, sft_a, sft_b, num_moduli, out_dtype, e_extra,
                           input_kind)
    if input_kind != "residues":
        raise ValueError(f"input_kind {input_kind!r}")
    return finalize(accumulate_mxu(r, num_moduli), sft_a, sft_b, num_moduli,
                    out_dtype, e_extra)
