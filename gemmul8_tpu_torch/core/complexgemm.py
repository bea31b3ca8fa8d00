"""Complex GEMM emulation: three strategies over the residue engine.

Counterpart of `gemmul8_tpu/core/complexgemm.py` `gemm_complex_core`, its
Pallas branch (`use_pallas=True`), and of its `_canon_complex`: a complex128
operand is carried as a float64 (Re, Im) pair, a complex64 one as a
float32 pair, and each operand is encoded at its own word (a c128 x c64
call is not widened), as the JAX package dispatches per operand:

- Re and Im of each row of A and each column of B share one shift, taken
  from the joint norm of both parts (fast mode: `enc.joint_fast_sft`) or
  from |Re| + |Im| magnitudes at one bit less (accurate mode:
  `accurate_sfts_complex`);
- the four parts are encoded into int8 residue slices;
- one complex residue GEMM computes the Re and Im residues: in 4-dot form
  (RR - II, IR + RI) for COMPLEX_BIG_MATRIX_ENCODE and COMPLEX_CLASSIC_MULT,
  whose block products are the same exact sums, and in 3-dot form with the
  recentered sum slices for COMPLEX_KARATSUBA_MULT;
- Re and Im are reconstructed from their residues, into float64 or
  float32: centered int8, or canonical uint8 under GEMMUL8_MXU_CRT=0
  (`gemm.centered_residues`).

Accurate mode's magnitude GEMM takes the deferred-fold kernel under
GEMMUL8_MAGMAX_SCRATCH=1, as the JAX package's does; its magnitudes stay
the emax + mag7 pair whatever GEMMUL8_FUSED_MAG7 says, as in
`_mag7_complex_pallas`.

All three strategies compute the same exact residues, so on the same
shifts they give the same output bits. Each step goes through a wrapper of
`gemmul8_tpu_torch.hopper`: the Hopper kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import tables, trace
from ..hopper import kernels as hk
from ..hopper import matmul as hm
from ..types import ComputeType
from . import encode as enc
from . import slicegemm as sg
from .gemm import centered_residues, check_shapes

# bounds on k per strategy that keep every int32 accumulation exact: the
# 4-dot forms sum two products of k terms, Karatsuba combines three
_KMAX = {
    ComputeType.COMPLEX_BIG_MATRIX_ENCODE: tables.MAX_K // 2,
    ComputeType.COMPLEX_CLASSIC_MULT: tables.MAX_K // 2,
    ComputeType.COMPLEX_KARATSUBA_MULT: tables.MAX_K // 4,
}


def accurate_sfts_complex(a_re, a_im, b_re, b_im, num_moduli: int):
    """Accurate-mode shifts (sft_a (m, 1), sft_b (1, n)) int32 shared by Re
    and Im: |Re| + |Im| magnitudes at MAG_SHIFT_COMPLEX below each row's
    and column's joint max exponent, one int8 GEMM of them with its row/col
    max, then the shifts, each at its operand's exponent bias (the
    counterpart of `_accurate_sfts_pallas`)."""
    mag_a, emax_a = hk.mag7_operand_complex(a_re, a_im, axis=1)
    mag_b, emax_b = hk.mag7_operand_complex(b_re, b_im, axis=0)
    smax_a, smax_b = hm.magmax_matmul(mag_a, mag_b)
    return (enc.accurate_sft(smax_a, emax_a, num_moduli,
                             enc.MAG_SHIFT_COMPLEX,
                             mant_bits=enc.mant_bits_of(a_re)),
            enc.accurate_sft(smax_b, emax_b, num_moduli,
                             enc.MAG_SHIFT_COMPLEX,
                             mant_bits=enc.mant_bits_of(b_re)))


def encode_complex_operands(a_re, a_im, b_re, b_im, num_moduli: int,
                            fastmode: bool):
    """(a8r, a8i, sft_a, b8r, b8i, sft_b): the shared shifts and the int8
    residue slices of the four parts, B's K-major (`enc.KMajorSlices`, read
    by the residue GEMM without a copy)."""
    if fastmode:
        sft_a = enc.joint_fast_sft(a_re, a_im, num_moduli, 1,
                                   stats=hk.fast_stats)
        sft_b = enc.joint_fast_sft(b_re, b_im, num_moduli, 0,
                                   stats=hk.fast_stats)
    else:
        sft_a, sft_b = accurate_sfts_complex(a_re, a_im, b_re, b_im,
                                             num_moduli)
    return (hk.encode_slices(a_re, sft_a, num_moduli, axis=1),
            hk.encode_slices(a_im, sft_a, num_moduli, axis=1), sft_a,
            hk.encode_slices(b_re, sft_b, num_moduli, axis=0, k_major=True),
            hk.encode_slices(b_im, sft_b, num_moduli, axis=0, k_major=True),
            sft_b)


@trace.traced("gm8.core.gemm_complex_core")
def gemm_complex_core(a_re, a_im, b_re, b_im, num_moduli: int,
                      fastmode: bool, compute_type: ComputeType,
                      out_dtype: str = "f64", e_extra: int = 0):
    """(Re, Im) of 2^e_extra * (A_re + i A_im) @ (B_re + i B_im), emulated
    with num_moduli residues, float64 (out_dtype "f64") or float32 ("f32"):
    (m, k) and (k, n) parts on one device, an operand's two parts both
    float64 or both float32. REAL_DEFAULT means
    COMPLEX_BIG_MATRIX_ENCODE."""
    if compute_type in (ComputeType.REAL_DEFAULT, None):
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    _, k, _ = check_shapes(a_re, b_re)
    if k > _KMAX[compute_type]:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound for {compute_type}")
    if out_dtype not in ("f64", "f32"):
        raise ValueError(f"out_dtype {out_dtype!r}: expected 'f64' or 'f32'")
    parts = [x.contiguous() for x in (a_re, a_im, b_re, b_im)]
    for re, im in (parts[:2], parts[2:]):
        if im.shape != re.shape or im.dtype != re.dtype:
            raise ValueError("Re and Im of an operand must have one shape "
                             "and one dtype")
        enc.mant_bits_of(re)
    if any(x.device != parts[0].device for x in parts):
        raise ValueError("operands on more than one device")
    a8r, a8i, sft_a, b8r, b8i, sft_b = encode_complex_operands(
        *parts, num_moduli, fastmode)
    kara = None
    if compute_type == ComputeType.COMPLEX_KARATSUBA_MULT:
        kara = (sg.recenter_add_int8(a8r, a8i, num_moduli),
                sg.recenter_add_int8(b8r, b8i, num_moduli))
    r_re, r_im = hm.matmul_complex_mod(a8r, a8i, b8r, b8i, num_moduli,
                                       centered=centered_residues(),
                                       kara=kara)
    del a8r, a8i, b8r, b8i, kara
    return (hk.reconstruct(r_re, sft_a, sft_b, num_moduli, out_dtype,
                           e_extra=e_extra),
            hk.reconstruct(r_im, sft_a, sft_b, num_moduli, out_dtype,
                           e_extra=e_extra))


def complex_kind(x: torch.Tensor) -> str:
    """"c128" for a complex128 or float64 operand of a complex call, "c64"
    for complex64 or any other real dtype (float32, float16, bfloat16 and
    integers widen to float32), as the JAX package's `_canon_complex`
    sorts them; other complex dtypes raise TypeError."""
    if x.is_complex() and x.dtype not in (torch.complex128, torch.complex64):
        raise TypeError(f"unsupported complex dtype {x.dtype}")
    return "c128" if x.dtype in (torch.complex128, torch.float64) else "c64"


def flip_sign(x: torch.Tensor) -> torch.Tensor:
    """-x by its sign bit alone (float64 or float32): -0.0 from +0.0 and
    every NaN payload kept, as numpy's negation and the JAX package's
    conjugate of a C64Bits operand give them."""
    if x.dtype == torch.float64:
        return (x.contiguous().view(torch.int64) ^ (-(1 << 63))).view(
            torch.float64)
    return (x.contiguous().view(torch.int32) ^ (-(1 << 31))).view(
        torch.float32)


def canon_complex(x: torch.Tensor, op: str = "N"):
    """(Re, Im) contiguous parts of op(x) for an operand of a complex
    call, every bit kept (-0.0 and NaN payloads included): complex128 ->
    its two float64 parts; float64 -> itself and +0.0 zeros; complex64 ->
    its two float32 parts; any other real dtype -> widened to float32
    (exactly) and +0.0 zeros. op "T" transposes; "C" transposes and, on a
    complex operand, flips the sign bit of every Im word (a real operand's
    conjugate is itself). A tensor with torch's lazy conjugate bit gives
    the parts of its value, the sign bits flipped the same way."""
    kind = complex_kind(x)
    if op not in ("N", "T", "C"):
        raise ValueError(f"op must be N/T/C, got {op}")
    if x.is_complex():
        lazy = x.is_conj()
        if lazy:
            x = x.conj()   # the stored words, the bit cleared
        re, im = x.real, x.imag
        if lazy != (op == "C"):
            im = flip_sign(im)
    else:
        re = x if kind == "c128" else x.to(torch.float32)
        im = None
    if op != "N":
        re = re.t()
        im = None if im is None else im.t()
    re = re.contiguous()
    return re, (torch.zeros_like(re) if im is None else im.contiguous())
