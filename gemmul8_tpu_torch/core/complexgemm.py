"""Complex GEMM emulation: three strategies over the residue engine.

Counterpart of `gemmul8_tpu/core/complexgemm.py` `gemm_complex_core`, its
Pallas branch (`use_pallas=True`), for complex128 operands carried as
float64 (Re, Im) pairs:

- Re and Im of each row of A and each column of B share one shift, taken
  from the joint norm of both parts (fast mode: `enc.joint_fast_sft`) or
  from |Re| + |Im| magnitudes at one bit less (accurate mode:
  `accurate_sfts_complex`);
- the four parts are encoded into int8 residue slices;
- one complex residue GEMM computes the Re and Im residues: in 4-dot form
  (RR - II, IR + RI) for COMPLEX_BIG_MATRIX_ENCODE and COMPLEX_CLASSIC_MULT,
  whose block products are the same exact sums, and in 3-dot form with the
  recentered sum slices for COMPLEX_KARATSUBA_MULT;
- Re and Im are reconstructed from their residues: centered int8, or
  canonical uint8 under GEMMUL8_MXU_CRT=0 (`gemm.centered_residues`).

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

from .. import tables
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
    max, then the shifts (the counterpart of `_accurate_sfts_pallas`)."""
    mag_a, emax_a = hk.mag7_operand_complex(a_re, a_im, axis=1)
    mag_b, emax_b = hk.mag7_operand_complex(b_re, b_im, axis=0)
    smax_a, smax_b = hm.magmax_matmul(mag_a, mag_b)
    return (enc.accurate_sft(smax_a, emax_a, num_moduli,
                             enc.MAG_SHIFT_COMPLEX),
            enc.accurate_sft(smax_b, emax_b, num_moduli,
                             enc.MAG_SHIFT_COMPLEX))


def encode_complex_operands(a_re, a_im, b_re, b_im, num_moduli: int,
                            fastmode: bool):
    """(a8r, a8i, sft_a, b8r, b8i, sft_b): the shared shifts and the int8
    residue slices of the four parts."""
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
            hk.encode_slices(b_re, sft_b, num_moduli, axis=0),
            hk.encode_slices(b_im, sft_b, num_moduli, axis=0), sft_b)


def gemm_complex_core(a_re, a_im, b_re, b_im, num_moduli: int,
                      fastmode: bool, compute_type: ComputeType,
                      out_dtype: str = "f64", e_extra: int = 0):
    """(Re, Im) of 2^e_extra * (A_re + i A_im) @ (B_re + i B_im), emulated
    with num_moduli residues: float64 (m, k) and (k, n) parts on one
    device. REAL_DEFAULT means COMPLEX_BIG_MATRIX_ENCODE."""
    if compute_type in (ComputeType.REAL_DEFAULT, None):
        compute_type = ComputeType.COMPLEX_BIG_MATRIX_ENCODE
    _, k, _ = check_shapes(a_re, b_re)
    if k > _KMAX[compute_type]:
        raise ValueError(
            f"k={k} exceeds the int32-exactness bound for {compute_type}")
    if out_dtype != "f64":
        raise NotImplementedError("complex64 output: ROADMAP A4")
    parts = [x.contiguous() for x in (a_re, a_im, b_re, b_im)]
    if any(x.dtype != torch.float64 for x in parts):
        raise NotImplementedError("complex64 operands: ROADMAP A4")
    if parts[1].shape != parts[0].shape or parts[3].shape != parts[2].shape:
        raise ValueError("Re and Im of an operand must have one shape")
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


def canon_complex(x: torch.Tensor):
    """(Re, Im) float64 contiguous parts of a complex operand, every bit
    kept (-0.0 and NaN payloads included): complex128 -> its two parts;
    float64 -> itself and +0.0 zeros. Other dtypes raise (ROADMAP A4)."""
    if x.dtype == torch.complex128:
        return x.real.contiguous(), x.imag.contiguous()
    if x.dtype == torch.float64:
        return x.contiguous(), torch.zeros_like(x)
    raise NotImplementedError(
        f"{x.dtype} in a complex GEMM: ROADMAP A4 (only complex128 and "
        "float64 are ported)")
