"""GEMM-emulation orchestrator: shifts -> residue slices -> int8 matmul
with the mod in its epilogue -> CRT reconstruct.

Counterpart of the one-shot schedule of `gemmul8_tpu/core/gemm.py`
`gemm_core` (its Pallas branch), in fast and accurate mode. Each step goes
through a wrapper of `gemmul8_tpu_torch.hopper`, which launches the Hopper
kernel for CUDA tensors and runs the plain PyTorch version for CPU tensors.

The JAX package's switches are read at call time from the environment,
with its values and defaults; every variant gives the default's bits:
- GEMMUL8_FUSED_ENCODE=1 (fast mode): shifts and slices of each operand
  from one kernel, `fast_encode_fused`;
- GEMMUL8_MXU_CRT (default "1"): "0" makes the matmul emit canonical uint8
  residues instead of centered int8 ones, which GEMMUL8_MM_PIPELINE=1 then
  sends to `matmul_mod_u8_pipelined`;
- GEMMUL8_FUSED_MAG7=1 and GEMMUL8_MAGMAX_SCRATCH=1 (accurate mode) are
  read by `hopper.kernels.mag7_operand` and `hopper.matmul.magmax_matmul`;
- GEMMUL8_FUSED_RECONSTRUCT=1 and GEMMUL8_PIPELINE in 1..3 select kernels
  not ported yet (ROADMAP B14, B15) and raise NotImplementedError.
GEMMUL8_MXU_ENC is not read: in the JAX package it picks a contraction
inside `encode_slices_pallas` that works around the TPU's slow integer
division, with the same bits; the port's encode kernel has one form.
"""

from __future__ import annotations

import os

import torch

from .. import tables
from ..hopper import kernels as hk
from ..hopper import matmul as hm
from . import encode as enc


def check_shapes(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("operands must be 2-D")
    m, ka = a.shape
    kb, n = b.shape
    if ka != kb or ka == 0:
        raise ValueError(f"inner dims mismatch or empty: {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if ka > tables.MAX_K:
        raise ValueError(f"k={ka} exceeds the int32-exactness bound 2^17")
    return m, ka, n


def accurate_sfts(a: torch.Tensor, b: torch.Tensor, num_moduli: int):
    """Accurate-mode shifts (sft_a (m, 1), sft_b (1, n)) int32: 7-bit
    round-up magnitudes of both operands, one int8 GEMM |A| x |B| with its
    row/col max, then the shifts from those maxima (the counterpart of the
    JAX package's `accurate_sfts`, whose Pallas and jnp branches agree bit
    for bit)."""
    mag_a, emax_a = hk.mag7_operand(a, axis=1)
    mag_b, emax_b = hk.mag7_operand(b, axis=0)
    smax_a, smax_b = hm.magmax_matmul(mag_a, mag_b)
    return (enc.accurate_sft(smax_a, emax_a, num_moduli),
            enc.accurate_sft(smax_b, emax_b, num_moduli))


def gemm_core(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
              fastmode: bool = True, out_dtype: str = "f64",
              moduli_chunk: int | None = None,
              alpha_e: int = 0) -> torch.Tensor:
    """C = 2^alpha_e * A @ B emulated with num_moduli int8 GEMMs.
    a: (m, k), b: (k, n) float64 tensors on one device. fastmode=False
    takes the shifts from `accurate_sfts`."""
    check_shapes(a, b)
    if not fastmode and (out_dtype != "f64" or a.dtype != torch.float64
                         or b.dtype != torch.float64):
        raise NotImplementedError(
            "accurate mode with f32 operands or output: ROADMAP A4")
    if moduli_chunk is not None and moduli_chunk < num_moduli:
        raise NotImplementedError("moduli-chunked schedule: ROADMAP A6")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    check_unported_switches()
    a, b = a.contiguous(), b.contiguous()
    if fastmode and os.environ.get("GEMMUL8_FUSED_ENCODE") == "1":
        a8, sft_a = hk.fast_encode_fused(a, num_moduli, axis=1)
        b8, sft_b = hk.fast_encode_fused(b, num_moduli, axis=0)
    else:
        if fastmode:
            sft_a = hk.fast_sft(a, num_moduli, axis=1)
            sft_b = hk.fast_sft(b, num_moduli, axis=0)
        else:
            sft_a, sft_b = accurate_sfts(a, b, num_moduli)
        a8 = hk.encode_slices(a, sft_a, num_moduli, axis=1)
        b8 = hk.encode_slices(b, sft_b, num_moduli, axis=0)
    r8 = hm.matmul_mod_u8(a8, b8, num_moduli, centered=centered_residues())
    del a8, b8
    return hk.reconstruct(r8, sft_a, sft_b, num_moduli, out_dtype,
                          e_extra=alpha_e)


def centered_residues() -> bool:
    """GEMMUL8_MXU_CRT (default "1"): whether the matmul emits centered
    int8 residues for the reconstruct (else canonical uint8), as the JAX
    package's `mxu_crt_default`."""
    return os.environ.get("GEMMUL8_MXU_CRT", "1") == "1"


def check_unported_switches() -> None:
    """Raise on the JAX package's switches whose kernels are not ported,
    rather than run the default kernels under them."""
    pipe = os.environ.get("GEMMUL8_PIPELINE") or "0"
    if pipe not in ("0", "1", "2", "3"):
        raise ValueError(
            f"GEMMUL8_PIPELINE={pipe!r}: expected one of '0','1','2','3'")
    if pipe != "0":
        raise NotImplementedError(
            f"GEMMUL8_PIPELINE={pipe}: the panel/rider pipeline kernels "
            "are not ported (ROADMAP B15)")
    if os.environ.get("GEMMUL8_FUSED_RECONSTRUCT") == "1":
        raise NotImplementedError(
            "GEMMUL8_FUSED_RECONSTRUCT=1: the fused matmul + reconstruct "
            "kernel is not ported (ROADMAP B14)")
