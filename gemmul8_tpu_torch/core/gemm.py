"""GEMM-emulation orchestrator: shifts -> residue slices -> int8 matmul
with the mod in its epilogue -> CRT reconstruct.

Counterpart of `gemmul8_tpu/core/gemm.py` `gemm_core` and
`gemm_core_panels` (their Pallas branches), in fast and accurate mode, for
float64 or float32 operands (each encoded at its own significand width, as
the JAX package dispatches per operand) and f64 or f32 output, with their
schedules: one-shot; moduli-chunked (the low-memory mode: only
`moduli_chunk` residue slices of each operand exist at a time; each chunk's
residues are folded into the int32 CRT limbs before the next chunk is
encoded, and the reconstruct kernel finishes from the limbs); the
panel/rider pipeline (`gemmul8_tpu_torch.pipelined`); and column panels
(`gemm_core_panels`: B and the output one n-panel at a time). Each step
goes through a wrapper of `gemmul8_tpu_torch.hopper`, which launches the
Hopper kernel for CUDA tensors and runs the plain PyTorch version for CPU
tensors.

The JAX package's switches are read at call time from the environment,
with its values and defaults; every variant gives the default's bits:
- GEMMUL8_FUSED_ENCODE=1 (fast mode): shifts and slices of each operand
  from one kernel, `fast_encode_fused`;
- GEMMUL8_MXU_CRT (default "1"): "0" makes the matmul emit canonical uint8
  residues instead of centered int8 ones, which GEMMUL8_MM_PIPELINE=1 then
  sends to `matmul_mod_u8_pipelined`;
- GEMMUL8_FUSED_MAG7=1 and GEMMUL8_MAGMAX_SCRATCH=1 (accurate mode) are
  read by `hopper.kernels.mag7_operand` and `hopper.matmul.magmax_matmul`;
- GEMMUL8_FUSED_RECONSTRUCT=1 (one-shot schedule, alpha_e == 0): the
  matmul and the reconstruct from one kernel, `matmul_reconstruct`;
- GEMMUL8_PIPELINE (default "0"; 1 reconstruct rider, 2 and the encode
  rider, 3 and the B split): the one-shot schedule with alpha_e == 0 and
  selected shifts (not under GEMMUL8_FUSED_ENCODE=1) runs the panel/rider
  pipeline where `pipelined.choose_panels` finds panels, before
  GEMMUL8_FUSED_RECONSTRUCT is looked at; the column-panel schedule runs it
  per column panel at level 1 (any level above 0), as the JAX package's.
GEMMUL8_MXU_ENC is not read: in the JAX package it picks a contraction
inside `encode_slices_pallas` that works around the TPU's slow integer
division, with the same bits; the port's encode kernel has one form.
GEMMUL8_RIDER_UNCOND is not read either: it drops the TPU riders' predicates,
with the same bits (`gemmul8_tpu_torch.pipelined`).
Every switch's kernels have their f32 forms too (the pipeline's riders
read each operand's own word and write the output's), so every switch acts
on f32, mixed and f32-output calls as on f64 ones. MXU_CRT and MM_PIPELINE
act on int8 data.

`gemm_phases` splits the default one-shot call into the four phases that
`api.gemm_timed` times (the JAX package's `gemm_phases`).

B's slices are encoded K-major (`hk.encode_slices(..., k_major=True)`), the
layout the residue GEMM reads without a copy, in the default one-shot
schedule, the chunked one, the column panels and `gemm_phases`. The
fused-reconstruct branch, the fused encode, the panel/rider pipeline and
`matmul_crt` take N-major slices, which their kernels copy K-major.

The real schedules make each operand contiguous before its shifts are
taken; `OPERAND_COPIES` counts, by operand "a" or "b", the times that made
a copy (an operand given as a strided view: a block of a larger matrix, a
transpose), while `trace.recording()` is on.
"""

from __future__ import annotations

import collections
import os

import torch

from .. import pipelined as pl
from .. import tables, trace
from ..hopper import kernels as hk
from ..hopper import matmul as hm
from ..planner import ModuliSchedule
from . import encode as enc
from . import reconstruct as rec


# copies of a strided operand by the real schedules' `.contiguous()`, by
# operand "a" or "b", counted while trace.recording() is on; reset by
# their reader
OPERAND_COPIES: collections.Counter = collections.Counter()


def contiguous_operands(a: torch.Tensor, b: torch.Tensor):
    """(a, b) made contiguous; while recording, each one copied counts in
    `OPERAND_COPIES`."""
    if trace.active():
        OPERAND_COPIES.update(name for name, x in (("a", a), ("b", b))
                              if not x.is_contiguous())
    return a.contiguous(), b.contiguous()


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
    row/col max, then the shifts from those maxima, each at its operand's
    exponent bias (the counterpart of the JAX package's `accurate_sfts`,
    whose Pallas and jnp branches agree bit for bit)."""
    mag_a, emax_a = hk.mag7_operand(a, axis=1)
    mag_b, emax_b = hk.mag7_operand(b, axis=0)
    smax_a, smax_b = hm.magmax_matmul(mag_a, mag_b)
    return (enc.accurate_sft(smax_a, emax_a, num_moduli,
                             mant_bits=enc.mant_bits_of(a)),
            enc.accurate_sft(smax_b, emax_b, num_moduli,
                             mant_bits=enc.mant_bits_of(b)))


def _check_call(a: torch.Tensor, b: torch.Tensor, out_dtype: str) -> None:
    """Check the operands (float64 or float32, on one device) and the
    output kind."""
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if out_dtype not in ("f64", "f32"):
        raise ValueError(f"out_dtype {out_dtype!r}: expected 'f64' or 'f32'")
    enc.mant_bits_of(a)
    enc.mant_bits_of(b)


@trace.traced("gm8.core.gemm_core")
def gemm_core(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
              fastmode: bool = True, out_dtype: str = "f64",
              moduli_chunk: int | None = None,
              alpha_e: int = 0) -> torch.Tensor:
    """C = 2^alpha_e * A @ B emulated with num_moduli int8 GEMMs.
    a: (m, k), b: (k, n) float64 or float32 tensors on one device, in any
    combination; out_dtype "f64" or "f32". fastmode=False takes the shifts
    from `accurate_sfts`. moduli_chunk < num_moduli runs the
    moduli-chunked schedule, with the one-shot call's bits."""
    m, k, n = check_shapes(a, b)
    _check_call(a, b, out_dtype)
    if moduli_chunk is not None and moduli_chunk < 1:
        raise ValueError(f"moduli_chunk={moduli_chunk}: expected >= 1")
    a, b = contiguous_operands(a, b)
    one_shot = moduli_chunk is None or moduli_chunk >= num_moduli
    # read where the JAX package reads it: an invalid value raises even
    # where the pipeline cannot run (FUSED_ENCODE)
    pipe = pl.pipeline_mode() if one_shot and alpha_e == 0 else 0
    # chosen before B is encoded: the fused kernel takes B N-major
    fused = (one_shot and alpha_e == 0
             and os.environ.get("GEMMUL8_FUSED_RECONSTRUCT") == "1"
             and hm.fused_reconstruct_ok(m, n, k, num_moduli))
    if (fastmode and one_shot
            and os.environ.get("GEMMUL8_FUSED_ENCODE") == "1"):
        a8, sft_a = hk.fast_encode_fused(a, num_moduli, axis=1)
        b8, sft_b = hk.fast_encode_fused(b, num_moduli, axis=0)
    else:
        # the shifts do not depend on the chunk: selected once
        if fastmode:
            sft_a = hk.fast_sft(a, num_moduli, axis=1)
            sft_b = hk.fast_sft(b, num_moduli, axis=0)
        else:
            sft_a, sft_b = accurate_sfts(a, b, num_moduli)
        if not one_shot:
            return _gemm_chunked(a, b, sft_a, sft_b, num_moduli,
                                 moduli_chunk, out_dtype, alpha_e)
        cfg = (pl.choose_panels(m, n, k, num_moduli, encode_rider=pipe >= 2)
               if pipe else None)
        if cfg:
            bsp = pipe == 3 and pl.bsplit_applicable(m, n, k, num_moduli,
                                                     *cfg)
            return pl.gemm_pipelined(a, b, num_moduli, out_dtype,
                                     panel_m=cfg[0], bn=cfg[1],
                                     sfts=(sft_a, sft_b),
                                     encode_rider=pipe >= 2, b_rider=bsp)
        a8 = hk.encode_slices(a, sft_a, num_moduli, axis=1)
        b8 = hk.encode_slices(b, sft_b, num_moduli, axis=0,
                              k_major=not fused)
    if fused:
        return hm.matmul_reconstruct(a8, b8, sft_a, sft_b, num_moduli,
                                     out_dtype)
    r8 = hm.matmul_mod_u8(a8, b8, num_moduli, centered=centered_residues())
    del a8, b8
    return hk.reconstruct(r8, sft_a, sft_b, num_moduli, out_dtype,
                          e_extra=alpha_e)


@trace.traced("gm8.core.gemm_chunked")
def _gemm_chunked(a, b, sft_a, sft_b, num_moduli: int, moduli_chunk: int,
                  out_dtype: str, alpha_e: int) -> torch.Tensor:
    """The moduli-chunked schedule on shifts already selected: per chunk,
    encode its slices of A and B, multiply them mod their moduli, fold the
    residues into the (num_limbs, m, n) int32 CRT limbs in place, and free
    the chunk before the next one is made; then reconstruct from the
    limbs."""
    limbs = None
    for j0, width in ModuliSchedule(num_moduli, moduli_chunk).chunks():
        idx = tuple(range(j0, j0 + width))
        a8 = hk.encode_slices(a, sft_a, num_moduli, axis=1, moduli_idx=idx)
        b8 = hk.encode_slices(b, sft_b, num_moduli, axis=0, moduli_idx=idx,
                              k_major=True)
        r8 = hm.matmul_mod_u8(a8, b8, num_moduli, moduli_idx=idx)
        del a8, b8
        if limbs is None:
            limbs = torch.zeros(
                (tables.num_limbs(num_moduli), *r8.shape[1:]),
                dtype=torch.int32, device=r8.device)
        rec.fold_chunk_(limbs, r8, num_moduli, idx)
        del r8
    return hk.reconstruct(limbs, sft_a, sft_b, num_moduli, out_dtype,
                          e_extra=alpha_e, input_kind="limbs")


def centered_residues() -> bool:
    """GEMMUL8_MXU_CRT (default "1"): whether the matmul emits centered
    int8 residues for the reconstruct (else canonical uint8), as the JAX
    package's `mxu_crt_default`."""
    return os.environ.get("GEMMUL8_MXU_CRT", "1") == "1"


@trace.traced("gm8.core.gemm_core_panels")
def gemm_core_panels(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
                     fastmode: bool = True, out_dtype: str = "f64",
                     n_panel: int | None = None,
                     alpha_e: int = 0) -> torch.Tensor:
    """The column-panel schedule: C = 2^alpha_e * A @ B with B, its slices,
    its residues and the output's columns made n_panel columns at a time,
    so that the residue memory follows the panel's width. Each panel's
    result goes into its columns of one (m, n) output. Fast mode encodes A
    once (B's shifts are per column, so the bits are the one-shot call's);
    accurate mode takes the shifts, and A's slices, anew for each panel
    (they depend on B), as the JAX package's `gemm_core_panels` does. With
    GEMMUL8_PIPELINE above 0 (and alpha_e == 0) a panel that
    `pipelined.choose_panels` takes runs the panel/rider pipeline (the
    reconstruct rider) on A's slices. Operands and output as in
    `gemm_core`; the output is allocated once in its dtype."""
    m, k, n = check_shapes(a, b)
    _check_call(a, b, out_dtype)
    if n_panel is None or n_panel < 1:
        raise ValueError(f"n_panel={n_panel}: expected >= 1")
    a, b = contiguous_operands(a, b)
    out = torch.empty((m, n), dtype=torch.float32 if out_dtype == "f32"
                      else torch.float64, device=a.device)
    sft_a = hk.fast_sft(a, num_moduli, axis=1) if fastmode else None
    a8 = None
    for j0 in range(0, n, n_panel):
        bp = b[:, j0:j0 + n_panel].contiguous()
        if fastmode:
            sft_b = hk.fast_sft(bp, num_moduli, axis=0)
        else:
            sft_a, sft_b = accurate_sfts(a, bp, num_moduli)
            a8 = None  # accurate shifts depend on B: A is encoded anew
        if a8 is None:
            a8 = hk.encode_slices(a, sft_a, num_moduli, axis=1)
        cfg = (pl.choose_panels(m, bp.shape[1], k, num_moduli)
               if pl.pipeline_mode() and alpha_e == 0 else None)
        if cfg:
            piece = pl.gemm_pipelined(a, bp, num_moduli, out_dtype,
                                      panel_m=cfg[0], bn=cfg[1],
                                      sfts=(sft_a, sft_b), a8=a8)
        else:
            b8 = hk.encode_slices(bp, sft_b, num_moduli, axis=0,
                                  k_major=True)
            r8 = hm.matmul_mod_u8(a8, b8, num_moduli,
                                  centered=centered_residues())
            del b8
            piece = hk.reconstruct(r8, sft_a, sft_b, num_moduli, out_dtype,
                                   e_extra=alpha_e)
            del r8
        out[:, j0:j0 + bp.shape[1]] = piece
        del bp, piece
    return out


def gemm_phases(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
                fastmode: bool = True, out_dtype: str = "f64"):
    """The default one-shot call as four callables, for phase timing (the
    JAX package's `gemm_phases`, the reference's four-part breakdown):
    encode(a, b) -> (a8, sft_a, b8, sft_b), the shifts (fast_sft, or the
    accurate pre-phase) and encode_slices of both operands (B's K-major);
    matmul(a8, b8) -> the int8 GEMMs with the mod in their epilogue
    (matmul_mod_u8, int8 residues); mod(r) -> r, the identity, since the
    mod ran in the GEMM's epilogue; reconstruct(r, sft_a, sft_b) -> the
    (m, n) result. They run the default kernels whatever the switches say,
    and give the default `gemm_core` call's bits."""
    check_shapes(a, b)
    _check_call(a, b, out_dtype)

    def encode(a, b):
        a, b = contiguous_operands(a, b)
        if fastmode:
            sft_a = hk.fast_sft(a, num_moduli, axis=1)
            sft_b = hk.fast_sft(b, num_moduli, axis=0)
        else:
            sft_a, sft_b = accurate_sfts(a, b, num_moduli)
        return (hk.encode_slices(a, sft_a, num_moduli, axis=1), sft_a,
                hk.encode_slices(b, sft_b, num_moduli, axis=0, k_major=True),
                sft_b)

    def matmul(a8, b8):
        return hm.matmul_mod_u8(a8, b8, num_moduli, centered=True)

    def mod(r):
        return r

    def reconstruct(r, sft_a, sft_b):
        return hk.reconstruct(r, sft_a, sft_b, num_moduli, out_dtype)

    return encode, matmul, mod, reconstruct
