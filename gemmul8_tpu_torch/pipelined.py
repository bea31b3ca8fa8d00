"""The panel/rider pipeline: GEMM emulation with the m axis split into
panels, each panel's int8 GEMM carrying the CRT reconstruct of the panel
before it (and optionally the encode of the panel after it) as riders.

Counterpart of `gemmul8_tpu/pallas/pipelined.py`, for f64 and f32
operands in any combination and f64 or f32 output, fast and accurate mode
(the schedule takes the call's shifts; the riders read each operand's own
word and round into the output's, as the JAX package's kinds say). The
launch that forms panel p's residues (`hopper.pipelined.matmul_rider_step`)
also reconstructs panel p-1 into its rows of the one (m, n) output and,
with the encode rider, encodes A-panel p+1; only the first panel's encode
and the last panel's reconstruct (`reconstruct_into`) run bare. With the B
split the first panel runs as two launches over B's column halves
(`matmul_bsplit_pair`), the left one encoding B's right half, so only B's
left half is encoded up front. Every schedule gives the one-shot call's
bits: the bodies are the one-shot path's, and only the order differs.

The gates (`pipeline_mode`, `pipeline_applicable`, `choose_panels`,
`bsplit_applicable`) are the JAX package's, the TPU's tile and VMEM limits
included, so that the same calls take the same schedule in both packages;
`bn` is the TPU matmul's column tile and enters only the gates (the card's
tile is 128 x 128).

GEMMUL8_RIDER_UNCOND is not read: in the JAX package it drops the
predicates around a lone rider, a Mosaic code-generation choice with the
same bits; the port's rider blocks have no predicate to drop.
"""

from __future__ import annotations

import os

import torch

from . import trace
from .core import encode as enc
from .core import riders
from .core.encode import ENC_BLOCK
from .hopper import kernels as hk
from .hopper import pipelined as hp

__all__ = ["ENC_BLOCK", "pipeline_mode", "pipeline_applicable",
           "choose_panels", "bsplit_applicable", "gemm_pipelined"]


def _rider_tiles(pm: int, np_: int, steps: int):
    """Rider tile shape (brm, brn) covering a (pm, np_) panel with at most
    `steps` tiles (one tile per grid step), lane-friendly (brn mult of 128,
    brm mult of 8). Width preference: 512 first (matches the matmul's bn
    tile so rider traffic aligns with the panel steps), then coarser, then
    finer; within a width, the smallest row count that fits — so the VPU
    work spreads as evenly as the width allows. Returns None if nothing
    fits."""
    for brn in (512, 1024, 2048, 256, 128):
        if np_ % brn:
            continue
        ncols = np_ // brn
        for brm in (32, 64, 128, 256, 512, 1024):
            if pm % brm:
                continue
            if (pm // brm) * ncols <= steps:
                return brm, brn
    return None


def pipeline_mode() -> int:
    """Pipeline gate from GEMMUL8_PIPELINE: 0 = off, 1 = reconstruct
    rider, 2 = reconstruct + encode riders, 3 = mode 2 plus the B-split
    first panel (B's right-half encode rides the left-half matmul).
    Default (unset or empty): 0; any other value raises."""
    v = os.environ.get("GEMMUL8_PIPELINE") or "0"
    if v not in ("0", "1", "2", "3"):
        # an explicit-but-invalid opt-in must not silently run unpipelined
        raise ValueError(
            f"GEMMUL8_PIPELINE={v!r}: expected one of '0','1','2','3'")
    return int(v)


def pipeline_applicable(m: int, n: int, k: int, num_moduli: int,
                        panel_m: int = 1024, bn: int = 512,
                        encode_rider: bool = False) -> bool:
    """Shape gates: panel-aligned m, lane-aligned n, full-k-resident A
    panel within VMEM. With encode_rider the middle panels carry TWO riders
    interleaved by step parity, so each rider's tiling must fit in half the
    grid steps."""
    if m % panel_m or m // panel_m < 2:
        return False
    if n % bn or k % 128 or k > 16384:
        return False
    steps = num_moduli * (n // bn)
    if encode_rider:
        return (_rider_tiles(panel_m, n, steps // 2) is not None
                and _rider_tiles(panel_m, k, steps // 2) is not None
                and _rider_tiles(panel_m, k, steps) is not None)
    return _rider_tiles(panel_m, n, steps) is not None


def choose_panels(m: int, n: int, k: int, num_moduli: int,
                  encode_rider: bool = False):
    """Pick (panel_m, bn) for the pipeline, preferring the tuned headline
    configuration (1024, 512) and falling back to smaller panels for
    smaller m. Returns None when no configuration applies."""
    for pm_ in (1024, 512, 256):
        for bn_ in (512, 256, 128):
            if pipeline_applicable(m, n, k, num_moduli, pm_, bn_,
                                   encode_rider):
                return pm_, bn_
    return None


def bsplit_applicable(m: int, n: int, k: int, num_moduli: int,
                      panel_m: int = 1024, bn: int = 512) -> bool:
    """The B-split schedule additionally needs an even column-tile count
    and a rider tiling that encodes the right half of B (k x n/2) within
    the left-half matmul's L*(nt/2) grid steps."""
    nt = n // bn
    if nt % 2 or nt < 2 or (n // 2) % ENC_BLOCK[1]:
        return False
    if not pipeline_applicable(m, n, k, num_moduli, panel_m, bn,
                               encode_rider=True):
        return False
    return _rider_tiles(k, n // 2, num_moduli * (nt // 2)) is not None


@trace.traced("gm8.core.gemm_pipelined")
def gemm_pipelined(a: torch.Tensor, b: torch.Tensor, num_moduli: int,
                   kind: str = "f64", panel_m: int = 1024, bn: int = 512,
                   sfts=None, encode_rider: bool = False, a8=None,
                   b_rider: bool = False,
                   acc_out: bool = True) -> torch.Tensor:
    """C = A @ B, (m, k) x (k, n), each operand float64 or float32,
    emulated with the panel/rider pipeline: the one-shot call's bits.

    kind: the output's, "f64" (float64) or "f32" (float32, rounded once).
    The encode riders read each operand's own word.

    sfts: the call's (sft_a (m, 1), sft_b (1, n)) int32 shifts, fast or
    accurate (default: fast mode's). encode_rider: A is encoded panel by
    panel, each panel's encode riding the previous panel's GEMM (only panel
    0 is encoded up front). a8: A's (L, m, k) slices, already encoded (the
    column-panel schedule encodes A once; not with encode_rider). b_rider:
    the B split (needs encode_rider and `bsplit_applicable`). acc_out: the
    riders write rows of one (m, n) output; else each panel's rows are a
    tensor of their own, concatenated at the end."""
    m, k = a.shape
    n = b.shape[1]
    L = num_moduli
    a_kind = "f32" if enc.mant_bits_of(a) == 24 else "f64"
    b_kind = "f32" if enc.mant_bits_of(b) == 24 else "f64"
    if kind not in riders.KINDS:
        raise ValueError(f"kind {kind!r}: expected 'f64' or 'f32'")
    P = m // panel_m if panel_m > 0 else 0
    if m % max(panel_m, 1) or P < 2:
        # the schedule needs >= 2 panels (panel p's matmul carries panel
        # p-1's reconstruct); callers gate via choose_panels/
        # pipeline_applicable, which enforce the same bound
        raise ValueError(
            f"panel pipeline needs m a multiple of panel_m with at least "
            f"2 panels; got m={m}, panel_m={panel_m}")
    if k % 128 or n % bn:
        raise ValueError(f"panel pipeline needs k % 128 == 0 and n % bn "
                         f"== 0; got k={k}, n={n}, bn={bn}")
    if b_rider and not (encode_rider and bsplit_applicable(m, n, k, L,
                                                           panel_m, bn)):
        raise ValueError("b_rider needs encode_rider and bsplit_applicable")
    if a8 is not None and encode_rider:
        raise ValueError("a8 and encode_rider are exclusive")
    if sfts is not None:
        sft_a, sft_b = sfts
    else:
        sft_a = hk.fast_sft(a, L, axis=1)
        sft_b = hk.fast_sft(b, L, axis=0)
    if b_rider:
        b8 = hk.encode_slices(b, sft_b, L, axis=0,
                              col_tiles=(0, (n // 2) // ENC_BLOCK[1]))
    else:
        b8 = hk.encode_slices(b, sft_b, L, axis=0)
    if a8 is not None:
        a8_p = a8
    elif encode_rider:
        a8_p = hk.encode_slices(a[:panel_m], sft_a[:panel_m], L, axis=1)
    else:
        a8_p = hk.encode_slices(a, sft_a, L, axis=1)
    out = (torch.empty((m, n), dtype=riders.KINDS[kind], device=a.device)
           if acc_out else None)
    pieces = []      # each panel's rows (acc_out=False)
    if b_rider:
        r_prev, bt, a8_p = hp.matmul_bsplit_pair(a8_p, b8, b, sft_a, sft_b,
                                                 L, panel_m, a_src=a,
                                                 a_kind=a_kind,
                                                 b_kind=b_kind)
        b8 = None
        p_start = 1
    else:
        # filled from b8 by the first stage's launch
        bt = torch.empty((L, n, k), dtype=torch.int8, device=a.device)
        r_prev = None
        p_start = 0
    for p in range(p_start, P):
        src = a if (encode_rider and p < P - 1) else None
        r_p, rows, a8_next = hp.matmul_rider_step(
            a8_p, bt, p, r_prev, p - 1, sft_a, sft_b, L, panel_m, b8=b8,
            a_src=src, next_panel=p + 1, out=out, a_kind=a_kind,
            out_kind=kind)
        b8 = None    # B is K-major from here on
        if rows is not None and out is None:
            pieces.append(rows)
        r_prev = r_p
        if a8_next is not None:
            a8_p = a8_next
    if acc_out:
        return hp.reconstruct_into(r_prev, sft_a, sft_b, L, out, P - 1,
                                   panel_m, kind)
    pieces.append(hk.reconstruct(
        r_prev, riders.panel_rows(sft_a, P - 1, panel_m), sft_b, L, kind))
    return torch.cat(pieces, dim=0)
