"""Plain versions of the panel pipeline's kernels.

The panel/rider pipeline (`gemmul8_tpu_torch.pipelined`) splits the m axis
of A into panels. The launch that forms panel p's residues also does, as
riders, the CRT reconstruct of panel p-1 and the encode of A-panel p+1;
the first panel may run as two launches over B's column halves, the left
one encoding B's right half. These functions compute what each launch
writes, one step after the other, from the plain bodies of the one-shot
path: `slicegemm.matmul_mod` (uncentered residues), `reconstruct.
reconstruct` and `encode.encode_slices`. They are the counterparts of the
JAX package's `matmul_rider_step`, `matmul_bsplit_pair` and
`_reconstruct_into` (`gemmul8_tpu/pallas/pipelined.py`), with their word
kinds (`a_kind`, `b_kind`: an encode rider's f64 or f32 source;
`out_kind`, `kind`: f64 or f32 output), and what the Hopper kernel
(`csrc/matmul_rider.cu`) is held to.

B is held as its GEMM operand is on the card: K-major, `bt` (L, n, k)
int8, made from the (L, k, n) slices once per call (`kmajor`). The
reconstruct rider writes rows of the full-size output when one is given.
"""

from __future__ import annotations

import torch

from . import encode as enc
from . import reconstruct as rec
from . import slicegemm as sg


def kmajor(b8: torch.Tensor) -> torch.Tensor:
    """(L, k, n) int8 slices of B -> (L, n, k), contiguous: the layout the
    panel GEMMs read."""
    return b8.transpose(1, 2).contiguous()


def panel_rows(x: torch.Tensor, panel: int, panel_m: int) -> torch.Tensor:
    """Rows [panel * panel_m, (panel + 1) * panel_m) of x's first axis
    (of its second axis for 3-D slices)."""
    r0 = panel * panel_m
    return x[:, r0:r0 + panel_m] if x.dim() == 3 else x[r0:r0 + panel_m]


KINDS = {"f64": torch.float64, "f32": torch.float32}


def check_kind(x, kind: str, name: str) -> None:
    """Raise unless kind is "f64" or "f32" and x (a rider's source or
    output; None: off) has that kind's dtype."""
    if kind not in KINDS:
        raise ValueError(f"{name} kind {kind!r}: expected 'f64' or 'f32'")
    if x is not None and x.dtype != KINDS[kind]:
        raise ValueError(f"{name} is {x.dtype}, not {KINDS[kind]} "
                         f"({kind})")


def matmul_rider_step(a8, bt, panel: int, r_prev, prev_panel: int, sft_a,
                      sft_b, num_moduli: int, panel_m: int, *, b8=None,
                      a_src=None, next_panel: int = -1, out=None,
                      a_kind: str = "f64", out_kind: str = "f64"):
    """One pipeline stage: (res, rec_rows, a8_next).

    res: (L, panel_m, n) uint8 residues of A-panel `panel` against B. a8
    holds that panel's (L, panel_m, k) slices, or all of A's (L, m, k).
    bt: (L, n, k) K-major B; with b8 ((L, k, n)) given, bt is first filled
    from it (the call's first stage).
    rec_rows: with r_prev ((L, panel_m, n) uint8 residues of panel
    `prev_panel`), that panel's (panel_m, n) rows in out_kind ("f64":
    float64, "f32": float32, rounded once): written into rows of out
    ((m, n), that dtype) when given, else a new tensor; None without.
    a8_next: with a_src ((m, k), float64 or float32 as a_kind says), the
    (L, panel_m, k) int8 slices of A-panel `next_panel`; None without.
    sft_a (m, 1) and sft_b (1, n) are the call's shifts."""
    check_kind(a_src, a_kind, "a_src")
    check_kind(out, out_kind, "out")
    if b8 is not None:
        bt.copy_(kmajor(b8))
    rows = a8 if a8.shape[1] == panel_m else panel_rows(a8, panel, panel_m)
    res = sg.matmul_mod(rows, bt.transpose(1, 2), num_moduli)
    rec_rows = None
    if r_prev is not None:
        piece = rec.reconstruct(r_prev, panel_rows(sft_a, prev_panel,
                                                   panel_m), sft_b,
                                num_moduli, out_kind)
        if out is None:
            rec_rows = piece
        else:
            rec_rows = panel_rows(out, prev_panel, panel_m).copy_(piece)
    a8_next = None
    if a_src is not None:
        a8_next = enc.encode_slices(panel_rows(a_src, next_panel, panel_m),
                                    panel_rows(sft_a, next_panel, panel_m),
                                    num_moduli, axis=1)
    return res, rec_rows, a8_next


def matmul_bsplit_pair(a8_p0, b8_left, b_src, sft_a, sft_b, num_moduli: int,
                       panel_m: int, *, a_src=None, a_kind: str = "f64",
                       b_kind: str = "f64"):
    """Panel 0 as two column halves: (res0, bt, a8_next).

    b8_left: (L, k, n) int8 whose left half (columns [0, n/2)) holds B's
    slices (the rest is not read); b_src: the (k, n) B, float64 or float32
    as b_kind says, whose right half is encoded with sft_b's right half.
    res0: (L, panel_m, n) uint8 residues of A-panel 0 ((L, panel_m, k)
    slices a8_p0) against all of B; bt: (L, n, k) K-major B, both halves;
    a8_next: with a_src (a_kind's dtype), A-panel 1's (L, panel_m, k)
    slices."""
    check_kind(a_src, a_kind, "a_src")
    check_kind(b_src, b_kind, "b_src")
    h = b8_left.shape[2] // 2
    right = enc.encode_slices(b_src[:, h:], sft_b[:, h:], num_moduli, axis=0)
    b8 = torch.cat([b8_left[:, :, :h], right], dim=2)
    res0 = sg.matmul_mod(a8_p0, b8, num_moduli)
    a8_next = None
    if a_src is not None:
        a8_next = enc.encode_slices(panel_rows(a_src, 1, panel_m),
                                    panel_rows(sft_a, 1, panel_m),
                                    num_moduli, axis=1)
    return res0, kmajor(b8), a8_next


def reconstruct_into(r8, sft_a, sft_b, num_moduli: int, out, last_panel: int,
                     panel_m: int, kind: str = "f64"):
    """The last panel's reconstruct written into its rows of the (m, n)
    output `out`, float64 (kind "f64") or float32 ("f32", rounded once);
    returns out."""
    check_kind(out, kind, "out")
    panel_rows(out, last_panel, panel_m).copy_(rec.reconstruct(
        r8, panel_rows(sft_a, last_panel, panel_m), sft_b, num_moduli,
        kind))
    return out
