"""The CRT contraction on the tensor cores: counterpart of
`scripts/probe_mxu_crt.py` (`_build`, its Pallas kernels; `_wp`, the weight
matrix).

For residues R (L, m, n) it centres them (r ^ 0x80 as int8), forms
Y = W' R per block of bm rows, W' = `core.reconstruct.crt_mxu_consts(L,
bm)` ((nd+1)*bm,
L*bm), and folds Y[nd] + sum_d Y[d] into (m, n) int32. W' = wc kron I_bm,
so Y[d] at each element is sum_j wc[d, j] rc_j whatever bm is: the output
does not depend on bm or bn. Variants, as the script's:

    full     centre + contraction + fold
    nodot    centre + the sum of the centred residues (no contraction)
    dotonly  no centring, on a (m/bm, L*bm, n) int8 input whose block i
             holds rows i*bm.. of every modulus, modulus-major (the layout
             the TPU's sublane collapse gave)
    noxor    contraction + fold on an int8 (L, m, n) input (no centring)

The kernel (`csrc/probe_mxu_crt.cu`) contracts with the compact (nd+1) x L
table (`crt_mxu_weights`) on the int8 tensor cores. The plain version is an
f64 matmul, exact: |Y| <= L * 128^2 < 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..core.reconstruct import crt_mxu_weights

VARIANTS = ("full", "nodot", "dotonly", "noxor")
# the script's `time` defaults: variant bm bn L m n
DEFAULTS = ("full", 16, 512, 14, 8192, 8192)
_CHUNK = 1 << 24            # elements per f64 product of the plain version


def input_shape(variant: str, num_moduli: int, bm: int, m: int, n: int):
    return ((m // bm, num_moduli * bm, n) if variant == "dotonly"
            else (num_moduli, m, n))


def input_dtype(variant: str) -> torch.dtype:
    return torch.uint8 if variant in ("full", "nodot") else torch.int8


def make_input(variant: str, num_moduli: int, bm: int, m: int, n: int,
               seed: int = 0) -> np.ndarray:
    """The script's random input of a variant: uint8 residues for full and
    nodot, int8 for noxor and dotonly."""
    rng = np.random.default_rng(seed)
    shape = input_shape(variant, num_moduli, bm, m, n)
    if variant in ("full", "nodot"):
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.integers(-128, 128, shape, dtype=np.int8)


def centered_planes(r: torch.Tensor, num_moduli: int, bm: int,
                    variant: str) -> torch.Tensor:
    """(L, m*n) int8: the residues each variant contracts, one plane per
    modulus, elements in row-major (m, n) order."""
    L = num_moduli
    if variant == "dotonly":
        mi, _, n = r.shape
        return r.reshape(mi, L, bm, n).permute(1, 0, 2, 3).reshape(L, -1)
    if variant == "noxor":
        return r.reshape(L, -1)
    return (r ^ 0x80).view(torch.int8).reshape(L, -1)


def out_shape(r: torch.Tensor, bm: int, variant: str):
    if variant == "dotonly":
        return (r.shape[0] * bm, r.shape[2])
    return tuple(r.shape[1:])


def check_args(r: torch.Tensor, num_moduli: int, bm: int, variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if not 2 <= num_moduli <= tables.MAX_MODULI:
        raise ValueError("num_moduli must be in [2, 20]")
    if r.dim() != 3 or r.dtype != input_dtype(variant):
        raise TypeError(f"{variant} takes a 3-d {input_dtype(variant)} "
                        "tensor")
    if variant == "dotonly":
        if bm < 1 or r.shape[1] != num_moduli * bm:
            raise ValueError("dotonly takes (m/bm, L*bm, n)")
    elif r.shape[0] != num_moduli:
        raise ValueError("expected (L, m, n) residues")


def mxu_crt_plain(r: torch.Tensor, num_moduli: int, bm: int,
                  variant: str = "full") -> torch.Tensor:
    """(m, n) int32: Y[nd] + sum_{d<nd} Y[d] of Y = wc rc (nodot: the sum
    of rc over the moduli)."""
    check_args(r, num_moduli, bm, variant)
    rc = centered_planes(r, num_moduli, bm, variant)
    if variant == "nodot":
        out = rc.to(torch.int32).sum(0, dtype=torch.int32)
    else:
        wc = torch.as_tensor(crt_mxu_weights(num_moduli)[0],
                             dtype=torch.float64, device=r.device)
        out = torch.empty(rc.shape[1], dtype=torch.int32, device=r.device)
        for e0 in range(0, rc.shape[1], _CHUNK):
            y = wc @ rc[:, e0:e0 + _CHUNK].double()
            out[e0:e0 + _CHUNK] = y.sum(0).to(torch.int32)
    return out.reshape(out_shape(r, bm, variant))


def bytes_moved(num_moduli: int, m: int, n: int) -> int:
    """Each residue read once, each int32 output written once."""
    return num_moduli * m * n + 4 * m * n


def run(variant: str = DEFAULTS[0], bm: int = DEFAULTS[1],
        bn: int = DEFAULTS[2], num_moduli: int = DEFAULTS[3],
        m: int = DEFAULTS[4], n: int = DEFAULTS[5], iters: int = 20) -> dict:
    """The script's `time`: ms per call of one variant at (L, m, n); the
    call's checksum feeds a zero-valued nudge into the next call's input,
    as the script's chained protocol. bn only checks that it divides n
    (the script's grid): the kernel's tiling is its own."""
    from ..bench.timing import chained_time, require_gpu
    from ..hopper import probes as hp

    require_gpu()
    if m % bm or n % bn:
        raise ValueError(f"bm={bm} must divide m={m} and bn={bn} n={n}")
    r = torch.from_numpy(make_input(variant, num_moduli, bm, m, n)).cuda()

    def step(s):
        r.view(torch.int8).view(-1)[:1].add_((s & 0).to(torch.int8))
        return hp.mxu_crt(r, num_moduli, bm, variant)[::64, ::64].sum()

    sec, _ = chained_time(step, torch.zeros((), dtype=torch.int64,
                                            device=r.device), iters)
    print(f"{variant} bm={bm} bn={bn}: {sec * 1e3:.3f} ms", flush=True)
    return {variant: sec * 1e3}


def lower(num_moduli: int = 14) -> bool:
    """The script's `lower` (does the kernel compile): on the card, build
    the kernel and run each variant once at the script's (L, 128, 512)
    blocks, bm 8, 16, 32, against the plain version."""
    from ..bench.timing import require_gpu
    from ..hopper import probes as hp

    require_gpu()
    ok = True
    for variant in VARIANTS:
        for bm in (8, 16, 32):
            r = torch.from_numpy(make_input(variant, num_moduli, bm, 128,
                                            512)).cuda()
            same = torch.equal(hp.mxu_crt(r, num_moduli, bm, variant),
                               mxu_crt_plain(r, num_moduli, bm, variant))
            ok = ok and same
            print(f"{'OK  ' if same else 'FAIL'} {variant} bm={bm}",
                  flush=True)
    return ok
