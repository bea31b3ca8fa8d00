"""Integer work inside the residue GEMM's block: counterpart of
`scripts/probe_deaddep.py` (`build`, its two Pallas kernels).

The GEMM is the port's matmul_mod kernel (`csrc/wgmma_s8.cuh`: a TMA
ring, wgmma on 128 x 256 tiles, a persistent grid of one block an SM)
computing the canonical residues (A8[l] @ B8[l]) mod m_l, uint8 (L, n,
n). The injected work is counted per 128 x 128 tile (a 128 x 256 tile
does that of its two): after the tile's mod epilogue the consumers run
an injected chain, v = v * 3 + 1 repeated nops / 2 times per element
(one multiply-add on the card, the script's two ops), in one of the
script's variants:

    base     nops = 0: the GEMM alone
    indep    over a tile-sized scratch in shared memory that starts at 0
    deaddep  the same, seeded with (the tile's (0, 0) product) & 1: a data
             edge from the block's own accumulator
    hbmin    over a streamed int32 rider block of 2048 words per tile
    hbmio    the same, also writing the chained block back
    recbody  the reconstruct body (csrc/crt.cuh) on a streamed uint8
             residue block of 1024 elements per tile, shifts 0, f64 out
    recmxu   the same through the CRT contraction on the tensor cores
             (csrc/crt_mma.cuh, the mxu_crt probe's device code)
    kloop    indep's chain run in registers between the mainloop's
             k-tiles, from the GEMM's own warps, after a k-tile's wgmmas
             are issued and before they are waited for (the port's own
             variant; the script has none like it)

Every variant but kloop runs its work after the tile's epilogue, where
only the ring's prefetch of the next tile can overlap it with MMAs; kloop
asks whether the asynchronous tensor cores hide integer work issued
beside them.

The rider totals are the script's (L (n/1024)(n/512) steps of (128, 512)
words, or of (64, 512) and (8, 4096) residue blocks), spread over the
card's L (n/128)^2 tiles. Each tile's chain output is its own word of aux
(the chain value of the tile's first element), never "last block wins".
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import reconstruct as rec
from ..core import slicegemm as sg

VARIANTS = ("base", "indep", "deaddep", "hbmin", "hbmio", "recbody",
            "recmxu", "kloop")
CHAIN = ("indep", "deaddep", "hbmin", "hbmio", "kloop")
HBM = ("hbmin", "hbmio")
REC = ("recbody", "recmxu")
TILE = 128
HBM_PER = TILE * TILE // 8        # rider words a tile (128 x 512 / 1024 x 512)
REC_PER = TILE * TILE // 16       # rider elements a tile (64 x 512 / ...)
MUL, ADD = 3, 1                   # the chain v = v * MUL + ADD
REC_CHUNK = 1 << 22               # rider elements a plain reconstruct
# the script's defaults: n, L, nops
DEFAULTS = (8192, 14, (0, 16, 32))


def tiles(n: int, num_moduli: int) -> int:
    return num_moduli * (n // TILE) ** 2


def variants_of(nops: int):
    """The script's variants at one nops: -1 recbody, -2 recmxu, 0 base,
    > 0 the chain variants (the script's four and kloop)."""
    if nops > 0:
        return CHAIN
    return {-1: ("recbody",), -2: ("recmxu",), 0: ("base",)}[nops]


def check_n(n: int) -> None:
    if n < 1024 or n % 1024:
        raise ValueError(f"n={n}: a multiple of 1024, as the script's grid "
                         "of (1024, 512) blocks needs")


def make_rider(variant: str, n: int, num_moduli: int, seed: int = 0):
    """The script's rider input: int32 words in [0, 255) (hbm variants),
    flat; uint8 residues in [0, 199), (L, tiles * REC_PER) (rec
    variants); None otherwise."""
    rng = np.random.default_rng(seed)
    t = tiles(n, num_moduli)
    if variant in HBM:
        return rng.integers(0, 255, t * HBM_PER).astype(np.int32)
    if variant in REC:
        return rng.integers(0, 199, (num_moduli, t * REC_PER)).astype(
            np.uint8)
    return None


def _wrap(v: torch.Tensor) -> torch.Tensor:
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def chain_plain(v: torch.Tensor, reps: int) -> torch.Tensor:
    """reps steps of v = v * MUL + ADD in int32 arithmetic (wrapping)."""
    v = v.to(torch.int64)
    for _ in range(reps):
        v = _wrap(v * MUL + ADD)
    return v.to(torch.int32)


def corner_products(a8: torch.Tensor, b8: torch.Tensor) -> torch.Tensor:
    """(L, n/128, n/128) int64: each tile's product at its (0, 0) element,
    exact (|x| <= 128^2 k < 2^53)."""
    return (a8[:, ::TILE, :].double() @ b8[:, :, ::TILE].double()).to(
        torch.int64)


def check_args(a8, b8, num_moduli: int, nops: int, variant: str, rin):
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    L, n = num_moduli, a8.shape[-1]
    if a8.dtype != torch.int8 or b8.dtype != torch.int8:
        raise TypeError("a8 and b8 must be int8")
    if tuple(a8.shape) != (L, n, n) or tuple(b8.shape) != (L, n, n):
        raise ValueError(f"a8 and b8 must be ({L}, n, n)")
    check_n(n)
    if not 2 <= L <= 20 or nops < 0 or nops % 2:
        raise ValueError("num_moduli in [2, 20] and an even nops >= 0")
    t = tiles(n, L)
    if variant in HBM:
        if rin is None or rin.dtype != torch.int32 or rin.numel() != \
                t * HBM_PER:
            raise ValueError(f"{variant} takes {t * HBM_PER} int32 rider "
                             "words")
    elif variant in REC:
        if rin is None or rin.dtype != torch.uint8 or \
                tuple(rin.shape) != (L, t * REC_PER):
            raise ValueError(f"{variant} takes ({L}, {t * REC_PER}) uint8 "
                             "rider residues")


def deaddep_plain(a8: torch.Tensor, b8: torch.Tensor, num_moduli: int,
                  nops: int, variant: str, rin: torch.Tensor | None = None):
    """(residues (L, n, n) uint8, aux (tiles,) int32 or None, rider output
    or None): hbmio's chained words (int32, as rin), recbody's and
    recmxu's float64 reconstruction of the rider residues (flat)."""
    check_args(a8, b8, num_moduli, nops, variant, rin)
    L, n = num_moduli, a8.shape[-1]
    res = sg.matmul_mod(a8, b8, L)
    reps = nops // 2
    aux = rout = None
    if variant in ("indep", "deaddep", "kloop"):
        seed = torch.zeros(tiles(n, L), dtype=torch.int64, device=a8.device)
        if variant == "deaddep":
            seed = corner_products(a8, b8).reshape(-1) & 1
        aux = chain_plain(seed, reps)
    elif variant in HBM:
        v = chain_plain(rin.reshape(-1), reps)
        aux = v.reshape(-1, HBM_PER)[:, 0].contiguous()
        rout = v if variant == "hbmio" else None
    elif variant in REC:
        # elementwise, in chunks: the plain reconstruct's int64 limbs take
        # ~0.5 KB an element
        zeros = torch.zeros((1, REC_CHUNK), dtype=torch.int32,
                            device=rin.device)
        rout = torch.cat([
            rec.reconstruct(c.reshape(L, 1, -1), zeros[:, :1],
                            zeros[:, :c.shape[1]], L).reshape(-1)
            for c in rin.split(REC_CHUNK, dim=1)])
    return res, aux, rout


def sm_cycles(stamps: torch.Tensor) -> int:
    """The launch's span in SM clock cycles from `hopper.probes.deaddep`'s
    stamps (SM, start, end of each block): on each SM, its last block's
    end less its first block's start; the most over the SMs. Each SM's
    clock counts its own cycles, so spans are compared within an SM."""
    sm = stamps[:, 0]
    n_sm = int(sm.max()) + 1
    first = torch.full((n_sm,), 2 ** 62, dtype=torch.int64,
                       device=stamps.device)
    last = torch.full((n_sm,), -2 ** 62, dtype=torch.int64,
                      device=stamps.device)
    first.scatter_reduce_(0, sm, stamps[:, 1], "amin")
    last.scatter_reduce_(0, sm, stamps[:, 2], "amax")
    used = torch.zeros(n_sm, dtype=torch.bool, device=stamps.device)
    used[sm] = True
    return int((last - first)[used].max())


def injected_ops(n: int, num_moduli: int, nops: int, variant: str) -> int:
    """The JAX count of the injected ops: elements chained x nops (the
    card does nops / 2 multiply-adds per element)."""
    per = HBM_PER if variant in HBM else TILE * TILE
    return tiles(n, num_moduli) * per * nops if variant in CHAIN else 0


def run(n: int = DEFAULTS[0], num_moduli: int = DEFAULTS[1],
        nops_list=DEFAULTS[2], iters: int = 12) -> dict:
    """The script's `main`: ms per call of each variant at each nops, the
    calls chained through a zero-valued nudge of A by the last checksum."""
    from ..bench.timing import chained_time, require_gpu
    from ..hopper import probes as hp

    require_gpu()
    check_n(n)
    L = num_moduli
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-128, 128, (L, n, n),
                                       dtype=np.int8)).cuda()
    b8 = torch.from_numpy(rng.integers(-128, 128, (L, n, n),
                                       dtype=np.int8)).cuda()
    res = {}
    for nops in nops_list:
        for variant in variants_of(nops):
            r = make_rider(variant, n, L)
            rin = None if r is None else torch.from_numpy(r).cuda()

            def step(s, v=variant, k=max(nops, 0), rin=rin):
                a8.view(-1)[:1].add_((s & 0).to(torch.int8))
                o, aux, rout = hp.deaddep(a8, b8, L, k, v, rin)
                s = o[:, ::64, ::64].sum(dtype=torch.int64)
                if aux is not None:
                    s = s + aux[0]
                if rout is not None and v in REC:
                    s = s + rout.view(torch.int64)[0]
                return s

            sec, _ = chained_time(step, torch.zeros(
                (), dtype=torch.int64, device=a8.device), iters)
            res[(nops, variant)] = sec * 1e3
            gops = injected_ops(n, L, max(nops, 0), variant) / 1e9
            print(f"nops={nops:3d} {variant:8s}: {sec * 1e3:7.3f} ms "
                  f"(injected {gops:5.1f} G ops, JAX count)", flush=True)
    return res
