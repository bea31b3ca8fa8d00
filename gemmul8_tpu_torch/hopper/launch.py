"""Device-keyed launch table of the Hopper kernels.

Counterpart of the JAX package's `pallas/launch.py` (`get`), keyed by the
card's compute capability (`torch.cuda.get_device_capability()`) instead
of the TPU's device kind. A capability without an entry raises: there is
no generic profile to fall back on, since a tile that does not fit a
card's shared memory would not launch, and one that fits but was never
measured there has no claim to run.

Only what is pure tuning lives here. The statistics kernels' reduction
chunk, `STATS_CHUNK` (2048 along the contraction axis), is part of the
fast shift's bits (the block-wise online norm merge) and stays fixed on
every card, as in the JAX package.

Entries:
    "matmul_mod"  `MatmulModLaunch` of csrc/matmul_mod.cu (the wgmma tile
                  of csrc/wgmma_s8.cuh): the output tile's width, the TMA
                  ring's depth and the raster group of the persistent grid.
                  They are compile-time constants of the kernel:
                  hopper/build.py passes `defines()` of the entry for the
                  capability it builds for to nvcc, and the source checks
                  them (`static_assert`).
    "matmul_rider" `MatmulModLaunch` of csrc/matmul_rider.cu, the same
                  tile with encode warps beside its producer: their plane
                  rows take the shared memory of a fourth stage.
    "matmul_mod_pipelined" `MatmulModLaunch` of
                  csrc/matmul_mod_pipelined.cu, the ping-pong schedule:
                  each consumer warpgroup owns whole 128 x `tile_n` tiles.
    "matmul_complex" `MatmulModLaunch` of csrc/matmul_complex.cu, the
                  cooperative tile with the complex products chained.
    "matmul_reconstruct" `MatmulModLaunch` of csrc/matmul_reconstruct.cu,
                  the cooperative tile walking (tile, modulus, k-tile),
                  the consumers reconstructing each tile after its last
                  modulus. The wrapper sizes the kernel's scratch of
                  residues by its `tile_n` (hopper/matmul.py).
    "matmul_crt"  `MatmulModLaunch` of csrc/matmul_crt.cu, the same walk
                  and scratch, the consumers storing each tile's CRT sum
                  as canonical limbs.
    "magmax"      `MatmulModLaunch` of csrc/magmax.cu, the cooperative tile
                  at one slice with a row and column max epilogue; the
                  scratch form's buffers follow its `tile_n`.
csrc/probe_deaddep.cu is built with the "matmul_mod" entry: its GEMM is
matmul_mod's kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import tables

STATS_CHUNK = tables.STATS_CHUNK


@dataclass(frozen=True)
class MatmulModLaunch:
    tile_n: int        # output columns of a tile (wgmma's n)
    stages: int        # stages of the TMA ring
    raster_group: int  # m-tiles walked together by the persistent grid

    def defines(self) -> tuple:
        """The nvcc flags that compile this launch into its source."""
        return (f"-DGM8_MM_TILE_N={self.tile_n}",
                f"-DGM8_MM_STAGES={self.stages}",
                f"-DGM8_MM_GROUP={self.raster_group}")


# H100 and H200 (sm_90): a 128 x 256 tile (64 x 256 s32 accumulator, 128
# registers a consumer thread), four 48 KB stages (230,464 bytes of shared
# memory a block with the epilogue's staging tile, of the 232,448 a block
# may opt into), groups of 16 m-tiles (132 tiles in flight read 16 A panels
# and 8-9 B panels). The rider kernel's encode warps and tables take 4,944
# bytes more, which leave three stages. The ping-pong kernel's warpgroup
# tiles are 128 x 128 (two wgmma.m64n128k32 chains, 128 registers a
# thread): 32 KB stages, six of them beside its two 16 KB staging tiles
# (230,496 bytes). The complex kernel runs matmul_mod's tile and ring; its
# Karatsuba carry stays in registers, so no stage gives way, nor for the
# two CRT-fused GEMMs, whose digit table and chunk counter take 848 bytes
# and whose limb rows sit in the staging tile, nor for the magnitude GEMM,
# whose warps' column maxima sit there.
TABLE = {(9, 0): {"matmul_mod": MatmulModLaunch(tile_n=256, stages=4,
                                                raster_group=16),
                  "matmul_rider": MatmulModLaunch(tile_n=256, stages=3,
                                                  raster_group=16),
                  "matmul_mod_pipelined": MatmulModLaunch(
                      tile_n=128, stages=6, raster_group=16),
                  "matmul_complex": MatmulModLaunch(tile_n=256, stages=4,
                                                    raster_group=16),
                  "matmul_reconstruct": MatmulModLaunch(
                      tile_n=256, stages=4, raster_group=16),
                  "matmul_crt": MatmulModLaunch(tile_n=256, stages=4,
                                                raster_group=16),
                  "magmax": MatmulModLaunch(tile_n=256, stages=4,
                                            raster_group=16)}}


def get(name: str, capability=None):
    """Launch entry `name` for the given compute capability (major, minor),
    or the current CUDA device's. Raises RuntimeError for a capability the
    table has no entry for, KeyError for an unknown name."""
    if capability is None:
        capability = torch.cuda.get_device_capability()
    capability = tuple(int(c) for c in capability)
    profile = TABLE.get(capability)
    if profile is None:
        raise RuntimeError(
            f"no launch entry for compute capability {capability}: the "
            f"Hopper kernels are built and tuned for {sorted(TABLE)}")
    return profile[name]
