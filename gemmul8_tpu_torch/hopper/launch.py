"""Device-keyed launch table of the Hopper kernels.

Counterpart of the JAX package's `pallas/launch.py` (`get`), keyed by the
card's compute capability (`torch.cuda.get_device_capability()`) instead
of the TPU's device kind. A capability without an entry raises: there is
no generic profile to fall back on, since a tile that does not fit a
card's shared memory would not launch, and one that fits but was never
measured there has no claim to run.

Only what is pure tuning lives here: a launch shape that moves no bit.
What sets the order of a sum stays fixed on every card, as in the JAX
package, because the fast shift's bits follow it: the statistics
kernels' reduction chunk, `STATS_CHUNK` (2048 along the contraction
axis, the block-wise online norm merge); the row statistics' 256-thread
block (8 elements a thread, a warp shuffle tree, the 8 warps in order);
and a column's 16 runs of 128 rows (csrc/fast_stats.cuh; core/encode.py
`fast_stats_running(run=128, ways=16)` is the columns' plain twin). A
constant that sets such an order is part of the bit contract, not an
entry.

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
    "fast_sft"    `FastSftLaunch` of csrc/fast_sft.cu (the JAX table's
                  "stats_ax1" and "stats_ax0"): the column kernel's loads
                  in flight and blocks an SM.
    "encode"      `EncodeLaunch` of csrc/encode.cu ("enc_mxu"): threads a
                  block (of the N-major form; the K-major form's block is
                  8 warps) and the grid's blocks an SM.
    "reconstruct" `ReconstructLaunch` of csrc/reconstruct.cu ("rec_mxu"):
                  threads a block, elements a warp takes at a time, the
                  grid's blocks an SM.
    "mag7"        `Mag7Launch` of csrc/mag7.cu ("mag7"): emax's and
                  mag7_fused's column blocking, mag7's tile, mag7_fused's
                  steps in flight and k per tile.
    "fast_encode_fused" `FastEncodeFusedLaunch` of
                  csrc/fast_encode_fused.cu: the row stage's bytes and the
                  column statistics' loads in flight.
csrc/probe_deaddep.cu is built with the "matmul_mod" entry: its GEMM is
matmul_mod's kernel. Every entry's constants are compile-time constants
of its source: hopper/build.py passes `defines()` of the entry for the
capability it builds for to nvcc (`build.SOURCE_FLAGS`), and the source
refuses to build without them (`#error`) and checks their limits
(`static_assert`), whose formulas `fits` and `smem_bytes` repeat, so a
tuner drops a candidate before it compiles. A candidate entry builds into
a library of its own (`build.candidate`); a wrapper takes it by its
`launch=` keyword.

The JAX table's names (`pallas/launch.py` `get`) map to these entries by
`JAX_NAMES`; its "enc_vpu" and "rec_vpu" blocks have no counterpart: the
port has one encode kernel and one reconstruct kernel, on the tensor
cores, for every form.
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


@dataclass(frozen=True)
class FastSftLaunch:
    col_load_bytes: int     # a column thread's bytes of loads in flight
    col_blocks_per_sm: int  # the column kernel's blocks an SM its
                            # registers must allow

    def defines(self) -> tuple:
        return (f"-DGM8_SFT_COL_LOAD_BYTES={self.col_load_bytes}",
                f"-DGM8_SFT_COL_BLOCKS_PER_SM={self.col_blocks_per_sm}")


@dataclass(frozen=True)
class EncodeLaunch:
    threads: int        # threads a block
    blocks_per_sm: int  # the grid-stride walk's cap: blocks an SM

    def defines(self) -> tuple:
        return (f"-DGM8_ENC_THREADS={self.threads}",
                f"-DGM8_ENC_BLOCKS_PER_SM={self.blocks_per_sm}")


@dataclass(frozen=True)
class ReconstructLaunch:
    threads: int        # threads a block
    chunk: int          # elements a warp takes at a time (its limb rows'
                        # stride is chunk + 4 ints)
    blocks_per_sm: int  # the grid-stride walk's cap: blocks an SM

    def defines(self) -> tuple:
        return (f"-DGM8_REC_THREADS={self.threads}",
                f"-DGM8_REC_CHUNK={self.chunk}",
                f"-DGM8_REC_BLOCKS_PER_SM={self.blocks_per_sm}")


@dataclass(frozen=True)
class Mag7Launch:
    col_strip: int    # columns a block of emax's and mag7_fused's column
                      # kernels
    col_threads: int  # emax over columns: threads a column
    col_rows: int     # emax over columns: rows a block
    tile: int         # mag7 over columns: the transpose tile's side
    fused_steps: int  # mag7_fused's rows: a warp's steps in flight
    fused_k: int      # mag7_fused's columns: k a tile

    def defines(self) -> tuple:
        return (f"-DGM8_MAG_COL_STRIP={self.col_strip}",
                f"-DGM8_MAG_COL_THREADS={self.col_threads}",
                f"-DGM8_MAG_COL_ROWS={self.col_rows}",
                f"-DGM8_MAG_TILE={self.tile}",
                f"-DGM8_MAG_FUSED_STEPS={self.fused_steps}",
                f"-DGM8_MAG_FUSED_K={self.fused_k}")


@dataclass(frozen=True)
class FastEncodeFusedLaunch:
    stage_bytes: int     # a row's words kept in shared memory
    col_load_bytes: int  # a column thread's bytes of loads in flight in
                         # the statistics

    def defines(self) -> tuple:
        return (f"-DGM8_FUSED_STAGE_BYTES={self.stage_bytes}",
                f"-DGM8_FUSED_COL_LOAD_BYTES={self.col_load_bytes}")


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
                                            raster_group=16),
                  # the other sources: the constants they were built with
                  # before the table held them, kept by the tuners' sweeps
                  # on an H100 80GB HBM3 at 700 W (PERF.md) but for two:
                  # mag7's transpose tile, 64 before (32 ran mag7 in
                  # 0.94-0.95 of the time), and encode's grid, 8 blocks an
                  # SM before (16 ran encode_slices in 0.98)
                  "fast_sft": FastSftLaunch(col_load_bytes=32,
                                            col_blocks_per_sm=3),
                  "encode": EncodeLaunch(threads=256, blocks_per_sm=16),
                  "reconstruct": ReconstructLaunch(threads=128, chunk=128,
                                                   blocks_per_sm=16),
                  "mag7": Mag7Launch(col_strip=32, col_threads=8,
                                     col_rows=256, tile=32, fused_steps=4,
                                     fused_k=128),
                  "fast_encode_fused": FastEncodeFusedLaunch(
                      stage_bytes=64 * 1024, col_load_bytes=8)}}


# the JAX table's names -> the port's entries (None: no counterpart)
JAX_NAMES = {"stats_ax1": "fast_sft", "stats_ax0": "fast_sft",
             "enc_mxu": "encode", "enc_vpu": None,
             "rec_mxu": "reconstruct", "rec_vpu": None,
             "matmul": "matmul_mod", "magmax": "magmax", "mag7": "mag7"}

SMEM_BLOCK = 232448   # shared memory a block may opt into on sm_90
SMEM_STATIC = 49152   # a block's static shared memory
_ENC_TABLE_BYTES = 1024     # sizeof(EncMmaTable), csrc/encode_mma.cuh
_REC_CONSTS_BYTES = 1152    # sizeof(Consts), csrc/reconstruct.cu: the
                            # CrtMmaTable (832) and 20 ModDivisors (320)
_MAX_LD = 1 << 17           # mag7.cu kMaxLd


def _pow2(v: int) -> bool:
    return v >= 1 and v & (v - 1) == 0


def smem_bytes(name: str, entry) -> int:
    """The shared memory of the largest block that entry `name`'s source
    launches under `entry`, by the formula its `static_assert` checks."""
    if name in ("matmul_mod", "matmul_mod_pipelined"):
        stage = (128 + entry.tile_n) * 128      # wgmma_s8.cuh stage_bytes
        staging = 128 * entry.tile_n * (2 if name != "matmul_mod" else 1)
        return 1024 + entry.stages * stage + staging + 16 * entry.stages
    if name == "fast_sft":       # the column block's parts (static)
        return 12 * 32 * (2 + 16)
    if name == "encode":       # the N-major block, or the K-major one's
        return max(entry.threads // 32, 4 * 8) * 64 * 16 + _ENC_TABLE_BYTES
    if name == "reconstruct":
        return (entry.threads // 32 * 12 * (entry.chunk + 4) * 4
                + _REC_CONSTS_BYTES)
    if name == "mag7":
        cols = (_MAX_LD // entry.fused_k * entry.col_strip * 2
                + (256 // 32 + 1) * entry.col_strip * 4
                + entry.col_strip * (entry.fused_k + 4))
        rows = _MAX_LD // 64 * (64 + 4)          # mag7_fused's f64 rows
        return max(cols, rows, entry.tile * (entry.tile + 4))
    if name == "fast_encode_fused":
        return (entry.stage_bytes + 16 + 8 * 64 * 16 + _ENC_TABLE_BYTES
                + 2 * 4 * 8)
    raise KeyError(name)


def fits(name: str, entry) -> bool:
    """Whether entry `name`'s source builds under `entry`: its
    `static_assert`s, shared memory within what a block may hold."""
    e = entry
    if name in ("matmul_mod", "matmul_mod_pipelined"):
        ok = (e.tile_n == (256 if name == "matmul_mod" else 128)
              and e.stages >= 2 and e.raster_group >= 1)
    elif name == "fast_sft":
        ok = (e.col_load_bytes >= 8 and e.col_load_bytes % 8 == 0
              and 1 <= e.col_blocks_per_sm and e.col_blocks_per_sm * 512
              <= 2048)
    elif name in ("encode", "reconstruct"):
        ok = (e.threads % 32 == 0 and 32 <= e.threads <= 1024
              and e.blocks_per_sm >= 1
              and (name == "encode" or e.chunk == 128)
              and smem_bytes(name, e) <= SMEM_STATIC)
    elif name == "mag7":
        pieces = e.fused_k // 16
        ok = (e.col_strip * e.col_threads <= 1024 and e.col_threads >= 1
              and e.col_rows >= 1 and _pow2(e.tile) and e.tile <= 256
              and e.tile * e.tile // 4 % 256 == 0
              and e.tile * (e.tile + 4) <= SMEM_STATIC
              and e.fused_steps >= 1
              and e.col_strip * e.fused_k // 16 == 256
              and e.fused_k % 16 == 0 and _pow2(pieces)
              and e.col_strip % 4 == 0 and e.col_strip <= 64
              and _pow2(e.col_strip))
    elif name == "fast_encode_fused":
        ok = (e.stage_bytes > 0 and e.stage_bytes % (512 * 8) == 0
              and e.col_load_bytes >= 8 and e.col_load_bytes % 8 == 0)
    else:
        raise KeyError(name)
    return ok and smem_bytes(name, e) <= SMEM_BLOCK


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
