// Accurate-mode magnitude GEMM with the row and column max in the epilogue:
// row_max[i] = max_j (|A| x |B|)[i, j], col_max[j] = max_i (|A| x |B|)[i, j]
// over int8 magnitudes in [0, 64]; the (m, n) product never reaches device
// memory.
//
// Replaces: magmax_matmul_pallas, gemmul8_tpu/pallas/matmul.py:393.
// Bound on the H100: int8 tensor-core operations. At 8192^3 it is one
// int8 GEMM, 1/14 of the main matmul's work; its operands are 2 x 64 MB
// and its output 2 x 32 KB.
// Design: matmul_mod.cu's cooperative tile (wgmma_s8.cuh: TMA ring, one
// producer warp, two consumer warpgroups of wgmma.m64n256k32 on a 128 x
// 256 tile, a persistent grid walking the tiles in raster groups; the
// launch entry "magmax" of hopper/launch.py, matmul_mod's values) at one
// slice, with a max epilogue. Both operands come K-major: A (m, k) with
// row stride lda, and B as Bt (n, k) with row stride ldb, as the mag7
// kernel writes them, so no transpose pass or workspace is needed. Each
// is read through a tensor map whose extent along k is k and whose row
// stride is its ld: the bytes between k and ld (a caller's buffer may hold
// anything there) and rows past m or n read as zeros, adding products of
// 0, which change no max. Products are >= 0 and at most 64 * 64 * 2^17 =
// 2^29, so the int32 accumulator never wraps. In the fragment
// (wgmma_s8.cuh CLayout_64xN) a row of the 256 columns lies in the four
// lanes of one quad of one warp: each thread takes the max of its two
// rows' 64 values, two shuffles (xor 1, 2) give the row's. A column lies
// in the 8 quads of 8 warps: each thread folds its two rows, three
// shuffles (xor 4, 8, 16) give the warp's 16 rows, and the 8 warps'
// maxima meet in the staging tile (two buffers, so one barrier a tile),
// where consumer thread i folds column i. Then one global atomicMax per
// row and per column into outputs the caller zero-fills: max is
// order-independent and 0 is its neutral element, so any tile order gives
// the same bits. The TPU kernel's iota-masked lane fold existed only for
// Mosaic's block rules and has no counterpart here.
//
// gm8_magmax_matmul_scratch is the deferred-fold variant. Replaces:
// magmax_matmul_scratch, gemmul8_tpu/pallas/matmul.py:312. The same kernel;
// a template flag on the last store swaps the global atomicMax for plain
// stores of each tile's maxima into its own column of an (m, n_tiles)
// buffer and its own row of an (m_tiles, n) buffer (n_tiles = ceil(n /
// 256), m_tiles = ceil(m / 128)), which two torch.amax calls fold, as the
// JAX package folds in XLA. No zero fill, no atomics; the max is
// order-independent, so the bits are the default's.
#include "common.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "magmax.cu takes its launch from hopper/launch.py"
#endif

namespace {

using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kAcc = kBN / 2;           // accumulator registers a thread
constexpr int kWarps = gm8::wg::kConsumerWarps;
constexpr int kConsumers = 32 * kWarps;
constexpr int kBarrier = 3;             // named barrier of the consumers
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages);
static_assert(kBN == 256, "wgmma_s8.cuh issues wgmma.m64n256k32 only");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");
static_assert(kConsumers == kBN, "one consumer thread a column");
static_assert(2 * kWarps * kBN * 4 <= kBM * kBN,
              "two buffers of the warps' column maxima fit the staging tile");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

struct Args {
  int* row_max;  // m, or (m, tiles_n) with kScratch
  int* col_max;  // n, or (tiles_m, n) with kScratch
  int m, n, nk;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kBarrier), "n"(kConsumers)
               : "memory");
}

// kScratch false: fold the tile's maxima into row_max / col_max with
// atomicMax. kScratch true: store them plainly, the row maxima into column
// tn of row_max (m, tiles_n) and the column maxima into row tm of col_max
// (tiles_m, n); the caller finishes the fold.
template <bool kScratch>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
magmax_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const __grid_constant__ Args p) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = gm8::wg::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  gm8::wg::Ring ring;
  ring.base = gm8::wg::smem_u32(smem);
  ring.stages = kStages;
  ring.bn = kBN;
  unsigned char* stg = smem + kStages * gm8::wg::stage_bytes(kBN);
  ring.full = gm8::wg::smem_u32(stg + kBM * kBN);
  ring.empty = ring.full + 8 * kStages;
  const gm8::wg::TileWalk walk(1, p.m, p.n, kBN, kGroup);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gm8::wg::mbar_init(ring.full + 8 * s, 1);
      gm8::wg::mbar_init(ring.empty + 8 * s, kWarps);
    }
    gm8::wg::mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 2) {  // producer warpgroup: one thread issues the loads
    gm8::wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      gm8::wg::tma_prefetch(map_a);
      gm8::wg::tma_prefetch(map_b);
      gm8::wg::produce(map_a, map_b, ring, walk, p.nk);
    }
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 * role .. + 63 of each tile
  gm8::wg::setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;  // 0..7
  const int g = lane >> 2, t = lane & 3;
  // the warps' column maxima: two buffers of kWarps rows of kBN ints
  int* cols = reinterpret_cast<int*>(stg);
  int stage = 0, buf = 0;
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < walk.total; tile += gridDim.x) {
    int l, tm, tn;
    walk.at(tile, l, tm, tn);
    // defined for each tile, so that the accumulator is dead outside the
    // mainloop and the epilogue
    int acc[kAcc];
#pragma unroll
    for (int r = 0; r < kAcc; ++r) acc[r] = 0;
    gm8::wg::consume<kBN>(acc, ring, role, p.nk, stage, phase);
    // rows: register 4 v2 + 2 v1 + v0 holds row 16 warp' + g + 8 v1 of
    // the warpgroup's half, column 8 v2 + 2 t + v0
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      int v = 0;
#pragma unroll
      for (int v2 = 0; v2 < kBN / 8; ++v2)
        v = max(v, max(acc[4 * v2 + 2 * v1], acc[4 * v2 + 2 * v1 + 1]));
      v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
      v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
      const int row = tm * kBM + 16 * warp + g + 8 * v1;
      if (t == 0 && row < p.m) {
        if constexpr (kScratch)
          p.row_max[static_cast<size_t>(row) * walk.tiles_n + tn] = v;
        else if (v > 0)
          atomicMax(p.row_max + row, v);
      }
    }
    // columns: the max of the thread's two rows, then of the warp's 16
    int* mine = cols + (buf * kWarps + warp) * kBN;
#pragma unroll
    for (int v2 = 0; v2 < kBN / 8; ++v2)
#pragma unroll
      for (int v0 = 0; v0 < 2; ++v0) {
        int v = max(acc[4 * v2 + v0], acc[4 * v2 + 2 + v0]);
        v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 4));
        v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 8));
        v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, 16));
        if (g == 0) mine[8 * v2 + 2 * t + v0] = v;
      }
    // every warp's maxima of this tile are in buffer buf; the other
    // buffer's reads (the last tile's) were done before this barrier
    consumers_sync();
    const int* all = cols + buf * kWarps * kBN;
    int v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = max(v, all[w * kBN + threadIdx.x]);
    const int col = tn * kBN + threadIdx.x;
    if (col < p.n) {
      if constexpr (kScratch)
        p.col_max[static_cast<size_t>(tm) * p.n + col] = v;
      else if (v > 0)
        atomicMax(p.col_max + col, v);
    }
    buf ^= 1;
  }
}

template <bool kScratch>
int launch(const void* a, int lda, const void* bt, int ldb, void* row_max,
           void* col_max, int m, int n, int k, void* stream) {
  if (lda % 16 != 0 || ldb % 16 != 0 || lda < k || ldb < k || m < 1 ||
      n < 1 || k < 1 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // extent k along k, row stride ld (hopper/matmul.py k_major_map)
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a, 1, m, k, kBM, lda,
                                static_cast<size_t>(m) * lda) ||
      !gm8::wg::make_tensor_map(&map_b, bt, 1, n, k, kBN, ldb,
                                static_cast<size_t>(n) * ldb))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = gm8::wg::persistent_grid(
      static_cast<long long>((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN));
  cudaFuncSetAttribute(magmax_kernel<kScratch>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const Args p{static_cast<int*>(row_max), static_cast<int*>(col_max), m, n,
               (k + kBK - 1) / kBK};
  magmax_kernel<kScratch><<<grid, gm8::wg::kThreads, kSmem,
                            static_cast<cudaStream_t>(stream)>>>(map_a,
                                                                 map_b, p);
  return gm8::launch_status();
}

}  // namespace

// a: (m, k) int8 with row stride lda; bt: (n, k) int8 (B transposed) with
// row stride ldb; lda, ldb multiples of 16 and both bases 16-byte aligned;
// the bytes between k and ld are not read. row_max: m int32, col_max: n
// int32, both zero-filled by the caller. k <= 2^17 (checked by the
// caller).
GM8_EXPORT int gm8_magmax_matmul(const void* a, int lda, const void* bt,
                                 int ldb, void* row_max, void* col_max,
                                 int m, int n, int k, void* stream) {
  return launch<false>(a, lda, bt, ldb, row_max, col_max, m, n, k, stream);
}

// a, bt, m, n, k as for gm8_magmax_matmul. row_part: (m, ceil(n / 256))
// int32, col_part: (ceil(m / 128), n) int32 (the tile of the launch entry
// "magmax"); every entry is written, so no zero fill. The row maxima are
// row_part's row maxima, the column maxima col_part's column maxima.
GM8_EXPORT int gm8_magmax_matmul_scratch(const void* a, int lda,
                                         const void* bt, int ldb,
                                         void* row_part, void* col_part,
                                         int m, int n, int k, void* stream) {
  return launch<true>(a, lda, bt, ldb, row_part, col_part, m, n, k, stream);
}
