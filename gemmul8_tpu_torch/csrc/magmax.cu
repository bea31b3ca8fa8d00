// Accurate-mode magnitude GEMM with the row and column max in the epilogue:
// row_max[i] = max_j (|A| x |B|)[i, j], col_max[j] = max_i (|A| x |B|)[i, j]
// over int8 magnitudes in [0, 64]; the (m, n) product never reaches device
// memory.
//
// Replaces: magmax_matmul_pallas, gemmul8_tpu/pallas/matmul.py:393.
// Bound on the H100: int8 tensor-core operations. At 8192^3 it is one
// int8 GEMM, 1/14 of the main matmul's work; its operands are 2 x 64 MB
// and its output 2 x 32 KB.
// Design: the tile of mma_s8.cuh (the main matmul's mainloop) with a max
// epilogue. Both operands come K-major: A (m, k) with row stride lda, and
// B as Bt (n, k) with row stride ldb, as the mag7 kernel writes them, so
// no transpose pass or workspace is needed. Products are >= 0 and at most
// 64 * 64 * 2^17 = 2^29, so the int32 accumulator never wraps. A block
// folds its 128 x 128 tile's maxima through shared memory (shuffles across
// the lanes that share a row or column, then shared-memory atomicMax
// across warps), then one global atomicMax per row and per column into
// outputs the caller zero-fills: max is order-independent and 0 is its
// neutral element, so any block order gives the same bits. Zero padding
// (rows past m or n, bytes past k) adds products of 0 and changes no max.
// The TPU kernel's iota-masked lane fold existed only for Mosaic's block
// rules and has no counterpart here.
//
// gm8_magmax_matmul_scratch is the deferred-fold variant. Replaces:
// magmax_matmul_scratch, gemmul8_tpu/pallas/matmul.py:312. The same tile
// and in-block fold; a template flag on the epilogue swaps the global
// atomicMax for plain stores of each tile's maxima into its own column of
// an (m, n_tiles) buffer and its own row of an (m_tiles, n) buffer (2 MB +
// 2 MB at 8192^2), which two torch.amax calls fold, as the JAX package
// folds in XLA. No zero fill, no atomics; the max is order-independent, so
// the bits are the default's.
#include "common.cuh"
#include "mma_s8.cuh"

namespace {

constexpr int kThreads = gm8::kMmaThreads;
static_assert(kThreads == gm8::kBM + gm8::kBN, "one thread per row/col");

// kScratch false: fold the block's maxima into row_max / col_max with
// atomicMax. kScratch true: store them plainly, the row maxima into column
// blockIdx.x of row_max (m, gridDim.x) and the column maxima into row
// blockIdx.y of col_max (gridDim.y, n); the caller finishes the fold.
template <bool kScratch>
__global__ void __launch_bounds__(kThreads, 2)
magmax_kernel(const signed char* __restrict__ A, int lda,
              const signed char* __restrict__ Bt, int ldb,
              int* __restrict__ row_max, int* __restrict__ col_max, int m,
              int n, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_row[gm8::kBM], s_col[gm8::kBN];
  const int bm0 = blockIdx.y * gm8::kBM, bn0 = blockIdx.x * gm8::kBN;
  if (threadIdx.x < gm8::kBM)
    s_row[threadIdx.x] = 0;
  else
    s_col[threadIdx.x - gm8::kBM] = 0;

  int acc[4][4][4];
  gm8::mma_tile<true>(A, lda, Bt, ldb, m, n, k, bm0, bn0, smem, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  __syncthreads();  // s_row / s_col zeroed (mma_tile syncs only if k > 0)

  // rows: a lane holds rows g and g + 8 of each 16-row group mt; the four
  // lanes t of a row group hold its other columns
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = 0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        v = max(v, max(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]));
      v = max(v, __shfl_xor_sync(~0u, v, 1));
      v = max(v, __shfl_xor_sync(~0u, v, 2));
      if (t == 0) atomicMax(&s_row[wm * 64 + mt * 16 + g + 8 * h], v);
    }
  // columns: a lane holds columns 2t and 2t + 1 of each 8-column group
  // nt; the eight lanes g hold its other rows
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int v = 0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        v = max(v, max(acc[mt][nt][c], acc[mt][nt][c + 2]));
      v = max(v, __shfl_xor_sync(~0u, v, 4));
      v = max(v, __shfl_xor_sync(~0u, v, 8));
      v = max(v, __shfl_xor_sync(~0u, v, 16));
      if (g == 0) atomicMax(&s_col[wn * 32 + nt * 8 + t * 2 + c], v);
    }
  __syncthreads();
  if (threadIdx.x < gm8::kBM) {
    const int row = bm0 + threadIdx.x;
    const int v = s_row[threadIdx.x];
    if constexpr (kScratch) {
      if (row < m)
        row_max[static_cast<size_t>(row) * gridDim.x + blockIdx.x] = v;
    } else {
      if (row < m && v > 0) atomicMax(&row_max[row], v);
    }
  } else {
    const int col = bn0 + threadIdx.x - gm8::kBM;
    const int v = s_col[threadIdx.x - gm8::kBM];
    if constexpr (kScratch) {
      if (col < n) col_max[static_cast<size_t>(blockIdx.y) * n + col] = v;
    } else {
      if (col < n && v > 0) atomicMax(&col_max[col], v);
    }
  }
}

template <bool kScratch>
int launch(const void* a, int lda, const void* bt, int ldb, void* row_max,
           void* col_max, int m, int n, int k, void* stream) {
  if (lda % 16 != 0 || ldb % 16 != 0 || lda < k || ldb < k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(magmax_kernel<kScratch>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       gm8::kMmaSmemBytes);
  dim3 grid((n + gm8::kBN - 1) / gm8::kBN, (m + gm8::kBM - 1) / gm8::kBM);
  magmax_kernel<kScratch><<<grid, kThreads, gm8::kMmaSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const signed char*>(a), lda,
      static_cast<const signed char*>(bt), ldb, static_cast<int*>(row_max),
      static_cast<int*>(col_max), m, n, k);
  return gm8::launch_status();
}

}  // namespace

// a: (m, k) int8 with row stride lda; bt: (n, k) int8 (B transposed) with
// row stride ldb; lda, ldb multiples of 16 and both bases 16-byte aligned.
// row_max: m int32, col_max: n int32, both zero-filled by the caller.
// k <= 2^17 (checked by the caller).
GM8_EXPORT int gm8_magmax_matmul(const void* a, int lda, const void* bt,
                                 int ldb, void* row_max, void* col_max,
                                 int m, int n, int k, void* stream) {
  return launch<false>(a, lda, bt, ldb, row_max, col_max, m, n, k, stream);
}

// a, bt, m, n, k as for gm8_magmax_matmul. row_part: (m, ceil(n / 128))
// int32, col_part: (ceil(m / 128), n) int32; every entry is written, so no
// zero fill. The row maxima are row_part's row maxima, the column maxima
// col_part's column maxima.
GM8_EXPORT int gm8_magmax_matmul_scratch(const void* a, int lda,
                                         const void* bt, int ldb,
                                         void* row_part, void* col_part,
                                         int m, int n, int k, void* stream) {
  return launch<true>(a, lda, bt, ldb, row_part, col_part, m, n, k, stream);
}
