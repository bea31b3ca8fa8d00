// Fast-mode ("vecnorm") shift selection per row of A or per column of B,
// or (gm8_fast_stats) the raw statistics the shift is taken from: the max
// biased exponent, the f32 squared norm relative to it and the any-nonzero
// flag, which the complex path merges over Re and Im before it takes one
// shared shift.
//
// Replaces: fast_sft_pallas, gemmul8_tpu/pallas/kernels.py:54 (both its
// modes; return_stats=True is the second), each in its F64Bits and f32
// forms.
// Bound on the H100: device-memory bytes. Each element is read once (8
// bytes f64, 4 bytes f32) for a handful of integer and f32 operations; at
// 8192^2 that is 0.5 GB per f64 operand (0.27 GB f32), about 0.16 ms
// (0.08 ms) at 3.35 TB/s.
// Design: rows of A (axis=1) are contiguous, so one 256-thread block per
// row holds a 2048-wide chunk in registers (8 elements a thread), reduces
// the chunk's max exponent and then its f32 squared norm across the block,
// and merges chunks online exactly as the TPU kernel does (rescale by
// exact powers of two); at 8192^2 it reads at emax's rate, and staging the
// row in shared memory by cp.async first ran slower (H100 80GB HBM3, 700
// W). Columns of B (axis=0) are strided: a block takes 32 neighbouring
// columns (coalesced reads along a row) and one 2048-row chunk, split over
// 16 threads a column, each reading its 128-row run once in a running
// exponent frame (fast_stats.cuh). The grid is strips x chunks in
// clusters along the chunks (up to 8 blocks; a block takes chunk rank,
// rank + 8, ..); after each round the cluster's first block reads the
// others' chunk statistics from their shared memory and merges them in
// chunk order, so a strip's merge order is fixed and nothing goes through
// device memory. The sum order inside a chunk differs from XLA's, so a
// shift may differ by 1 where the floored value lies within f32 rounding
// of an integer (sft_floor_frac < 1e-4). The bodies live in
// fast_stats.cuh, shared with the fused stats + encode kernels
// (fast_encode_fused.cu), whose shifts are therefore these bits. The two
// modes share them; a template flag picks the final store. The source
// word is the other template parameter (src_word.cuh): an f32 operand's
// form reads 4-byte words with the same threads and order, and its shift
// takes bias 127.
#include <cooperative_groups.h>

#include "common.cuh"
#include "fast_stats.cuh"

#if !defined(GM8_SFT_COL_LOAD_BYTES) || !defined(GM8_SFT_COL_BLOCKS_PER_SM)
#error "fast_sft.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

namespace cg = cooperative_groups;

using gm8::kColX;
using gm8::kColY;
using gm8::kRowThreads;

constexpr int kMaxCluster = 8;  // the portable cluster size
// a column thread's loads in flight (and as many in hand), and the column
// kernel's blocks an SM that its registers must allow, from the launch
// table (hopper/launch.py `FastSftLaunch`). The row kernel's threads and
// the column kernel's 32 x 16 threads stay fixed: they set the order of
// the f32 norm's sums (fast_stats.cuh), which the shift's bits follow.
constexpr int kColLoadBytes = GM8_SFT_COL_LOAD_BYTES;
constexpr int kColBlocksPerSm = GM8_SFT_COL_BLOCKS_PER_SM;
static_assert(kColLoadBytes >= 8 && kColLoadBytes % 8 == 0,
              "a column thread loads whole f64 words (and f32 pairs)");
static_assert(kColBlocksPerSm >= 1 &&
                  kColBlocksPerSm * kColX * kColY <= 2048,
              "over the 2048 threads an SM holds");

// outputs of the stats mode: per row or column the max biased exponent,
// the f32 squared norm relative to it and the any-nonzero flag
struct StatsOut {
  long long* emax;
  float* nrm2;
  bool* any;
};

// the shift (kStats false) or the raw statistics (kStats true) of row or
// column i
template <bool kStats, typename Word>
__device__ __forceinline__ void store(int* out, const StatsOut& st, int i,
                                      const gm8::Stats& s, int t_f,
                                      float guard) {
  if constexpr (kStats) {
    st.emax[i] = s.emax;
    st.nrm2[i] = s.nrm2;
    st.any[i] = s.any != 0;
  } else {
    out[i] = gm8::sft_from_stats(s.emax, s.nrm2, s.any, t_f, guard,
                                 gm8::Src<Word>::kBias);
  }
}

template <bool kStats, typename Word>
__global__ void __launch_bounds__(kRowThreads)
sft_rows(const Word* __restrict__ x, int* __restrict__ out, StatsOut st,
         int kdim, int t_f, float guard) {
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  const gm8::Stats s =
      gm8::row_stats<Word>([xr](int k) { return __ldg(xr + k); }, kdim);
  if (threadIdx.x == 0)
    store<kStats, Word>(out, st, blockIdx.x, s, t_f, guard);
}

// strip blockIdx.x, chunks blockIdx.y, + gridDim.y, ..; gridDim.y is the
// cluster's size, so the cluster holds the strip's blocks
template <bool kStats, typename Word>
__global__ void __launch_bounds__(kColX * kColY, kColBlocksPerSm)
sft_cols(const Word* __restrict__ x, int* __restrict__ out, StatsOut st,
         int kdim, int cols, int t_f, float guard) {
  __shared__ gm8::Stats part[2][kColX];  // a round's chunk, by its parity
  cg::cluster_group cluster = cg::this_cluster();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColX + tx;
  const bool valid = col < cols;
  const int ways = static_cast<int>(gridDim.y);
  const int rank = static_cast<int>(cluster.block_rank());
  const int chunks = (kdim + gm8::kChunk - 1) / gm8::kChunk;
  gm8::Stats acc{0, 0.0f, 0};
  for (int r = 0; r * ways < chunks; ++r) {
    const int c = r * ways + rank;
    if (c < chunks) {
      const gm8::Stats s =
          gm8::col_chunk_stats<kColLoadBytes>(x, c * gm8::kChunk, kdim,
                                              cols, col, valid);
      if (ty == 0) part[r & 1][tx] = s;
    }
    // the round's parts are written; the last round but one's were read
    cluster.sync();
    if (rank == 0 && ty == 0) {
      for (int i = 0; i < ways && r * ways + i < chunks; ++i)
        acc = gm8::merge_stats(
            acc, *cluster.map_shared_rank(&part[r & 1][tx], i));
    }
  }
  cluster.sync();  // no block leaves while its parts may still be read
  if (rank == 0 && ty == 0 && valid)
    store<kStats, Word>(out, st, col, acc, t_f, guard);
}

template <bool kStats, typename Word>
int launch(const void* x, int* out, const StatsOut& st, int rows, int kdim,
           int axis, int t_f, float guard, cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    sft_rows<kStats, Word><<<rows, kRowThreads, 0, s>>>(xp, out, st, kdim,
                                                        t_f, guard);
    return gm8::launch_status();
  }
  const int chunks = (kdim + gm8::kChunk - 1) / gm8::kChunk;
  const int ways =
      chunks < 1 ? 1 : chunks < kMaxCluster ? chunks : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kColX - 1) / kColX, ways);
  cfg.blockDim = dim3(kColX, kColY);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ways;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, sft_cols<kStats, Word>, xp,
                                           out, st, kdim, rows, t_f, guard);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

// x: (rows, kdim) for axis=1 or (kdim, rows) for axis=0, f64 bits (f32 = 0)
// or f32 bits (f32 = 1). out: rows int32 shifts. t_f:
// tables.threshold_fast; guard: f32(1+k*2^-23).
GM8_EXPORT int gm8_fast_sft(const void* x, void* out, int rows, int kdim,
                            int axis, int t_f, float guard, int f32,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<int*>(out);
  if (f32)
    return launch<false, unsigned>(x, o, StatsOut{}, rows, kdim, axis, t_f,
                                   guard, s);
  return launch<false, unsigned long long>(x, o, StatsOut{}, rows, kdim,
                                           axis, t_f, guard, s);
}

// x as for gm8_fast_sft, f64 bits (f32 = 0) or f32 bits (f32 = 1). emax:
// rows int64; nrm2: rows f32; any: rows bool. The statistics carry no
// bias: the caller takes the shift at its operand's.
GM8_EXPORT int gm8_fast_stats(const void* x, void* emax, void* nrm2,
                              void* any, int rows, int kdim, int axis,
                              int f32, void* stream) {
  const StatsOut st{static_cast<long long*>(emax), static_cast<float*>(nrm2),
                    static_cast<bool*>(any)};
  auto s = static_cast<cudaStream_t>(stream);
  if (f32)
    return launch<true, unsigned>(x, nullptr, st, rows, kdim, axis, 0, 0.0f,
                                  s);
  return launch<true, unsigned long long>(x, nullptr, st, rows, kdim, axis,
                                          0, 0.0f, s);
}
