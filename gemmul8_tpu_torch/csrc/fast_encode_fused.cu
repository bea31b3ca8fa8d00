// Fast-mode shift selection and residue encode in one kernel: per row of A
// (axis=1) or column of B (axis=0) the shift of fast_sft.cu, then the
// (L, d0, d1) int8 centered residues of trunc(x * 2^sft), as encode.cu
// writes them.
//
// Replaces: fast_encode_fused_pallas, gemmul8_tpu/pallas/kernels.py:209
// (its F64Bits and f32 forms).
// Bound on the H100: device-memory bytes. Read once, each f64 element costs
// 8 bytes in and L bytes out: at 8192^2 and 14 moduli, 1.07 GB read and
// 1.88 GB written for both operands, 0.88 ms at 3.35 TB/s. An f32 element
// costs 4 bytes in (at 8 moduli, 0.54 GB read and 1.07 GB written, 0.48
// ms).
// Design: the TPU kernel held a row block's whole contraction extent in
// VMEM; a block here has 227 KB of shared memory. The statistics are
// fast_sft.cu's bodies (fast_stats.cuh: same threads, same summation
// order), so the shifts are the fast_sft kernel's bits, and the encode is
// encode.cu's tensor-core body (encode_mma.cuh: byte planes, mma.sync
// against the call's weight table, one multiply-and-shift a residue, a
// warp tile of 64 elements of a row, 16 consecutive residues of a slot in
// one 16-byte store; byte stores only at a ragged end).
// Rows of A: one 256-thread block per row. The row's words (up to
// kStageBytes: all of them to 8192 f64 or 16384 f32 elements) are copied
// into shared memory with cp.async, all in flight at once; the statistics
// and then the encode read them there, so the row comes from device memory
// once. A longer row's words past that are read twice, the second time
// from L2 (a size rule).
// Columns of B: a column's shift needs the whole column, and a 32-column
// strip (kdim x 256 bytes in f64, 2 MB at 8192) fits no SM. So the kernel
// is one cooperative launch of as many blocks as are resident: each takes
// the statistics of 32-column strips (32 x 16 threads, each chunk split
// into runs as fast_sft's column kernel splits it, the chunks walked in
// order: each word read once), a grid-wide barrier follows, and then every
// warp of the grid encodes B as encode.cu walks it, in row-major order,
// last rows first (the rows the statistics read last, likeliest still in
// L2), the shifts read back from the output. So B is read twice, once for
// the statistics and once to encode, the second time mostly from device
// memory at 8192^2 (its 537 MB are ten times L2), but in
// the order that keeps each slice's writes whole rows of 128-byte lines
// (encoding strip by strip, each block in its own strip, wrote 32 bytes a
// row of each slice at a time, and ran slower).
// The source word is a template parameter (src_word.cuh), as in the
// kernels it fuses: the f32 form reads 4-byte words with the same threads
// and order, takes its shift at bias 127 and its left shifts up to 53.
#include <cstring>

#include "common.cuh"
#include "encode_mma.cuh"
#include "fast_stats.cuh"

#if !defined(GM8_FUSED_STAGE_BYTES) || !defined(GM8_FUSED_COL_LOAD_BYTES)
#error "fast_encode_fused.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::EncMmaTable;
using gm8::kColX;
using gm8::kColY;
using gm8::kEncTile;
using gm8::kRowThreads;

constexpr int kRowWarps = kRowThreads / 32;
constexpr int kColThreads = kColX * kColY;
constexpr int kColWarps = kColThreads / 32;
constexpr int kRowStep = kRowWarps * kEncTile;  // a step of the row's encode
// From the launch table (hopper/launch.py `FastEncodeFusedLaunch`): a
// row's words kept in shared memory (64 KB: 8192 f64 or 16384 f32
// elements), a multiple of the block's 512-element encode step in f64
// words; and a column thread's loads in flight in the statistics (8 bytes:
// the most that leaves every form free of spills beside the encode's
// registers; 16 spilled in the f64 one-slot-tile form, 32 in the f32 one).
constexpr int kStageBytes = GM8_FUSED_STAGE_BYTES;
constexpr int kColLoadBytes = GM8_FUSED_COL_LOAD_BYTES;
constexpr int kStepBytes = kRowStep * 8;  // an encode step of f64 words
static_assert(kStageBytes > 0 &&
                  kStageBytes / kStepBytes * kStepBytes == kStageBytes,
              "whole encode steps of f64 words staged");
static_assert(kColLoadBytes >= 8 && kColLoadBytes / 8 * 8 == kColLoadBytes,
              "a column thread loads whole f64 words (and f32 pairs)");
static_assert(kStageBytes + 16 + kRowWarps * kEncTile * 16 +
                      sizeof(EncMmaTable) + 2 * 4 * (kRowThreads / 32) <=
                  232448,
              "the row kernel: over the shared memory a block may opt into "
              "on sm_90");

// every thread of every block of the grid, all of whose blocks are
// resident (a cooperative launch); count: zero before the launch. The
// global-memory writes before it are seen by every block after it. A
// block still waiting after 2^35 SM cycles (over 17 s) has lost a peer:
// it traps, which fails the launch, rather than hang the card.
__device__ __forceinline__ void grid_sync(unsigned* count) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(count, 1u);
    const long long t0 = clock64();
    while (*static_cast<volatile unsigned*>(count) < gridDim.x) {
      __nanosleep(64);
      if (clock64() - t0 > (1LL << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// the call's table into shared memory (encode.cu: from the kernel
// parameter, per-lane reads serialise); visible after the block's next
// barrier
__device__ __forceinline__ void copy_table(EncMmaTable& S,
                                           const EncMmaTable& T, int tid,
                                           int nthreads) {
  for (int i = tid; i < static_cast<int>(sizeof(S) / 16); i += nthreads)
    reinterpret_cast<uint4*>(&S)[i] = reinterpret_cast<const uint4*>(&T)[i];
}

// elements k and k + 1 of a line at p (shared or global memory, written
// before this kernel or before the block's last barrier), zero at or past
// end: one 16-byte load for f64 (8 for f32) where both lie before end and
// the pair is aligned
template <typename Word>
__device__ __forceinline__ void load_pair(const Word* p, int k, int end,
                                          Word& w0, Word& w1) {
  const Word* q = p + k;
  w0 = w1 = Word(0);
  if (k + 1 < end &&
      (reinterpret_cast<uintptr_t>(q) & (2 * sizeof(Word) - 1)) == 0) {
    if constexpr (sizeof(Word) == 8) {
      const ulonglong2 v = *reinterpret_cast<const ulonglong2*>(q);
      w0 = v.x;
      w1 = v.y;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      w0 = v.x;
      w1 = v.y;
    }
  } else {
    if (k < end) w0 = q[0];
    if (k + 1 < end) w1 = q[1];
  }
}

// words [e0, e1) of a row xr into the same places of stage, in flight on
// return (cp.async: 16 bytes a copy where the row is 16-byte aligned and
// e0 a multiple of 16 bytes, else a word a copy); cp_wait_all() waits for
// every copy this thread issued
template <typename Word>
__device__ __forceinline__ void stage_words(Word* stage, const Word* xr,
                                            int e0, int e1) {
  constexpr int kSize = static_cast<int>(sizeof(Word));
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(stage));
  if ((reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
    const char* src = reinterpret_cast<const char*>(xr);
    const int b1 = e1 * kSize;
    for (int b = e0 * kSize + 16 * static_cast<int>(threadIdx.x); b < b1;
         b += 16 * kRowThreads)
      asm volatile(
          "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst + b),
          "l"(src + b), "r"(min(16, b1 - b))
          : "memory");
  } else {
    for (int k = e0 + static_cast<int>(threadIdx.x); k < e1;
         k += kRowThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                       dst + kSize * k),
                   "l"(xr + k), "n"(kSize)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared16(unsigned addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// st: the shared addresses of the lane's two plane rows
template <int kMT, typename Word, typename Store>
__device__ __forceinline__ void encode_tile(const gm8::EncSlots<kMT>& slots,
                                            const unsigned (&st)[2],
                                            const unsigned (&ld_addr)[2],
                                            Word w0, Word w1, int s0, int s1,
                                            int q_max, int L, Store store) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  st_shared16(st[0], gm8::enc_planes(w0, s0, q_max));
  st_shared16(st[1], gm8::enc_planes(w1, s1, q_max));
  __syncwarp();
  unsigned b[8];
  gm8::enc_frags(ld_addr, b);
  __syncwarp();  // the next tile's planes overwrite these rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    unsigned w[2][4];
    slots.contract_reduce(mt, b, w);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int l = 16 * mt + 8 * h + g;
      if (l < L) store(l, tq, w[h]);
    }
  }
}

// A (rows, kdim): one block per row. The row's first `staged` words are
// copied into shared memory, all in flight at once, before its statistics
// (the rest, if any, is read from global memory, twice); its encode reads
// them from there
template <typename Word, int kMT>
__global__ void __launch_bounds__(kRowThreads)
fused_rows(const Word* __restrict__ x, signed char* __restrict__ out,
           int* __restrict__ sft_out, int rows, int kdim, int staged, int L,
           int t_f, float guard, int q_max,
           const __grid_constant__ EncMmaTable T) {
  extern __shared__ __align__(16) unsigned char dyn[];
  Word* const stage = reinterpret_cast<Word*>(dyn);
  __shared__ __align__(16) uint4 planes[kRowWarps][kEncTile];
  __shared__ EncMmaTable S;
  copy_table(S, T, threadIdx.x, kRowThreads);
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  stage_words(stage, xr, 0, staged);
  cp_wait_all();
  __syncthreads();  // the staged words and the table
  const gm8::Stats s = gm8::row_stats<Word>(
      [xr, stage, staged](int k) {
        return k < staged ? stage[k] : __ldg(xr + k);
      },
      kdim);
  const int sft = gm8::sft_from_stats(s.emax, s.nrm2, s.any, t_f, guard,
                                      gm8::Src<Word>::kBias);
  if (threadIdx.x == 0) sft_out[blockIdx.x] = sft;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const gm8::EncSlots<kMT> slots(S);
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(planes[warp]));
  const unsigned ld_addr[2] = {gm8::enc_ld_addr(sbase, 0),
                               gm8::enc_ld_addr(sbase, 1)};
  const unsigned st[2] = {sbase + 16 * gm8::enc_row(2 * lane),
                          sbase + 16 * gm8::enc_row(2 * lane + 1)};
  const size_t total = static_cast<size_t>(rows) * kdim;
  signed char* const orow = out + static_cast<size_t>(blockIdx.x) * kdim;
  for (int c = warp * kEncTile; c < kdim; c += kRowStep) {
    Word w0, w1;
    load_pair(c < staged ? static_cast<const Word*>(stage) : xr,
              c + 2 * lane, kdim, w0, w1);
    encode_tile(slots, st, ld_addr, w0, w1, sft, sft, q_max, L,
                [=](int l, int tq, const unsigned (&w)[4]) {
                  gm8::enc_store16(orow + l * total, c + 16 * tq, kdim, w);
                });
  }
}

// B (kdim, cols): the statistics of kColX-column strips (strip blockIdx.x,
// then every gridDim.x-th), a grid-wide barrier, then the encode of all of
// B as encode.cu walks it: warp tiles of 64 columns of a row in row-major
// order over the grid's warps, last rows first (those the statistics read
// last), the shifts read back from sft_out
template <typename Word, int kMT>
__global__ void __launch_bounds__(kColThreads, kMT == 1 ? 2 : 1)
fused_cols(const Word* __restrict__ x, signed char* __restrict__ out,
           int* __restrict__ sft_out, int cols, int kdim, int L, int t_f,
           float guard, int q_max, const __grid_constant__ EncMmaTable T,
           unsigned* sync) {
  __shared__ __align__(16) uint4 planes[kColWarps][kEncTile];
  __shared__ EncMmaTable S;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kColX + tx;
  copy_table(S, T, tid, kColThreads);
  const int strips = (cols + kColX - 1) / kColX;
  for (int strip = blockIdx.x; strip < strips; strip += gridDim.x) {
    const int col = strip * kColX + tx;
    const bool valid = col < cols;
    const gm8::Stats s =
        gm8::col_stats<kColLoadBytes>(x, kdim, cols, col, valid);
    if (ty == 0 && valid)
      sft_out[col] = gm8::sft_from_stats(s.emax, s.nrm2, s.any, t_f, guard,
                                         gm8::Src<Word>::kBias);
  }
  grid_sync(sync);  // every shift, and the table

  const int warp = tid >> 5, lane = tid & 31;
  const gm8::EncSlots<kMT> slots(S);
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(planes[warp]));
  const unsigned ld_addr[2] = {gm8::enc_ld_addr(sbase, 0),
                               gm8::enc_ld_addr(sbase, 1)};
  const unsigned st[2] = {sbase + 16 * gm8::enc_row(2 * lane),
                          sbase + 16 * gm8::enc_row(2 * lane + 1)};
  const size_t total = static_cast<size_t>(kdim) * cols;
  // tile (r, ct): row r, columns 64 ct..; the grid's warps walk them in
  // row-major order from the last, a stride of drow rows and dct tiles
  // apart, without a division in the loop
  const int ntc = (cols + kEncTile - 1) / kEncTile;
  const long long stride = static_cast<long long>(gridDim.x) * kColWarps;
  const long long t0 = static_cast<long long>(kdim) * ntc - 1 -
                       (static_cast<long long>(blockIdx.x) * kColWarps + warp);
  if (t0 < 0) return;
  const int drow = static_cast<int>(stride / ntc);
  const int dct =
      static_cast<int>(stride - static_cast<long long>(drow) * ntc);
  int r = static_cast<int>(t0 / ntc);
  int ct = static_cast<int>(t0 - static_cast<long long>(r) * ntc);
  // the words of tile (rr, cc), lane's columns 64 cc + 2 lane, + 1; zeros
  // where rr < 0
  auto fetch = [=](int rr, int cc, Word& a0, Word& a1) {
    a0 = a1 = Word(0);
    if (rr >= 0)
      load_pair(x + static_cast<size_t>(rr) * cols, kEncTile * cc + 2 * lane,
                cols, a0, a1);
  };
  Word w0, w1;
  fetch(r, ct, w0, w1);
  while (r >= 0) {
    int nr = r - drow, nct = ct - dct;
    if (nct < 0) {
      nct += ntc;
      --nr;
    }
    // the next tile's words, in flight during this tile's contraction
    Word n0w, n1w;
    fetch(nr, nct, n0w, n1w);
    const int c = kEncTile * ct + 2 * lane;
    const int s0 = c < cols ? __ldcg(sft_out + c) : 0;
    const int s1 = c + 1 < cols ? __ldcg(sft_out + c + 1) : 0;
    const int c0 = kEncTile * ct;
    signed char* const orow = out + static_cast<size_t>(r) * cols;
    encode_tile(slots, st, ld_addr, w0, w1, s0, s1, q_max, L,
                [=](int l, int tq, const unsigned (&w)[4]) {
                  gm8::enc_store16(orow + l * total, c0 + 16 * tq, cols, w);
                });
    r = nr;
    ct = nct;
    w0 = n0w;
    w1 = n1w;
  }
}

template <typename Word, int kMT>
int launch(const void* x, signed char* op, int* sp, int rows, int kdim,
           int axis, int L, int t_f, float guard, int q_max,
           const EncMmaTable& T, unsigned* sync, cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    constexpr int kMaxStaged = kStageBytes / static_cast<int>(sizeof(Word));
    const int staged = kdim < kMaxStaged ? kdim : kMaxStaged;
    // a 16-byte copy at a ragged end fills up to 16 bytes past the words
    const int bytes = staged * static_cast<int>(sizeof(Word)) + 16;
    cudaFuncSetAttribute(fused_rows<Word, kMT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kStageBytes + 16);
    fused_rows<Word, kMT><<<rows, kRowThreads, bytes, s>>>(
        xp, op, sp, rows, kdim, staged, L, t_f, guard, q_max, T);
    return gm8::launch_status();
  }
  // as many blocks as are resident at once, no more than there are strips
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_cols<Word, kMT>, kColThreads, 0);
  const int strips = (rows + kColX - 1) / kColX;
  const int grid = strips < per_sm * sms ? strips : per_sm * sms;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&xp, &op, &sp, &rows, &kdim, &L, &t_f, &guard, &q_max,
                  const_cast<EncMmaTable*>(&T), &sync};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_cols<Word, kMT>), dim3(grid),
      dim3(kColX, kColY), args, 0, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename Word>
int launch_word(const void* x, signed char* op, int* sp, int rows, int kdim,
                int axis, int L, int t_f, float guard, int q_max,
                const EncMmaTable& T, unsigned* sync, cudaStream_t s) {
  return L <= 16 ? launch<Word, 1>(x, op, sp, rows, kdim, axis, L, t_f,
                                   guard, q_max, T, sync, s)
                 : launch<Word, 2>(x, op, sp, rows, kdim, axis, L, t_f,
                                   guard, q_max, T, sync, s);
}

}  // namespace

// x: (rows, kdim) for axis=1, (kdim, rows) for axis=0, f64 bits (f32 = 0)
// or f32 bits (f32 = 1). out: (num_moduli, d0, d1) int8 slices in x's
// layout; sft: rows int32. table: the EncMmaTable of the moduli 0 ..
// num_moduli - 1, on the host (hopper/kernels.py encode_mma_table). t_f:
// tables.threshold_fast; guard: f32(1 + k * 2^-23); q_max: the static
// left-shift cap max(threshold_accurate - mant_bits, 0) (mant_bits 53 for
// f64, 24 for f32). sync: for axis=0, one zeroed uint32 of device memory,
// the counter of the column form's grid-wide barrier (unused for axis=1).
// The column form is a cooperative launch; a grid of more blocks than are
// resident at once is refused by the runtime, never run.
GM8_EXPORT int gm8_fast_encode_fused(const void* x, void* out, void* sft,
                                     int rows, int kdim, int axis,
                                     const void* table, int num_moduli,
                                     int t_f, float guard, int q_max, int f32,
                                     void* sync, void* stream) {
  if (num_moduli < 1 || num_moduli > gm8::kMaxModuli || rows < 1 ||
      kdim < 1 || (axis != 0 && axis != 1) || q_max < 0 ||
      q_max > (f32 ? 53 : 24) || (axis == 0 && sync == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  EncMmaTable T;
  std::memcpy(&T, table, sizeof(T));
  auto s = static_cast<cudaStream_t>(stream);
  auto op = static_cast<signed char*>(out);
  auto sp = static_cast<int*>(sft);
  auto sy = static_cast<unsigned*>(sync);
  return f32 ? launch_word<unsigned>(x, op, sp, rows, kdim, axis, num_moduli,
                                     t_f, guard, q_max, T, sy, s)
             : launch_word<unsigned long long>(x, op, sp, rows, kdim, axis,
                                               num_moduli, t_f, guard, q_max,
                                               T, sy, s);
}
