// The fast-mode ("vecnorm") statistics of one row or column of an f64 or
// f32 operand: the max biased exponent, the f32 squared norm relative to
// it, merged online over 2048-wide chunks, and the any-nonzero flag; and
// the shift taken from them. The source word is a template parameter
// (unsigned long long: f64 bits, unsigned: f32 bits; src_word.cuh), so
// every kernel built on these bodies gets both forms by instantiation.
// Shared by the shift kernels (fast_sft.cu) and the fused stats + encode
// kernels (fast_encode_fused.cu, which encodes on the tensor cores with
// encode_mma.cuh), so both give the same bits: one body, one summation
// order.
//
// Rows (row_stats): one kRowThreads-thread block per row holds a chunk in
// registers (8 elements a thread), reduces its max exponent and then its
// f32 squared norm across the block. The row's words come through a
// loader (element k of the row), so a caller may also keep them as they
// pass (the fused kernel stages the row in shared memory); where the words
// come from never changes the order they are summed in.
// Columns (col_chunk_stats, one 2048-row chunk): a kColX x kColY block
// takes kColX neighbouring columns (coalesced reads along a row) and
// splits the chunk's rows into kColY runs of kColRun rows, one a thread.
// A thread reads its run once, a batch of loads in flight while it sums
// the batch before, summing the squares relative to the running max
// exponent of what it has read (its frame) and rescaling the sum by an
// exact 2^-2d when that max rises by d; at the chunk's end each run's sum
// is scaled to the chunk's max and the runs are summed in thread order.
// Without subnormals, scaling by a power of two commutes with f32
// rounding, so these are the bits of summing each run relative to the
// chunk's max from the start (the order of reading the run twice, max
// then norm), except where a term or a sum falls below f32's normal range
// in one frame and not the other: elements 63 or more binades under their
// chunk's max, which can move a shift only at a floor boundary.
// core/encode.py fast_stats_running is the plain twin of this order.
// Chunks merge in chunk order (merge_stats: rescaled by exact powers of
// two), from a zero accumulator, which merges as the identity. The
// kernels have internal linkage, so each including source gets its own
// copy.
#pragma once

#include "common.cuh"
#include "src_word.cuh"

namespace gm8 {
namespace {

// The chunk, the row block's threads (8 elements a thread, then a warp
// shuffle tree and the 8 warps in order) and a column's 16 runs of 128
// rows set the order of the f32 norm's sums, which the shift's bits
// follow: they are part of the bit contract, not launch entries
// (core/encode.py fast_stats_running(run=128, ways=16) is the columns'
// plain twin).
constexpr int kChunk = 2048;  // tables.STATS_CHUNK
constexpr int kRowThreads = 256;
constexpr int kColX = 32;
constexpr int kColY = 16;
constexpr int kColRun = kChunk / kColY;  // a column thread's run of rows

struct Fields {
  int exp;       // biased exponent, 1 for subnormals
  bool nonzero;
  unsigned m23;  // top 23 stored mantissa bits
};

struct Stats {
  int emax;
  float nrm2;
  int any;
};

template <typename Word>
__device__ __forceinline__ Fields fields(Word bits) {
  using S = Src<Word>;
  Fields f;
  const int e = S::biased_exp(bits);
  f.exp = e > 0 ? e : 1;
  f.nonzero = (bits << 1) != Word(0);
  f.m23 = static_cast<unsigned>((bits >> (S::kStored - 23)) & 0x7FFFFF);
  return f;
}

// |x| * 2^-(e_blk - bias) as f32, 0 where its exponent would underflow
__device__ __forceinline__ float scaled_abs(const Fields& f, int e_blk) {
  int eb = f.exp - e_blk + 127;
  return (f.nonzero && eb >= 1) ? __int_as_float((eb << 23) | f.m23) : 0.0f;
}

// exact 2^e for e <= 0; 0 below the normal range
__device__ __forceinline__ float pow2f(int e) {
  return e >= -126 ? __int_as_float((e + 127) << 23) : 0.0f;
}

__device__ __forceinline__ float merge(float s_acc, int e_acc, float s_blk,
                                       int e_blk, int e_new) {
  return __fadd_rn(__fmul_rn(s_acc, pow2f(2 * (e_acc - e_new))),
                   __fmul_rn(s_blk, pow2f(2 * (e_blk - e_new))));
}

// acc followed by the next chunk's statistics b; from acc = {0, 0, 0} it
// gives b's bits
__device__ __forceinline__ Stats merge_stats(const Stats& acc,
                                             const Stats& b) {
  const int e_new = max(acc.emax, b.emax);
  return {e_new, merge(acc.nrm2, acc.emax, b.nrm2, b.emax, e_new),
          acc.any | b.any};
}

// bias: the operand's exponent bias (Src<Word>::kBias)
__device__ __forceinline__ int sft_from_stats(int emax, float nrm2, int any,
                                              int t_f, float guard,
                                              int bias = 1023) {
  float n2 = fmaxf(__fmul_rn(nrm2, guard), 1.0f);
  float v = floorf(__fadd_rn(__fmul_rn(log2f(n2), -0.51f),
                             static_cast<float>(t_f)));
  int s = min(t_f - 1, static_cast<int>(v)) - (emax - bias);
  return any ? s : 0;
}

__device__ __forceinline__ int block_max(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < kRowThreads / 32; ++i) v = max(v, sh[i]);
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  v = sh[0];
  for (int i = 1; i < kRowThreads / 32; ++i) v = __fadd_rn(v, sh[i]);
  return v;
}

// the statistics of a row of kdim elements, element k read as load(k)
// (once, for k < kdim, by thread k % kRowThreads); every thread of the
// kRowThreads-thread block must call it
template <typename Word, typename Load>
__device__ __forceinline__ Stats row_stats(Load load, int kdim) {
  constexpr int kPer = kChunk / kRowThreads;
  __shared__ int sh_i[kRowThreads / 32];
  __shared__ float sh_f[kRowThreads / 32];
  Stats acc{0, 0.0f, 0};
  for (int c0 = 0; c0 < kdim; c0 += kChunk) {
    Fields f[kPer];
    int e_t = 0, any_t = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int k = c0 + i * kRowThreads + threadIdx.x;
      f[i] = fields(k < kdim ? load(k) : Word(0));
      if (f[i].nonzero) {
        e_t = max(e_t, f[i].exp);
        any_t = 1;
      }
    }
    int e_blk = block_max(e_t, sh_i);
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float xs = scaled_abs(f[i], e_blk);
      part = __fadd_rn(part, __fmul_rn(xs, xs));
    }
    float s_blk = block_sum(part, sh_f);
    acc = merge_stats(acc, {e_blk, s_blk, __syncthreads_or(any_t)});
  }
  return acc;
}

// a column thread's running frame over its run: the max biased exponent
// of the nonzero words read so far, the f32 sum of their squares relative
// to it, whether any was nonzero
template <typename Word>
__device__ __forceinline__ void frame_add(Stats& fr, Word w) {
  const Fields f = fields(w);
  if (!f.nonzero) return;
  if (f.exp > fr.emax) {
    fr.nrm2 = __fmul_rn(fr.nrm2, pow2f(2 * (fr.emax - f.exp)));
    fr.emax = f.exp;
  }
  const float xs = scaled_abs(f, fr.emax);
  fr.nrm2 = __fadd_rn(fr.nrm2, __fmul_rn(xs, xs));
  fr.any = 1;
}

// frame_add's bits for an f32 word in fewer instructions (the column body
// is latency-bound, an f32 word most), its fields taken from the word
// whole: |w|'s bits less (emax - 127) << 23 are the scaled value's bits,
// a subnormal first given exponent 1 (fields' rule)
template <>
__device__ __forceinline__ void frame_add(Stats& fr, unsigned w) {
  unsigned a = w & 0x7FFFFFFFu;
  if (a < (1u << 23)) {
    if (a == 0) return;
    a += 1u << 23;
  }
  const int e = static_cast<int>(a >> 23);
  if (e > fr.emax) {
    fr.nrm2 = __fmul_rn(fr.nrm2, pow2f(2 * (fr.emax - e)));
    fr.emax = e;
  }
  const int xb = static_cast<int>(a) - ((fr.emax - 127) << 23);
  const float xs = xb >= (1 << 23) ? __int_as_float(xb) : 0.0f;
  fr.nrm2 = __fadd_rn(fr.nrm2, __fmul_rn(xs, xs));
  fr.any = 1;
}

// the statistics of the chunk of rows [c0, c0 + kChunk) of column col of
// x (kdim, cols), valid = col < cols: each word read once (thread ty's
// run of kColRun rows in its frame, in batches of kLoadBytes, the next
// batch's loads issued before the batch in hand is summed), the runs
// scaled to the chunk's max and summed in ty order. Every thread of the
// kColX x kColY block must call it; each gets its column's statistics.
template <int kLoadBytes, typename Word>
__device__ __forceinline__ Stats col_chunk_stats(const Word* __restrict__ x,
                                                 int c0, int kdim, int cols,
                                                 int col, bool valid) {
  constexpr int kBatch = kLoadBytes / static_cast<int>(sizeof(Word));
  __shared__ Stats sh[kColY][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  Stats fr{0, 0.0f, 0};
  const int r0 = c0 + ty * kColRun;
  const int n = valid ? min(kColRun, kdim - r0) : 0;
  const Word* p = x + static_cast<size_t>(r0) * cols + col;
  // words i .. i + kBatch - 1 of the run, zero past its end
  auto load = [p, n, cols](Word (&w)[kBatch], int i) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      w[j] = i + j < n ? __ldg(p + static_cast<size_t>(i + j) * cols)
                       : Word(0);
  };
  Word w[kBatch], next[kBatch];
  load(w, 0);
  for (int i = 0; i < n; i += kBatch) {
    load(next, i + kBatch);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) frame_add(fr, w[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) w[j] = next[j];
  }
  sh[ty][tx] = fr;
  __syncthreads();
  Stats s{0, 0.0f, 0};
  for (int i = 0; i < kColY; ++i) {
    s.emax = max(s.emax, sh[i][tx].emax);
    s.any |= sh[i][tx].any;
  }
  for (int i = 0; i < kColY; ++i)
    s.nrm2 = __fadd_rn(s.nrm2, __fmul_rn(sh[i][tx].nrm2,
                                         pow2f(2 * (sh[i][tx].emax -
                                                    s.emax))));
  __syncthreads();  // sh is rewritten by the next chunk
  return s;
}

// the statistics of column col of x (kdim, cols), valid = col < cols: its
// chunks in order, each word read once; every thread of the kColX x kColY
// block must call it
template <int kLoadBytes, typename Word>
__device__ __forceinline__ Stats col_stats(const Word* __restrict__ x,
                                           int kdim, int cols, int col,
                                           bool valid) {
  Stats acc{0, 0.0f, 0};
  for (int c0 = 0; c0 < kdim; c0 += kChunk)
    acc = merge_stats(acc, col_chunk_stats<kLoadBytes>(x, c0, kdim, cols,
                                                       col, valid));
  return acc;
}

}  // namespace
}  // namespace gm8
