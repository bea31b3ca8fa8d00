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
// come from never changes the order they are summed in. Columns
// (col_stats): a kColX x kColY
// block takes kColX neighbouring columns (coalesced reads along a row) and
// splits each chunk of rows over kColY threads per column; each thread
// reads its rows twice (max, then norm) instead of holding them. Every
// thread of the row's block, or of the column's kColY threads, returns the
// same statistics. The kernels have internal linkage, so each including
// source gets its own copy.
#pragma once

#include "common.cuh"
#include "src_word.cuh"

namespace gm8 {
namespace {

constexpr int kChunk = 2048;  // tables.STATS_CHUNK: part of the bit contract
constexpr int kRowThreads = 256;
constexpr int kColX = 32;
constexpr int kColY = 16;

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
  int e_acc = 0, any_acc = 0;
  float s_acc = 0.0f;
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
    int af = __syncthreads_or(any_t);
    if (c0 == 0) {
      e_acc = e_blk;
      s_acc = s_blk;
      any_acc = af;
    } else {
      int e_new = max(e_acc, e_blk);
      s_acc = merge(s_acc, e_acc, s_blk, e_blk, e_new);
      e_acc = e_new;
      any_acc |= af;
    }
  }
  return {e_acc, s_acc, any_acc};
}

// the statistics of column col of x (kdim, cols), valid = col < cols; every
// thread of the kColX x kColY block must call it
template <typename Word>
__device__ __forceinline__ Stats col_stats(const Word* __restrict__ x,
                                           int kdim, int cols, int col,
                                           bool valid) {
  constexpr int kRows = kChunk / kColY;
  __shared__ int sh_e[kColY][kColX];
  __shared__ int sh_a[kColY][kColX];
  __shared__ float sh_s[kColY][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  int e_acc = 0, any_acc = 0;
  float s_acc = 0.0f;
  for (int c0 = 0; c0 < kdim; c0 += kChunk) {
    const int r0 = c0 + ty * kRows;
    const int r1 = min(r0 + kRows, kdim);
    int e_t = 0, any_t = 0;
    if (valid) {
      for (int r = r0; r < r1; ++r) {
        Fields f = fields(x[static_cast<size_t>(r) * cols + col]);
        if (f.nonzero) {
          e_t = max(e_t, f.exp);
          any_t = 1;
        }
      }
    }
    sh_e[ty][tx] = e_t;
    sh_a[ty][tx] = any_t;
    __syncthreads();
    int e_blk = 0, af = 0;
    for (int i = 0; i < kColY; ++i) {
      e_blk = max(e_blk, sh_e[i][tx]);
      af |= sh_a[i][tx];
    }
    float part = 0.0f;
    if (valid) {
      for (int r = r0; r < r1; ++r) {
        float xs = scaled_abs(fields(x[static_cast<size_t>(r) * cols + col]),
                              e_blk);
        part = __fadd_rn(part, __fmul_rn(xs, xs));
      }
    }
    sh_s[ty][tx] = part;
    __syncthreads();
    float s_blk = 0.0f;
    for (int i = 0; i < kColY; ++i) s_blk = __fadd_rn(s_blk, sh_s[i][tx]);
    __syncthreads();  // shared tiles are rewritten by the next chunk
    if (c0 == 0) {
      e_acc = e_blk;
      s_acc = s_blk;
      any_acc = af;
    } else {
      int e_new = max(e_acc, e_blk);
      s_acc = merge(s_acc, e_acc, s_blk, e_blk, e_new);
      e_acc = e_new;
      any_acc |= af;
    }
  }
  return {e_acc, s_acc, any_acc};
}

}  // namespace
}  // namespace gm8
