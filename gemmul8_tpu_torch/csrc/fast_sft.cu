// Fast-mode ("vecnorm") shift selection per row of A or per column of B,
// or (gm8_fast_stats) the raw statistics the shift is taken from: the max
// biased exponent, the f32 squared norm relative to it and the any-nonzero
// flag, which the complex path merges over Re and Im before it takes one
// shared shift.
//
// Replaces: fast_sft_pallas, gemmul8_tpu/pallas/kernels.py:54 (both its
// modes; return_stats=True is the second).
// Bound on the H100: device-memory bytes. Each f64 element is read once
// (8 bytes) for a handful of integer and f32 operations; at 8192^2 that is
// 0.5 GB per operand, about 0.16 ms at 3.35 TB/s.
// Design: rows of A (axis=1) are contiguous, so one 256-thread block per
// row holds a 2048-wide chunk in registers (8 elements a thread), reduces
// the chunk's max exponent and then its f32 squared norm across the block,
// and merges chunks online exactly as the TPU kernel does (rescale by exact
// powers of two). Columns of B (axis=0) are strided, so a block takes 32
// neighbouring columns (coalesced reads along a row) and splits each chunk
// of rows over 16 threads per column; each thread reads its rows twice
// (max, then norm) instead of holding them. The sum order inside a chunk
// differs from XLA's, so a shift may differ by 1 where the floored value
// lies within f32 rounding of an integer (sft_floor_frac < 1e-4). The two
// modes share the kernel bodies; a template flag picks the final store, so
// the shift mode compiles as it did before the stats mode existed.
#include "common.cuh"

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

__device__ __forceinline__ Fields fields(unsigned long long bits) {
  Fields f;
  int e = static_cast<int>((bits >> 52) & 0x7FF);
  f.exp = e > 0 ? e : 1;
  f.nonzero = (bits << 1) != 0ull;
  f.m23 = static_cast<unsigned>((bits >> 29) & 0x7FFFFF);
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

__device__ __forceinline__ int sft_from_stats(int emax, float nrm2, int any,
                                              int t_f, float guard) {
  float n2 = fmaxf(__fmul_rn(nrm2, guard), 1.0f);
  float v = floorf(__fadd_rn(__fmul_rn(log2f(n2), -0.51f),
                             static_cast<float>(t_f)));
  int s = min(t_f - 1, static_cast<int>(v)) - (emax - 1023);
  return any ? s : 0;
}

// outputs of the stats mode: per row or column the max biased exponent,
// the f32 squared norm relative to it and the any-nonzero flag
struct StatsOut {
  long long* emax;
  float* nrm2;
  bool* any;
};

// the shift (kStats false) or the raw statistics (kStats true) of row or
// column i
template <bool kStats>
__device__ __forceinline__ void store(int* out, const StatsOut& st, int i,
                                      int emax, float nrm2, int any, int t_f,
                                      float guard) {
  if constexpr (kStats) {
    st.emax[i] = emax;
    st.nrm2[i] = nrm2;
    st.any[i] = any != 0;
  } else {
    out[i] = sft_from_stats(emax, nrm2, any, t_f, guard);
  }
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

template <bool kStats>
__global__ void __launch_bounds__(kRowThreads)
sft_rows(const unsigned long long* __restrict__ x, int* __restrict__ out,
         StatsOut st, int kdim, int t_f, float guard) {
  constexpr int kPer = kChunk / kRowThreads;
  __shared__ int sh_i[kRowThreads / 32];
  __shared__ float sh_f[kRowThreads / 32];
  const unsigned long long* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  int e_acc = 0, any_acc = 0;
  float s_acc = 0.0f;
  for (int c0 = 0; c0 < kdim; c0 += kChunk) {
    Fields f[kPer];
    int e_t = 0, any_t = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      int k = c0 + i * kRowThreads + threadIdx.x;
      f[i] = fields(k < kdim ? xr[k] : 0ull);
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
  if (threadIdx.x == 0)
    store<kStats>(out, st, blockIdx.x, e_acc, s_acc, any_acc, t_f, guard);
}

template <bool kStats>
__global__ void __launch_bounds__(kColX * kColY)
sft_cols(const unsigned long long* __restrict__ x, int* __restrict__ out,
         StatsOut st, int kdim, int cols, int t_f, float guard) {
  constexpr int kRows = kChunk / kColY;
  __shared__ int sh_e[kColY][kColX];
  __shared__ int sh_a[kColY][kColX];
  __shared__ float sh_s[kColY][kColX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * kColX + tx;
  const bool valid = col < cols;
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
  if (valid && ty == 0)
    store<kStats>(out, st, col, e_acc, s_acc, any_acc, t_f, guard);
}

template <bool kStats>
int launch(const void* x, int* out, const StatsOut& st, int rows, int kdim,
           int axis, int t_f, float guard, cudaStream_t s) {
  auto xp = static_cast<const unsigned long long*>(x);
  if (axis == 1) {
    sft_rows<kStats><<<rows, kRowThreads, 0, s>>>(xp, out, st, kdim, t_f,
                                                  guard);
  } else {
    dim3 block(kColX, kColY);
    sft_cols<kStats><<<(rows + kColX - 1) / kColX, block, 0, s>>>(
        xp, out, st, kdim, rows, t_f, guard);
  }
  return gm8::launch_status();
}

}  // namespace

// x: (rows, kdim) for axis=1 or (kdim, rows) for axis=0, f64 bits.
// out: rows int32 shifts. t_f: tables.threshold_fast; guard: f32(1+k*2^-23).
GM8_EXPORT int gm8_fast_sft(const void* x, void* out, int rows, int kdim,
                            int axis, int t_f, float guard, void* stream) {
  return launch<false>(x, static_cast<int*>(out), StatsOut{}, rows, kdim,
                       axis, t_f, guard, static_cast<cudaStream_t>(stream));
}

// x as for gm8_fast_sft. emax: rows int64; nrm2: rows f32; any: rows bool.
GM8_EXPORT int gm8_fast_stats(const void* x, void* emax, void* nrm2,
                              void* any, int rows, int kdim, int axis,
                              void* stream) {
  const StatsOut st{static_cast<long long*>(emax), static_cast<float*>(nrm2),
                    static_cast<bool*>(any)};
  return launch<true>(x, nullptr, st, rows, kdim, axis, 0, 0.0f,
                      static_cast<cudaStream_t>(stream));
}
