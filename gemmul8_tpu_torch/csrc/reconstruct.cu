// CRT reconstruction, inverse scaling and rounding to f64 or f32:
// out = RNE( centered(sum_j w_j r_j mod M) * 2^(e_extra - sft_a - sft_b) ).
//
// Replaces: reconstruct_pallas, gemmul8_tpu/pallas/kernels.py:956 (its f64
// and f32 outputs, out_kind "f64" and "f32"; residues as int8-centered,
// uint8 or raw int32 slice products, or the weighted sum itself as 16-bit
// limbs, input_kind="limbs"; its MXU contraction _crt_accumulate_mxu).
// Bound on the H100: device-memory bytes. Per output element it reads
// num_moduli bytes and writes 8 (4 for f32): 22 bytes at 14 moduli, 0.44 ms
// at 8192^2 and 3.35 TB/s. Limb input reads 4 * num_limbs bytes instead.
// Design: a warp takes 128 consecutive elements at a time. For residue
// input each thread loads 16 elements of each of its moduli with one
// 16-byte load, transposes the bytes four elements at a time into A
// fragments, and mma.sync.m16n8k32 s8 forms the weighted sum against the
// compact digit table (crt_mma.cuh: the redundant 16-bit limbs Y[2l] + 256
// Y[2l+1] + 32896 S + CL[l], CL entering as the accumulator's start); the
// warp's limbs are transposed through shared memory so that lane i holds
// every limb of elements i, i + 32, i + 64 and i + 96, whose tails it runs
// in turn.
// Uint8 residues are centred (^ 0x80) and raw int32 products reduced
// (moduli.cuh mod_div) before the transpose. Limb input skips the sum. The
// tail (crt_tail.cuh) works on 4 words where the sum stays below 2^128 (up
// to 14 moduli), else 6: one f64 quotient estimate rounded to nearest, one
// multiply-subtract, one conditional negate, one rounding. The constants:
// the digit table and the divisors by value, M, floor(M/2) + 1 and 1/M in
// __constant__ memory, one table per moduli count. The output kind is a
// template parameter: f32 output rounds the centered integer once to 24
// bits, never through an f64, which would round twice.
#include <cstring>
#include <type_traits>

#include "common.cuh"
#include "crt_mma.cuh"
#include "crt_tail.cuh"
#include "moduli.cuh"

#if !defined(GM8_REC_THREADS) || !defined(GM8_REC_CHUNK) || \
    !defined(GM8_REC_BLOCKS_PER_SM)
#error "reconstruct.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::CrtMmaTable;
using gm8::CrtTable;
using gm8::kCrtTiles;
// a block's threads, the elements a warp takes at a time and the grid's
// blocks an SM (the grid-stride walk's cap), from the launch table
// (hopper/launch.py `ReconstructLaunch`)
constexpr int kThreads = GM8_REC_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = GM8_REC_CHUNK;
constexpr int kBlocksPerSm = GM8_REC_BLOCKS_PER_SM;
constexpr int kZStride = kChunk + 4;  // ints a limb row: conflict-free
static_assert(kChunk == 128, "a warp's mma fragments hold 8 row groups of "
              "16 elements: 128 elements a chunk");
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "whole warps, at most 1024 threads a block");
static_assert(kBlocksPerSm >= 1, "a block an SM or more");

__constant__ CrtTable c_crt[gm8::kMaxModuli + 1];  // indexed by num_moduli

// what r holds: (L, m, n) canonical uint8 residues, int8 residues holding
// r - 128, raw int32 slice products, or (nl, m, n) int32 16-bit limbs of X
enum Kind { kU8 = 0, kCentered = 1, kProducts = 2, kLimbs = 3 };

struct alignas(16) Consts {
  CrtMmaTable mma;          // the digit table of L
  gm8::SlotDivisors div;    // kProducts: the divisors of moduli 0..L-1
};
static_assert(kWarps * 12 * kZStride * sizeof(int) + sizeof(Consts) <= 49152,
              "over the static shared memory of a block");

// the centred residue bytes r_j - 128 of elements e0..e0+15 of modulus j,
// four to a word (0 past L and past mn); vec: 16-byte loads
template <int kKind>
__device__ __forceinline__ void load_row(unsigned (&w)[4],
                                         const void* __restrict__ rv, int j,
                                         size_t e0, int L, size_t mn,
                                         bool vec, const Consts& P) {
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0u;
  if (j >= L || e0 >= mn) return;
  const size_t off = static_cast<size_t>(j) * mn + e0;
  if constexpr (kKind == kProducts) {
    const int* r = static_cast<const int*>(rv) + off;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int v[4] = {0, 0, 0, 0};
      if (vec) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(r) + k);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (e0 + 4 * k + b < mn) v[b] = __ldg(r + 4 * k + b);
      }
      unsigned c[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) c[b] = gm8::mod_div(v[b], P.div.v[j]);
      w[k] = gm8::pack4(c[0], c[1], c[2], c[3]) ^ 0x80808080u;
    }
  } else {
    gm8::crt_load16(w, static_cast<const unsigned char*>(rv), j, e0, L, mn,
                    vec, kKind == kU8);
  }
}

template <int kKind, typename Out, int kW>
__global__ void __launch_bounds__(kThreads)
reconstruct_kernel(const void* __restrict__ rv,
                   const int* __restrict__ sft_a,
                   const int* __restrict__ sft_b, Out* __restrict__ out,
                   int L, int planes, int m, int n, int e_extra,
                   const __grid_constant__ Consts P) {
  __shared__ __align__(16) int zs[kWarps][12][kZStride];
  // the constants in shared memory: each thread reads the digits, limb
  // corrections and divisors of its own lanes, which the compiler may
  // reload where they are used; from the kernel parameter those reloads
  // would serialise on the lanes' distinct addresses, from shared memory
  // they cost one conflict-free load
  __shared__ Consts S;
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(S) / 16);
       i += kThreads)
    reinterpret_cast<uint4*>(&S)[i] = reinterpret_cast<const uint4*>(&P)[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const CrtTable& T = c_crt[L];
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t chunks = (mn + kChunk - 1) / kChunk;
  const size_t stride = static_cast<size_t>(gridDim.x) * kWarps;
  size_t c = static_cast<size_t>(blockIdx.x) * kWarps + warp;
  if (c >= chunks) return;
  const int nl = S.mma.nd / 2;
  // the chunk's first element as (row, col), advanced by the grid stride
  int row0 = static_cast<int>(kChunk * c / n);
  int col0 = static_cast<int>(kChunk * c - static_cast<size_t>(row0) * n);
  const int dq = static_cast<int>(kChunk * stride / n);
  const int dr =
      static_cast<int>(kChunk * stride - static_cast<size_t>(dq) * n);

  unsigned bf[kCrtTiles][2];
  int cl[kCrtTiles];
  // thread (g, t): elements 16g..16g+15 of moduli 4t..4t+3 (wl) and
  // 16+4t.. (wh); word k of each holds elements 16g+4k..16g+4k+3. The next
  // chunk's rows are loaded into them once this chunk's are contracted, so
  // they arrive during this chunk's tails.
  unsigned wl[4][4], wh[4][4];
  bool vec = false;
  auto load_rows = [&](size_t e0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_row<kKind>(wl[i], rv, 4 * t + i, e0 + 16 * g, L, mn, vec, S);
      if (L > 16)
        load_row<kKind>(wh[i], rv, 16 + 4 * t + i, e0 + 16 * g, L, mn, vec,
                        S);
    }
  };
  if constexpr (kKind != kLimbs) {
    gm8::crt_b_frags(S.mma, bf);
#pragma unroll
    for (int q = 0; q < kCrtTiles; ++q) cl[q] = S.mma.cl[4 * q + t];
    vec = mn % 16 == 0 && (reinterpret_cast<uintptr_t>(rv) & 15) == 0;
    load_rows(kChunk * c);
  }
  for (;;) {
    const size_t e0 = kChunk * c;
    const size_t cn = c + stride;
    if constexpr (kKind != kLimbs) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned cw[4] = {wl[0][k], wl[1][k], wl[2][k], wl[3][k]};
        unsigned lo[4], hi[4] = {0u, 0u, 0u, 0u};
        gm8::transpose4(cw, lo);
        if (L > 16) {
          const unsigned ch[4] = {wh[0][k], wh[1][k], wh[2][k], wh[3][k]};
          gm8::transpose4(ch, hi);
        }
        int d[2][kCrtTiles][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < kCrtTiles; ++q) {
            d[p][q][0] = d[p][q][2] = cl[q];
            d[p][q][1] = d[p][q][3] = 0;
          }
        gm8::crt_mma_acc(lo, hi, bf, d);
        // limb 4q + t of elements 16g + 4k + 2p (row g) and + 2p + 1
        // (row g + 8), without the ones row's term
#pragma unroll
        for (int q = 0; q < kCrtTiles; ++q)
          *reinterpret_cast<int4*>(&zs[warp][4 * q + t][16 * g + 4 * k]) =
              make_int4(d[0][q][0] + 256 * d[0][q][1],
                        d[0][q][2] + 256 * d[0][q][3],
                        d[1][q][0] + 256 * d[1][q][1],
                        d[1][q][2] + 256 * d[1][q][3]);
      }
      __syncwarp();
      if (cn < chunks) load_rows(kChunk * cn);
    }
#pragma unroll 2
    for (int j = 0; j < kChunk / 32; ++j) {
      const size_t e = e0 + lane + 32 * j;
      if (e >= mn) break;
      int limb[2 * kW];
      if constexpr (kKind == kLimbs) {
        const int* r = static_cast<const int*>(rv);
#pragma unroll
        for (int l = 0; l < 2 * kW; ++l)
          limb[l] = l < planes ? __ldg(r + l * mn + e) : 0;
      } else {
        const int s1 = zs[warp][nl][lane + 32 * j];  // the row of ones
#pragma unroll
        for (int l = 0; l < 2 * kW; ++l)
          limb[l] = l < nl ? zs[warp][l][lane + 32 * j] + 32896 * s1 : 0;
      }
      int col = col0 + lane + 32 * j, row = row0;
      while (col >= n) {
        col -= n;
        ++row;
      }
      unsigned x[kW], mag[kW];
      gm8::limbs_to_words(limb, x);
      const bool neg = gm8::center_rn(x, T, mag);
      out[e] = gm8::round_word_rn<Out>(
          mag, neg, e_extra - (__ldg(sft_a + row) + __ldg(sft_b + col)));
    }
    if (cn >= chunks) break;
    __syncwarp();  // the next chunk's limbs overwrite these rows
    c = cn;
    row0 += dq;
    col0 += dr;
    if (col0 >= n) {
      col0 -= n;
      ++row0;
    }
  }
}

template <int kKind, typename Out, int kW>
void launch_kind(const void* r, int planes, const int* a, const int* b,
                 void* out, int L, int m, int n, int e_extra,
                 const Consts& P, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t chunks = (static_cast<size_t>(m) * n + kChunk - 1) / kChunk;
  const size_t want = (chunks + kWarps - 1) / kWarps;
  const size_t cap = static_cast<size_t>(kBlocksPerSm) * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  reconstruct_kernel<kKind, Out, kW><<<blocks, kThreads, 0, s>>>(
      r, a, b, static_cast<Out*>(out), L, planes, m, n, e_extra, P);
}

// the tail's word count: 4 where every sum of residues is below 2^128 (X <
// 256 L M, up to 14 moduli), else 6; limbs (each below 2^29) take 6
template <typename Out>
int launch(const void* r, int kind, int planes, const int* a, const int* b,
           void* out, int L, int m, int n, int e_extra, const Consts& P,
           cudaStream_t s) {
  const bool w4 = L <= 14;
  switch (kind) {
#define GM8_KIND(K)                                                         \
  case K:                                                                   \
    if (w4)                                                                 \
      launch_kind<K, Out, 4>(r, planes, a, b, out, L, m, n, e_extra, P, s); \
    else                                                                    \
      launch_kind<K, Out, 6>(r, planes, a, b, out, L, m, n, e_extra, P, s); \
    break;
    GM8_KIND(kU8)
    GM8_KIND(kCentered)
    GM8_KIND(kProducts)
#undef GM8_KIND
    case kLimbs:
      launch_kind<kLimbs, Out, 6>(r, planes, a, b, out, L, m, n, e_extra, P,
                                  s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return gm8::launch_status();
}

}  // namespace

// table: (num_moduli 0..20) CrtTable entries built by the Python wrapper.
GM8_EXPORT int gm8_set_crt_tables(const void* table, int nbytes) {
  if (nbytes != static_cast<int>(sizeof(c_crt))) return -1;
  cudaMemcpyToSymbol(c_crt, table, sizeof(c_crt));
  return gm8::launch_status();
}

// r: `planes` planes of (m, n): for kind 0 canonical uint8 residues, 1 int8
// residues holding r - 128, 2 raw int32 slice products (planes = L each),
// 3 int32 16-bit limbs of the weighted sum (planes = num_limbs <= 12, each
// limb in [0, 2^29), standing for a sum below 256 L M). mma_table: the
// CrtMmaTable of L on the host (hopper/kernels.py crt_mma_table).
// sft_a: m int32, sft_b: n int32; out: (m, n) f64 (out_f32 = 0) or f32
// (out_f32 = 1).
GM8_EXPORT int gm8_reconstruct(const void* r, int kind, int planes,
                               const void* sft_a, const void* sft_b,
                               void* out, const void* mma_table, int L,
                               int m, int n, int e_extra, int out_f32,
                               void* stream) {
  gm8::SlotModuli mods;
  const bool planes_ok = kind == kLimbs
                             ? planes >= 1 && planes <= 2 * gm8::kWords
                             : planes == L;
  if (!gm8::slot_moduli(nullptr, L, &mods) || !planes_ok || m < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Consts P;
  std::memcpy(&P.mma, mma_table, sizeof(P.mma));
  P.div = gm8::slot_divisors(mods);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int*>(sft_a);
  auto b = static_cast<const int*>(sft_b);
  if (out_f32)
    return launch<unsigned>(r, kind, planes, a, b, out, L, m, n, e_extra, P,
                            s);
  return launch<unsigned long long>(r, kind, planes, a, b, out, L, m, n,
                                    e_extra, P, s);
}
