// CRT reconstruction, inverse scaling and rounding to f64 or f32:
// out = RNE( centered(sum_j w_j r_j mod M) * 2^(e_extra - sft_a - sft_b) ).
//
// Replaces: reconstruct_pallas, gemmul8_tpu/pallas/kernels.py:956 (its f64
// and f32 outputs, out_kind "f64" and "f32"; residues as int8-centered,
// uint8 or raw int32 slice products, or the weighted sum itself as 16-bit
// limbs, input_kind="limbs").
// Bound on the H100: integer operations for residue input. Per output
// element it reads num_moduli bytes and writes 8 (4 for f32), but does about
// 6 * num_moduli 64-bit multiply-adds, a mod-M reduction and a multi-word
// shift. Limb input reads 4 * num_limbs bytes per element (32 at 14 moduli)
// and skips the multiply-adds: device-memory bytes bound it.
// Design: one thread per output element with the whole integer in
// registers as six 32-bit words; the sum and the tail are crt.cuh's, shared
// with the CRT-fused GEMMs. The TPU kernel's 16-bit limbs and MXU
// contraction worked around a 32-bit vector unit; here the CRT sum
// accumulates in 64-bit integers. The input kind is a template flag: raw
// int32 products are first reduced mod m_j (the residue is unique, so the
// port's % gives the TPU kernel's Barrett result); limbs, canonical or not
// (each nonnegative and below 2^29), are added into the words with their
// carries, which gives the integer they stand for. The constants sit in
// __constant__ memory, one table per moduli count. The output kind is the
// other template parameter: f32 output rounds the centered integer once to
// 24 bits (crt_round_f32), never through an f64, which would round twice.
#include <type_traits>

#include "common.cuh"
#include "crt.cuh"
#include "moduli.cuh"

namespace {

using gm8::CrtTable;
using gm8::kWords;
constexpr int kThreads = 256;

__constant__ CrtTable c_crt[gm8::kMaxModuli + 1];  // indexed by num_moduli

// what r holds: (L, m, n) canonical uint8 residues, int8 residues holding
// r - 128, raw int32 slice products, or (nl, m, n) int32 16-bit limbs of X
enum Kind { kU8 = 0, kCentered = 1, kProducts = 2, kLimbs = 3 };

// the element type of r for each kind
template <int kKind>
using Plane = std::conditional_t<kKind == kProducts || kKind == kLimbs, int,
                                 unsigned char>;

template <int kKind, typename Out>
__global__ void __launch_bounds__(kThreads)
reconstruct_kernel(const Plane<kKind>* __restrict__ r,
                   const int* __restrict__ sft_a,
                   const int* __restrict__ sft_b,
                   Out* __restrict__ out, int L, int planes,
                   int m, int n, int e_extra,
                   const __grid_constant__ gm8::SlotModuli mods) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  const CrtTable& T = c_crt[L];
  const size_t mn = static_cast<size_t>(m) * n;
  for (int row = blockIdx.y; row < m; row += gridDim.y) {
    const size_t idx = static_cast<size_t>(row) * n + col;
    unsigned long long acc[kWords] = {0, 0, 0, 0, 0, 0};
    if constexpr (kKind == kLimbs) {
#pragma unroll
      for (int i = 0; i < 2 * kWords; ++i)
        if (i < planes)
          gm8::crt_add_limb(acc, i, static_cast<unsigned>(r[i * mn + idx]));
    } else if constexpr (kKind == kProducts) {
      for (int j = 0; j < L; ++j)
        gm8::crt_add(acc, T, j, gm8::mod_canon(r[j * mn + idx], mods.m[j]));
    } else {
      for (int j = 0; j < L; ++j) {
        unsigned v = r[j * mn + idx];
        // int8 holds r - 128
        gm8::crt_add(acc, T, j, kKind == kCentered ? (v ^ 0x80u) : v);
      }
    }
    unsigned x[kWords];
    gm8::crt_words(acc, x);
    unsigned mag[kWords];
    const bool neg = gm8::crt_center(x, T, mag);
    out[idx] = gm8::crt_round_word<Out>(mag, neg,
                                        e_extra - (sft_a[row] + sft_b[col]));
  }
}

template <typename Out>
int launch(const void* r, int kind, int planes, const int* a, const int* b,
           void* out, int L, int m, int n, int e_extra,
           const gm8::SlotModuli& mods, cudaStream_t s) {
  dim3 grid((n + kThreads - 1) / kThreads, m < 65535 ? m : 65535);
  auto o = static_cast<Out*>(out);
  switch (kind) {
    case kU8:
      reconstruct_kernel<kU8, Out><<<grid, kThreads, 0, s>>>(
          static_cast<const unsigned char*>(r), a, b, o, L, planes, m, n,
          e_extra, mods);
      break;
    case kCentered:
      reconstruct_kernel<kCentered, Out><<<grid, kThreads, 0, s>>>(
          static_cast<const unsigned char*>(r), a, b, o, L, planes, m, n,
          e_extra, mods);
      break;
    case kProducts:
      reconstruct_kernel<kProducts, Out><<<grid, kThreads, 0, s>>>(
          static_cast<const int*>(r), a, b, o, L, planes, m, n, e_extra,
          mods);
      break;
    case kLimbs:
      reconstruct_kernel<kLimbs, Out><<<grid, kThreads, 0, s>>>(
          static_cast<const int*>(r), a, b, o, L, planes, m, n, e_extra,
          mods);
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
// limb in [0, 2^29)). sft_a: m int32, sft_b: n int32; out: (m, n) f64
// (out_f32 = 0) or f32 (out_f32 = 1).
GM8_EXPORT int gm8_reconstruct(const void* r, int kind, int planes,
                               const void* sft_a, const void* sft_b,
                               void* out, int L, int m, int n, int e_extra,
                               int out_f32, void* stream) {
  gm8::SlotModuli mods;
  const bool planes_ok =
      kind == kLimbs ? planes >= 1 && planes <= 2 * kWords : planes == L;
  if (!gm8::slot_moduli(nullptr, L, &mods) || !planes_ok)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int*>(sft_a);
  auto b = static_cast<const int*>(sft_b);
  if (out_f32)
    return launch<unsigned>(r, kind, planes, a, b, out, L, m, n, e_extra,
                            mods, s);
  return launch<unsigned long long>(r, kind, planes, a, b, out, L, m, n,
                                    e_extra, mods, s);
}
