// Batched complex int8 GEMM with the modular reduction in the epilogue:
// per modulus l, the Re and Im residues of (ReA + i ImA)(ReB + i ImB),
//   4-dot:     Re = RR - II,  Im = IR + RI
//   Karatsuba: E = RR, F = II, G = SaSb;  Re = E - F,  Im = G - E - F
// (XY = X8[l] @ Y8[l]; Sa, Sb the recentered sums ReA + ImA and ReB + ImB),
// mod m_l, as canonical uint8 or as r - 128 int8 when centered.
//
// Replaces: matmul_complex_mod_pallas, gemmul8_tpu/pallas/matmul.py:492.
// Bound on the H100: int8 tensor-core operations. At 8192^3 with 14 moduli
// the 4-dot form is 4 x 15.4 T multiply-adds, the Karatsuba form 3 x; the
// int8 operands (4 or 6 x 0.94 GB) and residues (2 x 0.94 GB) are small
// next to that.
// Design: the 128 x 128 tile of mma_s8.cuh, unchanged, run once per product
// in one block. One int32 accumulator (64 registers a thread) is all the
// __launch_bounds__(256, 2) budget of 128 registers holds beside the
// fragments, so the products of a tile run one after another into that
// one accumulator, and each is reduced mod m_l in registers the moment it
// is done. The residues are then combined mod m_l; a residue is unique,
// so any exact order gives the bits of the TPU kernel's (RR - II) mod m_l.
// A residue that a later product still needs is carried in the block's own
// bytes of the output (each thread reads back only the bytes it wrote):
//   4-dot:     RR -> out_re; II -> out_re = RR - II;
//              IR -> out_im; RI -> out_im = IR + RI;
//   Karatsuba: E -> out_re; F -> out_re = E - F, out_im = E + F;
//              G -> out_im = G - (E + F).
// The carried bytes stay in L2 at these tile sizes and cost one byte
// written and read per product, against 2k bytes of operands read. Two
// live accumulators (4-dot) or three (Karatsuba), as on the TPU, would
// need a smaller tile or one block per SM. Each product alone is at most
// 128 * 128 * 2^16 = 2^30 in magnitude (k <= 2^16, complexgemm._KMAX), so
// no accumulator wraps, and the sums of residues are taken mod m_l in
// [0, 2 m_l), never in signed overflow. B's slices are N-major, so each B
// operand is first copied into its own K-major workspace (transpose_b.cuh);
// each A operand is read in place with row stride kp (padded by its own
// shape by the caller). wgmma and TMA are for later work.
#include "common.cuh"
#include "mma_s8.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBM;
using gm8::kBN;
constexpr int kThreads = gm8::kMmaThreads;
constexpr int kSmemBytes = gm8::kMmaSmemBytes;

__constant__ int c_moduli[gm8::kMaxModuli] = {
#define GM8_MOD_VALUE(J, M) M,
    GM8_FOR_MODULI(GM8_MOD_VALUE)
#undef GM8_MOD_VALUE
};

// operand slots: 0 = Re, 1 = Im, 2 = the Karatsuba sum
struct Operands {
  const signed char* a[3];   // (L, m, kp)
  const signed char* bt[3];  // (L, n, kp), K-major
};

__device__ __forceinline__ int mod_canon(int x, int mod) {
  if (mod == 256) return x & 255;
  const int r = x % mod;
  return r < 0 ? r + mod : r;
}

// (a -/+ b) mod m for a, b in [0, m)
__device__ __forceinline__ int sub_mod(int a, int b, int mod) {
  return a - b + (a < b ? mod : 0);
}
__device__ __forceinline__ int add_mod(int a, int b, int mod) {
  const int s = a + b;
  return s >= mod ? s - mod : s;
}

// f(i, residue) for each in-range element i = row * n + col of the
// accumulator tile, the product reduced to its canonical residue
template <typename F>
__device__ __forceinline__ void for_each_residue(const int (&acc)[4][4][4],
                                                 int bm0, int bn0, int m,
                                                 int n, int mod, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = bm0 + wm * 64 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int col = bn0 + wn * 32 + nt * 8 + t * 2 + (r & 1);
        if (row < m && col < n)
          f(static_cast<size_t>(row) * n + col,
            mod_canon(acc[mt][nt][r], mod));
      }
}

template <bool kKara>
__global__ void __launch_bounds__(kThreads, 2)
matmul_complex_kernel(Operands ops, unsigned char* __restrict__ out_re,
                      unsigned char* __restrict__ out_im, int m, int n,
                      int kp, int centered) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.z;
  const int bm0 = blockIdx.y * kBM, bn0 = blockIdx.x * kBN;
  const size_t a_off = static_cast<size_t>(l) * m * kp;
  const size_t b_off = static_cast<size_t>(l) * n * kp;
  unsigned char* ore = out_re + static_cast<size_t>(l) * m * n;
  unsigned char* oim = out_im + static_cast<size_t>(l) * m * n;
  const int mod = c_moduli[l];
  const int bias = centered ? 128 : 0;
  int acc[4][4][4];

  // RR (4-dot) or E (Karatsuba)
  gm8::mma_tile<false>(ops.a[0] + a_off, kp, ops.bt[0] + b_off, kp, m, n, kp,
                       bm0, bn0, smem, acc);
  for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int rr) {
    ore[i] = static_cast<unsigned char>(rr);
  });
  // the next product refills the ring: every warp must be done reading it
  __syncthreads();
  // II (4-dot) or F (Karatsuba)
  gm8::mma_tile<false>(ops.a[1] + a_off, kp, ops.bt[1] + b_off, kp, m, n, kp,
                       bm0, bn0, smem, acc);
  if constexpr (kKara) {
    for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int f) {
      const int e = ore[i];
      ore[i] = static_cast<unsigned char>(sub_mod(e, f, mod) - bias);
      oim[i] = static_cast<unsigned char>(add_mod(e, f, mod));
    });
    __syncthreads();
    // G
    gm8::mma_tile<false>(ops.a[2] + a_off, kp, ops.bt[2] + b_off, kp, m, n,
                         kp, bm0, bn0, smem, acc);
    for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int g) {
      oim[i] = static_cast<unsigned char>(sub_mod(g, oim[i], mod) - bias);
    });
  } else {
    for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int ii) {
      ore[i] = static_cast<unsigned char>(sub_mod(ore[i], ii, mod) - bias);
    });
    __syncthreads();
    // IR
    gm8::mma_tile<false>(ops.a[1] + a_off, kp, ops.bt[0] + b_off, kp, m, n,
                         kp, bm0, bn0, smem, acc);
    for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int ir) {
      oim[i] = static_cast<unsigned char>(ir);
    });
    __syncthreads();
    // RI
    gm8::mma_tile<false>(ops.a[0] + a_off, kp, ops.bt[1] + b_off, kp, m, n,
                         kp, bm0, bn0, smem, acc);
    for_each_residue(acc, bm0, bn0, m, n, mod, [&](size_t i, int ri) {
      oim[i] = static_cast<unsigned char>(add_mod(oim[i], ri, mod) - bias);
    });
  }
}

template <bool kKara>
int launch(const Operands& ops, unsigned char* out_re, unsigned char* out_im,
           int L, int m, int n, int kp, int centered, cudaStream_t s) {
  cudaFuncSetAttribute(matmul_complex_kernel<kKara>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, L);
  matmul_complex_kernel<kKara><<<grid, kThreads, kSmemBytes, s>>>(
      ops, out_re, out_im, m, n, kp, centered);
  return gm8::launch_status();
}

}  // namespace

// ar, ai (and sa when kara): (L, m, kp) int8, kp % 16 == 0, zero-padded past
// k by the caller when k % 16 != 0; br, bi (and sb): (L, k, n) int8;
// bt: the K-major workspaces, (2 or 3, L, n, kp) int8; out_re, out_im:
// (L, m, n) uint8 or int8. Slice l uses modulus MODULI[l]. sa and sb are
// ignored (may be null) unless kara. k <= 2^16 (checked by the caller).
GM8_EXPORT int gm8_matmul_complex_mod(const void* ar, const void* ai,
                                      const void* sa, const void* br,
                                      const void* bi, const void* sb,
                                      void* bt, void* out_re, void* out_im,
                                      int L, int m, int n, int k, int kp,
                                      int centered, int kara, void* stream) {
  if (kp % 16 != 0 || kp < k || k > (1 << 16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int nb = kara ? 3 : 2;
  const void* a_in[3] = {ar, ai, sa};
  const void* b_in[3] = {br, bi, sb};
  const size_t ws = static_cast<size_t>(L) * n * kp;
  Operands ops{};
  for (int i = 0; i < nb; ++i) {
    auto bti = static_cast<signed char*>(bt) + i * ws;
    gm8::transpose_b(static_cast<const signed char*>(b_in[i]), bti, L, k, n,
                     kp, s);
    ops.a[i] = static_cast<const signed char*>(a_in[i]);
    ops.bt[i] = bti;
  }
  auto ore = static_cast<unsigned char*>(out_re);
  auto oim = static_cast<unsigned char*>(out_im);
  return kara ? launch<true>(ops, ore, oim, L, m, n, kp, centered, s)
              : launch<false>(ops, ore, oim, L, m, n, kp, centered, s);
}
