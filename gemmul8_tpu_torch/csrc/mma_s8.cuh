// The mma.sync int8 tensor-core tile of the GEMM kernels not yet on the
// wgmma tile (wgmma_s8.cuh, which runs matmul_mod.cu, matmul_rider.cu,
// matmul_complex.cu, matmul_mod_pipelined.cu, matmul_reconstruct.cu and
// probe_deaddep.cu): magmax.cu and the CRT-fused GEMM of crt_gemm.cuh
// (matmul_crt.cu). One 128 x 128 output tile of
// A (rows, k) x Bt (cols, k)^T, both operands K-major, accumulated in int32.
//
// 8 warps, each 64 x 32, run mma.sync.m16n8k32 (s8 x s8 -> s32). 16-byte
// cp.async copies fill a 3-stage ring of 128-byte-deep k-tiles in shared
// memory (16-byte chunks XOR-swizzled by row, so ldmatrix reads are free of
// bank conflicts) while the warps multiply the oldest stage; ldmatrix loads
// the fragments. Rows past the operand's end land in shared memory as
// zeros (cp.async's source-size operand). With kRaggedK, so do a row's
// bytes at or past any k, and the padding of a row is never read;
// without it, k must be a multiple of 16 (the caller zero-pads), and a
// 16-byte chunk is copied whole or not at all, which keeps the copy
// arithmetic of the main matmul's hot loop minimal.
//
// Accumulator layout: acc[mt][nt][r] is the product at
//   row = bm0 + wm * 64 + mt * 16 + g + (r >= 2 ? 8 : 0)
//   col = bn0 + wn * 32 + nt * 8 + t * 2 + (r & 1)
// with warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4,
// g = lane / 4, t = lane % 4.
#pragma once

#include "common.cuh"

namespace gm8 {

constexpr int kBM = 128, kBN = 128, kBK = 128;  // kBK in bytes (int8)
constexpr int kStages = 3;
constexpr int kMmaThreads = 256;
constexpr int kTileBytes = kBM * kBK;                 // one operand, one stage
constexpr int kMmaSmemBytes = kStages * 2 * kTileBytes;  // 96 KB, dynamic

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copies `bytes` (0..16) from src and zero-fills the rest of the 16 bytes
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-row tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + ((c ^ (r & 7)) << 4);
}

// one stage: rows [r0, r0+128) x bytes [k0, k0+128) of a (rows, k) K-major
// operand with row stride ld (ld % 16 == 0, 16-byte aligned base), copied
// by the kMmaThreads threads tid = 0..kMmaThreads-1; bytes at or past k
// and rows at or past `rows` are zero-filled
template <bool kRaggedK>
__device__ __forceinline__ void load_tile(int tid, unsigned sdst,
                                          const signed char* g, int r0,
                                          int rows, int k0, int k, int ld) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kMmaThreads;
    const int r = idx >> 3, c = idx & 7;
    const int kc = k0 + c * 16;
    int bytes;
    if constexpr (kRaggedK)
      bytes = r0 + r < rows ? min(max(k - kc, 0), 16) : 0;
    else
      bytes = (r0 + r < rows) && (kc < k) ? 16 : 0;
    const signed char* src =
        bytes > 0 ? g + static_cast<size_t>(r0 + r) * ld + kc : g;
    cp_async16(sdst + swz(r, c), src, bytes);
  }
}

// no work between k-tiles
struct NoKHook {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// acc (zeroed here) = the (bm0, bn0) tile of A (m, k; stride lda) times
// Bt (n, k; stride ldb) transposed. smem: kMmaSmemBytes of dynamic shared
// memory. Every thread of the 256-thread block must call it. hook(kt, nk)
// runs in every thread after the MMAs of k-tile kt of nk are issued.
template <bool kRaggedK, class KHook>
__device__ __forceinline__ void mma_tile(const signed char* A, int lda,
                                         const signed char* Bt, int ldb,
                                         int m, int n, int k, int bm0,
                                         int bn0, unsigned char* smem,
                                         int (&acc)[4][4][4], KHook& hook) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const unsigned s0 = smem_addr(smem);
  auto a_stage = [&](int s) { return s0 + s * 2 * kTileBytes; };
  auto b_stage = [&](int s) { return s0 + s * 2 * kTileBytes + kTileBytes; };

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = (k + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_tile<kRaggedK>(threadIdx.x, a_stage(s), A, bm0, m, s * kBK, k,
                          lda);
      load_tile<kRaggedK>(threadIdx.x, b_stage(s), Bt, bn0, n, s * kBK, k,
                          ldb);
    }
    asm volatile("cp.async.commit_group;\n");
  }

  // ldmatrix row/chunk of this lane within a 16 x 32-byte A fragment and
  // within a pair of 8 x 32-byte B fragments
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chk = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_chk = (lane >> 3) & 1;

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
    __syncthreads();  // stage kt landed; stage kt-1 is free to refill
    const int pf = kt + kStages - 1;
    if (pf < nk) {
      const int s = pf % kStages;
      load_tile<kRaggedK>(threadIdx.x, a_stage(s), A, bm0, m, pf * kBK, k,
                          lda);
      load_tile<kRaggedK>(threadIdx.x, b_stage(s), Bt, bn0, n, pf * kBK, k,
                          ldb);
    }
    asm volatile("cp.async.commit_group;\n");
    const unsigned sa = a_stage(kt % kStages), sb = b_stage(kt % kStages);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      unsigned af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], sa + swz(wm * 64 + mt * 16 + a_row,
                                     ks * 2 + a_chk));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, sb + swz(wn * 32 + np * 16 + b_row, ks * 2 + b_chk));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    hook(kt, nk);
  }
  asm volatile("cp.async.wait_group 0;\n");
}

template <bool kRaggedK>
__device__ __forceinline__ void mma_tile(const signed char* A, int lda,
                                         const signed char* Bt, int ldb,
                                         int m, int n, int k, int bm0,
                                         int bn0, unsigned char* smem,
                                         int (&acc)[4][4][4]) {
  NoKHook none;
  mma_tile<kRaggedK>(A, lda, Bt, ldb, m, n, k, bm0, bn0, smem, acc, none);
}

}  // namespace gm8
