// B's int8 slices (L, k, n), N-major, copied into a K-major workspace
// (L, n, kp) with zeros in [k, kp): the layout the tensor-core tile of
// wgmma_s8.cuh reads. The main path's B needs no copy: encode.cu writes it
// K-major, and matmul_mod.cu, matmul_mod_pipelined.cu and matmul_complex.cu
// read it in place. The copy is left to the entries given an N-major B:
// those three for such a B (the fused-encode variant, the sharded engine's
// big-matrix complex form), the CRT-fused GEMMs (matmul_reconstruct.cu,
// matmul_crt.cu), the deaddep probe and the panel pipeline
// (matmul_rider.cu, which copies one column half of B with a row stride of
// its own). The kernel has internal linkage, so each including source gets
// its own copy.
#pragma once

#include "common.cuh"

namespace gm8 {
namespace {

constexpr int kTT = 64;  // transpose tile: 64 k x 64 n bytes

__global__ void __launch_bounds__(256)
transpose_b_kernel(const signed char* __restrict__ b,
                   signed char* __restrict__ bt, int k, int n, int kp,
                   int ldb, int bt_rows) {
  __shared__ unsigned sm[kTT][kTT / 4 + 1];  // [n][k word]
  const int l = blockIdx.z;
  const int n0 = blockIdx.x * kTT, k0 = blockIdx.y * kTT;
  const signed char* bl = b + static_cast<size_t>(l) * k * ldb;
  signed char* btl = bt + static_cast<size_t>(l) * bt_rows * kp;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 4x4 blocks
  unsigned w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kk = k0 + ty * 4 + r, nn = n0 + tx * 4;
    unsigned v = 0;
    if (kk < k) {
      const signed char* p = bl + static_cast<size_t>(kk) * ldb + nn;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (nn + i < n)
          v |= static_cast<unsigned>(static_cast<unsigned char>(p[i]))
               << (8 * i);
    }
    w[r] = v;
  }
  // 4 x 4 byte transpose: word c holds column tx*4+c at k = ty*4..+3
  unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
  unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
  unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
  unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  sm[tx * 4 + 0][ty] = __byte_perm(t0, t1, 0x5410);
  sm[tx * 4 + 1][ty] = __byte_perm(t0, t1, 0x7632);
  sm[tx * 4 + 2][ty] = __byte_perm(t2, t3, 0x5410);
  sm[tx * 4 + 3][ty] = __byte_perm(t2, t3, 0x7632);
  __syncthreads();
  // rows of bt are kp bytes, kp % 16 == 0: word stores stay aligned
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * 256;
    const int nr = idx >> 4, kw = idx & 15;
    const int nn = n0 + nr, kk = k0 + kw * 4;
    if (nn < n && kk < kp)
      *reinterpret_cast<unsigned*>(btl + static_cast<size_t>(nn) * kp + kk) =
          sm[nr][kw];
  }
}

// b: (L, k, n) int8 -> bt: (L, n, kp) int8, kp % 16 == 0, kp >= k. With
// ldb and bt_rows (0: n), the first n columns of a (L, k, ldb) b go to the
// first n rows of each (bt_rows, kp) plane of bt.
inline void transpose_b(const signed char* b, signed char* bt, int L, int k,
                        int n, int kp, cudaStream_t s, int ldb = 0,
                        int bt_rows = 0) {
  dim3 grid((n + kTT - 1) / kTT, (kp + kTT - 1) / kTT, L);
  transpose_b_kernel<<<grid, 256, 0, s>>>(b, bt, k, n, kp, ldb ? ldb : n,
                                          bt_rows ? bt_rows : n);
}

}  // namespace
}  // namespace gm8
