// Batched int8 GEMM with the whole per-modulus epilogue fused: the residue
// of each product and the CRT-weighted sum over the moduli. Emits
// (nl, m, n) int32 canonical 16-bit limbs of X = sum_l w_l * (C_l mod m_l),
// C_l = A8[l] @ B8[l]: what the limb input of the reconstruct kernel takes.
//
// Replaces: matmul_crt_pallas, gemmul8_tpu/pallas/matmul.py:637.
// Bound on the H100: tensor-core operations (L x 2mnk, as matmul_mod.cu);
// the limbs are 4 * nl bytes per element (2.1 GB at 8192^2 and 14 moduli,
// more than the 0.94 GB of residues they replace).
// Design: crt_gemm.cuh. One block per 128 x 128 tile loops over the moduli
// with the residues parked in its own scratch, then sums them with the
// weights in 64-bit words (crt.cuh) and writes the words as 16-bit limbs,
// which are canonical by construction: no per-limb sums, no carry pass.
// The TPU kernel's Barrett (bias 8, fixups 8, 4, 2, 1) is not carried over:
// a residue is unique and the % of mod_canon gives it. The 256 lane keeps
// the hardware accumulator's wrap at 2^31 and x & 255. B is copied K-major
// first (transpose_b.cuh), as for matmul_mod.cu.
#include <cstring>

#include "common.cuh"
#include "crt_gemm.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBM;
using gm8::kBN;
using gm8::kWords;
constexpr int kThreads = gm8::kMmaThreads;
constexpr int kSmemBytes = gm8::kMmaSmemBytes;

__global__ void __launch_bounds__(kThreads, 2)
matmul_crt_kernel(const signed char* __restrict__ A,
                  const signed char* __restrict__ Bt,
                  unsigned char* __restrict__ scratch, int* __restrict__ out,
                  int L, int nl, int m, int n, int kp,
                  const __grid_constant__ gm8::CrtTable T,
                  const __grid_constant__ gm8::SlotModuli mods) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sc =
      scratch + static_cast<size_t>(blockIdx.x) * L * gm8::kTileElems;
  const int ntn = (n + kBN - 1) / kBN;
  const int ntiles = ntn * ((m + kBM - 1) / kBM);
  const size_t mn = static_cast<size_t>(m) * n;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bm0 = tile / ntn * kBM, bn0 = tile % ntn * kBN;
    gm8::tile_residues(A, Bt, L, m, n, kp, bm0, bn0, mods, smem, sc);
    gm8::for_each_crt_sum(
        sc, L, T, bm0, bn0, m, n,
        [&](int row, int col, const unsigned (&x)[kWords]) {
          int* o = out + static_cast<size_t>(row) * n + col;
#pragma unroll
          for (int i = 0; i < 2 * kWords; ++i)
            if (i < nl)
              o[i * mn] =
                  static_cast<int>((x[i >> 1] >> (16 * (i & 1))) & 0xFFFFu);
        });
  }
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0); b8: (L, k, n) int8; bt: (L, n, kp) int8 workspace;
// scratch: (nblocks, L, 128 * 128) uint8 workspace; out: (nl, m, n) int32;
// table: the CrtTable of L moduli, on the host. Slice l uses modulus
// MODULI[l]; k <= 2^17 (checked by the caller); nl <= 12.
GM8_EXPORT int gm8_matmul_crt(const void* a8, const void* b8, void* bt,
                              void* scratch, void* out, const void* table,
                              int L, int nl, int m, int n, int k, int kp,
                              int nblocks, void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k || nl < 1 || nl > 2 * kWords || nblocks < 1 ||
      !gm8::slot_moduli(nullptr, L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  std::memcpy(&T, table, sizeof(T));
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  cudaFuncSetAttribute(matmul_crt_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  matmul_crt_kernel<<<nblocks, kThreads, kSmemBytes, s>>>(
      static_cast<const signed char*>(a8), btp,
      static_cast<unsigned char*>(scratch), static_cast<int*>(out), L, nl, m,
      n, kp, T, mods);
  return gm8::launch_status();
}
