// Batched int8 GEMM with the modular reduction in the epilogue:
// out[l] = (A8[l] @ B8[l]) mod m_l as canonical uint8, or r - 128 as int8
// when centered.
//
// Replaces: matmul_mod_u8_pallas, gemmul8_tpu/pallas/matmul.py:95.
// Bound on the H100: tensor-core operations. At 8192^3 with 14 moduli the
// call is 15.4 T integer multiply-adds x 2; the int8 operands (1.9 GB) and
// residues (0.9 GB) are small next to that.
// Design: the warp-level tensor-core instruction mma.sync.m16n8k32
// (s8 x s8 -> s32) wants both operands K-major. A (L, m, k) is; B
// (L, k, n) is not, so a first kernel copies B into a K-major workspace
// (L, n, kp), kp = k rounded up to 16 with zeros (one 1-byte-per-element
// pass, small next to the product; transpose_b.cuh). The GEMM kernel then
// computes a 128 x 128 tile of one modulus with the tile of mma_s8.cuh (8
// warps of mma.sync, a 3-stage cp.async ring, swizzled ldmatrix loads). The
// accumulator is the hardware's wrapping int32: the modulus-256 lane can
// reach 128 * 128 * 2^17 = 2^31, which wraps to a multiple of 256, so its
// residue stays right; the odd lanes stay below 2^31. The epilogue reduces
// mod m_l in registers and writes one byte per residue. Slot l of a call
// holds modulus MODULI[moduli_idx[l]] (all the moduli in order, or the
// chunk of a moduli-chunked call): the moduli come by value (moduli.cuh).
// wgmma and TMA are for later work.
#include "common.cuh"
#include "mma_s8.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBM;
using gm8::kBN;
constexpr int kThreads = gm8::kMmaThreads;
constexpr int kSmemBytes = gm8::kMmaSmemBytes;

// ---- the GEMM ------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 2)
matmul_mod_kernel(const signed char* __restrict__ A,
                  const signed char* __restrict__ Bt,
                  unsigned char* __restrict__ out, int m, int n, int kp,
                  int centered,
                  const __grid_constant__ gm8::SlotModuli mods) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.z;
  const int bm0 = blockIdx.y * kBM, bn0 = blockIdx.x * kBN;
  const signed char* Al = A + static_cast<size_t>(l) * m * kp;
  const signed char* Bl = Bt + static_cast<size_t>(l) * n * kp;
  int acc[4][4][4];
  gm8::mma_tile<false>(Al, kp, Bl, kp, m, n, kp, bm0, bn0, smem, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;

  const int mod = mods.m[l];
  unsigned char* ol = out + static_cast<size_t>(l) * m * n;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = bm0 + wm * 64 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int col = bn0 + wn * 32 + nt * 8 + t * 2 + (r & 1);
        if (row < m && col < n) {
          const int res = gm8::mod_canon(acc[mt][nt][r], mod);
          ol[static_cast<size_t>(row) * n + col] =
              static_cast<unsigned char>(centered ? res - 128 : res);
        }
      }
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0); b8: (L, k, n) int8; bt: (L, n, kp) int8 workspace;
// out: (L, m, n) uint8 or int8. Slice l uses modulus MODULI[moduli_idx[l]]
// (moduli_idx: L ints on the host, or null for 0..L-1); k <= 2^17 (checked
// by the caller).
GM8_EXPORT int gm8_matmul_mod_u8(const void* a8, const void* b8, void* bt,
                                 void* out, const void* moduli_idx, int L,
                                 int m, int n, int k, int kp, int centered,
                                 void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k ||
      !gm8::slot_moduli(static_cast<const int*>(moduli_idx), L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  cudaFuncSetAttribute(matmul_mod_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, L);
  matmul_mod_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const signed char*>(a8), btp,
      static_cast<unsigned char*>(out), m, n, kp, centered, mods);
  return gm8::launch_status();
}
