// Batched int8 GEMM fused with the CRT reconstruction:
// out = RNE( centered(sum_l w_l (C_l mod m_l) mod M) * 2^(-sft_a - sft_b) ),
// C_l = A8[l] @ B8[l], as f64 or f32: matmul_mod.cu and reconstruct.cu in
// one kernel, the residues never stored as an (L, m, n) tensor.
//
// Replaces: matmul_reconstruct_pallas, gemmul8_tpu/pallas/megakernel.py:80
// (its f64 and f32 outputs).
// Bound on the H100: tensor-core operations (L x 2mnk); beside the int8
// operands it moves only the shifts and 8 bytes (f32: 4) per output
// element.
// Design: crt_gemm.cuh, the loop of matmul_crt.cu; after the last modulus
// the block runs crt.cuh's tail (mod M, centering, rounding) on each CRT
// sum of its tile and writes f64, or f32 rounded once from the integer
// (crt_round_f32, never through an f64: the output type is a template
// parameter, the rest of the kernel is one body). The TPU kernel's T + 1 grid,
// parity-banked accumulators and rider slots overlapped vector work with
// the matrix unit inside one TPU core; here two blocks per SM overlap one
// block's tail with the other's products. The scratch of residues is per
// resident block, so any m, n and any 2 to 20 moduli fit. B is copied
// K-major first (transpose_b.cuh), as for matmul_mod.cu.
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

// Out: unsigned long long (f64 bits) or unsigned (f32 bits)
template <typename Out>
__global__ void __launch_bounds__(kThreads, 2)
matmul_reconstruct_kernel(const signed char* __restrict__ A,
                          const signed char* __restrict__ Bt,
                          unsigned char* __restrict__ scratch,
                          const int* __restrict__ sft_a,
                          const int* __restrict__ sft_b,
                          Out* __restrict__ out, int L, int m, int n, int kp,
                          const __grid_constant__ gm8::CrtTable T,
                          const __grid_constant__ gm8::SlotModuli mods) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sc =
      scratch + static_cast<size_t>(blockIdx.x) * L * gm8::kTileElems;
  const int ntn = (n + kBN - 1) / kBN;
  const int ntiles = ntn * ((m + kBM - 1) / kBM);
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int bm0 = tile / ntn * kBM, bn0 = tile % ntn * kBN;
    gm8::tile_residues(A, Bt, L, m, n, kp, bm0, bn0, mods, smem, sc);
    gm8::for_each_crt_sum(
        sc, L, T, bm0, bn0, m, n,
        [&](int row, int col, unsigned (&x)[kWords]) {
          unsigned mag[kWords];
          const bool neg = gm8::crt_center(x, T, mag);
          out[static_cast<size_t>(row) * n + col] = gm8::crt_round_word<Out>(
              mag, neg, -(sft_a[row] + sft_b[col]));
        });
  }
}

template <typename Out>
void launch(const signed char* a8, const signed char* btp,
            unsigned char* scratch, const int* sa, const int* sb, void* out,
            int L, int m, int n, int kp, int nblocks, const gm8::CrtTable& T,
            const gm8::SlotModuli& mods, cudaStream_t s) {
  cudaFuncSetAttribute(matmul_reconstruct_kernel<Out>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  matmul_reconstruct_kernel<Out><<<nblocks, kThreads, kSmemBytes, s>>>(
      a8, btp, scratch, sa, sb, static_cast<Out*>(out), L, m, n, kp, T,
      mods);
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0); b8: (L, k, n) int8; bt: (L, n, kp) int8 workspace;
// scratch: (nblocks, L, 128 * 128) uint8 workspace; sft_a: m int32, sft_b:
// n int32; out: (m, n) f64 (out_f32 = 0) or f32 (out_f32 = 1); table: the
// CrtTable of L moduli, on the host. Slice l uses modulus MODULI[l]; k <=
// 2^17 (checked by the caller).
GM8_EXPORT int gm8_matmul_reconstruct(const void* a8, const void* b8,
                                      void* bt, void* scratch,
                                      const void* sft_a, const void* sft_b,
                                      void* out, const void* table, int L,
                                      int m, int n, int k, int kp,
                                      int nblocks, int out_f32,
                                      void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k || nblocks < 1 ||
      !gm8::slot_moduli(nullptr, L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  std::memcpy(&T, table, sizeof(T));
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  auto ap = static_cast<const signed char*>(a8);
  auto sc = static_cast<unsigned char*>(scratch);
  auto sa = static_cast<const int*>(sft_a);
  auto sb = static_cast<const int*>(sft_b);
  if (out_f32)
    launch<unsigned>(ap, btp, sc, sa, sb, out, L, m, n, kp, nblocks, T, mods,
                     s);
  else
    launch<unsigned long long>(ap, btp, sc, sa, sb, out, L, m, n, kp,
                               nblocks, T, mods, s);
  return gm8::launch_status();
}
