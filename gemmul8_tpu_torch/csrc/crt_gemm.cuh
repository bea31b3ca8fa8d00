// The body of matmul_crt.cu's CRT-fused GEMM (matmul_reconstruct.cu runs
// its own on the wgmma tile): one block owns one 128 x 128 output tile at
// a time (the tile of mma_s8.cuh, unchanged), loops over the L moduli, and
// after the last one forms each element's CRT sum X = sum_l w_l * r_l.
//
// Where the sum lives. A thread holds the tile's 64 int32 accumulators of
// one product; the CRT sums of its 64 elements (six 32-bit words each) fit
// in no register file beside them, and 128 x 128 x 24 bytes fit in no
// shared memory. The most compact state that is exact is the residues
// themselves, one byte per element and modulus (the sum mod M needs 14 bytes
// at 14 moduli, a running sum of words 16 to 24, of limbs 32 to 44). So
// after each product the block reduces its accumulators mod m_l in
// registers (as matmul_mod.cu) and writes the bytes into its own scratch
// of L x 128 x 128 bytes in device memory, which the grid-stride loop
// reuses for every tile the block takes. After the last modulus the block
// reads the L bytes of each element back, neighbouring threads on
// neighbouring columns, and sums them with crt.cuh's crt_add. The scratch
// is written once and read once per tile, by the block that owns it: at
// 8192^2 and 14 moduli, 264 resident blocks hold 59 MB of it, against the
// 0.94 GB of residues the unfused path stores, and most of it is read back
// from L2. A running sum kept in the output instead would be read and
// written once per modulus, 16 to 44 bytes each way against 1 byte.
//
// The grid is persistent (gridDim.x blocks walk the tiles in order), so the
// scratch is sized by the blocks in flight, not by the output.
#pragma once

#include "common.cuh"
#include "crt.cuh"
#include "mma_s8.cuh"
#include "moduli.cuh"

namespace gm8 {
namespace {

constexpr int kTileElems = kBM * kBN;

// residues of tile (bm0, bn0) of A[l] (m, kp) x Bt[l] (n, kp)^T mod
// mods.m[l], l < L, into scratch (L, 128, 128) uint8; rows and columns past
// m and n hold residues of zero products
__device__ __forceinline__ void tile_residues(
    const signed char* __restrict__ A, const signed char* __restrict__ Bt,
    int L, int m, int n, int kp, int bm0, int bn0, const SlotModuli& mods,
    unsigned char* smem, unsigned char* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  for (int l = 0; l < L; ++l) {
    // the product refills the ring, and the first one overwrites the
    // scratch: every warp must be done reading both
    __syncthreads();
    int acc[4][4][4];
    mma_tile<false>(A + static_cast<size_t>(l) * m * kp, kp,
                    Bt + static_cast<size_t>(l) * n * kp, kp, m, n, kp, bm0,
                    bn0, smem, acc);
    const int mod = mods.m[l];
    unsigned char* sl = scratch + l * kTileElems;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // the accumulator's pairs (r = 2h, 2h + 1) are neighbouring columns
          const int lr = wm * 64 + mt * 16 + g + h * 8;
          const int lc = wn * 32 + nt * 8 + t * 2;
          const unsigned lo = mod_canon(acc[mt][nt][2 * h], mod);
          const unsigned hi = mod_canon(acc[mt][nt][2 * h + 1], mod);
          *reinterpret_cast<unsigned short*>(sl + lr * kBN + lc) =
              static_cast<unsigned short>(lo | (hi << 8));
        }
  }
  __syncthreads();  // the scratch is whole before any thread reads it
}

// f(row, col, x) for each in-range element of the tile, x the six words of
// its CRT sum over the scratch's residues; a warp takes 32 neighbouring
// columns of one row at a time
template <typename F>
__device__ __forceinline__ void for_each_crt_sum(
    const unsigned char* __restrict__ scratch, int L, const CrtTable& T,
    int bm0, int bn0, int m, int n, F f) {
  for (int i = threadIdx.x; i < kTileElems; i += kMmaThreads) {
    const int row = bm0 + i / kBN, col = bn0 + i % kBN;
    if (row >= m || col >= n) continue;
    unsigned long long acc[kWords] = {0, 0, 0, 0, 0, 0};
    for (int l = 0; l < L; ++l)
      crt_add(acc, T, l, __ldcg(scratch + l * kTileElems + i));
    unsigned x[kWords];
    crt_words(acc, x);
    f(row, col, x);
  }
}

}  // namespace
}  // namespace gm8
