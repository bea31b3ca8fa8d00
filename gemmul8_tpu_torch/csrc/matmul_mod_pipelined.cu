// Batched int8 GEMM with the modular reduction one n-tile behind the
// product: out[l] = (A8[l] @ B8[l]) mod m_l as canonical uint8, the function
// of matmul_mod.cu with centered = false, in another schedule.
//
// Replaces: matmul_mod_u8_pipelined, gemmul8_tpu/pallas/matmul.py:188.
// Bound on the H100: tensor-core operations, as matmul_mod.cu (8192^3 at 14
// moduli: 1.54e13 int8 operations, 7.78 ms at 1,979 TOPS).
// Design: the TPU kernel ran the mod of tile j-1 from one accumulator while
// its matrix unit filled the other with tile j. Here a block walks a run of
// up to kRun 128 x 128 output tiles along n of one (l, m-tile) row with two
// live accumulators. matmul_mod.cu's 128 x 128 accumulator takes 64
// registers a thread in a 256-thread block, two blocks per SM; this block
// has 512 threads (16 warps, 4 (m) x 4 (n), each 32 x 32), one per SM, so
// each accumulator takes 32 registers a thread and the pair fits the same
// register file; the bytes copied per output tile are matmul_mod.cu's. The
// price is the warp tile: a 32 x 32 warp tile reads 4 ldmatrix fragments
// per 8 mma.sync where matmul_mod.cu's 64 x 32 reads 6 per 16, a third
// more shared-memory reads per product (PERF.md has the times). While the
// warps issue tile j's mma.sync, the epilogue of tile j-1 (an exact
// remainder, one byte stored per residue) runs from the other accumulator
// in kPieces pieces, one after each of tile j's first k-steps, so the
// integer work interleaves with the tensor-core work instead of following
// it. The cp.async ring (3 stages of a 128 x 128-byte A tile, copied by
// warps 0-7, and a 128 x 128-byte B tile, copied by warps 8-15) runs on
// across tile boundaries, so the pipeline never drains inside a run. Runs
// of kRun tiles (not whole rows of 64 tiles at n = 8192) give 3584 blocks
// at 8192^3 and 14 moduli, so the last wave is short. B is copied K-major
// first (transpose_b.cuh), as for matmul_mod.cu; any k <= 2^17 is taken
// (the TPU kernel's k <= bk limit came from its launch table).
// Accumulators are the hardware's wrapping int32: the modulus-256 lane is
// reduced as x & 255, which the wrap leaves right.
#include "common.cuh"
#include "mma_s8.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBK;
using gm8::kStages;
constexpr int kTM = gm8::kBM, kTN = gm8::kBN;
constexpr int kThreads = 2 * gm8::kMmaThreads;  // half copy A, half B
constexpr int kRun = 16;     // n-tiles a block walks
constexpr int kPieces = 8;   // epilogue pieces: one (mt, nt) pair each
constexpr int kStageBytes = (kTM + kTN) * kBK;
constexpr int kSmemBytes = kStages * kStageBytes;  // 96 KB, dynamic

using Acc = int[2][4][4];  // [mt][nt][r] of a warp's 32 x 32 tile

// what every thread of a block needs for its run of tiles
struct Run {
  const signed char* A;   // (m, kp) of slice l
  const signed char* Bt;  // (n, kp) of slice l
  unsigned char* out;     // (m, n) of slice l
  int m, n, kp, nk, bm0, bn_first, mod;
  unsigned s0;            // shared-memory address of the ring
};

// warp row and column (0..3 each) of the 4 x 4 warp grid
__device__ __forceinline__ int warp_m() { return threadIdx.x >> 7; }
__device__ __forceinline__ int warp_n() { return (threadIdx.x >> 5) & 3; }

__device__ __forceinline__ unsigned a_stage(const Run& r, int s) {
  return r.s0 + s * kStageBytes;
}
__device__ __forceinline__ unsigned b_stage(const Run& r, int s) {
  return r.s0 + s * kStageBytes + kTM * kBK;
}

// cp.async copies of flat step `it` (tile it / nk, k-tile it % nk): warps
// 0-7 copy the A tile, warps 8-15 the B tile
__device__ __forceinline__ void load_step(const Run& r, int it) {
  const int tile = it / r.nk, kt = it - tile * r.nk, s = it % kStages;
  if (threadIdx.x < gm8::kMmaThreads)
    gm8::load_tile<false>(threadIdx.x, a_stage(r, s), r.A, r.bm0, r.m,
                          kt * kBK, r.kp, r.kp);
  else
    gm8::load_tile<false>(threadIdx.x - gm8::kMmaThreads, b_stage(r, s),
                          r.Bt, r.bn_first + tile * kTN, r.n, kt * kBK, r.kp,
                          r.kp);
}

// acc += the stage's 128-byte-deep products
__device__ __forceinline__ void mma_stage(const Run& r, Acc& acc, int s) {
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chk = lane >> 4;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_chk = (lane >> 3) & 1;
  const unsigned sa = a_stage(r, s), sb = b_stage(r, s);
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    unsigned af[2][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      gm8::ldmatrix_x4(af[mt], sa + gm8::swz(warp_m() * 32 + mt * 16 + a_row,
                                             ks * 2 + a_chk));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      unsigned q[4];
      gm8::ldmatrix_x4(q, sb + gm8::swz(warp_n() * 32 + np * 16 + b_row,
                                        ks * 2 + b_chk));
      bf[2 * np][0] = q[0];
      bf[2 * np][1] = q[1];
      bf[2 * np + 1][0] = q[2];
      bf[2 * np + 1][1] = q[3];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) gm8::mma_s8(acc[mt][nt], af[mt], bf[nt]);
  }
}

__device__ __forceinline__ unsigned residue(int x, int mod) {
  if (mod == 256) return static_cast<unsigned>(x) & 255u;
  const int res = x % mod;
  return static_cast<unsigned>(res < 0 ? res + mod : res);
}

// piece P (mt = P / 4, nt = P % 4) of the tile at column bn0
template <int P>
__device__ __forceinline__ void store_piece(const Run& r, const Acc& acc,
                                            int bn0) {
  constexpr int mt = P / 4, nt = P % 4;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row =
        r.bm0 + warp_m() * 32 + mt * 16 + (lane >> 2) + (q >= 2 ? 8 : 0);
    const int col = bn0 + warp_n() * 32 + nt * 8 + (lane & 3) * 2 + (q & 1);
    if (row < r.m && col < r.n)
      r.out[static_cast<size_t>(row) * r.n + col] =
          static_cast<unsigned char>(residue(acc[mt][nt][q], r.mod));
  }
}

__device__ __forceinline__ void store_piece(const Run& r, const Acc& acc,
                                            int bn0, int p) {
  switch (p) {
    case 0: store_piece<0>(r, acc, bn0); break;
    case 1: store_piece<1>(r, acc, bn0); break;
    case 2: store_piece<2>(r, acc, bn0); break;
    case 3: store_piece<3>(r, acc, bn0); break;
    case 4: store_piece<4>(r, acc, bn0); break;
    case 5: store_piece<5>(r, acc, bn0); break;
    case 6: store_piece<6>(r, acc, bn0); break;
    case 7: store_piece<7>(r, acc, bn0); break;
    default: break;
  }
}

// one tile into cur over its nk k-steps (flat steps it.. of the run), with
// the previous tile's epilogue from prev spread over the first kPieces
// steps when has_prev
__device__ __forceinline__ void run_tile(const Run& r, int& it, int total,
                                         Acc& cur, const Acc& prev,
                                         bool has_prev, int prev_bn0) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[mt][nt][q] = 0;
  for (int kt = 0; kt < r.nk; ++kt, ++it) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
    __syncthreads();  // step it landed; step it-1's stage is free to refill
    const int pf = it + kStages - 1;
    if (pf < total) load_step(r, pf);
    asm volatile("cp.async.commit_group;\n");
    mma_stage(r, cur, it % kStages);
    if (has_prev && kt < kPieces) store_piece(r, prev, prev_bn0, kt);
  }
  if (has_prev)
    for (int p = r.nk; p < kPieces; ++p) store_piece(r, prev, prev_bn0, p);
}

__global__ void __launch_bounds__(kThreads, 1)
matmul_mod_pipelined_kernel(const signed char* __restrict__ A,
                            const signed char* __restrict__ Bt,
                            unsigned char* __restrict__ out, int m, int n,
                            int kp,
                            const __grid_constant__ gm8::SlotModuli mods) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.z;
  Run r;
  r.A = A + static_cast<size_t>(l) * m * kp;
  r.Bt = Bt + static_cast<size_t>(l) * n * kp;
  r.out = out + static_cast<size_t>(l) * m * n;
  r.m = m;
  r.n = n;
  r.kp = kp;
  r.nk = (kp + kBK - 1) / kBK;
  r.bm0 = blockIdx.y * kTM;
  r.bn_first = blockIdx.x * kRun * kTN;
  r.mod = mods.m[l];
  r.s0 = gm8::smem_addr(smem);
  const int n_tiles = min(kRun, (n - r.bn_first + kTN - 1) / kTN);
  const int total = n_tiles * r.nk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_step(r, s);
    asm volatile("cp.async.commit_group;\n");
  }
  // static ping-pong: even tiles in acc0, odd tiles in acc1
  Acc acc0, acc1;
  int it = 0;
  for (int j = 0; j < n_tiles; j += 2) {
    run_tile(r, it, total, acc0, acc1, j > 0, r.bn_first + (j - 1) * kTN);
    if (j + 1 < n_tiles)
      run_tile(r, it, total, acc1, acc0, true, r.bn_first + j * kTN);
  }
  asm volatile("cp.async.wait_group 0;\n");
  const int last = n_tiles - 1, bn0 = r.bn_first + last * kTN;
  if (last & 1) {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) store_piece(r, acc1, bn0, p);
  } else {
#pragma unroll
    for (int p = 0; p < kPieces; ++p) store_piece(r, acc0, bn0, p);
  }
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0); b8: (L, k, n) int8; bt: (L, n, kp) int8 workspace;
// out: (L, m, n) uint8 canonical residues. Slice l uses modulus
// MODULI[moduli_idx[l]] (moduli_idx: L ints on the host, or null for
// 0..L-1); k <= 2^17 (checked by the caller).
GM8_EXPORT int gm8_matmul_mod_u8_pipelined(const void* a8, const void* b8,
                                           void* bt, void* out,
                                           const void* moduli_idx, int L,
                                           int m, int n, int k, int kp,
                                           void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k ||
      !gm8::slot_moduli(static_cast<const int*>(moduli_idx), L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  cudaFuncSetAttribute(matmul_mod_pipelined_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  const int n_tiles = (n + kTN - 1) / kTN;
  dim3 grid((n_tiles + kRun - 1) / kRun, (m + kTM - 1) / kTM, L);
  matmul_mod_pipelined_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const signed char*>(a8), btp,
      static_cast<unsigned char*>(out), m, n, kp, mods);
  return gm8::launch_status();
}
