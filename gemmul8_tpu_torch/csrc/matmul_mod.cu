// Batched int8 GEMM with the modular reduction in the epilogue:
// out[l] = (A8[l] @ B8[l]) mod m_l as canonical uint8, or r - 128 as int8
// when centered.
//
// Replaces: matmul_mod_u8_pallas, gemmul8_tpu/pallas/matmul.py:95.
// Bound on the H100: tensor-core operations. At 8192^3 with 14 moduli the
// call is 15.4 T integer multiply-adds x 2 (7.78 ms at 1,979 TOPS); the
// int8 operands (1.9 GB) and residues (0.9 GB) are small next to that.
// Design: wgmma reads 8-bit operands K-major only. A (L, m, k) is; B is
// too where its encode wrote it so ((L, n, kp), kp = k rounded up to 16
// with zeros: encode.cu's K-major form), and the kernel reads it in place.
// A B given N-major (L, k, n) (the fused-encode variant, the sharded
// engine's big-matrix complex form) is first copied into a K-major
// workspace of that shape by a first kernel (transpose_b.cuh). The GEMM kernel then
// runs the tile of wgmma_s8.cuh on a persistent grid, one block per SM:
// TMA fills a ring of stages from 3-D tensor maps (which zero-fill ragged
// rows and k), a producer warp keeps the loads in flight, and two consumer
// warpgroups each accumulate a 64 x 256 half of a 128 x 256 tile with
// wgmma, so one tile's epilogue runs while the producer loads the next.
// The accumulator is the hardware's wrapping int32: the modulus-256 lane
// can reach 128 * 128 * 2^17 = 2^31, which wraps to a multiple of 256, so
// its residue stays right; the odd lanes stay below 127^2 * 2^17 < 2^31.
// The epilogue (wgmma_s8.cuh store_tile) reduces mod m_l with a per-slot
// multiplier and shift (moduli.cuh mod_div, exact for every int32; the 256
// lane as x & 255), writes the residue bytes into a swizzled staging tile
// in shared memory and stores it in 16-byte pieces. Slot l of a call holds modulus
// MODULI[moduli_idx[l]] (all the moduli in order, or the chunk of a
// moduli-chunked call). The tile width, the ring's depth and the raster
// group are compile-time constants from the launch table (hopper/launch.py
// `MatmulModLaunch.defines`, passed to nvcc by hopper/build.py).
#include "common.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_mod.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages);
static_assert(kBN == 256, "wgmma_s8.cuh issues wgmma.m64n256k32 only");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
matmul_mod_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  unsigned char* __restrict__ out, int L, int m, int n,
                  int kp, int centered,
                  const __grid_constant__ gm8::SlotDivisors divs) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = gm8::wg::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  gm8::wg::Ring ring;
  ring.base = gm8::wg::smem_u32(smem);
  ring.stages = kStages;
  ring.bn = kBN;
  unsigned char* stg = smem + kStages * gm8::wg::stage_bytes(kBN);
  ring.full = gm8::wg::smem_u32(stg + kBM * kBN);
  ring.empty = ring.full + 8 * kStages;
  const gm8::wg::TileWalk walk(L, m, n, kBN, kGroup);
  const int nk = (kp + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gm8::wg::mbar_init(ring.full + 8 * s, 1);
      gm8::wg::mbar_init(ring.empty + 8 * s, gm8::wg::kConsumerWarps);
    }
    gm8::wg::mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 2) {  // producer warpgroup: one thread issues the loads
    gm8::wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      gm8::wg::tma_prefetch(map_a);
      gm8::wg::tma_prefetch(map_b);
      gm8::wg::produce(map_a, map_b, ring, walk, nk);
    }
  } else {  // consumer warpgroups 0 and 1: rows 64 * role .. + 63
    gm8::wg::setmaxnreg_inc<232>();
    const unsigned flip = centered ? 0x8080u : 0u;
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
      int l, tm, tn;
      walk.at(t, l, tm, tn);
      gm8::wg::consume<kBN>(acc, ring, role, nk, stage, phase);
      const gm8::ModDivisor dv = divs.v[l];
      unsigned char* ol = out + static_cast<size_t>(l) * m * n;
      if (dv.d == 256)
        gm8::wg::store_tile<kBN, true>(acc, stg, ol, n, m, tm * kBM,
                                       tn * kBN, n, role, dv, flip);
      else
        gm8::wg::store_tile<kBN, false>(acc, stg, ol, n, m, tm * kBM,
                                        tn * kBN, n, role, dv, flip);
    }
  }
}

// every x in [lo, lo + count) of slot blockIdx.y: mod_div against
// mod_canon, the mismatches counted into bad[slot]
__global__ void __launch_bounds__(256)
mod_div_check_kernel(long long lo, long long count,
                     const __grid_constant__ gm8::SlotDivisors divs,
                     unsigned long long* __restrict__ bad) {
  const gm8::ModDivisor dv = divs.v[blockIdx.y];
  unsigned long long miss = 0;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < count; i += step) {
    const int x = static_cast<int>(lo + i);
    miss += gm8::mod_div(x, dv) != static_cast<unsigned>(
                                       gm8::mod_canon(x, dv.d));
  }
  if (miss) atomicAdd(bad + blockIdx.y, miss);
}

// ---- host ------------------------------------------------------------------
int launch_gemm(const signed char* a8, const signed char* bt,
                unsigned char* out, int L, int m, int n, int kp,
                int centered, const gm8::SlotModuli& mods, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a8, L, m, kp, kBM) ||
      !gm8::wg::make_tensor_map(&map_b, bt, L, n, kp, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = gm8::wg::persistent_grid(
      static_cast<long long>(L) * ((m + kBM - 1) / kBM) *
      ((n + kBN - 1) / kBN));
  cudaFuncSetAttribute(matmul_mod_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  matmul_mod_kernel<<<grid, gm8::wg::kThreads, kSmem, s>>>(
      map_a, map_b, out, L, m, n, kp, centered, gm8::slot_divisors(mods));
  return gm8::launch_status();
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0) and a 16-byte aligned start; b8: (L, k, n) int8, copied
// into the (L, n, kp) int8 workspace bt; or, with bt null, B itself, (L, n,
// kp) K-major with zeros in [k, kp) and 16-byte aligned, read in place;
// out: (L, m, n) uint8 or int8. Slice l uses
// modulus MODULI[moduli_idx[l]] (moduli_idx: L ints on the host, or null
// for 0..L-1); k <= 2^17 (checked by the caller).
GM8_EXPORT int gm8_matmul_mod_u8(const void* a8, const void* b8, void* bt,
                                 void* out, const void* moduli_idx, int L,
                                 int m, int n, int k, int kp, int centered,
                                 void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k || m < 0 || n < 0 ||
      reinterpret_cast<uintptr_t>(a8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt ? bt : b8) % 16 != 0 ||
      !gm8::slot_moduli(static_cast<const int*>(moduli_idx), L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto outp = static_cast<unsigned char*>(out);
  if (kp == 0)  // empty products: residue 0 everywhere
    return static_cast<int>(cudaMemsetAsync(
        outp, centered ? 0x80 : 0, static_cast<size_t>(L) * m * n, s));
  auto btp = static_cast<const signed char*>(b8);
  if (bt) {
    gm8::transpose_b(btp, static_cast<signed char*>(bt), L, k, n, kp, s);
    btp = static_cast<const signed char*>(bt);
  }
  return launch_gemm(static_cast<const signed char*>(a8), btp, outp, L, m,
                     n, kp, centered, mods, s);
}

// bad[l] (device, L uint64, zeroed by the caller) += the x in [lo, hi] for
// which the GEMM epilogue's mod_div differs from mod_canon, for slot l's
// modulus (moduli_idx as for gm8_matmul_mod_u8)
GM8_EXPORT int gm8_mod_div_check(const void* moduli_idx, int L, long long lo,
                                 long long hi, void* bad, void* stream) {
  gm8::SlotModuli mods;
  if (lo < INT32_MIN || hi > INT32_MAX || lo > hi ||
      !gm8::slot_moduli(static_cast<const int*>(moduli_idx), L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  dim3 grid(8 * sms, L);
  mod_div_check_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      lo, hi - lo + 1, gm8::slot_divisors(mods),
      static_cast<unsigned long long*>(bad));
  return gm8::launch_status();
}
