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
// Design: matmul_mod.cu's wgmma tile (wgmma_s8.cuh): the B operands come
// K-major from their encode (encode.cu's K-major form; the Karatsuba sum
// of two such parts is one too) and are read in place; B operands given
// N-major are first copied each into its own K-major workspace
// (transpose_b.cuh). Each A operand (row stride kp, padded by the
// caller) and each K-major B is read
// through its own 3-D tensor map into one TMA ring; one producer warp, two
// consumer warpgroups each accumulating a 64 x 256 half of a 128 x 256
// tile with wgmma.m64n256k32, a persistent grid. The producer walks (tile,
// product, k-tile), so each product of a tile is formed once, one after
// the other, and the ring never drains between products. The products are
// chained in the one 128-register accumulator a consumer thread holds
// (a second does not fit beside it), and a residue is unique, so any
// exact order of the arithmetic gives the TPU kernel's bits:
//   4-dot:     acc = II; acc = -acc; acc += RR  -> Re = acc mod m;
//              acc = c; acc += IR; acc += RI    -> Im = (acc - c) mod m;
//   Karatsuba: acc = E -> e = acc mod m, kept;
//              acc = F -> f; Re = e - f, s = e + f kept;
//              acc = G -> Im = g - s (all mod m).
// Exactness (k <= 2^16, any int8 slices): one product lies in
// [-128 * 127 k, 128 * 128 k], so every partial sum of the Re chain stays
// within +-(2^31 - 2^23), and E, F, G each within 2^30. IR + RI reaches
// 2^31 (k = 2^16, -128 in both products), one past int32, so the Im chain
// starts at c = -2^24 and its partial sums lie in [-2^31, 2^31 - 2^24]:
// nothing wraps, and the epilogue's divisor carries -c in its offset
// (moduli.cuh mod_divisor's bias). G - E - F spans more than 2^32, so
// Karatsuba carries e and then s as residue bytes. In registers (32 beside
// the accumulator) they spilled, so each thread keeps them in its
// warpgroup's rows of the staging tile, 32 words a thread at fixed
// offsets, and takes them back into accumulator registers freed by the
// product's reduction; Re and Im are then staged there and stored, s
// waiting meanwhile in the same registers. Every chain ends as
// store_half's epilogue does: mod_div, the bytes staged in shared memory
// and stored in 16-byte pieces. The ring's depth and the raster group are
// compile-time constants from the launch table (hopper/launch.py
// "matmul_complex", passed to nvcc by hopper/build.py).
#include "common.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_complex.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages);
constexpr int kAcc = kBN / 2;           // accumulator registers a thread
// the Im chain's start: IR + RI + c stays in [-2^31, 2^31 - 2^24]
constexpr int kImBias = -(1 << 24);
static_assert(kBN == 256, "wgmma_s8.cuh issues wgmma.m64n256k32 here");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

// the operand maps: A parts (0 = Re, 1 = Im, 2 = the Karatsuba sum) and
// the K-major B workspaces, in the same order
struct Maps {
  CUtensorMap a[3];
  CUtensorMap b[3];
};

// each form's products in the order the producer loads them, by their A
// and B operand: 4-dot II, RR, IR, RI; Karatsuba E (RR), F (II), G (SaSb)
__host__ __device__ constexpr int op_a(bool kara, int p) {
  return kara ? p : 1 - (p & 1);
}
__host__ __device__ constexpr int op_b(bool kara, int p) {
  return kara ? p : (p == 0 || p == 3) ? 1 : 0;
}

template <bool kKara>
__device__ __forceinline__ void produce_products(
    const Maps& maps, const gm8::wg::Ring& ring,
    const gm8::wg::TileWalk& walk, int nk) {
  constexpr int kProducts = kKara ? 3 : 4;
  const unsigned bytes = gm8::wg::stage_bytes(kBN);
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
    int l, tm, tn;
    walk.at(t, l, tm, tn);
#pragma unroll
    for (int p = 0; p < kProducts; ++p) {
      const CUtensorMap& ma = maps.a[op_a(kKara, p)];
      const CUtensorMap& mb = maps.b[op_b(kKara, p)];
      for (int kt = 0; kt < nk; ++kt) {
        gm8::wg::mbar_wait(ring.empty + 8 * stage, phase ^ 1);
        const unsigned full = ring.full + 8 * stage;
        gm8::wg::mbar_expect_tx(full, bytes);
        gm8::wg::tma_load(ring.a(stage), ma, full, kt * kBK, tm * kBM, l);
        gm8::wg::tma_load(ring.b(stage), mb, full, kt * kBK, tn * kBN, l);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  }
}

__device__ __forceinline__ void fill(int (&acc)[kAcc], int v) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = v;
}

// (a -/+ b) mod d for a, b in [0, d)
__device__ __forceinline__ unsigned sub_mod(unsigned a, unsigned b,
                                            unsigned d) {
  const unsigned t = a - b + d;
  return min(t, t - d);
}
__device__ __forceinline__ unsigned add_mod(unsigned a, unsigned b,
                                            unsigned d) {
  const unsigned t = a + b;
  return min(t, t - d);
}

// Karatsuba's epilogue registers: each fragment pair's two residues
// mod dv.d into its first register (acc[2 i]); each carried word into the
// second register of the word's first pair (acc[4 w + 1], free then)
__device__ __forceinline__ void reduce_with_carry(int (&acc)[kAcc],
                                                  const unsigned* carried,
                                                  const gm8::ModDivisor& dv) {
#pragma unroll
  for (int w = 0; w < kAcc / 4; ++w) {
    acc[4 * w] = static_cast<int>(gm8::mod_div(acc[4 * w], dv) |
                                  (gm8::mod_div(acc[4 * w + 1], dv) << 8));
    acc[4 * w + 2] = static_cast<int>(
        gm8::mod_div(acc[4 * w + 2], dv) |
        (gm8::mod_div(acc[4 * w + 3], dv) << 8));
    acc[4 * w + 1] = static_cast<int>(carried[128 * w]);
  }
}

// pair i's two carried residues (low byte first) of reduce_with_carry's
// words
__device__ __forceinline__ unsigned pair_of(const int (&acc)[kAcc], int i) {
  return (static_cast<unsigned>(acc[4 * (i >> 1) + 1]) >> (16 * (i & 1))) &
         0xFFFFu;
}

template <bool kKara>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
matmul_complex_kernel(const __grid_constant__ Maps maps,
                      unsigned char* __restrict__ out_re,
                      unsigned char* __restrict__ out_im, int L, int m,
                      int n, int kp, int centered,
                      const __grid_constant__ gm8::SlotDivisors divs,
                      const __grid_constant__ gm8::SlotDivisors divs_im) {
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
      for (int i = 0; i < (kKara ? 3 : 2); ++i) {
        gm8::wg::tma_prefetch(maps.a[i]);
        gm8::wg::tma_prefetch(maps.b[i]);
      }
      produce_products<kKara>(maps, ring, walk, nk);
    }
  } else {  // consumer warpgroups 0 and 1: rows 64 * role .. + 63
    gm8::wg::setmaxnreg_inc<232>();
    const unsigned flip = centered ? 0x8080u : 0u;
    int acc[kAcc];
    int stage = 0;
    unsigned phase = 0;
    for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
      int l, tm, tn;
      walk.at(t, l, tm, tn);
      const gm8::ModDivisor dv = divs.v[l];
      const unsigned d = static_cast<unsigned>(dv.d);
      const size_t off = static_cast<size_t>(l) * m * n;
      const int row0 = tm * kBM, col0 = tn * kBN;
      if constexpr (kKara) {
        // e, then s, wait in this warpgroup's 16 KB of the staging tile
        // as 32 words a thread (word w of thread x at w * 512 + 4 x:
        // pairs 2 w and 2 w + 1 of its fragment, two residues each), read
        // back by the thread that wrote them; Re and Im are staged there
        // as store_half stages, once every thread holds its carried words
        unsigned char* half = stg + role * 64 * kBN;
        unsigned* carried = reinterpret_cast<unsigned*>(half) +
                            (threadIdx.x & 127);
        fill(acc, 0);  // E
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        gm8::wg::warpgroup_sync(1 + role);  // the last tile's reads are done
#pragma unroll
        for (int w = 0; w < kAcc / 4; ++w)
          carried[128 * w] = gm8::pack4(gm8::mod_div(acc[4 * w], dv),
                                        gm8::mod_div(acc[4 * w + 1], dv),
                                        gm8::mod_div(acc[4 * w + 2], dv),
                                        gm8::mod_div(acc[4 * w + 3], dv));
        fill(acc, 0);  // F: Re = e - f, s = e + f
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        reduce_with_carry(acc, carried, dv);
        gm8::wg::warpgroup_sync(1 + role);  // every thread holds its e
        gm8::wg::for_slots<kBN>(role * 64, [&](int r, int c, int i) {
          const unsigned f = acc[2 * i], e = pair_of(acc, i);
          *gm8::wg::stg_pair<kBN>(stg, r, c) = static_cast<unsigned short>(
              (sub_mod(e & 255u, f & 255u, d) |
               (sub_mod(e >> 8, f >> 8, d) << 8)) ^ flip);
          acc[2 * i] = static_cast<int>(add_mod(e & 255u, f & 255u, d) |
                                        (add_mod(e >> 8, f >> 8, d) << 8));
        });
        gm8::wg::warpgroup_sync(1 + role);  // the half tile is staged
        gm8::wg::write_rows<kBN, 64>(stg, out_re + off, n, m, row0, col0, n,
                                     role * 64);
        gm8::wg::warpgroup_sync(1 + role);  // and read
#pragma unroll
        for (int w = 0; w < kAcc / 4; ++w)
          carried[128 * w] = (static_cast<unsigned>(acc[4 * w]) & 0xFFFFu) |
                             (static_cast<unsigned>(acc[4 * w + 2]) << 16);
        fill(acc, 0);  // G: Im = g - s
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        reduce_with_carry(acc, carried, dv);
        gm8::wg::warpgroup_sync(1 + role);  // every thread holds its s
        gm8::wg::for_slots<kBN>(role * 64, [&](int r, int c, int i) {
          const unsigned g = acc[2 * i], sv = pair_of(acc, i);
          *gm8::wg::stg_pair<kBN>(stg, r, c) = static_cast<unsigned short>(
              (sub_mod(g & 255u, sv & 255u, d) |
               (sub_mod(g >> 8, sv >> 8, d) << 8)) ^ flip);
        });
        gm8::wg::warpgroup_sync(1 + role);  // the half tile is staged
        gm8::wg::write_rows<kBN, 64>(stg, out_im + off, n, m, row0, col0, n,
                                     role * 64);
      } else {
        fill(acc, 0);  // II, negated, then RR: Re = RR - II
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = -acc[i];
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        gm8::wg::store_half<kBN>(
            acc, stg, out_re + off, n, m, row0, col0, n, role,
            [&](int x0, int x1) {
              return (gm8::mod_div(x0, dv) | (gm8::mod_div(x1, dv) << 8)) ^
                     flip;
            });
        const gm8::ModDivisor dvi = divs_im.v[l];
        fill(acc, kImBias);  // IR, then RI: Im = IR + RI
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        gm8::wg::consume<kBN, true>(acc, ring, role, nk, stage, phase);
        gm8::wg::store_half<kBN>(
            acc, stg, out_im + off, n, m, row0, col0, n, role,
            [&](int x0, int x1) {
              return (gm8::mod_div(x0, dvi) |
                      (gm8::mod_div(x1, dvi) << 8)) ^ flip;
            });
      }
    }
  }
}

template <bool kKara>
int launch(const Maps& maps, unsigned char* out_re, unsigned char* out_im,
           int L, int m, int n, int kp, int centered,
           const gm8::SlotModuli& mods, cudaStream_t s) {
  const int grid = gm8::wg::persistent_grid(
      static_cast<long long>(L) * ((m + kBM - 1) / kBM) *
      ((n + kBN - 1) / kBN));
  cudaFuncSetAttribute(matmul_complex_kernel<kKara>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  matmul_complex_kernel<kKara><<<grid, gm8::wg::kThreads, kSmem, s>>>(
      maps, out_re, out_im, L, m, n, kp, centered, gm8::slot_divisors(mods),
      gm8::slot_divisors(mods, kImBias));
  return gm8::launch_status();
}

}  // namespace

// ar, ai (and sa when kara): (L, m, kp) int8, kp % 16 == 0, zero-padded past
// k by the caller when k % 16 != 0, 16-byte aligned; br, bi (and sb):
// (L, k, n) int8, copied into bt, the K-major workspaces, (2 or 3, L, n, kp)
// int8, 16-byte aligned; or, with bt null, B's parts themselves, each
// (L, n, kp) K-major with zeros in [k, kp), 16-byte aligned, read in place
// (matmul_mod.cu's form); out_re, out_im: (L, m, n) uint8 or int8.
// Slice l uses modulus MODULI[l]. sa and sb are ignored (may be null)
// unless kara. k <= 2^16 (checked by the caller).
GM8_EXPORT int gm8_matmul_complex_mod(const void* ar, const void* ai,
                                      const void* sa, const void* br,
                                      const void* bi, const void* sb,
                                      void* bt, void* out_re, void* out_im,
                                      int L, int m, int n, int k, int kp,
                                      int centered, int kara, void* stream) {
  gm8::SlotModuli mods;
  const int nb = kara ? 3 : 2;
  const void* a_in[3] = {ar, ai, sa};
  const void* b_in[3] = {br, bi, sb};
  bool aligned = reinterpret_cast<uintptr_t>(bt) % 16 == 0;
  for (int i = 0; i < nb; ++i)
    aligned = aligned && a_in[i] != nullptr && b_in[i] != nullptr &&
              reinterpret_cast<uintptr_t>(a_in[i]) % 16 == 0 &&
              (bt || reinterpret_cast<uintptr_t>(b_in[i]) % 16 == 0);
  if (kp % 16 != 0 || kp < k || k > (1 << 16) || m < 0 || n < 0 ||
      !aligned || !gm8::slot_moduli(nullptr, L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto ore = static_cast<unsigned char*>(out_re);
  auto oim = static_cast<unsigned char*>(out_im);
  const size_t count = static_cast<size_t>(L) * m * n;
  if (kp == 0) {  // empty products: residue 0 everywhere
    const int zero = centered ? 0x80 : 0;
    const cudaError_t e = cudaMemsetAsync(ore, zero, count, s);
    return static_cast<int>(e != cudaSuccess
                                ? e : cudaMemsetAsync(oim, zero, count, s));
  }
  const size_t ws = static_cast<size_t>(L) * n * kp;
  Maps maps;
  for (int i = 0; i < nb; ++i) {
    const signed char* bti = static_cast<const signed char*>(b_in[i]);
    if (bt) {
      signed char* ws_i = static_cast<signed char*>(bt) + i * ws;
      gm8::transpose_b(bti, ws_i, L, k, n, kp, s);
      bti = ws_i;
    }
    if (!gm8::wg::make_tensor_map(&maps.a[i], a_in[i], L, m, kp, kBM) ||
        !gm8::wg::make_tensor_map(&maps.b[i], bti, L, n, kp, kBN))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!kara) {  // the unused third maps: copies, never loaded
    maps.a[2] = maps.a[0];
    maps.b[2] = maps.b[0];
  }
  return kara ? launch<true>(maps, ore, oim, L, m, n, kp, centered, mods, s)
              : launch<false>(maps, ore, oim, L, m, n, kp, centered, mods,
                              s);
}
