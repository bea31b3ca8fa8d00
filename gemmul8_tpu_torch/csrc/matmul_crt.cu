// Batched int8 GEMM with the whole per-modulus epilogue fused: the residue
// of each product and the CRT-weighted sum over the moduli. Emits
// (nl, m, n) int32 canonical 16-bit limbs of X = sum_l w_l * (C_l mod m_l),
// C_l = A8[l] @ B8[l]: what the limb input of the reconstruct kernel takes.
// X is not reduced mod M; the reconstruct does that.
//
// Replaces: matmul_crt_pallas, gemmul8_tpu/pallas/matmul.py:637.
// Bound on the H100: tensor-core operations (L x 2mnk, as matmul_mod.cu);
// the limbs are 4 * nl bytes per element (2.1 GB at 8192^2 and 14 moduli,
// 0.64 ms at 3.35 TB/s, more than the 0.94 GB of residues they replace).
// Design: matmul_reconstruct.cu's kernel with another end. The products
// run matmul_mod.cu's tile (wgmma_s8.cuh; the launch entry "matmul_crt" of
// hopper/launch.py, matmul_mod's values); the producer walks (tile,
// modulus, k-tile); after each modulus the consumers reduce their
// accumulator (store_tile: mod_div, or x & 255 for the 256 lane, whose
// int32 sum may wrap at k = 2^17 and stays right mod 256) into the block's
// scratch of L residue planes; after the tile's last modulus the 8
// consumer warps take its 128-element chunks off a counter while the
// producer loads the next tile, each chunk's sum on mma.sync.m16n8k32 s8
// against the compact digit table (crt_mma.cuh, the table built on the
// host from the CrtTable the call passes). Limb l of a digit sum, Y[2l] +
// 256 Y[2l+1] + 32896 S + CL[l], is nonnegative and below 2^29 but not
// canonical: each lane carries its elements' limbs once, low to high, in
// the warp's limb rows in shared memory (X < 255 L M fits nl limbs, so the
// last carry is 0), then the warp stores each limb plane's half chunk in
// 16-byte pieces of 4 columns, 32 contiguous bytes to a sector. B is
// copied K-major first (transpose_b.cuh), as for matmul_mod.cu. The walk,
// the scratch and the chunks' digit sums are matmul_reconstruct.cu's,
// written out again rather than shared, so that kernel keeps the code
// PERF.md measured (as wgmma_s8.cuh keeps store_tile written out).
#include <cstring>

#include "common.cuh"
#include "crt_mma.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_crt.cu takes its launch from hopper/launch.py"
#endif

namespace {

using gm8::CrtMmaTable;
using gm8::kCrtTiles;
using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kAcc = kBN / 2;           // accumulator registers a thread
constexpr int kTileElems = kBM * kBN;   // a residue plane of a tile
constexpr int kRecChunk = 128;          // elements a warp's chunk
constexpr int kRecHalf = kRecChunk / 2;
constexpr int kChunks = kTileElems / kRecChunk;
constexpr int kLimbRows = 4 * kCrtTiles;  // 12 limb rows (row nl: S)
constexpr int kZStride = kRecHalf + 4;    // ints a limb row of a half
constexpr int kZBytes = kLimbRows * kZStride * 4;  // a warp's limb rows
constexpr int kConsumers = 32 * gm8::wg::kConsumerWarps;
constexpr int kBarrier = 3;           // named barrier of the consumers
// after the ring's barriers: the digit table and the chunk counter (16
// bytes)
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages) +
                      static_cast<int>(sizeof(CrtMmaTable)) + 16;
static_assert(kBN == 256, "wgmma_s8.cuh issues wgmma.m64n256k32 only");
static_assert(kBN % kRecChunk == 0, "a chunk lies in one row of a tile");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");
static_assert(4 * kZBytes <= kBM * kBN / 2,
              "a warpgroup's limb rows fit its half of the staging tile");
static_assert((kZStride * 4) % 16 == 0 && kZBytes % 16 == 0,
              "limb rows start on 16-byte boundaries");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

// the constants of a launch, by value
struct alignas(16) Consts {
  CrtMmaTable W;             // the digit table of the call's L
  gm8::SlotDivisors divs;    // the residues' divisors of moduli 0..L-1
};

struct Args {
  int* out;                  // (nl, m, n) limbs
  unsigned char* scratch;    // (grid, L, kTileElems) residues
  int L, m, n, nk;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kBarrier), "n"(kConsumers)
               : "memory");
}

// residues j of elements e0 .. e0 + 15 of a tile's buffer, centred (^
// 0x80), four to a word; 0 past L. The buffer was written in this launch,
// so it is read through L2 (ld.global.cg), never the read-only path.
__device__ __forceinline__ void load16(unsigned (&w)[4],
                                       const unsigned char* buf, int j,
                                       int e0, int L) {
  if (j >= L) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    return;
  }
  const uint4 v = __ldcg(reinterpret_cast<const uint4*>(
      buf + static_cast<size_t>(j) * kTileElems + e0));
  w[0] = v.x ^ 0x80808080u;
  w[1] = v.y ^ 0x80808080u;
  w[2] = v.z ^ 0x80808080u;
  w[3] = v.w ^ 0x80808080u;
}

// The chunks of tile (tm, tn) from its residues, taken by the calling warp
// off the counter until none is left, the next chunk's residues in flight
// during a chunk's last limb stores; at: the warp's limb rows. kNl: the
// most limbs of the instantiation's L (8 up to 14 moduli, else 11), kHi:
// moduli past 16.
template <int kNl, bool kHi>
__device__ __forceinline__ void crt_tile(const Args& p, const CrtMmaTable& W,
                                         const unsigned char* buf, int tm,
                                         int tn, unsigned* counter,
                                         unsigned char* at) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto grab = [&]() -> int {
    unsigned i = 0;
    if (lane == 0) i = atomicAdd(counter, 1u);
    i = __shfl_sync(0xFFFFFFFFu, i, 0);
    return i < static_cast<unsigned>(kChunks) ? static_cast<int>(i) : -1;
  };
  int c = grab();
  if (c < 0) return;
  int (*zs)[kZStride] = reinterpret_cast<int (*)[kZStride]>(at);
  const int L = p.L, nl = W.nd / 2;
  const size_t mn = static_cast<size_t>(p.m) * p.n;
  const bool vec = (p.n & 3) == 0;  // 16-byte pieces of 4 limbs aligned
  unsigned bf[kCrtTiles][2];
  gm8::crt_b_frags(W, bf);
  int cl[kCrtTiles];
#pragma unroll
  for (int q = 0; q < kCrtTiles; ++q) cl[q] = W.cl[4 * q + t];
  // thread (g, t): elements 16g..16g+15 of moduli 4t..4t+3 (wl) and
  // 16+4t.. (wh, kHi); word k holds elements 16g+4k..16g+4k+3
  unsigned wl[4][4], wh[kHi ? 4 : 1][4];
  auto load_rows = [&](int ch) {
    const int e0 = ch * kRecChunk + 16 * g;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load16(wl[i], buf, 4 * t + i, e0, L);
      if constexpr (kHi) load16(wh[i], buf, 16 + 4 * t + i, e0, L);
    }
  };
  load_rows(c);
  while (c >= 0) {
    const int cn = grab();
    const int row = tm * kBM + c / (kBN / kRecChunk);
    const int col0 = tn * kBN + (c % (kBN / kRecChunk)) * kRecChunk;
    if (row >= p.m || col0 >= p.n) {  // no output element: skip
      if (cn >= 0) load_rows(cn);
      c = cn;
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // half h: the limbs of elements 16g + 8h + 4kk + 0..3, without S's
      // term, at columns 8g + 4kk.. of the warp's limb rows
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int k = 2 * h + kk;
        const unsigned cw[4] = {wl[0][k], wl[1][k], wl[2][k], wl[3][k]};
        unsigned lo[4], hi[4] = {0u, 0u, 0u, 0u};
        gm8::transpose4(cw, lo);
        if constexpr (kHi) {
          const unsigned chw[4] = {wh[0][k], wh[1][k], wh[2][k], wh[3][k]};
          gm8::transpose4(chw, hi);
        }
        int d[2][kCrtTiles][4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int q = 0; q < kCrtTiles; ++q) {
            d[pp][q][0] = d[pp][q][2] = cl[q];
            d[pp][q][1] = d[pp][q][3] = 0;
          }
        gm8::crt_mma_acc(lo, hi, bf, d);
#pragma unroll
        for (int q = 0; q < kCrtTiles; ++q)
          *reinterpret_cast<int4*>(&zs[4 * q + t][8 * g + 4 * kk]) =
              make_int4(d[0][q][0] + 256 * d[0][q][1],
                        d[0][q][2] + 256 * d[0][q][3],
                        d[1][q][0] + 256 * d[1][q][1],
                        d[1][q][2] + 256 * d[1][q][3]);
      }
      __syncwarp();
      // the next chunk's residues, in flight during the last half's stores
      if (h == 1 && cn >= 0) load_rows(cn);
      // columns idx = lane, lane + 32 of the limb rows: S's term added and
      // the carries taken once, low limb to high, in place
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = lane + 32 * i;
        const int s = 32896 * zs[nl][idx];
        int carry = 0;
#pragma unroll
        for (int l = 0; l < kNl; ++l)
          if (l < nl) {
            const int v = zs[l][idx] + s + carry;
            zs[l][idx] = v & 0xFFFF;
            carry = v >> 16;
          }
      }
      __syncwarp();
      // limb plane l's half chunk: piece q = lane % 16 holds limb row
      // columns 4q .. 4q + 3, output columns col0 + 16 (q / 2) + 8 h +
      // 4 (q % 2) ..; lanes 0-15 take the even planes, 16-31 the odd
      const int q = lane & 15;
      const int col = col0 + 16 * (q >> 1) + 8 * h + 4 * (q & 1);
      if (col < p.n) {
        int* o = p.out + static_cast<size_t>(row) * p.n + col;
        for (int l = lane >> 4; l < nl; l += 2) {
          const int4 v = *reinterpret_cast<const int4*>(&zs[l][4 * q]);
          int* dst = o + l * mn;
          if (vec) {
            __stcs(reinterpret_cast<int4*>(dst), v);
          } else {
            const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < p.n) dst[e] = w[e];
          }
        }
      }
      __syncwarp();  // the next half's limbs overwrite these rows
    }
    c = cn;
  }
}

template <int kNl, bool kHi>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
matmul_crt_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ Args p,
                  const __grid_constant__ Consts P) {
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
  auto* W = reinterpret_cast<CrtMmaTable*>(stg + kBM * kBN + 16 * kStages);
  auto* counter = reinterpret_cast<unsigned*>(W + 1);
  // the tiles of the output; each tile's L products follow one another
  const gm8::wg::TileWalk walk(1, p.m, p.n, kBN, kGroup);
  unsigned char* sc =
      p.scratch + static_cast<size_t>(blockIdx.x) * p.L * kTileElems;
  // the chunks read their lanes' digits from shared memory, where
  // distinct addresses do not serialise as they would in the parameter
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(CrtMmaTable) / 16);
       i += blockDim.x)
    reinterpret_cast<uint4*>(W)[i] = reinterpret_cast<const uint4*>(&P.W)[i];
  if (threadIdx.x == 0) {
    *counter = 0;
    for (int s = 0; s < kStages; ++s) {
      gm8::wg::mbar_init(ring.full + 8 * s, 1);
      gm8::wg::mbar_init(ring.empty + 8 * s, gm8::wg::kConsumerWarps);
    }
    gm8::wg::mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  if (role == 2) {
    // the producer warpgroup: one thread loads (tile, modulus, k-tile)
    gm8::wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      gm8::wg::tma_prefetch(map_a);
      gm8::wg::tma_prefetch(map_b);
      const unsigned bytes = gm8::wg::stage_bytes(kBN);
      int stage = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
        int l0, tm, tn;
        walk.at(t, l0, tm, tn);
        for (int l = 0; l < p.L; ++l)
          for (int kt = 0; kt < p.nk; ++kt) {
            gm8::wg::mbar_wait(ring.empty + 8 * stage, phase ^ 1);
            const unsigned full = ring.full + 8 * stage;
            gm8::wg::mbar_expect_tx(full, bytes);
            gm8::wg::tma_load(ring.a(stage), map_a, full, kt * kBK,
                              tm * kBM, l);
            gm8::wg::tma_load(ring.b(stage), map_b, full, kt * kBK,
                              tn * kBN, l);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }
  // consumer warpgroups 0 and 1: product rows 64 * role .. + 63 of each
  // modulus, then the tile's chunks, their limb rows in the warpgroup's
  // half of the staging tile
  gm8::wg::setmaxnreg_inc<232>();
  unsigned char* at =
      stg + role * (kBM * kBN / 2) + ((threadIdx.x >> 5) % 4) * kZBytes;
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
    int l0, tm, tn;
    walk.at(t, l0, tm, tn);
    for (int l = 0; l < p.L; ++l) {
      // defined for each product, so that the accumulator is dead outside
      // the mainloop and the epilogue (an undefined one stays live through
      // the wgmma asm and spills all beside it)
      int acc[kAcc];
#pragma unroll
      for (int r = 0; r < kAcc; ++r) acc[r] = 0;
      gm8::wg::consume<kBN>(acc, ring, role, p.nk, stage, phase);
      const gm8::ModDivisor dv = P.divs.v[l];
      unsigned char* plane = sc + static_cast<size_t>(l) * kTileElems;
      if (dv.d == 256)
        gm8::wg::store_tile<kBN, true>(acc, stg, plane, kBN, kBM, 0, 0, kBN,
                                       role, dv, 0u);
      else
        gm8::wg::store_tile<kBN, false>(acc, stg, plane, kBN, kBM, 0, 0,
                                        kBN, role, dv, 0u);
    }
    // the tile's residues are whole, the staging tile's reads done
    consumers_sync();
    crt_tile<kNl, kHi>(p, *W, sc, tm, tn, counter, at);
    // every chunk is stored: the next tile may overwrite the residues and
    // the limb rows, and the counter starts again
    consumers_sync();
    if (threadIdx.x == 0) *counter = 0;
  }
}

template <int kNl, bool kHi>
int launch_kernel(const CUtensorMap& ma, const CUtensorMap& mb,
                  const Args& p, const Consts& P, int nblocks,
                  cudaStream_t s) {
  auto kernel = matmul_crt_kernel<kNl, kHi>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  kernel<<<nblocks, gm8::wg::kThreads, kSmem, s>>>(ma, mb, p, P);
  return gm8::launch_status();
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0) and a 16-byte aligned start; b8: (L, k, n) int8; bt:
// (L, n, kp) int8 workspace; scratch: (nblocks, L, 128 * 256) uint8
// workspace, nblocks the persistent grid (one block per SM, at most one
// per 128 x 256 tile); out: (nl, m, n) int32, 16-byte aligned; table: the
// CrtTable of L moduli, on the host; nl: its limb count (num_limbs(L),
// at most 11). Slice l uses modulus MODULI[l]; k <= 2^17 (checked by the
// caller).
GM8_EXPORT int gm8_matmul_crt(const void* a8, const void* b8, void* bt,
                              void* scratch, void* out, const void* table,
                              int L, int nl, int m, int n, int k, int kp,
                              int nblocks, void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k || m < 1 || n < 1 || nblocks < 1 || L < 2 ||
      !gm8::slot_moduli(nullptr, L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  std::memcpy(&T, table, sizeof(T));
  Consts P;
  std::memset(&P, 0, sizeof(P));
  P.W = gm8::crt_mma_table(T, L);
  P.divs = gm8::slot_divisors(mods);
  if (nl != P.W.nd / 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (kp == 0)  // empty products: every residue, X and limb 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(nl) * m * n * 4, s));
  if (reinterpret_cast<uintptr_t>(a8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a8, L, m, kp, kBM) ||
      !gm8::wg::make_tensor_map(&map_b, btp, L, n, kp, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{static_cast<int*>(out), static_cast<unsigned char*>(scratch),
               L, m, n, (kp + kBK - 1) / kBK};
  if (L <= 14) return launch_kernel<8, false>(map_a, map_b, p, P, nblocks, s);
  if (L <= 16)
    return launch_kernel<11, false>(map_a, map_b, p, P, nblocks, s);
  return launch_kernel<11, true>(map_a, map_b, p, P, nblocks, s);
}
