// Batched int8 GEMM fused with the CRT reconstruction:
// out = RNE( centered(sum_l w_l (C_l mod m_l) mod M) * 2^(-sft_a - sft_b) ),
// C_l = A8[l] @ B8[l], as f64 or f32: matmul_mod.cu and reconstruct.cu in
// one kernel, the residues never stored as an (L, m, n) tensor.
//
// Replaces: matmul_reconstruct_pallas, gemmul8_tpu/pallas/megakernel.py:80
// (its f64 and f32 outputs).
// Bound on the H100: tensor-core operations (L x 2mnk); beside the int8
// operands it moves only the shifts and 8 bytes (f32: 4) per output
// element, and its scratch of residues (below).
// Design: the products run matmul_mod.cu's tile (wgmma_s8.cuh: 3-D TMA
// maps into a ring of stages, one producer warp, two consumer warpgroups
// of wgmma.m64n256k32 s8 on a 128 x 256 tile, a persistent grid of one
// block per SM, matmul_mod's launch values in an entry of its own,
// "matmul_reconstruct" of hopper/launch.py). The producer walks (tile,
// modulus, k-tile), as matmul_complex.cu walks (tile, product, k-tile), so
// the ring runs on from one modulus to the next and from one tile to the
// next. After each modulus the consumers reduce their accumulator
// (store_tile: mod_div, or x & 255 for the 256 lane, whose int32 sum may
// wrap at k = 2^17 and stays right mod 256) and store the residue bytes,
// staged through the swizzled staging tile, in 16-byte pieces into the
// block's scratch: L planes of 128 x 256 bytes (448 KB at 14 moduli,
// which no shared memory holds), written once and read once per tile
// while they are still in L2, so the sum stays exact and the scratch small
// (60 MB at 14 moduli on 132 SMs, against the 0.94 GB of residues the
// unfused path stores at 8192^2). After the tile's last modulus the 8
// consumer warps reconstruct it, while the producer already loads the
// next tile into the ring: they take 128-element chunks off a counter in
// shared memory, each the pipeline rider's reconstruct body
// (matmul_rider.cu rec_chunks): 16-byte loads of 16 residues a modulus,
// the sum on mma.sync.m16n8k32 s8 against the compact digit table
// (crt_mma.cuh), the limbs through shared memory (the staging tile, free
// between tiles) in two halves, then crt_tail.cuh's tail, rounded once
// into f64 or f32 (round_word_rn, never through an f64). Rider warps
// beside the products, reconstructing the previous tile from a second
// buffer, ran slower: they took the products' issue slots, a stage's
// shared memory, and could not keep up. The digit table is built on the
// host from the CrtTable the call passes (crt_mma.cuh crt_mma_table).
// matmul_crt.cu runs the same walk and chunks and stores canonical limbs. B is copied K-major first
// (transpose_b.cuh), as for matmul_mod.cu.
#include <cstring>

#include "common.cuh"
#include "crt_mma.cuh"
#include "crt_tail.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_reconstruct.cu takes its launch from hopper/launch.py"
#endif

namespace {

using gm8::CrtMmaTable;
using gm8::CrtTable;
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
constexpr int kLimbRows = 4 * kCrtTiles;  // 12 limb rows (the last: S)
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
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

// the constants of a launch, by value
struct alignas(16) Consts {
  CrtMmaTable W;             // the digit table of the call's L
  CrtTable T;                // the tail's M, M / 2, 1 / M
  gm8::SlotDivisors divs;    // the residues' divisors of moduli 0..L-1
};

template <typename Out>
struct Args {
  const int* sa;             // m row shifts
  const int* sb;             // n column shifts
  Out* out;                  // (m, n) f64 or f32 words
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

// one element's output word from its limbs in column idx of a warp's half
// chunk (row nl: the ones row's S), rounded once at 2^e_fix
template <typename Out, int kW>
__device__ __forceinline__ Out rec_word(int (*zs)[kZStride], int idx, int nl,
                                        const CrtTable& T, int e_fix) {
  const int s1 = zs[nl][idx];
  int limb[2 * kW];
#pragma unroll
  for (int l = 0; l < 2 * kW; ++l)
    limb[l] = l < nl ? zs[l][idx] + 32896 * s1 : 0;
  unsigned x[kW], mag[kW];
  gm8::limbs_to_words(limb, x);
  const bool neg = gm8::center_rn(x, T, mag);
  return gm8::round_word_rn<Out>(mag, neg, e_fix);
}

// The chunks of tile (tm, tn) from its residues, taken by the calling warp
// off the counter until none is left, the next chunk's residues in
// flight during a chunk's last tails; at: the warp's limb rows. kW: the
// tail's words (4 up to 14 moduli, else 6), kHi: moduli past 16.
template <int kW, bool kHi, typename Out>
__device__ __forceinline__ void rec_tile(const Args<Out>& p,
                                         const CrtMmaTable& W,
                                         const CrtTable& T,
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
    const int sa = __ldg(p.sa + row);
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
      // the next chunk's residues, in flight during the last half's tails
      if (h == 1 && cn >= 0) load_rows(cn);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = lane + 32 * i;
        const int col = col0 + 16 * (idx >> 3) + 8 * h + (idx & 7);
        if (col >= p.n) continue;
        p.out[static_cast<size_t>(row) * p.n + col] = rec_word<Out, kW>(
            zs, idx, nl, T, -(sa + __ldg(p.sb + col)));
      }
      __syncwarp();  // the next half's limbs overwrite these rows
    }
    c = cn;
  }
}

template <int kW, bool kHi, typename Out>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
matmul_reconstruct_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b,
                          const __grid_constant__ Args<Out> p,
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
    rec_tile<kW, kHi>(p, *W, P.T, sc, tm, tn, counter, at);
    // every chunk is reconstructed: the next tile may overwrite the
    // residues and the limb rows, and the counter starts again
    consumers_sync();
    if (threadIdx.x == 0) *counter = 0;
  }
}

template <int kW, bool kHi, typename Out>
int launch_kernel(const CUtensorMap& ma, const CUtensorMap& mb,
                  const Args<Out>& p, const Consts& P, int nblocks,
                  cudaStream_t s) {
  auto kernel = matmul_reconstruct_kernel<kW, kHi, Out>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  kernel<<<nblocks, gm8::wg::kThreads, kSmem, s>>>(ma, mb, p, P);
  return gm8::launch_status();
}

// the tail's word count: 4 where every sum of residues is below 2^128 (X <
// 256 L M, up to 14 moduli), else 6; moduli past 16 take the second
// contraction
template <typename Out>
int launch(const signed char* a8, const signed char* btp,
           unsigned char* scratch, const int* sa, const int* sb, void* out,
           int L, int m, int n, int kp, int nblocks, const CrtTable& T,
           const gm8::SlotModuli& mods, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a8, L, m, kp, kBM) ||
      !gm8::wg::make_tensor_map(&map_b, btp, L, n, kp, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  Args<Out> p{sa, sb, static_cast<Out*>(out), scratch, L, m, n,
              (kp + kBK - 1) / kBK};
  Consts P;
  std::memset(&P, 0, sizeof(P));
  P.W = gm8::crt_mma_table(T, L);
  P.T = T;
  P.divs = gm8::slot_divisors(mods);
  if (L <= 14) return launch_kernel<4, false>(map_a, map_b, p, P, nblocks, s);
  if (L <= 16) return launch_kernel<6, false>(map_a, map_b, p, P, nblocks, s);
  return launch_kernel<6, true>(map_a, map_b, p, P, nblocks, s);
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0) and a 16-byte aligned start; b8: (L, k, n) int8; bt:
// (L, n, kp) int8 workspace; scratch: (nblocks, L, 128 * 256) uint8
// workspace, nblocks the persistent grid (one block per SM, at most one
// per 128 x 256 tile); sft_a: m int32, sft_b: n int32; out: (m, n) f64
// (out_f32 = 0) or f32 (out_f32 = 1); table: the CrtTable of L moduli, on
// the host. Slice l uses modulus MODULI[l]; k <= 2^17 (checked by the
// caller).
GM8_EXPORT int gm8_matmul_reconstruct(const void* a8, const void* b8,
                                      void* bt, void* scratch,
                                      const void* sft_a, const void* sft_b,
                                      void* out, const void* table, int L,
                                      int m, int n, int k, int kp,
                                      int nblocks, int out_f32,
                                      void* stream) {
  gm8::SlotModuli mods;
  if (kp % 16 != 0 || kp < k || m < 1 || n < 1 || nblocks < 1 || L < 2 ||
      !gm8::slot_moduli(nullptr, L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (kp == 0)  // empty products: every residue and output 0
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(m) * n * (out_f32 ? 4 : 8), s));
  if (reinterpret_cast<uintptr_t>(a8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CrtTable T;
  std::memcpy(&T, table, sizeof(T));
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, n, kp, s);
  auto ap = static_cast<const signed char*>(a8);
  auto sc = static_cast<unsigned char*>(scratch);
  auto sa = static_cast<const int*>(sft_a);
  auto sb = static_cast<const int*>(sft_b);
  if (out_f32)
    return launch<unsigned>(ap, btp, sc, sa, sb, out, L, m, n, kp, nblocks,
                            T, mods, s);
  return launch<unsigned long long>(ap, btp, sc, sa, sb, out, L, m, n, kp,
                                    nblocks, T, mods, s);
}
