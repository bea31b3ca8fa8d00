// Batched int8 GEMM with the modular reduction of one tile run beside the
// product of the next: out[l] = (A8[l] @ B8[l]) mod m_l as canonical uint8,
// the function of matmul_mod.cu with centered = false, in another schedule.
//
// Replaces: matmul_mod_u8_pipelined, gemmul8_tpu/pallas/matmul.py:188.
// Bound on the H100: tensor-core operations, as matmul_mod.cu (8192^3 at 14
// moduli: 1.54e13 int8 operations, 7.78 ms at 1,979 TOPS).
// Design: the TPU kernel reduced tile j-1 from one accumulator while its
// matrix unit filled the other with tile j. The Hopper form of that is the
// ping-pong schedule on the wgmma tile of wgmma_s8.cuh. B is read K-major
// in place where its encode wrote it so, else first copied K-major
// (transpose_b.cuh), as for matmul_mod.cu; TMA fills a ring of
// stages from 3-D tensor maps, one producer warp keeps the loads in flight
// across tiles, and a persistent grid walks the tiles. Where matmul_mod.cu's
// two consumer warpgroups share each 128 x 256 tile (the cooperative
// schedule: the tensor cores idle while both run the epilogue), here each
// consumer warpgroup owns whole 128 x 128 tiles: a block's tiles alternate
// between warpgroup 0 (its even tiles) and warpgroup 1 (its odd ones). Two
// named barriers pass the turn to issue wgmmas back and forth, so
// warpgroup 0 issues tile j's mainloop while warpgroup 1 reduces and
// stores tile j-1, then they swap: one warpgroup's epilogue always runs
// beside the other's products. A warpgroup's tile is two 64 x 128
// accumulators (two wgmma.m64n128k32 chains sharing each B stage), 128
// registers a thread, as the cooperative tile's 64 x 256.
// A 128 x 128 tile alone reads 1.33x the operand bytes per product of the
// 128 x 256 one from L2 (a 64 x 256 tile would read 1.67x), and L2 set
// this tile's pace: so the blocks run in clusters of two along m, the two
// blocks of a cluster walking the same sequence of tile pairs (rows 2 i
// and 2 i + 1 of one column of tiles), each loading its own A rows and
// half of the pair's shared B tile, multicast by TMA into both blocks'
// stages. Per product a block then reads the cooperative tile's bytes. A
// stage may be refilled once both blocks' consumers are done with it: the
// empty barriers count the consumer warps of both, and the producer waits
// for the last of them before its block exits.
// Each warpgroup stages its residues in its own 128 x 128 bytes of shared
// memory (wgmma_s8.cuh stage_frag, write_rows: 16-byte stores), reduced as
// in matmul_mod.cu by a per-slot multiplier and shift (moduli.cuh
// mod_div), the 256 lane as x & 255. The accumulators are the hardware's
// wrapping int32: the modulus-256 lane can reach 128 * 128 * 2^17 = 2^31,
// which wraps to a multiple of 256, so its residue stays right; the odd
// lanes stay below 127^2 * 2^17 < 2^31. Any k <= 2^17 is taken (the TPU
// kernel's k <= bk limit came from its launch table). The tile width, the
// ring's depth and the raster group are compile-time constants from the
// launch table (hopper/launch.py "matmul_mod_pipelined", passed to nvcc by
// hopper/build.py).
#include "common.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_mod_pipelined.cu takes its launch from hopper/launch.py"
#endif

namespace {

using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kWgWarps = 4;             // warps of a consumer warpgroup
constexpr int kCluster = 2;             // blocks of a cluster, along m
constexpr int kHalfB = kBN / kCluster;  // B rows (columns of out) a block
                                        // loads for both
constexpr int kStgBytes = kBM * kBN;    // a warpgroup's staging tile
// the 1024-byte alignment slack, the ring, two staging tiles, the barriers
constexpr int kSmem = 1024 + kStages * gm8::wg::stage_bytes(kBN) +
                      2 * kStgBytes + 16 * kStages;
// named barriers: 1 and 2 order each warpgroup's staging tile
// (write_rows), 3 + w passes warpgroup w the turn to issue its mainloop
constexpr int kTurnBarrier = 3;
static_assert(kBN == 128, "a ping-pong warpgroup's tile is 128 x 128: two "
              "wgmma.m64n128k32 chains of 64 registers");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

// bar.sync / bar.arrive over the 256 threads of both consumer warpgroups
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// a stage's release by one consumer warp (its leader): an arrival on the
// stage's empty barrier in each block of the cluster
__device__ __forceinline__ void release(unsigned empty) {
  if ((threadIdx.x & 31) == 0)
    for (unsigned c = 0; c < kCluster; ++c)
      gm8::wg::mbar_arrive_cluster(empty, c);
}

// the pair walk: tile pair T of the cluster's sequence is column tn of
// pair row tp of slice l; this block takes m-tile 2 tp + rank (the last
// m-tile again where the pair row has one; it loads those A rows, so
// that its half of B still reaches its peer, and stores nothing)
struct PairWalk {
  gm8::wg::TileWalk pairs;  // over tile pairs (rows of 2 kBM)
  int tiles_m;

  __device__ __forceinline__ PairWalk(int L, int m, int n)
      : pairs(L, ((m + kBM - 1) / kBM + 1) / 2 * kBM, n, kBN,
              kGroup / kCluster > 0 ? kGroup / kCluster : 1),
        tiles_m((m + kBM - 1) / kBM) {}

  // (l, m-tile, n-tile) of pair T for the block of this rank
  __device__ __forceinline__ void at(int T, unsigned rank, int& l, int& tm,
                                     int& tn) const {
    int tp;
    pairs.at(T, l, tp, tn);
    tm = kCluster * tp + static_cast<int>(rank);
  }
};

// the producer thread: every pair of this cluster, every k-tile, in order;
// then a wait for the release of every stage it filled, by both blocks
__device__ __forceinline__ void produce_pairs(const CUtensorMap& ma,
                                              const CUtensorMap& mb,
                                              const gm8::wg::Ring& ring,
                                              const PairWalk& walk, int nk,
                                              unsigned rank, int cid,
                                              int clusters) {
  // a stage: A's rows and both halves of B, this block's and the peer's
  const unsigned bytes = gm8::wg::stage_bytes(kBN);
  int stage = 0;
  unsigned phase = 0;
  const auto next = [&] {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (int T = cid; T < walk.pairs.total; T += clusters) {
    int l, tm, tn;
    walk.at(T, rank, l, tm, tn);
    tm = min(tm, walk.tiles_m - 1);
    for (int kt = 0; kt < nk; ++kt) {
      gm8::wg::mbar_wait(ring.empty + 8 * stage, phase ^ 1);
      const unsigned full = ring.full + 8 * stage;
      gm8::wg::mbar_expect_tx(full, bytes);
      gm8::wg::tma_load(ring.a(stage), ma, full, kt * kBK, tm * kBM, l);
      gm8::wg::tma_load_multicast(ring.b(stage) + rank * kHalfB * kBK, mb,
                                  full, kt * kBK,
                                  tn * kBN + static_cast<int>(rank) * kHalfB,
                                  l, (1u << kCluster) - 1);
      next();
    }
  }
  // the peer's consumers arrive here until their last stage: this block
  // may exit only once every stage it filled is released
  for (int s = 0; s < kStages; ++s) {
    gm8::wg::mbar_wait(ring.empty + 8 * stage, phase ^ 1);
    next();
  }
}

// one warpgroup's products of its tile's nk k-tiles, from ring step
// `step` on: acc0 += A rows 0-63 x B^T, acc1 += A rows 64-127 x B^T. The
// last k-tile's wgmmas are left in flight; finish() waits for them.
__device__ __forceinline__ void mainloop(int (&acc0)[kBN / 2],
                                         int (&acc1)[kBN / 2],
                                         const gm8::wg::Ring& ring, int nk,
                                         long long step, int& last) {
  int stage = static_cast<int>(step % kStages);
  unsigned phase = static_cast<unsigned>((step / kStages) & 1);
  gm8::wg::fence_regs(acc0);
  gm8::wg::fence_regs(acc1);
  for (int kt = 0; kt < nk; ++kt) {
    gm8::wg::mbar_wait(ring.full + 8 * stage, phase);
    const uint64_t da0 = gm8::wg::desc_sw128(ring.a(stage));
    const uint64_t da1 = gm8::wg::desc_sw128(ring.a(stage) + 64 * kBK);
    const uint64_t db = gm8::wg::desc_sw128(ring.b(stage));
    gm8::wg::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      gm8::wg::wgmma_s8<kBN>(acc0, da0 + 2 * ks, db + 2 * ks, 1);
      gm8::wg::wgmma_s8<kBN>(acc1, da1 + 2 * ks, db + 2 * ks, 1);
    }
    gm8::wg::wgmma_commit();
    if (kt > 0) {  // the previous k-tile's wgmmas are done with its stage
      gm8::wg::wgmma_wait<1>();
      release(ring.empty + 8 * last);
    }
    last = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

__device__ __forceinline__ void finish(int (&acc0)[kBN / 2],
                                       int (&acc1)[kBN / 2],
                                       const gm8::wg::Ring& ring, int last) {
  gm8::wg::wgmma_wait<0>();
  release(ring.empty + 8 * last);
  gm8::wg::fence_regs(acc0);
  gm8::wg::fence_regs(acc1);
}

// warpgroup wg's 128 x 128 tile as canonical residues: into its staging
// tile, then out (rows past m, columns past n not stored)
template <bool kPow2>
__device__ __forceinline__ void store(const int (&acc0)[kBN / 2],
                                      const int (&acc1)[kBN / 2],
                                      unsigned char* stg,
                                      unsigned char* __restrict__ out, int m,
                                      int n, int row0, int col0, int wg,
                                      const gm8::ModDivisor& dv) {
  const auto pair = [&](int x0, int x1) {
    return gm8::wg::residue_byte<kPow2>(x0, dv) |
           (gm8::wg::residue_byte<kPow2>(x1, dv) << 8);
  };
  gm8::wg::warpgroup_sync(1 + wg);  // the last tile's reads are done
  gm8::wg::stage_frag<kBN>(acc0, stg, 0, pair);
  gm8::wg::stage_frag<kBN>(acc1, stg, 64, pair);
  gm8::wg::warpgroup_sync(1 + wg);  // the tile is staged
  gm8::wg::write_rows<kBN, kBM>(stg, out, n, m, row0, col0, n, 0);
}

__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
matmul_mod_pipelined_kernel(const __grid_constant__ CUtensorMap map_a,
                            const __grid_constant__ CUtensorMap map_b,
                            unsigned char* __restrict__ out, int L, int m,
                            int n, int kp,
                            const __grid_constant__ gm8::SlotDivisors divs) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = gm8::wg::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  gm8::wg::Ring ring;
  ring.base = gm8::wg::smem_u32(smem);
  ring.stages = kStages;
  ring.bn = kBN;
  unsigned char* stg = smem + kStages * gm8::wg::stage_bytes(kBN);
  ring.full = gm8::wg::smem_u32(stg + 2 * kStgBytes);
  ring.empty = ring.full + 8 * kStages;
  const PairWalk walk(L, m, n);
  const int nk = (kp + kBK - 1) / kBK;
  const unsigned rank = gm8::wg::cluster_rank();
  const int cid = blockIdx.x / kCluster, clusters = gridDim.x / kCluster;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gm8::wg::mbar_init(ring.full + 8 * s, 1);
      // a stage is read by one warpgroup of each block of the cluster
      gm8::wg::mbar_init(ring.empty + 8 * s, kWgWarps * kCluster);
    }
    gm8::wg::mbar_init_fence();
  }
  // the peer's barriers are set up before any multicast or remote arrival
  gm8::wg::cluster_sync();
  const int role = threadIdx.x / 128;
  if (role == 2) {  // producer warpgroup: one thread issues the loads
    gm8::wg::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      gm8::wg::tma_prefetch(map_a);
      gm8::wg::tma_prefetch(map_b);
      produce_pairs(map_a, map_b, ring, walk, nk, rank, cid, clusters);
    }
  } else {  // consumer warpgroup `role`: the cluster's pairs j = role, +2, ..
    gm8::wg::setmaxnreg_inc<232>();
    unsigned char* my_stg = stg + role * kStgBytes;
    int acc0[kBN / 2], acc1[kBN / 2];
    int j = role;
    for (int T = cid + role * clusters; T < walk.pairs.total;
         T += 2 * clusters, j += 2) {
      int l, tm, tn;
      walk.at(T, rank, l, tm, tn);
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        acc0[i] = 0;
        acc1[i] = 0;
      }
      // pair j - 1 is the other warpgroup's: it passes the turn once its
      // mainloop is issued
      if (j > 0) turn_wait(kTurnBarrier + role);
      int last = 0;
      mainloop(acc0, acc1, ring, nk, static_cast<long long>(j) * nk, last);
      // pair j + 1, if the cluster has one, is the other warpgroup's
      if (T + clusters < walk.pairs.total)
        turn_pass(kTurnBarrier + 1 - role);
      finish(acc0, acc1, ring, last);
      if (tm >= walk.tiles_m) continue;  // the peer's pair row alone
      const gm8::ModDivisor dv = divs.v[l];
      unsigned char* ol = out + static_cast<size_t>(l) * m * n;
      if (dv.d == 256)
        store<true>(acc0, acc1, my_stg, ol, m, n, tm * kBM, tn * kBN, role,
                    dv);
      else
        store<false>(acc0, acc1, my_stg, ol, m, n, tm * kBM, tn * kBN, role,
                     dv);
    }
  }
}

}  // namespace

// a8: (L, m, kp) int8 with kp % 16 == 0 (zero-padded past k by the caller
// when k % 16 != 0) and a 16-byte aligned start; b8: (L, k, n) int8; bt:
// (L, n, kp) int8 workspace; out: (L, m, n) uint8 canonical residues.
// Slice l uses modulus MODULI[moduli_idx[l]] (moduli_idx: L ints on the
// host, or null for 0..L-1); k <= 2^17 (checked by the caller). bt null:
// b8 is B itself, K-major (matmul_mod.cu's form), read in place.
GM8_EXPORT int gm8_matmul_mod_u8_pipelined(const void* a8, const void* b8,
                                           void* bt, void* out,
                                           const void* moduli_idx, int L,
                                           int m, int n, int k, int kp,
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
    return static_cast<int>(
        cudaMemsetAsync(outp, 0, static_cast<size_t>(L) * m * n, s));
  auto btp = static_cast<const signed char*>(b8);
  if (bt) {
    gm8::transpose_b(btp, static_cast<signed char*>(bt), L, k, n, kp, s);
    btp = static_cast<const signed char*>(bt);
  }
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a8, L, m, kp, kBM) ||
      !gm8::wg::make_tensor_map(&map_b, btp, L, n, kp, kHalfB))
    return static_cast<int>(cudaErrorInvalidValue);
  // one cluster per kCluster SMs, no more than there are tile pairs
  const long long pairs = static_cast<long long>(L) *
                          (((m + kBM - 1) / kBM + 1) / 2) *
                          ((n + kBN - 1) / kBN);
  const int grid =
      gm8::wg::persistent_grid(pairs * kCluster) / kCluster * kCluster;
  cudaFuncSetAttribute(matmul_mod_pipelined_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(gm8::wg::kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const gm8::SlotDivisors divs = gm8::slot_divisors(mods);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, matmul_mod_pipelined_kernel, map_a, map_b, outp, L, m, n, kp,
      divs);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
