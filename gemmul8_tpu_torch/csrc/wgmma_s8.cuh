// The Hopper int8 GEMM tile (sm_90a): TMA loads into a ring of
// shared-memory stages, one producer warp, two consumer warpgroups running
// wgmma s8 x s8 -> s32, walked by a persistent grid; the residue epilogue
// (store_tile, built from stage_frag and write_rows) and the host's tensor
// maps (make_tensor_map). Its callers: matmul_mod.cu (the one-shot GEMM),
// matmul_rider.cu (the panel pipeline's GEMM, with rider work between
// tiles), matmul_complex.cu (the complex GEMM, products chained in one
// accumulator), matmul_mod_pipelined.cu (a ping-pong schedule: each
// consumer warpgroup owns whole 128 x 128 tiles, wgmma.m64n128k32),
// matmul_reconstruct.cu (the L products of a tile, their residues parked
// in device memory and reconstructed after its last product), matmul_crt.cu
// (the same walk, the CRT sums stored as canonical limbs), magmax.cu (one
// slice, a row and column max epilogue on the fragment) and
// probe_deaddep.cu (matmul_mod.cu's kernel with integer work injected,
// its kloop variant through consume's k-tile hook). It is the port's only
// int8 GEMM tile.
//
// Operands: A (L, m, kp) and Bt (L, n, kp) int8, both K-major (wgmma takes
// 8-bit operands K-major only), kp % 16 == 0, each read through a 3-D
// tensor map (kp, rows, L) with a 128-byte box along k and the 128-byte
// swizzle (make_tensor_map; a map may cover a window of rows of a larger
// operand, with its own row and slice strides). Rows past the map's rows
// and bytes past kp land in shared memory as zeros, so no load is masked
// and a tile never reads the next slice's rows or past its window. A stage holds a 128 x 128-byte A tile and a BN x
// 128-byte B tile, each at a 1024-byte boundary, as the swizzle and the
// wgmma descriptors (base offset 0) want.
//
// Block (kThreads = 384): warpgroups 0 and 1 consume, each the 64-row half
// of a 128 x BN output tile (BN = 256, matmul_mod.cu's kBN): per 128-byte
// k-tile four wgmma.m64n256k32 on shared-memory descriptors. Warpgroup 2 gives up its
// registers (setmaxnreg) and its first thread issues the loads. Per stage
// a full barrier (one arrival carrying the stage's byte count, then the
// loads' bytes; a box partly out of bounds still counts whole) and an
// empty barrier (one arrival from each of the 8 consumer warps once their
// wgmmas have read the stage). The ring runs on across tiles, so the
// producer loads the next tile while the consumers run the epilogue.
//
// Accumulator fragment (CUTLASS's CLayout_64xN, cute/atom/
// mma_traits_sm90_gmma.hpp): register v = v0 + 2 v1 + 4 v2 of thread
// (warp w of its warpgroup, lane) holds row 16 w + lane / 4 + 8 v1 and
// column 8 v2 + 2 (lane % 4) + v0 of the warpgroup's 64 x BN half.
//
// The accumulator wraps as int32 (no .satfinite), as mma.sync's does: the
// modulus-256 lane may reach 128 * 128 * 2^17 = 2^31 and stays right mod
// 256.
#pragma once

#include <cuda.h>

#include "common.cuh"
#include "moduli.cuh"

namespace gm8 {
namespace wg {

constexpr int kThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kBM = 128;           // output rows of a tile
constexpr int kBK = 128;           // k bytes of a stage
constexpr int kConsumerWarps = 8;
constexpr unsigned kSpinLimit = 1u << 28;  // a stuck pipeline traps

// dynamic shared memory of a block: the 1024-byte alignment slack, the
// ring, the epilogue's staging tile (kBM x bn bytes) and the barriers
__host__ __device__ constexpr int stage_bytes(int bn) {
  return (kBM + bn) * kBK;
}
__host__ __device__ constexpr int smem_bytes(int bn, int stages) {
  return 1024 + stages * stage_bytes(bn) + kBM * bn + 16 * stages;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned spins = 0;
  while (true) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (++spins == kSpinLimit) __trap();
  }
}

// ---- TMA -----------------------------------------------------------------
__device__ __forceinline__ void tma_prefetch(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(&map)) : "memory");
}

// box at (k0, row0, l) of a (kp, rows, L) map into shared memory at dst
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap& map,
                                         unsigned bar, int k0, int row0,
                                         int l) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar),
         "r"(k0), "r"(row0), "r"(l)
      : "memory");
}

// the box at (k0, row0, l) into shared memory at dst in every CTA of the
// cluster named in cta_mask, each signalling its own barrier at `bar`
// (dst and bar: this CTA's addresses, the same offsets in every CTA)
__device__ __forceinline__ void tma_load_multicast(unsigned dst,
                                                   const CUtensorMap& map,
                                                   unsigned bar, int k0,
                                                   int row0, int l,
                                                   unsigned short cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar),
         "r"(k0), "r"(row0), "r"(l), "h"(cta_mask)
      : "memory");
}

// ---- clusters ------------------------------------------------------------
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// one arrival on the barrier at this CTA's address `bar` in CTA `cta` of
// the cluster
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar,
                                                    unsigned cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n"
      :: "r"(bar), "r"(cta) : "memory");
}

// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---- wgmma ---------------------------------------------------------------
// K-major operand tile with the 128-byte swizzle at shared address `addr`
// (1024-byte aligned): start address >> 4 in bits 0-13, leading byte
// offset 1 (unused by the swizzled K-major form, as CUTLASS sets it),
// stride byte offset 1024 >> 4 (8 rows of 128 bytes) in bits 32-45,
// base offset 0, layout B128 (1) in bits 62-63. One k32 step further along
// the 128-byte row is 32 bytes: +2 on the descriptor.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of r across this point
// (the wgmmas write the accumulator asynchronously)
template <int R>
__device__ __forceinline__ void fence_regs(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d = (scale_d ? d : 0) + A (64 x 32, K-major) x B (N x 32, K-major)^T;
// N = 256 (one warpgroup's half of the cooperative tile) or 128 (one of
// the two 64-row halves of a ping-pong warpgroup's 128 x 128 tile)
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
      "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
      "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
      "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
      "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
      "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
      "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
      "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
      "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
      "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
      "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
      "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
      "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
      "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
      "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
      "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
      "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
      "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
      "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
      "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
      "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
      "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
      "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
      "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
      "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
      "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
      "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- warp roles ----------------------------------------------------------
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// barrier `id` (1..15) over the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// ---- the persistent grid's walk ------------------------------------------
// Tile t of L * tiles_m * tiles_n: slice l = t / (tiles_m * tiles_n), then,
// within the slice, groups of `group` m-tiles walked column by column, so
// that the tiles in flight at one time share few A rows and B columns.
struct TileWalk {
  int tiles_m, tiles_n, per_l, total, group;

  __device__ __forceinline__ TileWalk(int L, int m, int n, int bn, int g)
      : tiles_m((m + kBM - 1) / kBM), tiles_n((n + bn - 1) / bn),
        per_l(tiles_m * tiles_n), total(L * tiles_m * tiles_n), group(g) {}

  __device__ __forceinline__ void at(int t, int& l, int& tm, int& tn) const {
    l = t / per_l;
    const int r = t - l * per_l;
    const int span = group * tiles_n;
    const int g = r / span, w = r - g * span;
    const int rows = min(group, tiles_m - g * group);
    tm = g * group + w % rows;
    tn = w / rows;
  }
};

// shared-memory addresses of a block's ring and barriers
struct Ring {
  unsigned base;   // stage 0 (1024-byte aligned)
  unsigned full;   // full barrier of stage 0; stage s at + 8 s
  unsigned empty;  // empty barrier of stage 0
  int stages, bn;

  __device__ __forceinline__ unsigned a(int s) const {
    return base + s * stage_bytes(bn);
  }
  __device__ __forceinline__ unsigned b(int s) const {
    return a(s) + kBM * kBK;
  }
};

// the producer thread: every tile of this block, every k-tile, in order
__device__ __forceinline__ void produce(const CUtensorMap& ma,
                                        const CUtensorMap& mb,
                                        const Ring& ring, const TileWalk& walk,
                                        int nk) {
  const unsigned bytes = stage_bytes(ring.bn);
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
    int l, tm, tn;
    walk.at(t, l, tm, tn);
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(ring.empty + 8 * stage, phase ^ 1);
      const unsigned full = ring.full + 8 * stage;
      mbar_expect_tx(full, bytes);
      tma_load(ring.a(stage), ma, full, kt * kBK, tm * kBM, l);
      tma_load(ring.b(stage), mb, full, kt * kBK, tn * ring.bn, l);
      if (++stage == ring.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// consume's default k-tile hook: nothing
struct NoHook {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// a consumer warpgroup's product of one tile: acc = its 64-row half of
// A (tile rows) x Bt (tile columns)^T over all nk k-tiles, or with kAccIn
// acc += that product (the complex GEMM chains products in one
// accumulator). hook(kt, nk) runs after k-tile kt's wgmmas are committed
// and before they are waited for, inside their asynchronous window (the
// deaddep probe's kloop chain; a no-op for every other caller).
template <int BN, bool kAccIn = false, typename Hook = NoHook>
__device__ __forceinline__ void consume(int (&acc)[BN / 2], const Ring& ring,
                                        int half, int nk, int& stage,
                                        unsigned& phase,
                                        Hook&& hook = Hook{}) {
  const bool leader = (threadIdx.x & 31) == 0;
  int prev = 0;
  fence_regs(acc);
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(ring.full + 8 * stage, phase);
    const uint64_t da = desc_sw128(ring.a(stage) + half * 64 * kBK);
    const uint64_t db = desc_sw128(ring.b(stage));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      wgmma_s8<BN>(acc, da + 2 * ks, db + 2 * ks,
                   kAccIn || (kt | ks) != 0);
    wgmma_commit();
    hook(kt, nk);
    if (kt > 0) {  // the previous k-tile's wgmmas are done with its stage
      wgmma_wait<1>();
      if (leader) mbar_arrive(ring.empty + 8 * prev);
    }
    prev = stage;
    if (++stage == ring.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  if (leader) mbar_arrive(ring.empty + 8 * prev);
  fence_regs(acc);
}

// ---- the residue epilogue ----------------------------------------------
// staging tile (kBM x BN bytes): row r's 16-byte piece c sits at piece
// c ^ (r & 7), so the fragment's 2-byte writes (8 rows x 4 lanes a warp)
// and the 16-byte reads are free of bank conflicts
template <int BN>
__device__ __forceinline__ int stg_off(int r, int c) {
  return r * BN + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15);
}

// The residue byte of an int32 product: x & 255 for the modulus-256 lane
// (kPow2), else mod_div.
template <bool kPow2>
__device__ __forceinline__ unsigned residue_byte(int x,
                                                 const ModDivisor& dv) {
  if constexpr (kPow2)
    return static_cast<unsigned>(x) & 255u;
  else
    return mod_div(x, dv);
}

// f(r, c, i) for each pair i = 2 v2 + v1 of a 64 x BN accumulator
// fragment (its registers 2 i and 2 i + 1): the row r (from row_base) and
// the columns c, c + 1 (c even) of the tile they hold.
template <int BN, typename F>
__device__ __forceinline__ void for_slots(int row_base, F f) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = row_base + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int v2 = 0; v2 < BN / 8; ++v2)
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) f(r0 + 8 * v1, 8 * v2 + c0, 2 * v2 + v1);
}

// f(x0, x1, r, c, i): for_slots with the pair's two accumulator values
template <int BN, typename F>
__device__ __forceinline__ void for_pairs(const int (&acc)[BN / 2],
                                          int row_base, F f) {
  for_slots<BN>(row_base, [&](int r, int c, int i) {
    f(acc[2 * i], acc[2 * i + 1], r, c, i);
  });
}

// the two bytes of a fragment pair in a staging tile BN bytes wide
template <int BN>
__device__ __forceinline__ unsigned short* stg_pair(unsigned char* stg,
                                                    int r, int c) {
  return reinterpret_cast<unsigned short*>(stg + stg_off<BN>(r, c));
}

// One 64 x BN accumulator fragment into rows row_base .. row_base + 63 of
// a staging tile BN bytes wide: pair(x0, x1) gives the two bytes of each
// fragment pair (two neighbouring columns of one row), low byte first.
template <int BN, typename Pair>
__device__ __forceinline__ void stage_frag(const int (&acc)[BN / 2],
                                           unsigned char* stg, int row_base,
                                           Pair pair) {
  for_pairs<BN>(acc, row_base, [&](int x0, int x1, int r, int c, int) {
    *stg_pair<BN>(stg, r, c) = static_cast<unsigned short>(pair(x0, x1));
  });
}

// Rows row_base .. row_base + ROWS - 1 of a staging tile out by the 128
// threads of a warpgroup, in 16-byte pieces: out is the tile's slice,
// element (row, col) at out[row * ld + col]; the tile's origin (row0,
// col0); rows at or past `rows` and columns at or past col_end are not
// stored. A piece is stored whole where ld and col0 are multiples of 16
// and it ends by col_end, else bytewise.
template <int BN, int ROWS>
__device__ __forceinline__ void write_rows(const unsigned char* stg,
                                           unsigned char* __restrict__ out,
                                           size_t ld, int rows, int row0,
                                           int col0, int col_end,
                                           int row_base) {
  const int tid = threadIdx.x & 127;
  constexpr int kPieces = BN / 16;    // 16-byte pieces a row
  const bool vec = ((ld | static_cast<size_t>(col0)) & 15) == 0;
#pragma unroll
  for (int j = 0; j < ROWS * kPieces / 128; ++j) {
    const int p = tid + 128 * j;
    const int r = row_base + p / kPieces, c = 16 * (p % kPieces);
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= col_end) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stg + stg_off<BN>(r, c));
    unsigned char* dst = out + static_cast<size_t>(row) * ld + col;
    if (vec && col + 16 <= col_end) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b < col_end)
          dst[b] = static_cast<unsigned char>(w[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// One consumer warpgroup's 64-row half of a finished tile of the
// cooperative walk as the bytes pair(x0, x1) gives (stage_frag): into
// its rows of the staging tile, then out (write_rows). The warpgroup's
// named barrier 1 + half orders the staging tile's reuse.
template <int BN, typename Pair>
__device__ __forceinline__ void store_half(const int (&acc)[BN / 2],
                                           unsigned char* stg,
                                           unsigned char* __restrict__ out,
                                           size_t ld, int rows, int row0,
                                           int col0, int col_end, int half,
                                           Pair pair) {
  warpgroup_sync(1 + half);  // the last tile's reads are done
  stage_frag<BN>(acc, stg, half * 64, pair);
  warpgroup_sync(1 + half);  // the half tile is staged
  write_rows<BN, 64>(stg, out, ld, rows, row0, col0, col_end, half * 64);
}

// One consumer warpgroup's 64-row half of a finished tile as residues mod
// dv.d (canonical uint8, or ^ 0x80 with flip 0x8080: int8 r - 128): into
// the staging tile, then out in 16-byte pieces, as store_half with
// residue_byte's bytes would. It is written out rather than built on
// store_half: built on it, matmul_mod.cu's kernel compiles to other
// SASS (the same instructions, other registers and block order), and
// the default path's kernels stay the code PERF.md measured.
template <int BN, bool kPow2>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2],
                                           unsigned char* stg,
                                           unsigned char* __restrict__ out,
                                           size_t ld, int rows, int row0,
                                           int col0, int col_end, int half,
                                           const ModDivisor& dv,
                                           unsigned flip) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  warpgroup_sync(1 + half);  // the last tile's reads are done
  const int r0 = half * 64 + warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int v2 = 0; v2 < BN / 8; ++v2)
#pragma unroll
    for (int v1 = 0; v1 < 2; ++v1) {
      const int x0 = acc[4 * v2 + 2 * v1], x1 = acc[4 * v2 + 2 * v1 + 1];
      unsigned r0b, r1b;
      if constexpr (kPow2) {
        r0b = static_cast<unsigned>(x0) & 255u;
        r1b = static_cast<unsigned>(x1) & 255u;
      } else {
        r0b = mod_div(x0, dv);
        r1b = mod_div(x1, dv);
      }
      const unsigned short pair =
          static_cast<unsigned short>((r0b | (r1b << 8)) ^ flip);
      *reinterpret_cast<unsigned short*>(
          stg + stg_off<BN>(r0 + 8 * v1, 8 * v2 + c0)) = pair;
    }
  warpgroup_sync(1 + half);  // the half tile is staged
  constexpr int kPieces = BN / 16;    // 16-byte pieces a row
  const bool vec = ((ld | static_cast<size_t>(col0)) & 15) == 0;
#pragma unroll
  for (int j = 0; j < 64 * kPieces / 128; ++j) {
    const int p = tid + 128 * j;
    const int r = half * 64 + p / kPieces, c = 16 * (p % kPieces);
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= col_end) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(stg + stg_off<BN>(r, c));
    unsigned char* dst = out + static_cast<size_t>(row) * ld + col;
    if (vec && col + 16 <= col_end) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b < col_end)
          dst[b] = static_cast<unsigned char>(w[b >> 2] >> (8 * (b & 3)));
    }
  }
}

// ---- host: tensor maps ---------------------------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point query (the library links no libcuda of its own)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// rows [0, rows) of each of L K-major int8 slices at ptr (16-byte aligned,
// kp % 16 == 0), row r of slice l at ptr + l * slice + r * ld (ld and slice
// multiples of 16; 0: kp and rows * kp), as a 3-D map (kp, rows, L) with a
// 128-byte x box_rows box and the 128-byte swizzle; elements outside it
// read as zeros
inline bool make_tensor_map(CUtensorMap* map, const void* ptr, int L,
                            int rows, int kp, int box_rows, size_t ld = 0,
                            size_t slice = 0) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (ld == 0) ld = kp;
  if (slice == 0) slice = static_cast<size_t>(rows) * kp;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(L)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld),
                                 static_cast<cuuint64_t>(slice)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the persistent grid: one block per SM, no more than there is work for
inline int persistent_grid(long long items) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(items < sms ? items : sms);
}

}  // namespace wg
}  // namespace gm8
