// The residue GEMM with integer work injected into its blocks:
// out[l] = (A8[l] @ B8[l]) mod m_l (canonical uint8, matmul_mod.cu's
// kernel), and, per variant, work counted per logical 128 x 128 tile of
// the output (the script's and the plain version's unit; a 128 x 256
// wgmma tile does the work of its two):
//   base     nothing more
//   indep    a chain v = v * 3 + 1, reps times, over a tile-sized int32
//            scratch in shared memory that starts at 0
//   deaddep  the same, seeded with (the tile's (0, 0) product) & 1
//   hbmin    the chain over 2048 streamed int32 rider words of the tile
//   hbmio    the same, the chained words written back
//   recbody  crt.cuh's reconstruct body on 1024 streamed uint8 rider
//            residues of the tile, shifts 0, f64 out
//   recmxu   the same, the CRT sum formed on the tensor cores (crt_mma.cuh)
//   kloop    indep's chain (seeded 0, reps an element), run in registers
//            between the mainloop's k-tiles instead of after it: the
//            port's own variant, with no counterpart in the script
// aux[tile] (the chain variants) is the chain value of the tile's first
// element: each logical tile's own word.
//
// Replaces: the Pallas kernels of scripts/probe_deaddep.py build (:30, its
// calls :160 and :192): the matmul + Barrett structure on grid (l, i, j)
// with (1024, 512) blocks, the chain and the riders injected into each
// grid step.
// Bound on the H100: tensor-core operations (L x 2n^3); the injected
// multiply-adds issue at 64 a clock an SM on the CUDA cores, the riders
// add their bytes.
// Design: the question is whether integer work in the GEMM's own block
// costs its serial time. The GEMM is matmul_mod.cu's kernel on the wgmma
// tile of wgmma_s8.cuh, unchanged, with matmul_mod's launch entry
// (hopper/launch.py): a TMA ring, one producer warp, two consumer
// warpgroups of wgmma.m64n256k32 on a 128 x 256 tile, a persistent grid
// of one block per SM, store_tile's epilogue (the TPU's Barrett is the
// port's exact mod, the same canonical residue). The appended variants
// (indep .. recmxu) run in the two consumer warpgroups after their tile's
// epilogue, while the producer warp already loads the next tile into the
// ring: whether the ring's prefetch hides them is the measurement (the
// earlier mma.sync probe leaned on a second resident block instead). With
// the ring running on, only the epilogue's staging tile (32 KB) is free
// shared memory: indep and deaddep chain a thread's 128 elements (its
// accumulator's count) in four passes through its own 32 words of its
// warpgroup's half of it, hbmin parks its chained words there, recmxu
// stages its digits there. A thread's registers 64 j .. 64 j + 63 hold
// columns 128 j .. 128 j + 127, so its batches 8 j .. 8 j + 7 belong to
// logical tile j; deaddep's two seeds, the (0, 0) products of the two
// logical tiles, are consumer thread 0's registers 0 and 64, passed
// through shared memory. kloop issues the same multiply-adds from the
// consumers between their k-tiles, after a k-tile's wgmmas are committed
// and before they are waited for (wgmma_s8.cuh consume's hook): it asks
// whether the asynchronous tensor cores hide them. The chain is an asm
// volatile mad.lo.s32 on operands passed as kernel parameters, so the
// compiler cannot fold it into one multiply-add; a thread runs 8
// independent chains at a time. The TPU probe's "last block wins" aux is
// replaced by one word a logical tile.
#include <cstring>

#include "common.cuh"
#include "crt.cuh"
#include "crt_mma.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "probe_deaddep.cu takes matmul_mod's launch from hopper/launch.py"
#endif

namespace {

using gm8::kCrtTiles;
using gm8::kWords;
using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a wgmma tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
constexpr int kTile = 128;               // a logical tile's side
constexpr int kLogical = kBN / kTile;    // logical tiles a wgmma tile
constexpr int kConsumers = 256;          // consumer threads a block
constexpr int kElems = kTile * kTile;    // 16384 elements a logical tile
constexpr int kHbmPer = kElems / 8;      // 2048 rider words a tile
constexpr int kRecPer = kElems / 16;     // 1024 rider elements a tile
constexpr int kBatch = 8;                // independent chains a thread
constexpr int kAcc = kBN / 2;            // accumulator registers a thread
constexpr int kBatches = kAcc / kBatch;  // 16 batches a wgmma tile
constexpr int kPassBatches = 4;          // batches a pass of the scratch
constexpr int kHalfWords = kBM * kBN / 8;  // int32 words of a half
constexpr int kDPad = gm8::kCrtDigits + 1;  // a staged D row, padded
constexpr int kBarrier = 3;  // named barrier of the 256 consumer threads
// the ring, the staging tile, the barriers and the two seeds
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages) + 16;
static_assert(kBN == kLogical * kTile && kLogical == 2,
              "a 128 x 256 tile: two logical tiles");
static_assert(kElems * kLogical == kAcc * kConsumers &&
                  kHbmPer == kBatch * kConsumers,
              "a thread's accumulator is its share of both logical tiles");
static_assert(kBatches % kPassBatches == 0 &&
                  kPassBatches * kBatch * 128 == kHalfWords &&
                  kConsumers * kDPad * 4 <= kBM * kBN,
              "the scratch passes and recmxu's digits fit the staging tile");
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

enum Variant {
  kBase, kIndep, kDeadDep, kHbmIn, kHbmIO, kRecBody, kRecMxu, kKLoop,
  kVariants
};

struct Chain {
  int reps, mul, add;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kBarrier), "n"(kConsumers)
               : "memory");
}

__device__ __forceinline__ void chain8(int (&v)[kBatch], const Chain& c) {
#pragma unroll 1
  for (int r = 0; r < c.reps; ++r)
#pragma unroll
    for (int e = 0; e < kBatch; ++e)
      asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                   : "+r"(v[e]) : "r"(c.mul), "r"(c.add));
}

// kloop's chains, run by consume's k-tile hook: a thread's kBatches
// batches of kBatch elements in registers, each starting at 0 and run
// reps rounds. The U = kBatches x reps units (batch-major: a batch's
// rounds in order) are spread over the nk k-tiles, floor((kt + 1) U / nk)
// of them done after k-tile kt: U / nk after each, and one more where the
// remainder's running sum (err, Bresenham's) passes nk, so a k-tile costs
// no division. With 16 dividing nk batch b runs after k-tiles [b nk / 16,
// (b + 1) nk / 16) (n % 2048 == 0); at n = 1024 (nk = 8) two batches
// follow each k-tile. first0, first1: element 0 of batches 0 and 8 once
// their chains are done (consumer thread 0: the first element of logical
// tiles 0 and 1).
struct KLoopChain {
  Chain c;
  int v[kBatch];
  int q = 0, rem = 0, err = 0, round = 0, batch = 0;
  int first0 = 0, first1 = 0;

  __device__ __forceinline__ void operator()(int kt, int nk) {
    if (kt == 0) {
      const int units = kBatches * c.reps;
      q = units / nk;
      rem = units % nk;
    }
    int count = q;
    err += rem;
    if (err >= nk) {
      err -= nk;
      ++count;
    }
#pragma unroll 1
    for (; count > 0; --count) {
      if (round == 0) {
#pragma unroll
        for (int e = 0; e < kBatch; ++e) v[e] = 0;
      }
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                     : "+r"(v[e]) : "r"(c.mul), "r"(c.add));
      if (++round == c.reps) {
        if (batch == 0) first0 = v[0];
        if (batch == kBatches / kLogical) first1 = v[0];
        round = 0;
        ++batch;
      }
    }
  }
};

// the f64 bits of the reconstruction of element e (rider planes of
// `total` elements), from the residues
__device__ __forceinline__ unsigned long long rec_body(
    const unsigned char* rin, size_t total, size_t e, int L,
    const gm8::CrtTable& T) {
  unsigned long long acc[kWords] = {0, 0, 0, 0, 0, 0};
  for (int j = 0; j < L; ++j)
    gm8::crt_add(acc, T, j, rin[static_cast<size_t>(j) * total + e]);
  unsigned x[kWords], mag[kWords];
  gm8::crt_words(acc, x);
  const bool neg = gm8::crt_center(x, T, mag);
  return gm8::crt_round_f64(mag, neg, 0);
}

// the recmxu rider: 1024 elements of a logical tile in 4 chunks of 256;
// each consumer warp contracts 32 elements on the tensor cores and stages
// their digits Y[d] in shared memory (ds), then each consumer thread forms
// one element's limbs and runs the tail
__device__ __forceinline__ void rec_mxu(const unsigned char* rin,
                                        size_t total, size_t e_tile, int L,
                                        const gm8::CrtTable& T,
                                        const gm8::CrtMmaTable& W,
                                        unsigned long long* rout, int* ds) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned bf[kCrtTiles][2];
  gm8::crt_b_frags(W, bf);
  const int nl = W.nd / 2;
  for (int chunk = 0; chunk < kRecPer / kConsumers; ++chunk) {
    const int el = warp * 32 + 4 * g;                // local element
    const size_t e0 = e_tile + chunk * kConsumers + el;
    unsigned w[4], lo[4], hi[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * t + i;
      w[i] = j < L ? __ldg(reinterpret_cast<const unsigned*>(
                         rin + static_cast<size_t>(j) * total + e0)) ^
                         0x80808080u
                   : 0u;
    }
    gm8::transpose4(w, lo);
    if (L > 16) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 16 + 4 * t + i;
        w[i] = j < L ? __ldg(reinterpret_cast<const unsigned*>(
                           rin + static_cast<size_t>(j) * total + e0)) ^
                           0x80808080u
                     : 0u;
      }
      gm8::transpose4(w, hi);
    }
    int d[2][kCrtTiles][4];
    gm8::crt_mma(lo, hi, bf, d);
    // the previous chunk's rows are read (and, for the first, both
    // warpgroups' epilogues are done with the staging tile)
    consumers_sync();
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < kCrtTiles; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[(el + 2 * p + (r >> 1)) * kDPad + 8 * q + 2 * t + (r & 1)] =
              d[p][q][r];
    consumers_sync();
    const int* y = ds + threadIdx.x * kDPad;
    const int sum_s = y[W.nd] * 32896;
    unsigned long long acc[kWords] = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int l = 0; l < 2 * kWords; ++l)
      if (l < nl)
        gm8::crt_add_limb(acc, l, static_cast<unsigned>(
            y[2 * l] + y[2 * l + 1] * 256 + sum_s + W.cl[l]));
    unsigned x[kWords], mag[kWords];
    gm8::crt_words(acc, x);
    const bool neg = gm8::crt_center(x, T, mag);
    rout[e_tile + chunk * kConsumers + threadIdx.x] =
        gm8::crt_round_f64(mag, neg, 0);
  }
}

// the launch's arguments besides the tensor maps
struct Args {
  unsigned char* out;
  const void* rin;
  int* rout_i32;
  int* aux;
  unsigned long long* rout_f64;
  long long* stamps;
  int L, n;
  Chain ch;
};

// The appended work of one wgmma tile, whose first logical tile is tile0
// (its second tile0 + 1), by the 256 consumer threads; stg: the staging
// tile, free once the tile's epilogue is stored; seeds: deaddep's two.
template <int kVar>
__device__ __forceinline__ void appended(const Args& p, size_t tile0,
                                         unsigned char* stg, const int* seeds,
                                         const gm8::CrtTable& T,
                                         const gm8::CrtMmaTable& W) {
  const int tid = threadIdx.x;             // 0 .. 255
  const int half = tid >> 7, lt = tid & 127;
  // this thread's words of its warpgroup's half: batch bb of a pass,
  // element e at word bb * 1024 + e * 128 + lt
  int* own = reinterpret_cast<int*>(stg) + half * kHalfWords + lt;
  if constexpr (kVar == kDeadDep)
    consumers_sync();  // thread 0 has stored the seeds; the epilogues'
                       // reads of the staging tile are done
  else if constexpr (kVar == kIndep || kVar == kHbmIn)
    gm8::wg::warpgroup_sync(1 + half);  // this half's epilogue reads are
                                        // done
  if constexpr (kVar == kIndep || kVar == kDeadDep) {
    const int seed0 = kVar == kDeadDep ? seeds[0] : 0;
    const int seed1 = kVar == kDeadDep ? seeds[1] : 0;
#pragma unroll 1
    for (int pass = 0; pass < kBatches / kPassBatches; ++pass) {
#pragma unroll
      for (int i = 0; i < kPassBatches * kBatch; ++i) own[i * 128] = 0;
#pragma unroll 1
      for (int bb = 0; bb < kPassBatches; ++bb) {
        const int b = pass * kPassBatches + bb;
        const int j = b / (kBatches / kLogical);  // its logical tile
        const int seed = j ? seed1 : seed0;
        int v[kBatch];
#pragma unroll
        for (int e = 0; e < kBatch; ++e)
          v[e] = own[(bb * kBatch + e) * 128] + seed;
        chain8(v, p.ch);
#pragma unroll
        for (int e = 0; e < kBatch; ++e) own[(bb * kBatch + e) * 128] = v[e];
        if (tid == 0 && b % (kBatches / kLogical) == 0)
          p.aux[tile0 + j] = v[0];
      }
    }
  } else if constexpr (kVar == kHbmIn || kVar == kHbmIO) {
#pragma unroll 1
    for (int j = 0; j < kLogical; ++j) {
      const size_t base = (tile0 + j) * kHbmPer;
      const int* r = static_cast<const int*>(p.rin) + base;
      int v[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) v[e] = r[tid + e * kConsumers];
      chain8(v, p.ch);
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        if constexpr (kVar == kHbmIO)
          p.rout_i32[base + tid + e * kConsumers] = v[e];
        else
          own[(j * kBatch + e) * 128] = v[e];  // no device-memory write
      }
      if (tid == 0) p.aux[tile0 + j] = v[0];
    }
  } else if constexpr (kVar == kRecBody) {
    const auto* r = static_cast<const unsigned char*>(p.rin);
    const size_t tiles = static_cast<size_t>(p.L) * (p.n / kTile) *
                         (p.n / kTile);
#pragma unroll 1
    for (int j = 0; j < kLogical; ++j)
      for (int i = tid; i < kRecPer; i += kConsumers) {
        const size_t e = (tile0 + j) * kRecPer + i;
        p.rout_f64[e] = rec_body(r, tiles * kRecPer, e, p.L, T);
      }
  } else if constexpr (kVar == kRecMxu) {
    const size_t tiles = static_cast<size_t>(p.L) * (p.n / kTile) *
                         (p.n / kTile);
#pragma unroll 1
    for (int j = 0; j < kLogical; ++j)
      rec_mxu(static_cast<const unsigned char*>(p.rin), tiles * kRecPer,
              (tile0 + j) * kRecPer, p.L, T, W, p.rout_f64,
              reinterpret_cast<int*>(stg));
    consumers_sync();  // every digit row is read before the next epilogue
  }
}

// stamps (when not null): per logical tile, the SM of the block that ran
// its wgmma tile and the SM's clock64() when the consumers began it and
// after both consumer warpgroups were done with it (its appended work
// included), in SM clock cycles: a measure of the work that the SM
// clock's swings at the power cap leave alone
template <int kVar>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
deaddep_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ Args p,
               const __grid_constant__ gm8::SlotDivisors divs,
               const __grid_constant__ gm8::CrtTable T,
               const __grid_constant__ gm8::CrtMmaTable W) {
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
  int* seeds = reinterpret_cast<int*>(stg + kBM * kBN + 16 * kStages);
  const gm8::wg::TileWalk walk(p.L, p.n, p.n, kBN, kGroup);
  const int nk = p.n / kBK;
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
    return;
  }
  // consumer warpgroups 0 and 1: rows 64 * role .. + 63
  gm8::wg::setmaxnreg_inc<232>();
  const int tiles_side = p.n / kTile;
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
    int l, tm, tn;
    walk.at(t, l, tm, tn);
    const long long t0 = p.stamps && threadIdx.x == 0 ? clock64() : 0;
    // defined each tile, so that the accumulator is dead outside the
    // mainloop and the epilogue (an undefined one stays live through the
    // wgmma asm and spills all beside it)
    int acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0;
    if constexpr (kVar == kKLoop) {
      KLoopChain kc{p.ch};
      gm8::wg::consume<kBN>(acc, ring, role, nk, stage, phase, kc);
      if (threadIdx.x == 0) {
        const size_t tile0 =
            (static_cast<size_t>(l) * tiles_side + tm) * tiles_side +
            kLogical * tn;
        p.aux[tile0] = kc.first0;
        p.aux[tile0 + 1] = kc.first1;
      }
    } else {
      gm8::wg::consume<kBN>(acc, ring, role, nk, stage, phase);
    }
    if constexpr (kVar == kDeadDep) {
      // each logical tile's (0, 0) product: (row 0, column 128 j)
      if (threadIdx.x == 0) {
        seeds[0] = acc[0] & 1;
        seeds[1] = acc[kAcc / kLogical] & 1;
      }
    }
    const gm8::ModDivisor dv = divs.v[l];
    unsigned char* ol = p.out + static_cast<size_t>(l) * p.n * p.n;
    if (dv.d == 256)
      gm8::wg::store_tile<kBN, true>(acc, stg, ol, p.n, p.n, tm * kBM,
                                     tn * kBN, p.n, role, dv, 0u);
    else
      gm8::wg::store_tile<kBN, false>(acc, stg, ol, p.n, p.n, tm * kBM,
                                      tn * kBN, p.n, role, dv, 0u);
    const size_t tile0 =
        (static_cast<size_t>(l) * tiles_side + tm) * tiles_side +
        kLogical * tn;
    if constexpr (kVar != kBase && kVar != kKLoop)
      appended<kVar>(p, tile0, stg, seeds, T, W);
    if (p.stamps) {
      consumers_sync();
      if (threadIdx.x == 0) {
        unsigned sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        const long long t1 = clock64();
#pragma unroll
        for (int j = 0; j < kLogical; ++j) {
          long long* st = p.stamps + 3 * (tile0 + j);
          st[0] = sm;
          st[1] = t0;
          st[2] = t1;
        }
      }
    }
  }
}

template <int kVar>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
           const Args& p, const gm8::SlotDivisors& divs,
           const gm8::CrtTable& T, const gm8::CrtMmaTable& W,
           cudaStream_t s) {
  cudaFuncSetAttribute(deaddep_kernel<kVar>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const int grid = gm8::wg::persistent_grid(
      static_cast<long long>(p.L) * (p.n / kBM) * (p.n / kBN));
  deaddep_kernel<kVar><<<grid, gm8::wg::kThreads, kSmem, s>>>(
      map_a, map_b, p, divs, T, W);
  return gm8::launch_status();
}

}  // namespace

// a8, b8: (L, n, n) int8, n % 1024 == 0 (the script's grid), a8 16-byte
// aligned; bt: (L, n, n) int8 workspace (B copied K-major); out: (L, n, n)
// uint8; rin: the variant's rider (hbm: tiles x 2048 int32 words; rec: L
// planes of tiles x 1024 uint8 residues), tiles = L (n / 128)^2 logical
// tiles, tile (l, i, j) at (l n / 128 + i) n / 128 + j; rout: hbmio's
// int32 output (as rin); aux: tiles int32 (the chain variants); rec_out:
// tiles x 1024 f64 (the rec variants); crt_table, mma_table: the CrtTable
// and CrtMmaTable of L, on the host; variant: index into
// probes/deaddep.py VARIANTS; reps: nops / 2 multiply-adds an element;
// stamps: null, or tiles x 3 int64 (deaddep_kernel).
GM8_EXPORT int gm8_probe_deaddep(const void* a8, const void* b8, void* bt,
                                 void* out, const void* rin, void* rout,
                                 void* aux, void* rec_out,
                                 const void* crt_table,
                                 const void* mma_table, int L, int n,
                                 int variant, int reps, void* stamps,
                                 void* stream) {
  gm8::SlotModuli mods;
  const bool hbm = variant == kHbmIn || variant == kHbmIO;
  const bool rec = variant == kRecBody || variant == kRecMxu;
  const bool chain =
      (variant >= kIndep && variant <= kHbmIO) || variant == kKLoop;
  if (n < 1024 || n % 1024 || variant < 0 || variant >= kVariants ||
      reps < 0 || !gm8::slot_moduli(nullptr, L, &mods) ||
      reinterpret_cast<uintptr_t>(a8) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0 ||
      ((hbm || rec) && !rin) || (variant == kHbmIO && !rout) ||
      (chain && !aux) || (rec && !rec_out))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  std::memcpy(&T, crt_table, sizeof(T));
  gm8::CrtMmaTable W;
  std::memcpy(&W, mma_table, sizeof(W));
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, n, n, n, s);
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(&map_a, a8, L, n, n, kBM) ||
      !gm8::wg::make_tensor_map(&map_b, btp, L, n, n, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.out = static_cast<unsigned char*>(out);
  p.rin = rin;
  p.rout_i32 = static_cast<int*>(rout);
  p.aux = static_cast<int*>(aux);
  p.rout_f64 = static_cast<unsigned long long*>(rec_out);
  p.stamps = static_cast<long long*>(stamps);
  p.L = L;
  p.n = n;
  p.ch = Chain{reps, 3, 1};
  const gm8::SlotDivisors divs = gm8::slot_divisors(mods);
  switch (variant) {
#define GM8_DEADDEP_CASE(V) \
  case V:                   \
    return launch<V>(map_a, map_b, p, divs, T, W, s);
    GM8_DEADDEP_CASE(kBase)
    GM8_DEADDEP_CASE(kIndep)
    GM8_DEADDEP_CASE(kDeadDep)
    GM8_DEADDEP_CASE(kHbmIn)
    GM8_DEADDEP_CASE(kHbmIO)
    GM8_DEADDEP_CASE(kRecBody)
    GM8_DEADDEP_CASE(kRecMxu)
    GM8_DEADDEP_CASE(kKLoop)
#undef GM8_DEADDEP_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
