// The residue GEMM with integer work injected into its blocks:
// out[l] = (A8[l] @ B8[l]) mod m_l (canonical uint8, matmul_mod.cu's tile
// and epilogue), and after each 128 x 128 tile's epilogue, per variant:
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
// element: each tile's own word.
//
// Replaces: the Pallas kernels of scripts/probe_deaddep.py build (:30, its
// calls :160 and :192): the matmul + Barrett structure on grid (l, i, j)
// with (1024, 512) blocks, the chain and the riders injected into each
// grid step.
// Bound on the H100: tensor-core operations (L x 2n^3); the injected
// multiply-adds issue at 64 a clock an SM on the CUDA cores, the riders
// add their bytes.
// Design: the question is whether integer work in the GEMM's own block
// costs its serial time. The TPU ran the chain inside each grid step of
// one core; here a block runs it after its tile's mainloop and epilogue,
// in shared memory (the cp.async ring is free by then: 64 KB of scratch
// in its 96 KB), and the second block on the SM (__launch_bounds__(256,
// 2)) can keep the tensor cores busy meanwhile. The chain is an asm
// volatile mad.lo.s32 on operands passed as kernel parameters, so the
// compiler cannot fold it into one multiply-add; a thread runs 8
// independent chains at a time. The TPU probe's "last block wins" aux is
// replaced by one word a tile. The TPU's Barrett epilogue is the port's
// exact mod (moduli.cuh mod_canon): the same canonical residue. Every
// variant but kloop runs its work after the mainloop, so only the other
// block on the SM can hide it; kloop issues the same multiply-adds from
// the GEMM's own warps between their MMAs (mma_tile's k-tile hook), which
// asks whether the tensor-core pipeline hides them inside the block.
#include <cstring>

#include "common.cuh"
#include "crt.cuh"
#include "crt_mma.cuh"
#include "mma_s8.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBM;
using gm8::kBN;
using gm8::kCrtTiles;
using gm8::kWords;
constexpr int kThreads = gm8::kMmaThreads;
constexpr int kSmemBytes = gm8::kMmaSmemBytes;
constexpr int kElems = kBM * kBN;        // 16384 elements a tile
constexpr int kHbmPer = kElems / 8;      // 2048 rider words a tile
constexpr int kRecPer = kElems / 16;     // 1024 rider elements a tile
constexpr int kBatch = 8;                // independent chains a thread
constexpr int kDPad = gm8::kCrtDigits + 1;  // a staged D row, padded

enum Variant {
  kBase, kIndep, kDeadDep, kHbmIn, kHbmIO, kRecBody, kRecMxu, kKLoop,
  kVariants
};

struct Chain {
  int reps, mul, add;
};

__device__ __forceinline__ void chain8(int (&v)[kBatch], const Chain& c) {
#pragma unroll 1
  for (int r = 0; r < c.reps; ++r)
#pragma unroll
    for (int e = 0; e < kBatch; ++e)
      asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                   : "+r"(v[e]) : "r"(c.mul), "r"(c.add));
}

// kloop's chains: a thread's kElems / kThreads elements in kBatches
// batches of kBatch held in registers, each batch starting at 0 and run
// reps rounds. Batch b runs after k-tiles [b q, (b + 1) q), q = nk /
// kBatches (nk is a multiple of 8: n % 1024 == 0), reps / q rounds after
// each and one more after the first reps % q. first: element 0 of the
// first batch when its chain is done (the tile's first element for
// thread 0).
struct KLoopChain {
  static constexpr int kBatches = kElems / kThreads / kBatch;
  Chain c;
  int v[kBatch];
  int q = 1, base = 0, extra = 0, j = 0, b = 0, first = 0;

  __device__ __forceinline__ void operator()(int kt, int nk) {
    if (kt == 0) {
      q = nk / kBatches;
      base = c.reps / q;
      extra = c.reps % q;
    }
    if (j == 0) {
      if (b == 1) first = v[0];
#pragma unroll
      for (int e = 0; e < kBatch; ++e) v[e] = 0;
    }
    const int rounds = base + (j < extra ? 1 : 0);
#pragma unroll 1
    for (int r = 0; r < rounds; ++r)
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                     : "+r"(v[e]) : "r"(c.mul), "r"(c.add));
    if (++j == q) {
      j = 0;
      ++b;
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

// the recmxu rider: 1024 elements of the tile in 4 chunks of 256; each
// warp contracts 32 elements on the tensor cores and stages their digits
// Y[d] in shared memory, then each thread forms one element's limbs and
// runs the tail
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
  for (int chunk = 0; chunk < kRecPer / kThreads; ++chunk) {
    const int el = warp * 32 + 4 * g;                // local element
    const size_t e0 = e_tile + chunk * kThreads + el;
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
    __syncthreads();  // the previous chunk's rows are read
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int q = 0; q < kCrtTiles; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ds[(el + 2 * p + (r >> 1)) * kDPad + 8 * q + 2 * t + (r & 1)] =
              d[p][q][r];
    __syncthreads();
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
    rout[e_tile + chunk * kThreads + threadIdx.x] =
        gm8::crt_round_f64(mag, neg, 0);
  }
}

template <int kVar>
__device__ __forceinline__ void deaddep_tile(
    const signed char* __restrict__ A, const signed char* __restrict__ Bt,
    unsigned char* __restrict__ out, int n, const void* rin,
    int* __restrict__ rout_i32, int* __restrict__ aux,
    unsigned long long* __restrict__ rout_f64, int L, const Chain& ch,
    const gm8::SlotModuli& mods, const gm8::CrtTable& T,
    const gm8::CrtMmaTable& W) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int l = blockIdx.z;
  const int bm0 = blockIdx.y * kBM, bn0 = blockIdx.x * kBN;
  const size_t tile =
      (static_cast<size_t>(l) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  const size_t tiles = static_cast<size_t>(L) * gridDim.y * gridDim.x;
  const signed char* Al = A + static_cast<size_t>(l) * n * n;
  const signed char* Bl = Bt + static_cast<size_t>(l) * n * n;
  int acc[4][4][4];
  KLoopChain kc{ch};
  if constexpr (kVar == kKLoop)
    gm8::mma_tile<false>(Al, n, Bl, n, n, n, n, bm0, bn0, smem, acc, kc);
  else
    gm8::mma_tile<false>(Al, n, Bl, n, n, n, n, bm0, bn0, smem, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int mod = mods.m[l];
  unsigned char* ol = out + static_cast<size_t>(l) * n * n;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = bm0 + wm * 64 + mt * 16 + g + (r >= 2 ? 8 : 0);
        const int col = bn0 + wn * 32 + nt * 8 + t * 2 + (r & 1);
        ol[static_cast<size_t>(row) * n + col] =
            static_cast<unsigned char>(gm8::mod_canon(acc[mt][nt][r], mod));
      }
  if constexpr (kVar == kBase) return;
  if constexpr (kVar == kKLoop) {
    if (threadIdx.x == 0) aux[tile] = kc.first;
    return;
  }
  __syncthreads();  // every warp is past its last read of the ring
  int* scratch = reinterpret_cast<int*>(smem);
  if constexpr (kVar == kIndep || kVar == kDeadDep) {
    if constexpr (kVar == kDeadDep)  // the tile's (0, 0) product
      if (threadIdx.x == 0) scratch[kElems] = acc[0][0][0] & 1;
    for (int i = threadIdx.x; i < kElems; i += kThreads) scratch[i] = 0;
    __syncthreads();
    const int seed = kVar == kDeadDep ? scratch[kElems] : 0;
    for (int b = 0; b < kElems / kThreads; b += kBatch) {
      int v[kBatch];
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        v[e] = scratch[threadIdx.x + (b + e) * kThreads] + seed;
      chain8(v, ch);
#pragma unroll
      for (int e = 0; e < kBatch; ++e)
        scratch[threadIdx.x + (b + e) * kThreads] = v[e];
    }
    __syncthreads();
    if (threadIdx.x == 0) aux[tile] = scratch[0];
  } else if constexpr (kVar == kHbmIn || kVar == kHbmIO) {
    static_assert(kHbmPer == kBatch * kThreads, "one batch a thread");
    const int* r = static_cast<const int*>(rin) + tile * kHbmPer;
    int v[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) v[e] = r[threadIdx.x + e * kThreads];
    chain8(v, ch);
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if constexpr (kVar == kHbmIO)
        rout_i32[tile * kHbmPer + i] = v[e];
      else
        scratch[i] = v[e];  // consumed without a device-memory write
    }
    if (threadIdx.x == 0) aux[tile] = v[0];
  } else if constexpr (kVar == kRecBody) {
    const auto* r = static_cast<const unsigned char*>(rin);
    const size_t total = tiles * kRecPer;
    for (int i = threadIdx.x; i < kRecPer; i += kThreads) {
      const size_t e = tile * kRecPer + i;
      rout_f64[e] = rec_body(r, total, e, L, T);
    }
  } else {
    rec_mxu(static_cast<const unsigned char*>(rin), tiles * kRecPer,
            tile * kRecPer, L, T, W, rout_f64, scratch);
  }
}

// stamps (when not null): per tile, the block's SM and its clock64() at
// its start and after its last thread is done, in SM clock cycles: a
// measure of the work that the SM clock's swings at the power cap leave
// alone
template <int kVar>
__global__ void __launch_bounds__(kThreads, 2)
deaddep_kernel(const signed char* __restrict__ A,
               const signed char* __restrict__ Bt,
               unsigned char* __restrict__ out, int n, const void* rin,
               int* __restrict__ rout_i32,
               int* __restrict__ aux,
               unsigned long long* __restrict__ rout_f64, int L,
               const Chain ch,
               const __grid_constant__ gm8::SlotModuli mods,
               const __grid_constant__ gm8::CrtTable T,
               const __grid_constant__ gm8::CrtMmaTable W,
               long long* __restrict__ stamps) {
  const long long t0 = stamps ? clock64() : 0;
  deaddep_tile<kVar>(A, Bt, out, n, rin, rout_i32, aux, rout_f64, L, ch,
                     mods, T, W);
  if (stamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const size_t tile =
          (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
              gridDim.x + blockIdx.x;
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      stamps[3 * tile] = sm;
      stamps[3 * tile + 1] = t0;
      stamps[3 * tile + 2] = clock64();
    }
  }
}

template <int kVar>
void launch(const signed char* a8, const signed char* btp,
            unsigned char* out, int n, const void* rin, int* rout_i32,
            int* aux, unsigned long long* rout_f64, int L, const Chain& ch,
            const gm8::SlotModuli& mods, const gm8::CrtTable& T,
            const gm8::CrtMmaTable& W, long long* stamps, cudaStream_t s) {
  cudaFuncSetAttribute(deaddep_kernel<kVar>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  dim3 grid(n / kBN, n / kBM, L);
  deaddep_kernel<kVar><<<grid, kThreads, kSmemBytes, s>>>(
      a8, btp, out, n, rin, rout_i32, aux, rout_f64, L, ch, mods, T, W,
      stamps);
}

}  // namespace

// a8, b8: (L, n, n) int8, n % 1024 == 0 (the script's grid), a8 16-byte
// aligned; bt: (L, n, n) int8 workspace (B copied K-major); out: (L, n, n)
// uint8; rin: the variant's rider (hbm: tiles x 2048 int32 words; rec: L
// planes of tiles x 1024 uint8 residues), tiles = L (n / 128)^2; rout:
// hbmio's int32 output (as rin); aux: tiles int32 (the chain variants);
// rec_out: tiles x 1024 f64 (the rec variants); crt_table, mma_table: the
// CrtTable and CrtMmaTable of L, on the host; variant: index into
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
      ((hbm || rec) && !rin) || (variant == kHbmIO && !rout) ||
      (chain && !aux) || (rec && !rec_out))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  std::memcpy(&T, crt_table, sizeof(T));
  gm8::CrtMmaTable W;
  std::memcpy(&W, mma_table, sizeof(W));
  const Chain ch{reps, 3, 1};
  auto s = static_cast<cudaStream_t>(stream);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, n, n, n, s);
  auto ap = static_cast<const signed char*>(a8);
  auto op = static_cast<unsigned char*>(out);
  auto ri = static_cast<int*>(rout);
  auto ax = static_cast<int*>(aux);
  auto rf = static_cast<unsigned long long*>(rec_out);
  auto st = static_cast<long long*>(stamps);
#define GM8_DEADDEP_CASE(V)                                                 \
  case V:                                                                   \
    launch<V>(ap, btp, op, n, rin, ri, ax, rf, L, ch, mods, T, W, st, s);   \
    break;
  switch (variant) {
    GM8_DEADDEP_CASE(kBase)
    GM8_DEADDEP_CASE(kIndep)
    GM8_DEADDEP_CASE(kDeadDep)
    GM8_DEADDEP_CASE(kHbmIn)
    GM8_DEADDEP_CASE(kHbmIO)
    GM8_DEADDEP_CASE(kRecBody)
    GM8_DEADDEP_CASE(kRecMxu)
    GM8_DEADDEP_CASE(kKLoop)
  }
#undef GM8_DEADDEP_CASE
  return gm8::launch_status();
}
