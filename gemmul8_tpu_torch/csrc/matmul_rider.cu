// One stage of the panel/rider pipeline: the int8 GEMM of one m-panel of A
// against all of B with the mod in its epilogue (canonical uint8 residues),
// and, in the same launch, rider work of the neighbouring panels: the CRT
// reconstruct of the previous panel's residues into its rows of the f64 or
// f32 output, and the residue encode of the next A panel from its f64 or
// f32 source (gm8_matmul_rider_step). The first panel may instead run as
// two launches over B's column halves, the left half's GEMM carrying the
// encode of B's right half straight into the K-major copy of B that every
// GEMM of the call reads (gm8_matmul_bsplit_pair).
//
// Replaces: matmul_rider_step, gemmul8_tpu/pallas/pipelined.py:195 (its
// a_kind and out_kind, "f64" and "f32"), and matmul_bsplit_pair,
// pipelined.py:475 (its a_kind and b_kind).
// Bound on the H100: int8 tensor-core operations, L x 2 x panel_m x n x k
// a stage; beside them the riders move panel_m x n x (L + 8) bytes
// (reconstruct; L + 4 into f32) and panel_m x k x (8 + L) bytes (encode;
// 4 + L from f32), which the tensor cores' time leaves room for.
// Design: the GEMM runs matmul_mod.cu's tile (wgmma_s8.cuh: 3-D TMA maps
// into a ring of stages, one producer warp, two consumer warpgroups of
// wgmma.m64n256k32 s8 on a 128 x 256 tile, the multiply-and-shift mod and
// 16-byte stores of store_tile) on a persistent grid of one block per SM,
// its launch constants from hopper/launch.py's matmul_rider entry (a stage
// fewer than matmul_mod's: the riders' shared memory). The windows are the
// tensor maps': A's covers rows [a_row0, a_row0 + pm) of each (a_rows, k)
// slice, B's rows [c0, c1) of each (n, k) slice of the K-major B, so TMA
// fills rows past a window with zeros and no tile reads the columns launch
// 0a's B rider writes; the residues go into columns [c0, c1) of the
// (L, pm, n) buffer.
// The riders run beside the mainloop, not between tiles: the producer
// warpgroup's three other warps (setmaxnreg: 152 registers for its warps,
// 176 for the consumers, the block's 64,512 in all) take the block's
// reconstruct chunks, then its encode units, off two counters in shared
// memory; the consumer warps join once their GEMM tiles are done, with
// their rider memory in the idle ring. Block b's share of each kind of
// work is pieces b, b + P, ... (P blocks), so every SM has rider work
// from the launch's start. The bodies are the stand-alone kernels'
// tensor-core forms:
// - reconstruct (crt_mma.cuh, crt_tail.cuh, as reconstruct.cu): a warp
//   takes 128 elements, 16-byte loads of 16 residues a modulus, the CRT sum
//   on mma.sync.m16n8k32 s8; its limbs go through shared memory in two
//   halves of 64 elements (12 x 68 ints a warp), and each lane runs the
//   tail of two elements a half, rounded once into f64 or f32.
// - A encode (encode_mma.cuh, as encode.cu): a unit is two 64-column tiles
//   of the panel's rows; a tile's byte planes in shared memory, ldmatrix,
//   mma.sync.m16n8k16 s8 x u8 against the signed weight table, one
//   multiply-and-shift a residue, 16-byte stores. A unit's tiles contract
//   together (independent work in flight for one warp).
// - B encode into the K-major B: a unit is 64 k by 4 columns, four 16 x 4
//   tiles, each lane a 16-byte (f64) load of two neighbouring columns of
//   one row; the planes of element (row r, column c) sit at element
//   16 c + r, so the contraction leaves each lane 16 consecutive k of one
//   column: bt[l, col, k0..k0+15], no transpose pass. The unit's residues
//   are staged in shared memory and go out as 64 contiguous bytes of a
//   column (a lone 16-byte store costs its sector's other half as a fill).
// The next unit's (chunk's) words are loaded while one contracts. Rider
// work uses only rider buffers, disjoint from what the GEMM of the same
// launch reads and writes, so no block waits on another. The tables (the
// encode weights of encode.cu and the CRT digit table of each moduli
// count, hopper/kernels.py) are set once on the host
// (gm8_set_rider_tables), passed by value and copied to shared memory;
// the CrtTable of the call's L comes with the step. B is copied K-major
// once per call: by the first stage's launch (b8 given), or, split, its
// left half by the pair. The words are template parameters: each encode
// rider reads its source's own word (src_word.cuh, with its own left-shift
// cap), the reconstruct rider rounds once into the output's word. The
// entry points take the kinds as flags and launch the instance that runs.
#include <cstring>

#include "common.cuh"
#include "crt_mma.cuh"
#include "crt_tail.cuh"
#include "encode_mma.cuh"
#include "moduli.cuh"
#include "transpose_b.cuh"
#include "wgmma_s8.cuh"

#if !defined(GM8_MM_TILE_N) || !defined(GM8_MM_STAGES) || \
    !defined(GM8_MM_GROUP)
#error "matmul_rider.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::CrtMmaTable;
using gm8::CrtTable;
using gm8::EncMmaTable;
using gm8::kCrtTiles;
using gm8::wg::kBK;
using gm8::wg::kBM;

constexpr int kBN = GM8_MM_TILE_N;      // output columns of a tile
constexpr int kStages = GM8_MM_STAGES;  // stages of the TMA ring
constexpr int kGroup = GM8_MM_GROUP;    // m-tiles of a raster group
static_assert(kBN == 256, "wgmma_s8.cuh issues wgmma.m64n256k32 only");
static_assert(kStages >= 2 && kGroup >= 1,
              "a ring of two stages or more, groups of one m-tile or more");

constexpr int kWarps = gm8::wg::kConsumerWarps;  // consumer warps
constexpr int kRiderWarps = 3;   // warps 9..11, beside the producer
constexpr int kProducerRegs = 152;  // setmaxnreg of the producer warpgroup
constexpr int kConsumerRegs = 176;  // and of the consumers: 64,512 in all,
                                    // the block's 384 x 168
constexpr int kRecChunk = 128;   // reconstruct: elements a warp's chunk
constexpr int kRecHalf = kRecChunk / 2;
constexpr int kLimbRows = 4 * kCrtTiles;  // 12 limb rows (the last: S)
constexpr int kZStride = kRecHalf + 4;    // ints a limb row of a half
constexpr int kEncTile = gm8::kEncTile;   // encode: 64 elements a tile
constexpr int kPlanes = kEncTile * 16;    // a warp's plane rows, bytes
constexpr int kATiles = 2;       // A encode: a unit's 64-column tiles
constexpr int kBRows = 16;       // B encode: a tile's rows of B (k) ...
constexpr int kBCols = 4;        // ... and columns
constexpr int kBTiles = 4;       // a unit's tiles down k
constexpr int kStageSlot = kBTiles * kBRows * kBCols + 16;  // a slot's
                                 // unit of B, padded: conflict-free stores
constexpr int kRiderBytes = kBTiles * kPlanes +
                            gm8::kMaxModuli * kStageSlot;
                                 // a rider warp's shared memory: the
                                 // encode's plane rows of a unit's tiles
                                 // and B's staging, or the reconstruct's
                                 // limbs
static_assert(kATiles <= kBTiles, "the A unit's plane rows fit");
constexpr int kBarrier = 3;      // named barrier of the 8 consumer warps
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <=
                  gm8::wg::kThreads * 168,
              "the warpgroups' registers within the block's allocation");
static_assert(kLimbRows * kZStride * 4 <= kRiderBytes &&
                  kWarps * kRiderBytes <= kStages * (kBM + kBN) * kBK,
              "the consumers' rider memory fits the ring");

// the tables every block copies after the ring's barriers
struct alignas(16) SmemTables {
  EncMmaTable enc;   // the weights of moduli 0..19, slot l = modulus l
  CrtMmaTable crt;   // the digit table of the call's L
};

// after the ring's barriers: the tables, the block's two work counters
// (16 bytes), the rider warps' memory
constexpr int kSmem = gm8::wg::smem_bytes(kBN, kStages) +
                      static_cast<int>(sizeof(SmemTables)) + 16 +
                      kRiderWarps * kRiderBytes;
static_assert(kSmem <= 232448,
              "over the shared memory a block may opt into on sm_90");

// the constants of a launch, by value
struct alignas(16) Consts {
  SmemTables tabs;
  CrtTable crt;               // the reconstruct tail's M, M / 2, 1 / M
  gm8::SlotDivisors divs;     // the epilogue's divisors of moduli 0..L-1
};

// set once by gm8_set_rider_tables: the encode table and the digit table
// of every moduli count (zero below 2)
SmemTables g_tables[gm8::kMaxModuli + 1];
bool g_tables_set = false;

using F64 = unsigned long long;  // an f64 word's bits
using F32 = unsigned;            // an f32 word's bits

// What one launch does. A rider that is off has a null source and no
// work. AW, BW: the words of the A- and B-encode riders' sources; OW:
// the reconstruct rider's output word.
template <typename AW, typename BW, typename OW>
struct Stage {
  using AWord = AW;
  using BWord = BW;
  using Out = OW;
  // the GEMM: (L, pm, n) uint8 residues, columns [c0, c1), of the panel's
  // pm rows of A against the (L, n, k) K-major B (their windows are the
  // tensor maps')
  unsigned char* res;
  int pm, n, k, c0, c1, L;
  // reconstruct rider: the previous panel's (L, pm, n) uint8 residues ->
  // its (pm, n) f64 or f32 rows
  const unsigned char* r_prev;
  const int* r_sa;                 // pm row shifts
  const int* sb;                   // n column shifts
  OW* r_out;
  // A-encode rider: the next panel's (pm, k) rows -> (L, pm, k) int8
  const AW* a_src;
  const int* a_sft;                // pm row shifts
  signed char* a_out;
  // B-encode rider: columns [b_c0, n) of the (k, n) B -> those rows of
  // the K-major B, the buffer the GEMM reads in its columns [c0, c1)
  const BW* b_src;
  const int* b_sft;                // n column shifts
  signed char* b_out;
  int b_c0;
  // the encode's left-shift cap of each source's word (q_max)
  int a_q_max, b_q_max;
  // the encode units (A: kATiles 64-column tiles of the panel's rows; B:
  // kBTiles x 16 rows by 4 columns of B's right half)
  int a_units, b_units;
};

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(kBarrier), "n"(32 * kWarps)
               : "memory");
}

// ---- the reconstruct rider ------------------------------------------------
// one element's output word from its limbs in column idx of a warp's half
// chunk (row nl: the ones row's S), rounded once at 2^e_fix
template <typename OW, int kW>
__device__ __forceinline__ OW rec_word(int (*zs)[kZStride], int idx,
                                       int nl, const CrtTable& T,
                                       int e_fix) {
  const int s1 = zs[nl][idx];
  int limb[2 * kW];
#pragma unroll
  for (int l = 0; l < 2 * kW; ++l)
    limb[l] = l < nl ? zs[l][idx] + 32896 * s1 : 0;
  unsigned x[kW], mag[kW];
  gm8::limbs_to_words(limb, x);
  const bool neg = gm8::center_rn(x, T, mag);
  return gm8::round_word_rn<OW>(mag, neg, e_fix);
}

// The block's reconstruct chunks (128 elements of the flat (pm, n), c =
// b + P i), taken by each calling warp in the order of the shared counter,
// the next chunk's residues in flight during a chunk's last tails; zs: the
// warp's limb rows. kW: the tail's words (4 up to 14 moduli, else 6),
// kHi: moduli past 16.
template <int kW, bool kHi, typename S>
__device__ __forceinline__ void rec_chunks(const S& s, const CrtMmaTable& W,
                                           const CrtTable& T,
                                           unsigned* counter,
                                           unsigned char* at) {
  using OW = typename S::Out;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t mn = static_cast<size_t>(s.pm) * s.n;
  const long long chunks = static_cast<long long>((mn + kRecChunk - 1) /
                                                  kRecChunk);
  const int b = blockIdx.x, P = gridDim.x;
  const long long count = chunks > b ? (chunks - 1 - b) / P + 1 : 0;
  auto grab = [&]() -> long long {
    unsigned i = 0;
    if (lane == 0) i = atomicAdd(counter, 1u);
    i = __shfl_sync(0xFFFFFFFFu, i, 0);
    return i < count ? b + static_cast<long long>(P) * i : -1;
  };
  long long c = grab();
  if (c < 0) return;
  int (*zs)[kZStride] = reinterpret_cast<int (*)[kZStride]>(at);
  const int L = s.L, nl = W.nd / 2;
  unsigned bf[kCrtTiles][2];
  gm8::crt_b_frags(W, bf);
  int cl[kCrtTiles];
#pragma unroll
  for (int q = 0; q < kCrtTiles; ++q) cl[q] = W.cl[4 * q + t];
  const bool vec =
      mn % 16 == 0 && (reinterpret_cast<uintptr_t>(s.r_prev) & 15) == 0;
  // thread (g, t): elements 16g..16g+15 of moduli 4t..4t+3 (wl) and
  // 16+4t.. (wh, kHi); word k holds elements 16g+4k..16g+4k+3
  unsigned wl[4][4], wh[kHi ? 4 : 1][4];
  auto load_rows = [&](size_t e0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      gm8::crt_load16(wl[i], s.r_prev, 4 * t + i, e0 + 16 * g, L, mn, vec,
                      true);
      if constexpr (kHi)
        gm8::crt_load16(wh[i], s.r_prev, 16 + 4 * t + i, e0 + 16 * g, L, mn,
                        vec, true);
    }
  };
  load_rows(static_cast<size_t>(c) * kRecChunk);
  while (c >= 0) {
    const long long cn = grab();
    const size_t e0 = static_cast<size_t>(c) * kRecChunk;
    const int row0 = static_cast<int>(e0 / s.n);
    const int col0 = static_cast<int>(e0 - static_cast<size_t>(row0) * s.n);
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
          const unsigned ch[4] = {wh[0][k], wh[1][k], wh[2][k], wh[3][k]};
          gm8::transpose4(ch, hi);
        }
        int d[2][kCrtTiles][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < kCrtTiles; ++q) {
            d[p][q][0] = d[p][q][2] = cl[q];
            d[p][q][1] = d[p][q][3] = 0;
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
      if (h == 1 && cn >= 0) load_rows(static_cast<size_t>(cn) * kRecChunk);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = lane + 32 * i;
        const int el = 16 * (idx >> 3) + 8 * h + (idx & 7);
        if (e0 + el >= mn) continue;
        int col = col0 + el, row = row0;
        while (col >= s.n) {
          col -= s.n;
          ++row;
        }
        s.r_out[e0 + el] = rec_word<OW, kW>(
            zs, idx, nl, T, -(__ldg(s.r_sa + row) + __ldg(s.sb + col)));
      }
      __syncwarp();  // the next half's limbs overwrite these rows
    }
    c = cn;
  }
}

// ---- the encode riders ----------------------------------------------------
// A warp's plane rows in shared memory, and its lane's two elements' rows
// (e0, e1) and ldmatrix addresses there.
struct PlaneRows {
  uint4* st0;
  uint4* st1;
  unsigned ld_addr[2];

  PlaneRows() = default;
  __device__ __forceinline__ PlaneRows(unsigned char* at, int e0, int e1) {
    uint4* rows = reinterpret_cast<uint4*>(at);
    const unsigned base = gm8::wg::smem_u32(rows);
    st0 = rows + gm8::enc_row(e0);
    st1 = rows + gm8::enc_row(e1);
    ld_addr[0] = gm8::enc_ld_addr(base, 0);
    ld_addr[1] = gm8::enc_ld_addr(base, 1);
  }
};

// kT tiles' planes into the warp's kT plane rows, ldmatrix, then each
// slot's 16 residues of this lane's elements of tile i to store(i, l, w),
// for every slot (store stores only l < L); the tiles' contractions are
// independent, so one warp keeps kT times the work in flight. The rows
// are free again on return.
template <int kT, int kMT, typename Word, typename Store>
__device__ __forceinline__ void enc_tiles(const gm8::EncSlots<kMT>& slots,
                                          const gm8::EncPair<Word> (&x)[kT],
                                          int q_max,
                                          const PlaneRows (&pr)[kT],
                                          Store store) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    *pr[i].st0 = gm8::enc_planes(x[i].x0, x[i].s0, q_max);
    *pr[i].st1 = gm8::enc_planes(x[i].x1, x[i].s1, q_max);
  }
  __syncwarp();
  unsigned b[kT][8];
#pragma unroll
  for (int i = 0; i < kT; ++i) gm8::enc_frags(pr[i].ld_addr, b[i]);
  __syncwarp();  // the next tiles' planes overwrite these rows
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      unsigned w[2][4];
      slots.contract_reduce(mt, b[i], w);
#pragma unroll
      for (int h = 0; h < 2; ++h) store(i, 16 * mt + 8 * h + g, w[h]);
    }
}

// A unit u: the panel's 64-column tiles kATiles u + i in row-major order
// (none past the last tile), each a row's columns col .. col + 63; the
// words of each are a lane's pair
template <typename S>
struct AWords {
  gm8::EncPair<typename S::AWord> x[kATiles];
};

template <typename S>
__device__ __forceinline__ AWords<S> a_words(const S& s, int u) {
  const int lane = threadIdx.x & 31;
  const int ntc = (s.k + kEncTile - 1) / kEncTile;
  AWords<S> w;
#pragma unroll
  for (int i = 0; i < kATiles; ++i) {
    const int t = kATiles * u + i, row = t / ntc;
    w.x[i] = row < s.pm
                 ? gm8::enc_load_pair(s.a_src, s.a_sft,
                                      static_cast<size_t>(row) * s.k, row,
                                      (t - row * ntc) * kEncTile + 2 * lane,
                                      s.k, 1)
                 : gm8::EncPair<typename S::AWord>{0, 0, 0, 0};
  }
  return w;
}

template <int kMT, typename S>
__device__ __forceinline__ void a_unit(const S& s,
                                       const gm8::EncSlots<kMT>& slots,
                                       const PlaneRows (&pr)[kATiles],
                                       int u, const AWords<S>& x) {
  const int ntc = (s.k + kEncTile - 1) / kEncTile;
  const size_t total = static_cast<size_t>(s.pm) * s.k;
  int row[kATiles], col[kATiles];
#pragma unroll
  for (int i = 0; i < kATiles; ++i) {
    const int t = kATiles * u + i;
    row[i] = t / ntc;
    col[i] = (t - row[i] * ntc) * kEncTile + 16 * (threadIdx.x & 3);
  }
  enc_tiles(slots, x.x, s.a_q_max, pr,
            [&](int i, int l, const unsigned (&w)[4]) {
              if (l < s.L && row[i] < s.pm)
                gm8::enc_store16(s.a_out + l * total +
                                     static_cast<size_t>(row[i]) * s.k,
                                 col[i], s.k, w);
            });
}

// B unit u = (block of kBTiles x 16 rows, 4-column group) of B's right
// half: the words of its tiles (zero past k). Lane: row r of a tile,
// columns c and c + 1 (elements 16c + r and 16(c + 1) + r), so that after
// the contraction lane (g, tq) holds 16 consecutive k of column tq.
template <typename S>
struct BWords {
  gm8::EncPair<typename S::BWord> x[kBTiles];
};

template <typename S>
__device__ __forceinline__ BWords<S> b_words(const S& s, int u) {
  const int lane = threadIdx.x & 31;
  const int groups = (s.n - s.b_c0 + kBCols - 1) / kBCols;
  const int kb = u / groups;
  const int col = s.b_c0 + (u - kb * groups) * kBCols + 2 * (lane & 1);
  BWords<S> w;
#pragma unroll
  for (int i = 0; i < kBTiles; ++i) {
    const int kk = (kBTiles * kb + i) * kBRows + (lane >> 1);
    w.x[i] = kk < s.k ? gm8::enc_load_pair(s.b_src, s.b_sft,
                                           static_cast<size_t>(kk) * s.n,
                                           kk, col, s.n, 0)
                      : gm8::EncPair<typename S::BWord>{0, 0, 0, 0};
  }
  return w;
}

// B unit u, its words x: each tile's residues go to the warp's staging
// rows (slot l: the unit's k of 4 columns), then out in 16-byte pieces,
// consecutive lanes on consecutive pieces of one column, so that each
// store fills whole 32-byte sectors (a lone 16-byte store would cost its
// sector's other half as a fill); a unit cut by k (k % 64 != 0) has fewer
// tiles, and with one alone its pieces go out as 16 bytes
template <int kMT, typename S>
__device__ __forceinline__ void b_unit(const S& s,
                                       const gm8::EncSlots<kMT>& slots,
                                       const PlaneRows (&pr)[kBTiles],
                                       unsigned char* stage, int u,
                                       const BWords<S>& x) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int n = s.n, k = s.k;
  const int groups = (n - s.b_c0 + kBCols - 1) / kBCols;
  const int kb = u / groups;
  const int cw = s.b_c0 + (u - kb * groups) * kBCols;
  const int k0 = kBTiles * kb * kBRows;
  const int tiles = min(kBTiles, (k - k0) / kBRows);  // k % 16 == 0
  enc_tiles(slots, x.x, s.b_q_max, pr,
            [&](int i, int l, const unsigned (&w)[4]) {
              if (l < s.L && i < tiles)
                *reinterpret_cast<uint4*>(stage + l * kStageSlot +
                                          (tq * kBTiles + i) * kBRows) =
                    make_uint4(w[0], w[1], w[2], w[3]);
            });
  __syncwarp();
  // piece p: slot p / (4 tiles), column (p / tiles) % 4, tile p % tiles
  const size_t slice = static_cast<size_t>(n) * k;
  for (int p = lane; p < s.L * kBCols * tiles; p += 32) {
    const int i = p % tiles, c = p / tiles % kBCols, l = p / tiles / kBCols;
    if (cw + c < n)
      *reinterpret_cast<uint4*>(s.b_out + l * slice +
                                static_cast<size_t>(cw + c) * k + k0 +
                                i * kBRows) =
          *reinterpret_cast<const uint4*>(stage + l * kStageSlot +
                                          (c * kBTiles + i) * kBRows);
  }
  __syncwarp();  // the next unit's residues overwrite the staging rows
}

// The block's encode units u = b + P i, i < count, taken in the order of
// the shared counter by each warp that calls this (the encode warps from
// the start, the consumers once their walk is done), the next unit's
// words loaded while one contracts; planes: the warp's plane rows.
template <int kMT, typename S>
__device__ __forceinline__ void enc_units_mt(const S& s,
                                             const EncMmaTable& E,
                                             unsigned* counter, int units,
                                             unsigned char* planes) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x, P = gridDim.x;
  const int count = units > b ? (units - 1 - b) / P + 1 : 0;
  auto grab = [&] {
    unsigned i = 0;
    if (lane == 0) i = atomicAdd(counter, 1u);
    i = __shfl_sync(0xFFFFFFFFu, i, 0);
    return i < static_cast<unsigned>(count) ? b + P * static_cast<int>(i)
                                            : -1;
  };
  int u = grab();
  if (u < 0) return;
  const gm8::EncSlots<kMT> slots(E);
  if (s.b_src) {
    const int e0 = 16 * (2 * (lane & 1)) + (lane >> 1);
    PlaneRows pr[kBTiles];
#pragma unroll
    for (int i = 0; i < kBTiles; ++i)
      pr[i] = PlaneRows(planes + i * kPlanes, e0, e0 + 16);
    BWords<S> cur = b_words(s, u);
    while (u >= 0) {
      const int un = grab();
      BWords<S> nxt;
      if (un >= 0) nxt = b_words(s, un);
      b_unit(s, slots, pr, planes + kBTiles * kPlanes, u, cur);
      u = un;
      cur = nxt;
    }
  } else {
    PlaneRows pr[kATiles];
#pragma unroll
    for (int i = 0; i < kATiles; ++i)
      pr[i] = PlaneRows(planes + i * kPlanes, 2 * lane, 2 * lane + 1);
    AWords<S> cur = a_words(s, u);
    while (u >= 0) {
      const int un = grab();
      AWords<S> nxt;
      if (un >= 0) nxt = a_words(s, un);
      a_unit(s, slots, pr, u, cur);
      u = un;
      cur = nxt;
    }
  }
}

template <bool kPair, typename S>
__device__ __forceinline__ void rider_work(const S& s,
                                           const SmemTables& tabs,
                                           const CrtTable& T,
                                           unsigned* counters,
                                           unsigned char* at) {
  if constexpr (!kPair) {
    if (s.r_prev) {
      if (s.L <= 14)
        rec_chunks<4, false>(s, tabs.crt, T, counters, at);
      else if (s.L <= 16)
        rec_chunks<6, false>(s, tabs.crt, T, counters, at);
      else
        rec_chunks<6, true>(s, tabs.crt, T, counters, at);
    }
  }
  const int units = s.b_src ? s.b_units : s.a_units;
  if (s.L <= 16)
    enc_units_mt<1>(s, tabs.enc, counters + 1, units, at);
  else
    enc_units_mt<2>(s, tabs.enc, counters + 1, units, at);
}

// ---- the kernel -----------------------------------------------------------
template <bool kPair, typename AW, typename BW, typename OW>
__global__ void __launch_bounds__(gm8::wg::kThreads, 1)
rider_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ Stage<AW, BW, OW> s,
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
  auto* tabs = reinterpret_cast<SmemTables*>(stg + kBM * kBN + 16 * kStages);
  auto* counters = reinterpret_cast<unsigned*>(tabs + 1);  // 2 of 4
  unsigned char* enc_rows = reinterpret_cast<unsigned char*>(tabs + 1) + 16;
  const gm8::wg::TileWalk walk(s.L, s.pm, s.c1 - s.c0, kBN, kGroup);
  const int nk = (s.k + kBK - 1) / kBK;
  // the riders read their lanes' table entries from shared memory, where
  // distinct addresses do not serialise as they would in the parameter
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(SmemTables) / 16);
       i += blockDim.x)
    reinterpret_cast<uint4*>(tabs)[i] =
        reinterpret_cast<const uint4*>(&P.tabs)[i];
  if (threadIdx.x == 0) {
    counters[0] = counters[1] = 0;
    for (int st = 0; st < kStages; ++st) {
      gm8::wg::mbar_init(ring.full + 8 * st, 1);
      gm8::wg::mbar_init(ring.empty + 8 * st, gm8::wg::kConsumerWarps);
    }
    gm8::wg::mbar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp >= kWarps) {
    // the producer warpgroup: warp 8's first thread loads the GEMM tiles,
    // warps 9..11 take the rider work beside the mainloop
    gm8::wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      gm8::wg::tma_prefetch(map_a);
      gm8::wg::tma_prefetch(map_b);
      gm8::wg::produce(map_a, map_b, ring, walk, nk);
    } else if (warp > kWarps) {
      rider_work<kPair>(s, *tabs, P.crt, counters,
                        enc_rows + (warp - kWarps - 1) * kRiderBytes);
    }
    return;
  }
  // consumer warpgroups 0 and 1: GEMM rows 64 * role .. + 63, then the
  // rider work left
  gm8::wg::setmaxnreg_inc<kConsumerRegs>();
  const int role = threadIdx.x / 128;
  int stage = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < walk.total; t += gridDim.x) {
    int l, tm, tn;
    walk.at(t, l, tm, tn);
    // defined each tile (the first wgmma ignores it), so that its 128
    // registers are dead outside the mainloop: the wgmma asm reads them,
    // and an undefined accumulator stays live through the code beside it
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    gm8::wg::consume<kBN>(acc, ring, role, nk, stage, phase);
    const gm8::ModDivisor dv = P.divs.v[l];
    unsigned char* ol = s.res + static_cast<size_t>(l) * s.pm * s.n;
    if (dv.d == 256)
      gm8::wg::store_tile<kBN, true>(acc, stg, ol, s.n, s.pm, tm * kBM,
                                     s.c0 + tn * kBN, s.c1, role, dv, 0u);
    else
      gm8::wg::store_tile<kBN, false>(acc, stg, ol, s.n, s.pm, tm * kBM,
                                      s.c0 + tn * kBN, s.c1, role, dv, 0u);
  }
  consumers_sync();  // the ring is free: every load it took is consumed
  rider_work<kPair>(s, *tabs, P.crt, counters, smem + warp * kRiderBytes);
}

int cdiv(long long x, long long y) {
  return static_cast<int>((x + y - 1) / y);
}

// counts the work of each part of s, builds the two windows' tensor maps
// (A: rows [a_row0, a_row0 + pm) of each (a_rows, k) slice at a; B: rows
// [c0, c1) of each (n, k) slice at bt) and launches it
template <bool kPair, typename AW, typename BW, typename OW>
int launch(Stage<AW, BW, OW>& s, const signed char* a, int a_rows,
           int a_row0, const signed char* bt, const CrtTable* crt,
           cudaStream_t st) {
  gm8::SlotModuli mods;
  if (!g_tables_set || s.k < 16 || s.k % 16 != 0 || s.pm < 1 ||
      a_row0 < 0 || a_row0 + s.pm > a_rows || s.c0 < 0 || s.c0 >= s.c1 ||
      s.c1 > s.n || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0 ||
      !gm8::slot_moduli(nullptr, s.L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gemm = static_cast<long long>(s.L) * cdiv(s.pm, kBM) *
                         cdiv(s.c1 - s.c0, kBN);
  const long long a_units =
      s.a_src ? (static_cast<long long>(s.pm) * cdiv(s.k, kEncTile) +
                 kATiles - 1) / kATiles
              : 0;
  const long long b_units =
      s.b_src ? static_cast<long long>(cdiv(s.k, kBTiles * kBRows)) *
                    cdiv(s.n - s.b_c0, kBCols)
              : 0;
  if (gemm > 0x7FFFFFFFll || a_units > 0x7FFFFFFFll ||
      b_units > 0x7FFFFFFFll || (s.a_src && s.b_src))
    return static_cast<int>(cudaErrorInvalidValue);
  s.a_units = static_cast<int>(a_units);
  s.b_units = static_cast<int>(b_units);
  CUtensorMap map_a, map_b;
  if (!gm8::wg::make_tensor_map(
          &map_a, a + static_cast<size_t>(a_row0) * s.k, s.L, s.pm, s.k,
          kBM, s.k, static_cast<size_t>(a_rows) * s.k) ||
      !gm8::wg::make_tensor_map(
          &map_b, bt + static_cast<size_t>(s.c0) * s.k, s.L, s.c1 - s.c0,
          s.k, kBN, s.k, static_cast<size_t>(s.n) * s.k))
    return static_cast<int>(cudaErrorInvalidValue);
  Consts P;
  std::memset(&P, 0, sizeof(P));
  P.tabs = g_tables[s.L];
  if (crt) P.crt = *crt;
  P.divs = gm8::slot_divisors(mods);
  auto kernel = rider_kernel<kPair, AW, BW, OW>;
  // setmaxnreg only moves registers within the block's allocation: with
  // fewer a thread than the warpgroups' split needs, the consumers' inc
  // would wait for ever, so such a build is refused
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess ||
      fa.numRegs * gm8::wg::kThreads <
          2 * 128 * kConsumerRegs + 128 * kProducerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmem);
  kernel<<<gm8::wg::persistent_grid(gemm),
           gm8::wg::kThreads, kSmem, st>>>(map_a, map_b, s, P);
  return gm8::launch_status();
}

// one stage on the words AW (A's source) and OW (the output)
template <typename AW, typename OW>
int rider_step(const void* a8, const void* b8, void* bt, void* res,
               const void* r_prev, const void* r_sa, const void* sb,
               void* r_out, const void* a_src, const void* a_sft,
               void* a_out, const void* table, int a_rows, int a_row0, int L,
               int pm, int n, int k, int a_q_max, cudaStream_t st) {
  if (b8)
    gm8::transpose_b(static_cast<const signed char*>(b8),
                     static_cast<signed char*>(bt), L, k, n, k, st);
  Stage<AW, F64, OW> s{};
  s.res = static_cast<unsigned char*>(res);
  s.pm = pm;
  s.n = n;
  s.k = k;
  s.c0 = 0;
  s.c1 = n;
  s.L = L;
  s.r_prev = static_cast<const unsigned char*>(r_prev);
  s.r_sa = static_cast<const int*>(r_sa);
  s.sb = static_cast<const int*>(sb);
  s.r_out = static_cast<OW*>(r_out);
  s.a_src = static_cast<const AW*>(a_src);
  s.a_sft = static_cast<const int*>(a_sft);
  s.a_out = static_cast<signed char*>(a_out);
  s.a_q_max = a_q_max;
  CrtTable T;
  if (r_prev) std::memcpy(&T, table, sizeof(T));
  return launch<false>(s, static_cast<const signed char*>(a8), a_rows,
                       a_row0, static_cast<const signed char*>(bt),
                       r_prev ? &T : nullptr, st);
}

// the first panel's two launches on the words AW (A's source) and BW (B's)
template <typename AW, typename BW>
int bsplit_pair(const void* a8, const void* b8, void* bt, void* res,
                const void* b_src, const void* b_sft, const void* a_src,
                const void* a_sft, void* a_out, int L, int pm, int n, int k,
                int a_q_max, int b_q_max, cudaStream_t st) {
  const int h = n / 2;
  auto a = static_cast<const signed char*>(a8);
  auto btp = static_cast<signed char*>(bt);
  gm8::transpose_b(static_cast<const signed char*>(b8), btp, L, k, h, k,
                   st, n, n);
  Stage<AW, BW, F64> s{};
  s.res = static_cast<unsigned char*>(res);
  s.pm = pm;
  s.n = n;
  s.k = k;
  s.L = L;
  s.a_q_max = a_q_max;
  s.b_q_max = b_q_max;
  // 0a: the left half, B's right half riding
  s.c0 = 0;
  s.c1 = h;
  s.b_src = static_cast<const BW*>(b_src);
  s.b_sft = static_cast<const int*>(b_sft);
  s.b_out = btp;
  s.b_c0 = h;
  int code = launch<true>(s, a, pm, 0, btp, nullptr, st);
  if (code != 0) return code;
  // 0b: the right half, panel 1's encode riding
  s.c0 = h;
  s.c1 = n;
  s.b_src = nullptr;
  s.a_src = static_cast<const AW*>(a_src);
  s.a_sft = static_cast<const int*>(a_sft);
  s.a_out = static_cast<signed char*>(a_out);
  return launch<true>(s, a, pm, 0, btp, nullptr, st);
}

}  // namespace

// The riders' tables (hopper/pipelined.py rider_tables), kept on the host
// for every later launch: the EncMmaTable of moduli 0..19 (encode.cu's
// table, hopper/kernels.py encode_mma_table), then the CrtMmaTable of
// each moduli count 0..20 (hopper/kernels.py crt_mma_table; zeros below
// 2). nbytes: their size.
GM8_EXPORT int gm8_set_rider_tables(const void* blob, int nbytes) {
  constexpr int kEnc = static_cast<int>(sizeof(EncMmaTable));
  constexpr int kCrt = static_cast<int>(sizeof(CrtMmaTable));
  if (nbytes != kEnc + (gm8::kMaxModuli + 1) * kCrt)
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = static_cast<const unsigned char*>(blob);
  for (int L = 0; L <= gm8::kMaxModuli; ++L) {
    std::memcpy(&g_tables[L].enc, p, kEnc);
    std::memcpy(&g_tables[L].crt, p + kEnc + L * kCrt, kCrt);
  }
  g_tables_set = true;
  return 0;
}

// One stage. a8: (L, a_rows, k) int8, the panel its rows [a_row0,
// a_row0 + pm), 16-byte aligned; b8: (L, k, n) int8 or null: when given,
// it is first copied into bt (the call's first stage); bt: (L, n, k) int8,
// B K-major, 16-byte aligned; res: (L, pm, n) uint8 residues. Reconstruct
// rider (r_prev non-null): r_prev (L, pm, n) uint8, r_sa pm and sb n int32
// shifts, r_out (pm, n) f64 (out_f32 = 0) or f32 (out_f32 = 1), table the
// CrtTable of L moduli on the host. Encode rider (a_src non-null): a_src
// (pm, k) f64 (a_f32 = 0) or f32 (a_f32 = 1), a_sft pm int32 shifts, a_out
// (L, pm, k) int8; a_q_max the encode's left-shift cap for a_src's word.
// k % 16 == 0 and k >= 16; slice l uses modulus MODULI[l]; the riders'
// tables set (gm8_set_rider_tables).
GM8_EXPORT int gm8_matmul_rider_step(const void* a8, const void* b8,
                                     void* bt, void* res, const void* r_prev,
                                     const void* r_sa, const void* sb,
                                     void* r_out, const void* a_src,
                                     const void* a_sft, void* a_out,
                                     const void* table, int a_rows,
                                     int a_row0, int L, int pm, int n, int k,
                                     int a_q_max, int a_f32, int out_f32,
                                     void* stream) {
  if (r_prev && !table) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define GM8_STEP(AW, OW)                                                    \
  rider_step<AW, OW>(a8, b8, bt, res, r_prev, r_sa, sb, r_out, a_src,       \
                     a_sft, a_out, table, a_rows, a_row0, L, pm, n, k,      \
                     a_q_max, st)
  if (a_f32) return out_f32 ? GM8_STEP(F32, F32) : GM8_STEP(F32, F64);
  return out_f32 ? GM8_STEP(F64, F32) : GM8_STEP(F64, F64);
#undef GM8_STEP
}

// The first panel in two launches. a8: (L, pm, k) int8 panel 0, 16-byte
// aligned; b8: (L, k, n) int8, its left half [0, n/2) encoded (the rest is
// not read); bt: (L, n, k) int8 out, 16-byte aligned, B K-major: the left
// half copied from b8, the right half encoded from b_src (k, n) f64 (b_f32
// = 0) or f32 (b_f32 = 1) with b_sft n int32 shifts by the rider of launch
// 0a (the left half's GEMM); res: (L, pm, n) uint8, the left half from
// launch 0a, the right half from launch 0b, whose rider (a_src non-null)
// encodes panel 1's (pm, k) f64 (a_f32 = 0) or f32 (a_f32 = 1) rows a_src
// with a_sft pm shifts into a_out (L, pm, k) int8. a_q_max, b_q_max: the
// encode's left-shift cap for each source's word. n even and >= 2, k % 16
// == 0 and k >= 16; the riders' tables set.
GM8_EXPORT int gm8_matmul_bsplit_pair(const void* a8, const void* b8,
                                      void* bt, void* res, const void* b_src,
                                      const void* b_sft, const void* a_src,
                                      const void* a_sft, void* a_out, int L,
                                      int pm, int n, int k, int a_q_max,
                                      int b_q_max, int a_f32, int b_f32,
                                      void* stream) {
  if (n % 2 != 0 || n < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define GM8_PAIR(AW, BW)                                                    \
  bsplit_pair<AW, BW>(a8, b8, bt, res, b_src, b_sft, a_src, a_sft, a_out, L, \
                      pm, n, k, a_q_max, b_q_max, st)
  if (a_f32) return b_f32 ? GM8_PAIR(F32, F32) : GM8_PAIR(F32, F64);
  return b_f32 ? GM8_PAIR(F64, F32) : GM8_PAIR(F64, F64);
#undef GM8_PAIR
}
