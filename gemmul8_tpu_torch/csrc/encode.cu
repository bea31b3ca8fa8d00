// Residue slices of an f64 or f32 operand: out[l] = centered residue of
// trunc(x * 2^sft) mod m_l as int8, for the call's slots l (every modulus in
// order, a chunk of a moduli-chunked call, or any tuple: the slots are rows
// of the per-call weight table, so every form is one kernel); all of x's
// columns, or a range of them (the panel pipeline's B split: the left half
// of B is encoded up front, the right half by a rider, matmul_rider.cu).
// Two layouts of the output: N-major (L, d0, d1), x's own, for A and for
// the B slices of the paths that still copy B (transpose_b.cuh); and, for
// a B operand (axis 0), K-major (L, n, kp), kp = k rounded up to 16 with
// zeros in [k, kp): the layout the wgmma tile reads, so matmul_mod.cu and
// matmul_complex.cu take such a B without a copy.
//
// Replaces: encode_slices_pallas, gemmul8_tpu/pallas/kernels.py:691 (its
// F64Bits and f32 forms; its default MXU body _encode_tile_mxu, :612).
// Bound on the H100: device-memory bytes. Per element it reads 8 bytes (4
// for f32) and writes num_moduli bytes (22 bytes at 14 moduli: 1.4 GB per
// f64 operand at 8192^2, about 0.44 ms at 3.35 TB/s; 18 bytes f32).
// Design: the residue dots run on the int8 tensor cores (encode_mma.cuh):
// a warp takes 64 consecutive columns of one row, each thread reads two
// elements with one 16-byte load (8 for f32), writes their byte planes to
// shared memory, ldmatrix hands out the B fragments, 8 mma.sync a slot tile
// form every residue, and each thread reduces its accumulators with one
// multiply-and-shift each and writes 16 consecutive residues of a slot with
// one 16-byte store. The next tile's words are loaded before this tile's
// contraction. No remainder of the 77-bit value is taken per modulus and
// no residue is stored alone, except at a ragged edge (a column range or
// row that ends inside a thread's 16 elements, or a misaligned start),
// which takes byte stores. The source word is a template parameter
// (src_word.cuh): the f32 form reads 4-byte words into the same shifted
// value.
// The K-major form (a template parameter of the same kernel, 8 warps a
// block) takes a unit of 32 rows by 8 columns of x a warp, read
// row-major with 16-byte loads (8 for f32), 64 bytes of a row (32) a
// quarter-warp, as four 16 x 4 tiles: the planes of element (row r, column
// c) of a tile sit at element 16 c + r, so the contraction leaves each
// lane 16 consecutive k of one column (matmul_rider.cu's B encode). A lane
// pairs its two tiles' pieces of a column (32 consecutive k) with its
// neighbour's by one exchange of shuffles, so that each 16-byte store of a
// lane and of its neighbour fill one 32-byte sector of a row of the
// output. The units go down k first, so that the warps in flight together
// write whole rows of the output (across n first, each row was written 32
// bytes at a time far apart in time: 2.5x the N-major form's time). Rows
// past k are read as zeros, whose residues are 0: the pad [k, kp) is
// written with the rest.
#include <cstring>

#include "common.cuh"
#include "encode_mma.cuh"

#if !defined(GM8_ENC_THREADS) || !defined(GM8_ENC_BLOCKS_PER_SM)
#error "encode.cu takes its launch from hopper/launch.py (nvcc -D)"
#endif

namespace {

using gm8::EncMmaTable;
using gm8::kEncTile;
// a block's threads and the grid's blocks an SM (the grid-stride walk's
// cap), from the launch table (hopper/launch.py `EncodeLaunch`)
constexpr int kThreads = GM8_ENC_THREADS;
constexpr int kBlocksPerSm = GM8_ENC_BLOCKS_PER_SM;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "whole warps, at most 1024 threads a block");
static_assert(kBlocksPerSm >= 1, "a block an SM or more");
static_assert(kWarps * kEncTile * 16 + sizeof(EncMmaTable) <= 49152,
              "over the static shared memory of a block");
// the K-major form: a block's warps, whatever the launch entry's threads
// (its plane rows take 4 KB a warp), and a warp's unit of x
constexpr int kKWarps = 8;
constexpr int kKRows = 32;
constexpr int kKCols = 8;
static_assert(kKWarps * 4 * kEncTile * 16 + sizeof(EncMmaTable) <= 49152,
              "over the static shared memory of a block");

// The K-major form: x (k, n) row-major, sft n column shifts; out (L, n,
// kp), slot l's row col the residues of x's column col down k, zeros in
// [k, kp). A unit is 32 rows (a row group) by 8 columns (a column group)
// of x. Lane load j (0..3): row 8 j + lane / 4 of the unit, columns
// 2 (lane % 4) and the next, i.e. tile (kb, ct) = (j / 2, lane % 4 / 2),
// elements 16 c + r and 16 (c + 1) + r with c = 2 (lane % 2), r = 8 (j %
// 2) + lane / 4. Tile (kb, ct)'s plane
// rows are planes[warp][2 kb + ct], their 16-byte rows XOR-ed by 2 ct, so
// that a quarter-warp's stores into the two tiles of a load hit 8
// distinct bank groups (ldmatrix reads one tile: a constant XOR keeps its
// phases conflict-free).
template <typename Word, int kMT>
__device__ __forceinline__ void encode_k_major(
    const Word* __restrict__ x, const int* __restrict__ sft,
    signed char* __restrict__ out, int k, int n, int kp, int q_max, int L,
    const EncMmaTable& T) {
  __shared__ __align__(16) uint4 planes[kKWarps][4][kEncTile];
  __shared__ EncMmaTable S;
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(S) / 16);
       i += kKWarps * 32)
    reinterpret_cast<uint4*>(&S)[i] = reinterpret_cast<const uint4*>(&T)[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int lct = (lane & 3) >> 1;  // the tile column of this lane's loads
  const gm8::EncSlots<kMT> slots(S);
  uint4* st[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = 32 * (lane & 1) + 8 * (j & 1) + (lane >> 2);
    uint4* rows = planes[warp][2 * (j >> 1) + lct];
    st[j][0] = rows + (gm8::enc_row(e) ^ (2 * lct));
    st[j][1] = rows + (gm8::enc_row(e + 16) ^ (2 * lct));
  }
  unsigned ld_addr[2][2][2];  // [kb][ct][c]
#pragma unroll
  for (int kb = 0; kb < 2; ++kb)
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      const unsigned base = static_cast<unsigned>(
          __cvta_generic_to_shared(planes[warp][2 * kb + ct]));
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ld_addr[kb][ct][c] = base + (gm8::enc_ld_addr(0, c) ^ (32 * ct));
    }

  // units down k first (u = column group * nrg + row group), so that the
  // warps in flight together write whole rows of the output; advanced by
  // the grid stride without a division in the loop
  const int nrg = (k + kKRows - 1) / kKRows;
  const int ncg = (n + kKCols - 1) / kKCols;
  const long long stride = static_cast<long long>(gridDim.x) * kKWarps;
  const long long u0 = static_cast<long long>(blockIdx.x) * kKWarps + warp;
  if (u0 >= static_cast<long long>(nrg) * ncg) return;
  const int dcg = static_cast<int>(stride / nrg);
  const int drg =
      static_cast<int>(stride - static_cast<long long>(dcg) * nrg);
  int cg = static_cast<int>(u0 / nrg);
  int rg = static_cast<int>(u0 - static_cast<long long>(cg) * nrg);
  auto load = [&](int r, int c, gm8::EncPair<Word>(&w)[4]) {
    const int col = c * kKCols + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r * kKRows + 8 * j + (lane >> 2);
      w[j] = row < k ? gm8::enc_load_pair(x, sft,
                                          static_cast<size_t>(row) * n, row,
                                          col, n, 0)
                     : gm8::EncPair<Word>{0, 0, 0, 0};
    }
  };
  gm8::EncPair<Word> cur[4];
  load(rg, cg, cur);
  for (;;) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *st[j][0] = gm8::enc_planes(cur[j].x0, cur[j].s0, q_max);
      *st[j][1] = gm8::enc_planes(cur[j].x1, cur[j].s1, q_max);
    }
    __syncwarp();
    // the next unit's words, in flight during this unit's contraction
    int rgn = rg + drg, cgn = cg + dcg;
    if (rgn >= nrg) {
      rgn -= nrg;
      ++cgn;
    }
    if (cgn < ncg) load(rgn, cgn, cur);
    const int k0 = rg * kKRows;
    const int col0 = cg * kKCols;
    // a lane's pieces: 16 k at k0 + 16 piece; its stores, columns ca, cb
    const int piece = tq & 1;
    const bool odd = piece != 0;
    const bool k_ok = k0 + 16 * piece < kp;
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      unsigned b0[8], b1[8];
      gm8::enc_frags(ld_addr[0][ct], b0);
      gm8::enc_frags(ld_addr[1][ct], b1);
      const int ca = col0 + 4 * ct + (tq & 2), cb = ca + 1;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        unsigned w0[2][4], w1[2][4];
        slots.contract_reduce(mt, b0, w0);
        slots.contract_reduce(mt, b1, w1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // even lane: column tq, k0..+15 kept, k0+16.. sent; odd lane:
          // column tq, k0+16.. kept, k0.. sent
          unsigned r[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            r[i] = __shfl_xor_sync(0xFFFFFFFFu, odd ? w0[h][i] : w1[h][i], 1);
          const int l = 16 * mt + 8 * h + g;
          if (l >= L || !k_ok) continue;
          signed char* const p = out + static_cast<size_t>(l) * n * kp + k0 +
                                 16 * piece;
          if (ca < n)
            *reinterpret_cast<uint4*>(p + static_cast<size_t>(ca) * kp) =
                odd ? make_uint4(r[0], r[1], r[2], r[3])
                    : make_uint4(w0[h][0], w0[h][1], w0[h][2], w0[h][3]);
          if (cb < n)
            *reinterpret_cast<uint4*>(p + static_cast<size_t>(cb) * kp) =
                odd ? make_uint4(w1[h][0], w1[h][1], w1[h][2], w1[h][3])
                    : make_uint4(r[0], r[1], r[2], r[3]);
        }
      }
    }
    __syncwarp();  // the next unit's planes overwrite these rows
    if (cgn >= ncg) break;
    rg = rgn;
    cg = cgn;
  }
}

// The N-major form: out (L, d0, d1), columns [c0, c1) of each row
template <typename Word, int kMT>
__device__ __forceinline__ void encode_n_major(
    const Word* __restrict__ x, const int* __restrict__ sft,
    signed char* __restrict__ out, int d0, int d1, int axis, int q_max,
    int c0, int c1, int L, const EncMmaTable& T) {
  __shared__ __align__(16) uint4 rows[kWarps][kEncTile];
  // the table in shared memory: each thread reads the entries of its own
  // slots, which the compiler may reload where they are used; from the
  // kernel parameter those reloads would serialise on the lanes' distinct
  // addresses (a per-thread constant-bank index), from shared memory they
  // are conflict-free
  __shared__ EncMmaTable S;
  for (int i = threadIdx.x; i < static_cast<int>(sizeof(S) / 16);
       i += kThreads)
    reinterpret_cast<uint4*>(&S)[i] = reinterpret_cast<const uint4*>(&T)[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const gm8::EncSlots<kMT> slots(S);
  const unsigned sbase =
      static_cast<unsigned>(__cvta_generic_to_shared(rows[warp]));
  const unsigned ld_addr[2] = {gm8::enc_ld_addr(sbase, 0),
                               gm8::enc_ld_addr(sbase, 1)};
  uint4* const st0 = &rows[warp][gm8::enc_row(2 * lane)];
  uint4* const st1 = &rows[warp][gm8::enc_row(2 * lane + 1)];

  // tiles in row-major order, (row, column tile) advanced by the grid
  // stride without a division in the loop
  const int ntc = (c1 - c0 + kEncTile - 1) / kEncTile;
  const long long tiles = static_cast<long long>(d0) * ntc;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const size_t total = static_cast<size_t>(d0) * d1;
  long long t = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (t >= tiles) return;
  const int drow = static_cast<int>(stride / ntc);
  const int dct =
      static_cast<int>(stride - static_cast<long long>(drow) * ntc);
  int row = static_cast<int>(t / ntc);
  int ct = static_cast<int>(t - static_cast<long long>(row) * ntc);
  gm8::EncPair<Word> cur =
      gm8::enc_load_pair(x, sft, static_cast<size_t>(row) * d1, row,
                         c0 + ct * kEncTile + 2 * lane, c1, axis);
  for (;;) {
    *st0 = gm8::enc_planes(cur.x0, cur.s0, q_max);
    *st1 = gm8::enc_planes(cur.x1, cur.s1, q_max);
    __syncwarp();
    unsigned b[8];
    gm8::enc_frags(ld_addr, b);
    __syncwarp();  // the next tile's planes overwrite these rows
    // the next tile's words, in flight during this tile's contraction
    const long long tn = t + stride;
    int nrow = row + drow, nct = ct + dct;
    if (nct >= ntc) {
      nct -= ntc;
      ++nrow;
    }
    if (tn < tiles)
      cur = gm8::enc_load_pair(x, sft, static_cast<size_t>(nrow) * d1, nrow,
                               c0 + nct * kEncTile + 2 * lane, c1, axis);
    const int cs = c0 + ct * kEncTile;
    signed char* const obase = out + static_cast<size_t>(row) * d1;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      int d[8][4];
      slots.contract(mt, b, d);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = 16 * mt + 8 * h + g;
        if (l >= L) continue;
        unsigned w[4];
        slots.reduce(mt, h, d, w);
        gm8::enc_store16(obase + l * total, cs + 16 * tq, c1, w);
      }
    }
    if (tn >= tiles) break;
    t = tn;
    row = nrow;
    ct = nct;
  }
}

// kMT slot tiles of 16 (1: up to 16 moduli, 2: up to 32); kKMajor: the
// K-major form (x (d0, d1) = (k, n), out (L, n, kp)), launched with
// kKWarps warps a block
template <typename Word, int kMT, bool kKMajor>
__global__ void __launch_bounds__(kKMajor ? kKWarps * 32 : kThreads)
encode_kernel(const Word* __restrict__ x, const int* __restrict__ sft,
              signed char* __restrict__ out, int d0, int d1, int axis,
              int q_max, int c0, int c1, int L, int kp,
              const __grid_constant__ EncMmaTable T) {
  if constexpr (kKMajor)
    encode_k_major<Word, kMT>(x, sft, out, d0, d1, kp, q_max, L, T);
  else
    encode_n_major<Word, kMT>(x, sft, out, d0, d1, axis, q_max, c0, c1, L,
                              T);
}

template <typename Word>
void launch(const void* x, const int* sp, signed char* op, int d0, int d1,
            int axis, int q_max, int c0, int c1, int L,
            const EncMmaTable& T, cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles =
      static_cast<long long>(d0) * ((c1 - c0 + kEncTile - 1) / kEncTile);
  const long long want = (tiles + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  auto xp = static_cast<const Word*>(x);
  if (L <= 16)
    encode_kernel<Word, 1, false><<<blocks, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, c0, c1, L, 0, T);
  else
    encode_kernel<Word, 2, false><<<blocks, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, c0, c1, L, 0, T);
}

template <typename Word>
void launch_k_major(const void* x, const int* sp, signed char* op, int k,
                    int n, int kp, int q_max, int L, const EncMmaTable& T,
                    cudaStream_t s) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long units = static_cast<long long>((k + kKRows - 1) / kKRows) *
                          ((n + kKCols - 1) / kKCols);
  const long long want = (units + kKWarps - 1) / kKWarps;
  const long long cap = static_cast<long long>(kBlocksPerSm) * sms;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  auto xp = static_cast<const Word*>(x);
  if (L <= 16)
    encode_kernel<Word, 1, true><<<blocks, kKWarps * 32, 0, s>>>(
        xp, sp, op, k, n, 0, q_max, 0, n, L, kp, T);
  else
    encode_kernel<Word, 2, true><<<blocks, kKWarps * 32, 0, s>>>(
        xp, sp, op, k, n, 0, q_max, 0, n, L, kp, T);
}

}  // namespace

// x: (d0, d1) f64 bits (f32 = 0) or f32 bits (f32 = 1); sft: d0 shifts
// (axis=1) or d1 shifts (axis=0); table: the EncMmaTable of the call's n_idx
// slots, on the host (hopper/kernels.py encode_mma_table); out: (n_idx, d0,
// d1) int8, slice l for slot l, written in columns [c0, c1) only. q_max:
// the static left-shift cap max(threshold_accurate - mant_bits, 0) of the
// call's moduli count (mant_bits 53 for f64, 24 for f32).
GM8_EXPORT int gm8_encode_slices(const void* x, const void* sft, void* out,
                                 int d0, int d1, int axis, const void* table,
                                 int n_idx, int q_max, int c0, int c1,
                                 int f32, void* stream) {
  if (n_idx < 1 || n_idx > gm8::kMaxModuli || d0 < 1 || c0 < 0 ||
      c1 > d1 || c0 >= c1 || (axis != 0 && axis != 1) || q_max < 0 ||
      q_max > (f32 ? 53 : 24))
    return static_cast<int>(cudaErrorInvalidValue);
  EncMmaTable T;
  std::memcpy(&T, table, sizeof(T));
  auto s = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const int*>(sft);
  auto op = static_cast<signed char*>(out);
  if (f32)
    launch<unsigned>(x, sp, op, d0, d1, axis, q_max, c0, c1, n_idx, T, s);
  else
    launch<unsigned long long>(x, sp, op, d0, d1, axis, q_max, c0, c1,
                               n_idx, T, s);
  return gm8::launch_status();
}

// The K-major form of a B operand (axis 0): x (k, n) f64 or f32 bits, sft
// n column shifts, table, n_idx, q_max and f32 as for gm8_encode_slices;
// out: (n_idx, n, kp) int8, 16-byte aligned, kp % 16 == 0, kp >= k: slice
// l's row j holds the residues of x's column j, k of them, then zeros.
GM8_EXPORT int gm8_encode_slices_kmajor(const void* x, const void* sft,
                                        void* out, int k, int n, int kp,
                                        const void* table, int n_idx,
                                        int q_max, int f32, void* stream) {
  if (n_idx < 1 || n_idx > gm8::kMaxModuli || k < 1 || n < 1 || kp < k ||
      kp % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      q_max < 0 || q_max > (f32 ? 53 : 24))
    return static_cast<int>(cudaErrorInvalidValue);
  EncMmaTable T;
  std::memcpy(&T, table, sizeof(T));
  auto s = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const int*>(sft);
  auto op = static_cast<signed char*>(out);
  if (f32)
    launch_k_major<unsigned>(x, sp, op, k, n, kp, q_max, n_idx, T, s);
  else
    launch_k_major<unsigned long long>(x, sp, op, k, n, kp, q_max, n_idx, T,
                                       s);
  return gm8::launch_status();
}
