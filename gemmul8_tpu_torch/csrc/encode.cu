// Residue slices of an f64 or f32 operand: out[l] = centered residue of
// trunc(x * 2^sft) mod m_l as int8, for the call's slots l (every modulus in
// order, a chunk of a moduli-chunked call, or any tuple: the slots are rows
// of the per-call weight table, so every form is one kernel); all of x's
// columns, or a range of them (the panel pipeline's B split: the left half
// of B is encoded up front, the right half by a rider, matmul_rider.cu).
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

// kMT slot tiles of 16 (1: up to 16 moduli, 2: up to 32)
template <typename Word, int kMT>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const Word* __restrict__ x, const int* __restrict__ sft,
              signed char* __restrict__ out, int d0, int d1, int axis,
              int q_max, int c0, int c1, int L,
              const __grid_constant__ EncMmaTable T) {
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
    encode_kernel<Word, 1><<<blocks, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, c0, c1, L, T);
  else
    encode_kernel<Word, 2><<<blocks, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, c0, c1, L, T);
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
