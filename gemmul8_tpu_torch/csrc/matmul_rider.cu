// One stage of the panel/rider pipeline: the int8 GEMM of one m-panel of A
// against all of B with the mod in its epilogue (canonical uint8 residues),
// and, in the same grid, rider blocks that do independent work of the
// neighbouring panels: the CRT reconstruct of the previous panel's residues
// into its rows of the f64 or f32 output, and the residue encode of the
// next A panel from its f64 or f32 source (gm8_matmul_rider_step). The
// first panel may instead run as two launches over B's column halves, the
// left half's GEMM carrying the encode of B's right half straight into the
// K-major copy of B that every GEMM of the call reads
// (gm8_matmul_bsplit_pair).
//
// Replaces: matmul_rider_step, gemmul8_tpu/pallas/pipelined.py:195 (its
// a_kind and out_kind, "f64" and "f32"), and matmul_bsplit_pair,
// pipelined.py:475 (its a_kind and b_kind).
// Bound on the H100: int8 tensor-core operations, L x 2 x panel_m x n x k
// a stage; beside them the riders move panel_m x n x (L + 8) bytes
// (reconstruct; L + 4 into f32) and panel_m x k x (8 + L) bytes (encode;
// 4 + L from f32), and do their integer work, which is what they can
// overlap with the products.
// Design: one launch per panel, a 1-D grid of the GEMM's 128 x 128 tiles
// (mma_s8.cuh's tile and matmul_mod.cu's epilogue: the wrapping int32
// accumulator, a remainder by the slot's modulus) with the rider blocks
// spread evenly among them, so that an SM runs a rider block beside a GEMM
// block through most of the launch. A kernel has one dynamic shared-memory
// size, so a rider block takes a GEMM block's slot (two per SM) and leaves
// its 96 KB unused. The rider bodies are CUDA-core forms of the stand-alone
// kernels: crt.cuh's sum, centering and rounding on uint8 residues (a
// 32-row x 256-column tile, one column a thread), and residue.cuh's
// encode_element, one remainder chain per modulus (the same tile); the
// stand-alone encode.cu and reconstruct.cu contract on the tensor cores. The
// TPU kernel ran riders on grid steps of one core in order, under
// predicates; here blocks run in no order, and the riders' buffers are
// disjoint from what the GEMM reads and writes in the same launch, so no
// block waits on another. B is copied K-major once per call: by the first
// stage's launch (b8 given), or, split, its left half by the pair.
// The words are template parameters, as in the stand-alone kernels: each
// encode rider reads its source's own word (src_word.cuh: an f32 source's
// 4-byte words directly, with its own left-shift cap, up to 53 bits at 20
// moduli), and the reconstruct rider rounds the integer once into the
// output's word (crt_round_word). The GEMM tile is word-blind. The entry
// points take the kinds as flags and launch the instance that runs: the
// step by A's source word and the output word, the pair by A's and B's
// source words.
#include <cstring>

#include "common.cuh"
#include "crt.cuh"
#include "mma_s8.cuh"
#include "moduli.cuh"
#include "residue.cuh"
#include "transpose_b.cuh"

namespace {

using gm8::kBM;
using gm8::kBN;
using gm8::kWords;
constexpr int kThreads = gm8::kMmaThreads;
constexpr int kSmemBytes = gm8::kMmaSmemBytes;
constexpr int kRows = 32;        // rows of a reconstruct or A-encode tile
constexpr int kBkRows = 64;      // B-encode tile: 64 rows of B (k) ...
constexpr int kBkCols = 32;      // ... by 32 of its columns

using F64 = unsigned long long;  // an f64 word's bits
using F32 = unsigned;            // an f32 word's bits

// What one launch does. A rider that is off has a null source and no
// blocks. AW, BW: the words of the A- and B-encode riders' sources; OW:
// the reconstruct rider's output word.
template <typename AW, typename BW, typename OW>
struct Stage {
  using Out = OW;
  // the GEMM: (L, pm, n) uint8 residues, columns [c0, c1), of rows
  // [a_row0, a_row0 + pm) of each (a_rows, k) slice of A against the
  // (L, n, k) K-major B
  const signed char* a;
  const signed char* bt;
  unsigned char* res;
  int a_rows, a_row0, pm, n, k, c0, c1;
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
  int L, a_q_max, b_q_max;
  int rec_blocks, enc_blocks, benc_blocks;
};

template <typename S>
__device__ __forceinline__ void gemm_tile(const S& s,
                                          const gm8::SlotModuli& mods,
                                          unsigned char* smem, int g) {
  const int ntn = (s.c1 - s.c0 + kBN - 1) / kBN;
  const int ntm = (s.pm + kBM - 1) / kBM;
  const int bn0 = s.c0 + g % ntn * kBN;
  const int bm0 = g / ntn % ntm * kBM;
  const int l = g / (ntn * ntm);
  const signed char* Al =
      s.a + (static_cast<size_t>(l) * s.a_rows + s.a_row0) * s.k;
  const signed char* Bl = s.bt + static_cast<size_t>(l) * s.n * s.k;
  int acc[4][4][4];
  // columns at or past c1 load as zeros: the B-encode rider of the same
  // launch writes there
  gm8::mma_tile<false>(Al, s.k, Bl, s.k, s.pm, s.c1, s.k, bm0, bn0, smem,
                       acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int mod = mods.m[l];
  unsigned char* ol = s.res + static_cast<size_t>(l) * s.pm * s.n;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = bm0 + wm * 64 + mt * 16 + gr + (r >= 2 ? 8 : 0);
        const int col = bn0 + wn * 32 + nt * 8 + t * 2 + (r & 1);
        if (row < s.pm && col < s.c1)
          ol[static_cast<size_t>(row) * s.n + col] =
              static_cast<unsigned char>(gm8::mod_canon(acc[mt][nt][r], mod));
      }
}

// tile t of the previous panel's reconstruct: kRows rows x kThreads columns
template <typename S>
__device__ __forceinline__ void rec_tile(const S& s, const gm8::CrtTable& T,
                                         int t) {
  const int ncg = (s.n + kThreads - 1) / kThreads;
  const int col = t % ncg * kThreads + threadIdx.x;
  const int row0 = t / ncg * kRows;
  if (col >= s.n) return;
  const size_t plane = static_cast<size_t>(s.pm) * s.n;
  const int row1 = min(row0 + kRows, s.pm);
  for (int row = row0; row < row1; ++row) {
    const size_t idx = static_cast<size_t>(row) * s.n + col;
    unsigned long long acc[kWords] = {0, 0, 0, 0, 0, 0};
    for (int j = 0; j < s.L; ++j)
      gm8::crt_add(acc, T, j, s.r_prev[j * plane + idx]);
    unsigned x[kWords];
    gm8::crt_words(acc, x);
    unsigned mag[kWords];
    const bool neg = gm8::crt_center(x, T, mag);
    s.r_out[idx] = gm8::crt_round_word<typename S::Out>(
        mag, neg, -(s.r_sa[row] + s.sb[col]));
  }
}

// tile t of the next A panel's encode: kRows rows x kThreads columns
template <typename S>
__device__ __forceinline__ void enc_a_tile(const S& s, int t) {
  const int ncg = (s.k + kThreads - 1) / kThreads;
  const int col = t % ncg * kThreads + threadIdx.x;
  const int row0 = t / ncg * kRows;
  if (col >= s.k) return;
  const size_t total = static_cast<size_t>(s.pm) * s.k;
  const int row1 = min(row0 + kRows, s.pm);
  for (int row = row0; row < row1; ++row) {
    const size_t idx = static_cast<size_t>(row) * s.k + col;
    gm8::encode_element(s.a_src[idx], s.a_sft[row], s.a_out, total, idx,
                        s.L, s.a_q_max);
  }
}

// tile t of B's right-half encode: kBkRows rows of B x kBkCols columns,
// neighbouring threads on neighbouring rows, so that each slice's K-major
// writes coalesce; the four threads that read one 32-byte sector of a row
// of B sit in four warps of the block and meet in L1
template <typename S>
__device__ __forceinline__ void enc_b_tile(const S& s, int t) {
  const int ncg = (s.n - s.b_c0 + kBkCols - 1) / kBkCols;
  const int kk = t / ncg * kBkRows + (threadIdx.x & (kBkRows - 1));
  const int j0 = s.b_c0 + t % ncg * kBkCols;
  if (kk >= s.k) return;
  const size_t total = static_cast<size_t>(s.n) * s.k;
  for (int c = threadIdx.x / kBkRows; c < kBkCols; c += kThreads / kBkRows) {
    const int col = j0 + c;
    if (col >= s.n) break;
    gm8::encode_element(s.b_src[static_cast<size_t>(kk) * s.n + col],
                        s.b_sft[col], s.b_out, total,
                        static_cast<size_t>(col) * s.k + kk, s.L,
                        s.b_q_max);
  }
}

template <typename AW, typename BW, typename OW>
__global__ void __launch_bounds__(kThreads, 2)
rider_kernel(const __grid_constant__ Stage<AW, BW, OW> s,
             const __grid_constant__ gm8::CrtTable T,
             const __grid_constant__ gm8::SlotModuli mods) {
  extern __shared__ __align__(128) unsigned char smem[];
  // block b is a rider when it raises floor(b * riders / blocks): the
  // riders spread evenly over the grid, and the GEMM tiles keep their order
  const long long blocks = gridDim.x, b = blockIdx.x;
  const long long riders = s.rec_blocks + s.enc_blocks + s.benc_blocks;
  const long long before = b * riders / blocks;  // riders in [0, b)
  if ((b + 1) * riders / blocks == before) {
    gemm_tile(s, mods, smem, static_cast<int>(b - before));
    return;
  }
  int t = static_cast<int>(before);
  if (t < s.rec_blocks) {
    rec_tile(s, T, t);
    return;
  }
  t -= s.rec_blocks;
  if (t < s.enc_blocks) {
    enc_a_tile(s, t);
    return;
  }
  enc_b_tile(s, t - s.enc_blocks);
}

int cdiv(int x, int y) { return (x + y - 1) / y; }

// counts the blocks of each part of s and launches it
template <typename AW, typename BW, typename OW>
int launch(Stage<AW, BW, OW>& s, const void* table, cudaStream_t st) {
  gm8::SlotModuli mods;
  if (s.k % 16 != 0 || s.c0 < 0 || s.c0 >= s.c1 || s.c1 > s.n ||
      !gm8::slot_moduli(nullptr, s.L, &mods))
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::CrtTable T;
  if (table)
    std::memcpy(&T, table, sizeof(T));
  else
    std::memset(&T, 0, sizeof(T));
  const long long gemm_blocks = static_cast<long long>(s.L) *
                                cdiv(s.c1 - s.c0, kBN) * cdiv(s.pm, kBM);
  s.rec_blocks = s.r_prev ? cdiv(s.pm, kRows) * cdiv(s.n, kThreads) : 0;
  s.enc_blocks = s.a_src ? cdiv(s.pm, kRows) * cdiv(s.k, kThreads) : 0;
  s.benc_blocks =
      s.b_src ? cdiv(s.k, kBkRows) * cdiv(s.n - s.b_c0, kBkCols) : 0;
  const long long blocks =
      gemm_blocks + s.rec_blocks + s.enc_blocks + s.benc_blocks;
  if (blocks > 0x7FFFFFFFll) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(rider_kernel<AW, BW, OW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  rider_kernel<AW, BW, OW>
      <<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, st>>>(s, T,
                                                                    mods);
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
  s.a = static_cast<const signed char*>(a8);
  s.bt = static_cast<const signed char*>(bt);
  s.res = static_cast<unsigned char*>(res);
  s.a_rows = a_rows;
  s.a_row0 = a_row0;
  s.pm = pm;
  s.n = n;
  s.k = k;
  s.c0 = 0;
  s.c1 = n;
  s.r_prev = static_cast<const unsigned char*>(r_prev);
  s.r_sa = static_cast<const int*>(r_sa);
  s.sb = static_cast<const int*>(sb);
  s.r_out = static_cast<OW*>(r_out);
  s.a_src = static_cast<const AW*>(a_src);
  s.a_sft = static_cast<const int*>(a_sft);
  s.a_out = static_cast<signed char*>(a_out);
  s.L = L;
  s.a_q_max = a_q_max;
  return launch(s, r_prev ? table : nullptr, st);
}

// the first panel's two launches on the words AW (A's source) and BW (B's)
template <typename AW, typename BW>
int bsplit_pair(const void* a8, const void* b8, void* bt, void* res,
                const void* b_src, const void* b_sft, const void* a_src,
                const void* a_sft, void* a_out, int L, int pm, int n, int k,
                int a_q_max, int b_q_max, cudaStream_t st) {
  const int h = n / 2;
  gm8::transpose_b(static_cast<const signed char*>(b8),
                   static_cast<signed char*>(bt), L, k, h, k, st, n, n);
  Stage<AW, BW, F64> s{};
  s.a = static_cast<const signed char*>(a8);
  s.bt = static_cast<const signed char*>(bt);
  s.res = static_cast<unsigned char*>(res);
  s.a_rows = pm;
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
  s.b_out = static_cast<signed char*>(bt);
  s.b_c0 = h;
  int code = launch(s, nullptr, st);
  if (code != 0) return code;
  // 0b: the right half, panel 1's encode riding
  s.c0 = h;
  s.c1 = n;
  s.b_src = nullptr;
  s.a_src = static_cast<const AW*>(a_src);
  s.a_sft = static_cast<const int*>(a_sft);
  s.a_out = static_cast<signed char*>(a_out);
  return launch(s, nullptr, st);
}

}  // namespace

// One stage. a8: (L, a_rows, k) int8, the panel its rows [a_row0,
// a_row0 + pm); b8: (L, k, n) int8 or null: when given, it is first copied
// into bt (the call's first stage); bt: (L, n, k) int8, B K-major; res:
// (L, pm, n) uint8 residues. Reconstruct rider (r_prev non-null): r_prev
// (L, pm, n) uint8, r_sa pm and sb n int32 shifts, r_out (pm, n) f64
// (out_f32 = 0) or f32 (out_f32 = 1), table the CrtTable of L moduli on
// the host. Encode rider (a_src non-null): a_src (pm, k) f64 (a_f32 = 0) or
// f32 (a_f32 = 1), a_sft pm int32 shifts, a_out (L, pm, k) int8; a_q_max
// the encode's left-shift cap for a_src's word. k % 16 == 0; slice l uses
// modulus MODULI[l].
GM8_EXPORT int gm8_matmul_rider_step(const void* a8, const void* b8,
                                     void* bt, void* res, const void* r_prev,
                                     const void* r_sa, const void* sb,
                                     void* r_out, const void* a_src,
                                     const void* a_sft, void* a_out,
                                     const void* table, int a_rows,
                                     int a_row0, int L, int pm, int n, int k,
                                     int a_q_max, int a_f32, int out_f32,
                                     void* stream) {
  if (a_row0 < 0 || a_row0 + pm > a_rows || (r_prev && !table))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define GM8_STEP(AW, OW)                                                    \
  rider_step<AW, OW>(a8, b8, bt, res, r_prev, r_sa, sb, r_out, a_src,       \
                     a_sft, a_out, table, a_rows, a_row0, L, pm, n, k,      \
                     a_q_max, st)
  if (a_f32) return out_f32 ? GM8_STEP(F32, F32) : GM8_STEP(F32, F64);
  return out_f32 ? GM8_STEP(F64, F32) : GM8_STEP(F64, F64);
#undef GM8_STEP
}

// The first panel in two launches. a8: (L, pm, k) int8 panel 0; b8: (L, k,
// n) int8, its left half [0, n/2) encoded (the rest is not read); bt: (L, n,
// k) int8 out, B K-major: the left half copied from b8, the right half
// encoded from b_src (k, n) f64 (b_f32 = 0) or f32 (b_f32 = 1) with b_sft n
// int32 shifts by the rider of launch 0a (the left half's GEMM); res: (L,
// pm, n) uint8, the left half from launch 0a, the right half from launch
// 0b, whose rider (a_src non-null) encodes panel 1's (pm, k) f64 (a_f32 =
// 0) or f32 (a_f32 = 1) rows a_src with a_sft pm shifts into a_out (L, pm,
// k) int8. a_q_max, b_q_max: the encode's left-shift cap for each source's
// word. n even, k % 16 == 0.
GM8_EXPORT int gm8_matmul_bsplit_pair(const void* a8, const void* b8,
                                      void* bt, void* res, const void* b_src,
                                      const void* b_sft, const void* a_src,
                                      const void* a_sft, void* a_out, int L,
                                      int pm, int n, int k, int a_q_max,
                                      int b_q_max, int a_f32, int b_f32,
                                      void* stream) {
  if (n % 2 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define GM8_PAIR(AW, BW)                                                    \
  bsplit_pair<AW, BW>(a8, b8, bt, res, b_src, b_sft, a_src, a_sft, a_out, L, \
                      pm, n, k, a_q_max, b_q_max, st)
  if (a_f32) return b_f32 ? GM8_PAIR(F32, F32) : GM8_PAIR(F32, F64);
  return b_f32 ? GM8_PAIR(F64, F32) : GM8_PAIR(F64, F64);
#undef GM8_PAIR
}
