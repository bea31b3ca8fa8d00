// Fast-mode shift selection and residue encode in one kernel: per row of A
// (axis=1) or column of B (axis=0) the shift of fast_sft.cu, then the
// (num_moduli, d0, d1) int8 centered residues of trunc(x * 2^sft), as
// encode.cu writes them.
//
// Replaces: fast_encode_fused_pallas, gemmul8_tpu/pallas/kernels.py:209
// (its F64Bits and f32 forms).
// Bound on the H100: device-memory bytes. Read once, each f64 element costs
// 8 bytes in and num_moduli bytes out: at 8192^2 and 14 moduli, 1.07 GB read
// and 1.88 GB written for both operands, 0.88 ms at 3.35 TB/s; the separate
// kernels read the operand twice. An f32 element costs 4 bytes in (at 8
// moduli, 0.54 GB read and 1.07 GB written, 0.48 ms).
// Design: the TPU kernel held a row block's whole contraction extent in
// VMEM; a block here has 227 KB of shared memory, so nothing is held. A
// block takes the statistics of its row or column strip with the bodies of
// fast_sft.cu (fast_stats.cuh: same threads, same summation order), so its
// shifts are the fast_sft kernel's bits, and then encodes the same strip
// with encode.cu's residues (residue.cuh), reading it a second time. Rows
// of A: one 256-thread block per row; the second read of a row (64 KB at k
// = 8192) comes from the 50 MB L2 right after the first. Columns of B:
// 32-column strips of 32 x 16 threads, as fast_sft's column kernel; a strip
// is kdim x 256 bytes (2 MB at 8192), and the strips of the blocks in
// flight exceed L2, so the second read mostly comes from device memory.
// The source word is a template parameter (src_word.cuh), as in the
// kernels it fuses: the f32 form reads 4-byte words with the same threads
// and order, takes its shift at bias 127 and its left shifts up to 53.
#include "common.cuh"
#include "fast_stats.cuh"
#include "residue.cuh"

namespace {

using gm8::kColX;
using gm8::kColY;
using gm8::kRowThreads;

template <typename Word>
__global__ void __launch_bounds__(kRowThreads)
fused_rows(const Word* __restrict__ x, signed char* __restrict__ out,
           int* __restrict__ sft_out, int rows, int kdim, int num_moduli,
           int t_f, float guard, int q_max) {
  const Word* xr = x + static_cast<size_t>(blockIdx.x) * kdim;
  const gm8::Stats s = gm8::row_stats(xr, kdim);
  const int sft = gm8::sft_from_stats(s.emax, s.nrm2, s.any, t_f, guard,
                                      gm8::Src<Word>::kBias);
  if (threadIdx.x == 0) sft_out[blockIdx.x] = sft;
  const size_t total = static_cast<size_t>(rows) * kdim;
  const size_t base = static_cast<size_t>(blockIdx.x) * kdim;
  for (int k = threadIdx.x; k < kdim; k += kRowThreads)
    gm8::encode_element(xr[k], sft, out, total, base + k, num_moduli, q_max);
}

template <typename Word>
__global__ void __launch_bounds__(kColX * kColY)
fused_cols(const Word* __restrict__ x, signed char* __restrict__ out,
           int* __restrict__ sft_out, int cols, int kdim, int num_moduli,
           int t_f, float guard, int q_max) {
  const int col = blockIdx.x * kColX + threadIdx.x;
  const bool valid = col < cols;
  const gm8::Stats s = gm8::col_stats(x, kdim, cols, col, valid);
  if (!valid) return;
  const int sft = gm8::sft_from_stats(s.emax, s.nrm2, s.any, t_f, guard,
                                      gm8::Src<Word>::kBias);
  if (threadIdx.y == 0) sft_out[col] = sft;
  const size_t total = static_cast<size_t>(kdim) * cols;
  for (int r = threadIdx.y; r < kdim; r += kColY) {
    const size_t idx = static_cast<size_t>(r) * cols + col;
    gm8::encode_element(x[idx], sft, out, total, idx, num_moduli, q_max);
  }
}

template <typename Word>
void launch(const void* x, signed char* op, int* sp, int rows, int kdim,
            int axis, int num_moduli, int t_f, float guard, int q_max,
            cudaStream_t s) {
  auto xp = static_cast<const Word*>(x);
  if (axis == 1) {
    fused_rows<Word><<<rows, kRowThreads, 0, s>>>(xp, op, sp, rows, kdim,
                                                  num_moduli, t_f, guard,
                                                  q_max);
  } else {
    fused_cols<Word><<<(rows + kColX - 1) / kColX, dim3(kColX, kColY), 0,
                       s>>>(xp, op, sp, rows, kdim, num_moduli, t_f, guard,
                            q_max);
  }
}

}  // namespace

// x: (rows, kdim) for axis=1, (kdim, rows) for axis=0, f64 bits (f32 = 0)
// or f32 bits (f32 = 1). out: (num_moduli, d0, d1) int8 slices in x's
// layout; sft: rows int32. t_f: tables.threshold_fast; guard: f32(1 + k *
// 2^-23); q_max: the static left-shift cap max(threshold_accurate -
// mant_bits, 0) (mant_bits 53 for f64, 24 for f32).
GM8_EXPORT int gm8_fast_encode_fused(const void* x, void* out, void* sft,
                                     int rows, int kdim, int axis,
                                     int num_moduli, int t_f, float guard,
                                     int q_max, int f32, void* stream) {
  if (q_max < 0 || q_max > (f32 ? 53 : 24))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto op = static_cast<signed char*>(out);
  auto sp = static_cast<int*>(sft);
  if (f32)
    launch<unsigned>(x, op, sp, rows, kdim, axis, num_moduli, t_f, guard,
                     q_max, s);
  else
    launch<unsigned long long>(x, op, sp, rows, kdim, axis, num_moduli, t_f,
                               guard, q_max, s);
  return gm8::launch_status();
}
