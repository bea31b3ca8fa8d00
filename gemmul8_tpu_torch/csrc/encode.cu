// Residue slices of an f64 or f32 operand: out[l] = centered residue of
// trunc(x * 2^sft) mod m_j as int8, j = moduli_idx[l]: every modulus of the
// call in order, or the chunk of a moduli-chunked call; all of x's columns,
// or a range of them (the panel pipeline's B split: the left half of B is
// encoded up front, the right half by a rider, matmul_rider.cu).
//
// Replaces: encode_slices_pallas, gemmul8_tpu/pallas/kernels.py:691 (its
// F64Bits and f32 forms).
// Bound on the H100: device-memory bytes. Per element it reads 8 bytes (4
// for f32) and writes num_moduli bytes (22 bytes at 14 moduli: 1.4 GB per
// f64 operand at 8192^2, about 0.4 ms at 3.35 TB/s; 18 bytes f32); the
// arithmetic is a few 32-bit remainders by constants per modulus.
// Design: elementwise, one thread per element, neighbouring threads on
// neighbouring elements, so every read and each slice's writes coalesce.
// The TPU kernel's byte-plane MXU contraction worked around the TPU's lack
// of fast integer division; here each element is reduced by residue.cuh's
// remainders by compile-time moduli (shared with fast_encode_fused.cu).
// The source word is a template parameter (src_word.cuh): the f32 form
// reads 4-byte words into the same 24 + 53-bit shifted value.
#include "common.cuh"
#include "residue.cuh"

namespace {

constexpr int kThreads = 256;

// which moduli a call encodes: the first j1 in order (the one-shot call;
// encode_element), j0 .. j1 - 1 in order (a later chunk), or those slots
// gives a slice (any tuple)
enum Mode { kPrefix, kRange, kSlots };

template <int kMode, typename Word>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const Word* __restrict__ x,
              const int* __restrict__ sft, signed char* __restrict__ out,
              int d0, int d1, int axis, int q_max, int j0, int j1,
              int c0, int c1, const __grid_constant__ gm8::ModSlots slots) {
  const int col = c0 + blockIdx.x * kThreads + threadIdx.x;
  if (col >= c1) return;
  const size_t total = static_cast<size_t>(d0) * d1;
  for (int row = blockIdx.y; row < d0; row += gridDim.y) {
    const size_t idx = static_cast<size_t>(row) * d1 + col;
    const int s = sft[axis == 1 ? row : col];
    if constexpr (kMode == kPrefix)
      gm8::encode_element(x[idx], s, out, total, idx, j1, q_max);
    else if constexpr (kMode == kRange)
      gm8::encode_element_range(x[idx], s, out, total, idx, j0, j1, q_max);
    else
      gm8::encode_element_slots(x[idx], s, out, total, idx, slots, q_max);
  }
}

template <typename Word>
void launch(const void* x, const int* sp, signed char* op, int d0, int d1,
            int axis, int q_max, int j0, int j1, int c0, int c1, bool range,
            const gm8::ModSlots& slots, cudaStream_t s) {
  dim3 grid((c1 - c0 + kThreads - 1) / kThreads, d0 < 65535 ? d0 : 65535);
  auto xp = static_cast<const Word*>(x);
  if (range && j0 == 0)
    encode_kernel<kPrefix, Word><<<grid, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, j0, j1, c0, c1, slots);
  else if (range)
    encode_kernel<kRange, Word><<<grid, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, j0, j1, c0, c1, slots);
  else
    encode_kernel<kSlots, Word><<<grid, kThreads, 0, s>>>(
        xp, sp, op, d0, d1, axis, q_max, j0, j1, c0, c1, slots);
}

}  // namespace

// x: (d0, d1) f64 bits (f32 = 0) or f32 bits (f32 = 1); sft: d0 shifts
// (axis=1) or d1 shifts (axis=0); moduli_idx: n_idx distinct indices into
// the moduli table, on the host; out: (n_idx, d0, d1) int8, slice l for
// modulus moduli_idx[l], written in columns [c0, c1) only. q_max: the
// static left-shift cap max(threshold_accurate - mant_bits, 0) of the
// call's moduli count (mant_bits 53 for f64, 24 for f32).
GM8_EXPORT int gm8_encode_slices(const void* x, const void* sft, void* out,
                                 int d0, int d1, int axis,
                                 const void* moduli_idx, int n_idx,
                                 int q_max, int c0, int c1, int f32,
                                 void* stream) {
  auto idx = static_cast<const int*>(moduli_idx);
  gm8::ModSlots slots;
  if (!gm8::mod_slots(idx, n_idx, &slots) || c0 < 0 || c1 > d1 || c0 >= c1 ||
      q_max < 0 || q_max > (f32 ? 53 : 24))
    return static_cast<int>(cudaErrorInvalidValue);
  bool range = true;
  for (int l = 1; l < n_idx; ++l) range = range && idx[l] == idx[0] + l;
  auto s = static_cast<cudaStream_t>(stream);
  auto sp = static_cast<const int*>(sft);
  auto op = static_cast<signed char*>(out);
  const int j0 = idx[0], j1 = idx[0] + n_idx;
  if (f32)
    launch<unsigned>(x, sp, op, d0, d1, axis, q_max, j0, j1, c0, c1, range,
                     slots, s);
  else
    launch<unsigned long long>(x, sp, op, d0, d1, axis, q_max, j0, j1, c0,
                               c1, range, slots, s);
  return gm8::launch_status();
}
