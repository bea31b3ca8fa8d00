// Residue slices of an f64 operand: out[j] = centered residue of
// trunc(x * 2^sft) mod m_j as int8, for j < num_moduli.
//
// Replaces: encode_slices_pallas, gemmul8_tpu/pallas/kernels.py:691.
// Bound on the H100: device-memory bytes. Per element it reads 8 bytes and
// writes num_moduli bytes (22 bytes at 14 moduli: 1.4 GB at 8192^2, about
// 0.4 ms at 3.35 TB/s); the arithmetic is a few 32-bit remainders by
// constants per modulus.
// Design: elementwise, one thread per element, neighbouring threads on
// neighbouring elements, so every read and each slice's writes coalesce.
// The TPU kernel's byte-plane MXU contraction worked around the TPU's lack
// of fast integer division; here each element is reduced by residue.cuh's
// remainders by compile-time moduli (shared with fast_encode_fused.cu).
#include "common.cuh"
#include "residue.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
encode_kernel(const unsigned long long* __restrict__ x,
              const int* __restrict__ sft, signed char* __restrict__ out,
              int d0, int d1, int axis, int num_moduli, int q_max) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d1) return;
  const size_t total = static_cast<size_t>(d0) * d1;
  for (int row = blockIdx.y; row < d0; row += gridDim.y) {
    const size_t idx = static_cast<size_t>(row) * d1 + col;
    gm8::encode_element(x[idx], sft[axis == 1 ? row : col], out, total, idx,
                        num_moduli, q_max);
  }
}

}  // namespace

// x: (d0, d1) f64 bits; sft: d0 shifts (axis=1) or d1 shifts (axis=0);
// out: (num_moduli, d0, d1) int8. q_max: the static left-shift cap
// max(threshold_accurate - 53, 0).
GM8_EXPORT int gm8_encode_slices(const void* x, const void* sft, void* out,
                                 int d0, int d1, int axis, int num_moduli,
                                 int q_max, void* stream) {
  dim3 grid((d1 + kThreads - 1) / kThreads, d0 < 65535 ? d0 : 65535);
  encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(x), static_cast<const int*>(sft),
      static_cast<signed char*>(out), d0, d1, axis, num_moduli, q_max);
  return gm8::launch_status();
}
