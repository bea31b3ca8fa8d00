// Count leading zeros of int32 words: out = clz(x) (32 for 0, 0 for a
// negative word).
//
// Replaces: the Pallas kernel of scripts/probe_clz.py main (:20, its call
// :26), lax.clz on a (256, 256) int32 block.
// Bound on the H100: device-memory bytes (4 read and 4 written a word);
// __clz issues at 16 a clock an SM, far above that.
// Design: one word a thread, a grid-stride loop. Two forms, which the
// probe times against each other: __clz (form 0, any word) and the
// f32-exponent trick that lax.clz replaced in the JAX package's msb scan
// (form 1): convert the word to f32 and read the exponent field, exact for
// words below 2^24 (16-bit limbs), which the wrapper checks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int kForm>
__global__ void __launch_bounds__(kThreads)
clz_kernel(const int* __restrict__ x, int* __restrict__ out, int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const int v = x[i];
    int c;
    if constexpr (kForm == 0) {
      c = __clz(v);
    } else {
      // exponent field of the exact f32 value: bit length - 1 + 127
      const int e = static_cast<int>(__float_as_uint(__int2float_rn(v)) >> 23);
      c = v == 0 ? 32 : 158 - e;
    }
    out[i] = c;
  }
}

}  // namespace

// x, out: n int32 words on the device; form 0: __clz, 1: the exponent
// trick (words in [0, 2^24)).
GM8_EXPORT int gm8_probe_clz(const void* x, void* out, int n, int form,
                             void* stream) {
  if (n < 0 || (form != 0 && form != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int need = (n + kThreads - 1) / kThreads;
  const int blocks = need < 132 * 16 ? need : 132 * 16;
  auto xp = static_cast<const int*>(x);
  auto op = static_cast<int*>(out);
  if (form == 0)
    clz_kernel<0><<<blocks, kThreads, 0, s>>>(xp, op, n);
  else
    clz_kernel<1><<<blocks, kThreads, 0, s>>>(xp, op, n);
  return gm8::launch_status();
}
