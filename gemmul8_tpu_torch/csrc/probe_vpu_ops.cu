// Dependent op chains for the card's CUDA-core rates: out = steps x 16
// dependent ops b = op(b, a, i) applied to b = a = x, per element.
//
// Replaces: the Pallas kernel of scripts/probe_vpu_ops.py main (:26, its
// call :60): a (512, 512) block resident in fast memory while a sequential
// grid of 2048 steps applies 16 unrolled ops per step.
// Bound on the H100: the chain's instructions at the arithmetic throughput
// of compute capability 9.0 (CUDA C++ Programming Guide, results per clock
// an SM: 32-bit integer add, multiply-add, shift and logic 64; f32 add and
// multiply 128; type conversions 16), times 132 SMs and the SM clock.
// Memory is touched once a thread.
// Design: the TPU's sequential grid becomes a loop inside each thread, the
// element in registers; one thread an element, so 262,144 threads fill the
// card about once. The compiler folds wrapping integer chains (sixteen
// multiplies by constants into one, sixteen adds of a into one
// multiply-add), so each integer op is an asm volatile PTX instruction on
// operands it cannot see through: the constants 2i + 179 arrive as kernel
// parameters. The f32 ops are the _rn intrinsics, never contracted (the
// build also passes -fmad=false); f32 -> int32 is cvt.rzi.s32.f32, which
// saturates, as the plain version does explicitly. One kernel a case, each
// with its own unmangled name (gm8_vpu_<case>), so the SASS of each chain
// can be counted (cuobjdump -sass).
#include "common.cuh"

namespace gm8 {

constexpr int kVpuThreads = 256;
constexpr int kReps = 16;

struct ChainArgs {
  int ic[kReps];      // 2 i + 179
  float mac_b, mac_a; // 1.0001, 1e-6
  float third, k;     // 1/3, 2.9999
  float cvt;          // 1.5
};

enum Case {
  kMul, kConstMul, kConstMac, kAdd, kShrXor,
  kFMul, kFConstMac, kFFloor, kCvt, kCases
};

namespace {

template <int kCase>
__device__ __forceinline__ void chain(const unsigned* __restrict__ x,
                                      unsigned* __restrict__ out, int n,
                                      int steps, const ChainArgs& C) {
  const int i = blockIdx.x * kVpuThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned xa = x[i];
  if constexpr (kCase <= kShrXor || kCase == kCvt) {
    const int a = static_cast<int>(xa);
    int b = a;
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int r = 0; r < kReps; ++r) {
        if constexpr (kCase == kMul)
          asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(b) : "r"(a));
        else if constexpr (kCase == kConstMul)
          asm volatile("mul.lo.s32 %0, %0, %1;" : "+r"(b) : "r"(C.ic[r]));
        else if constexpr (kCase == kConstMac)
          asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                       : "+r"(b) : "r"(C.ic[r]), "r"(a));
        else if constexpr (kCase == kAdd)
          asm volatile("add.s32 %0, %0, %1;" : "+r"(b) : "r"(a));
        else if constexpr (kCase == kShrXor)
          asm volatile("shr.s32 %0, %0, 1;\n\txor.b32 %0, %0, %1;"
                       : "+r"(b) : "r"(a));
        else  // kCvt: trunc(f32(b) * 1.5), saturated, xor a
          b = __float2int_rz(__fmul_rn(__int2float_rn(b), C.cvt)) ^ a;
      }
    }
    out[i] = static_cast<unsigned>(b);
  } else {
    const float a = __uint_as_float(xa);
    float b = a;
    const float am = __fmul_rn(a, C.mac_a);  // loop-invariant in the body
#pragma unroll 1
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int r = 0; r < kReps; ++r) {
        if constexpr (kCase == kFMul)
          b = __fmul_rn(b, a);
        else if constexpr (kCase == kFConstMac)
          b = __fadd_rn(__fmul_rn(b, C.mac_b), am);
        else  // kFFloor
          b = __fsub_rn(b, __fmul_rn(floorf(__fmul_rn(b, C.third)), C.k));
      }
    }
    out[i] = __float_as_uint(b);
  }
}

}  // namespace
}  // namespace gm8

// one kernel a case, at global scope with C names for the SASS listing
#define GM8_VPU_KERNEL(NAME, CASE)                                          \
  extern "C" __global__ void __launch_bounds__(gm8::kVpuThreads)          \
      gm8_vpu_##NAME(const unsigned* __restrict__ x,                        \
                     unsigned* __restrict__ out, int n, int steps,          \
                     const gm8::ChainArgs C) {                              \
    gm8::chain<gm8::CASE>(x, out, n, steps, C);                             \
  }

GM8_VPU_KERNEL(i32_mul, kMul)
GM8_VPU_KERNEL(i32_constmul, kConstMul)
GM8_VPU_KERNEL(i32_constmac, kConstMac)
GM8_VPU_KERNEL(i32_add, kAdd)
GM8_VPU_KERNEL(i32_shrxor, kShrXor)
GM8_VPU_KERNEL(f32_mul, kFMul)
GM8_VPU_KERNEL(f32_constmac, kFConstMac)
GM8_VPU_KERNEL(f32_floor, kFFloor)
GM8_VPU_KERNEL(f32_cvt, kCvt)
#undef GM8_VPU_KERNEL

namespace {

using KernelFn = void (*)(const unsigned*, unsigned*, int, int,
                          const gm8::ChainArgs);
const KernelFn kKernels[gm8::kCases] = {
    gm8_vpu_i32_mul,    gm8_vpu_i32_constmul, gm8_vpu_i32_constmac,
    gm8_vpu_i32_add,    gm8_vpu_i32_shrxor,   gm8_vpu_f32_mul,
    gm8_vpu_f32_constmac, gm8_vpu_f32_floor,  gm8_vpu_f32_cvt};

}  // namespace

// x, out: n 4-byte words (int32, or float32 bits for the f32 cases 5-7);
// op_case: index into probes/vpu_ops.py CASES; steps of 16 ops each.
GM8_EXPORT int gm8_probe_vpu_ops(const void* x, void* out, int n,
                                 int op_case, int steps, void* stream) {
  using gm8::kVpuThreads;
  if (n < 1 || op_case < 0 || op_case >= gm8::kCases || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  gm8::ChainArgs C;
  for (int r = 0; r < gm8::kReps; ++r) C.ic[r] = 2 * r + 179;
  C.mac_b = 1.0001f;
  C.mac_a = 1e-6f;
  C.third = static_cast<float>(1.0 / 3.0);
  C.k = 2.9999f;
  C.cvt = 1.5f;
  kKernels[op_case]<<<(n + kVpuThreads - 1) / kVpuThreads, kVpuThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<unsigned*>(out), n, steps,
      C);
  return gm8::launch_status();
}
