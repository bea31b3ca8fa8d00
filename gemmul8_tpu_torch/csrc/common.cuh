// Shared helpers for the Hopper kernels of gemmul8_tpu_torch.
//
// Built by gemmul8_tpu_torch/hopper/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
// into one shared library with a plain C interface. Every entry point
// selects the caller's device, launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GM8_EXPORT extern "C" __attribute__((visibility("default")))

// X(index, modulus) for the 20 pairwise-coprime moduli, in table order
// (gemmul8_tpu_torch/tables.py MODULI).
#define GM8_FOR_MODULI(X)                                                   \
  X(0, 256) X(1, 255) X(2, 253) X(3, 251) X(4, 247) X(5, 241) X(6, 239)     \
  X(7, 233) X(8, 229) X(9, 227) X(10, 223) X(11, 217) X(12, 211)            \
  X(13, 199) X(14, 197) X(15, 193) X(16, 191) X(17, 181) X(18, 179)         \
  X(19, 173)

namespace gm8 {

constexpr int kMaxModuli = 20;

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// four bytes into one word, byte i from the low byte of ri
__device__ __forceinline__ unsigned pack4(unsigned r0, unsigned r1,
                                          unsigned r2, unsigned r3) {
  return __byte_perm(__byte_perm(r0, r1, 0x0040), __byte_perm(r2, r3, 0x0040),
                     0x5410);
}

// c += a (16 x 32, row) x b (32 x 8, col), s8 x s8 -> s32: the CRT
// contraction of crt_mma.cuh
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace gm8
