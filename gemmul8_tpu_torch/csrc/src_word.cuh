// The IEEE fields of an operand's source word: unsigned long long holds the
// bits of an f64 (11 exponent bits, 52 stored mantissa bits, bias 1023),
// unsigned those of an f32 (8, 23, bias 127). The stats, encode and
// magnitude bodies take the word type as a template parameter and read
// the fields through Src<Word>, so each kernel has an f64 and an f32 form
// with one body; the value of a word is (-1)^sign * mant * 2^(max(e, 1) -
// kMantShift), mant with the implicit bit where e > 0, as the JAX
// package's _f64_fields / _f32_fields define it (subnormal-exact).
// shifted_value is the encode's integer trunc(x * 2^sft) of a word, which
// the tensor-core contraction (encode_mma.cuh) reduces.
#pragma once

#include "common.cuh"

namespace gm8 {

template <typename Word>
struct Src;

template <>
struct Src<unsigned long long> {
  static constexpr int kStored = 52;       // stored mantissa bits
  static constexpr int kExpMask = 0x7FF;
  static constexpr int kBias = 1023;
  static constexpr int kMantShift = 1075;  // bias + stored bits
  __device__ __forceinline__ static int biased_exp(unsigned long long b) {
    return static_cast<int>((b >> kStored) & kExpMask);
  }
  // the significand with its implicit bit (53 bits), as a 64-bit word
  __device__ __forceinline__ static unsigned long long mant(
      unsigned long long b) {
    return (b & ((1ull << kStored) - 1)) |
           (biased_exp(b) > 0 ? (1ull << kStored) : 0ull);
  }
  __device__ __forceinline__ static bool neg(unsigned long long b) {
    return (b >> 63) != 0;
  }
};

template <>
struct Src<unsigned> {
  static constexpr int kStored = 23;
  static constexpr int kExpMask = 0xFF;
  static constexpr int kBias = 127;
  static constexpr int kMantShift = 150;
  __device__ __forceinline__ static int biased_exp(unsigned b) {
    return static_cast<int>((b >> kStored) & kExpMask);
  }
  // the 24-bit significand, widened to 64 bits
  __device__ __forceinline__ static unsigned long long mant(unsigned b) {
    return (b & ((1u << kStored) - 1)) |
           (biased_exp(b) > 0 ? (1u << kStored) : 0u);
  }
  __device__ __forceinline__ static bool neg(unsigned b) {
    return (b >> 31) != 0;
  }
};

// |trunc(x * 2^sft)| = hi * 2^64 + lo and its sign, from x's f64 or f32
// bits; q_max: the static left-shift cap max(threshold_accurate -
// mant_bits, 0), at most 24 for f64 and 53 for f32 (20 moduli), so the
// value has at most 77 bits
struct Shifted {
  unsigned long long lo;
  unsigned hi;
  bool neg;
};

template <typename Word>
__device__ __forceinline__ Shifted shifted_value(Word bits, int sft,
                                                 int q_max) {
  using S = Src<Word>;
  const unsigned long long mant = S::mant(bits);
  const int q = max(S::biased_exp(bits), 1) - S::kMantShift + sft;
  Shifted v{0, 0, S::neg(bits)};
  if (q < 0) {
    v.lo = mant >> min(-q, 63);
  } else {
    const int ql = min(q, q_max);
    v.lo = mant << ql;
    if (ql > 0) v.hi = static_cast<unsigned>(mant >> (64 - ql));
  }
  return v;
}

}  // namespace gm8
