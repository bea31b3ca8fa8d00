// Centered residues of one f64 element: out[j * total + idx] = the centered
// residue of trunc(x * 2^sft) mod m_j as int8, for j < num_moduli. Shared by
// the encode kernel (encode.cu) and the fused stats + encode kernels
// (fast_encode_fused.cu).
//
// The shifted value (at most 79 bits) is held as a 64-bit low word and a
// 32-bit high word and reduced with remainders by compile-time moduli, which
// the compiler turns into multiply-high sequences. The centered residue is
// unique, so any exact reduction gives the bits of the plain version.
#pragma once

#include "common.cuh"

namespace gm8 {
namespace {

template <int M>
__device__ __forceinline__ int centered_residue(unsigned long long lo,
                                                unsigned hi, bool neg) {
  if constexpr (M == 256) {
    // the centered residue mod 256 is the signed value's low byte
    unsigned lob = static_cast<unsigned>(lo) & 0xFFu;
    unsigned sv = neg ? ((256u - lob) & 0xFFu) : lob;
    return static_cast<int>(sv ^ 0x80u) - 0x80;
  } else {
    constexpr unsigned kP32 = static_cast<unsigned>((1ull << 32) % M);
    constexpr unsigned kP64 =
        static_cast<unsigned>((static_cast<unsigned long long>(kP32) * kP32) % M);
    unsigned r = (static_cast<unsigned>(lo) % M +
                  static_cast<unsigned>(lo >> 32) % M * kP32 + hi % M * kP64) % M;
    // odd M: negating the centered residue of |v| gives that of -|v|
    int c = static_cast<int>(r) - (r >= (M + 1) / 2 ? M : 0);
    return neg ? -c : c;
  }
}

// q_max: the static left-shift cap max(threshold_accurate - 53, 0)
__device__ __forceinline__ void encode_element(unsigned long long bits,
                                               int sft,
                                               signed char* __restrict__ out,
                                               size_t total, size_t idx,
                                               int num_moduli, int q_max) {
  const int e = static_cast<int>((bits >> 52) & 0x7FF);
  const bool neg = (bits >> 63) != 0;
  const unsigned long long mant =
      (bits & ((1ull << 52) - 1)) | (e > 0 ? (1ull << 52) : 0ull);
  const int q = max(e, 1) - 1075 + sft;
  // v = trunc(mant * 2^q) = hi * 2^64 + lo, left shift capped at q_max
  unsigned long long lo;
  unsigned hi = 0;
  if (q < 0) {
    lo = mant >> min(-q, 63);
  } else {
    const int ql = min(q, q_max);
    lo = mant << ql;
    if (ql > 0) hi = static_cast<unsigned>(mant >> (64 - ql));
  }
#define GM8_ENCODE_ONE(J, M)                                                \
  if (J < num_moduli)                                                       \
    out[J * total + idx] =                                                  \
        static_cast<signed char>(centered_residue<M>(lo, hi, neg));
  GM8_FOR_MODULI(GM8_ENCODE_ONE)
#undef GM8_ENCODE_ONE
}

}  // namespace
}  // namespace gm8
