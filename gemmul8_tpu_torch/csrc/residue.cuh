// Centered residues of one f64 or f32 element (the source word a template
// parameter, src_word.cuh), one remainder chain per modulus:
// out[j * total + idx] = the centered residue of trunc(x * 2^sft) mod m_j as
// int8, for j < num_moduli (encode_element: the fused stats + encode kernel
// of fast_encode_fused.cu). encode.cu and the encode riders of
// matmul_rider.cu run the residue dots on the tensor cores instead
// (encode_mma.cuh). Both start from the element's shifted value
// (src_word.cuh shifted_value).
#pragma once

#include "common.cuh"
#include "src_word.cuh"

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

template <typename Word>
__device__ __forceinline__ void encode_element(Word bits, int sft,
                                               signed char* __restrict__ out,
                                               size_t total, size_t idx,
                                               int num_moduli, int q_max) {
  const Shifted v = shifted_value(bits, sft, q_max);
#define GM8_ENCODE_ONE(J, M)                                                \
  if (J < num_moduli)                                                       \
    out[J * total + idx] =                                                  \
        static_cast<signed char>(centered_residue<M>(v.lo, v.hi, v.neg));
  GM8_FOR_MODULI(GM8_ENCODE_ONE)
#undef GM8_ENCODE_ONE
}

}  // namespace
}  // namespace gm8
