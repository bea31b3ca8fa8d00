// Centered residues of one f64 or f32 element (the source word a template
// parameter, src_word.cuh): out[j * total + idx] = the centered
// residue of trunc(x * 2^sft) mod m_j as int8, for j < num_moduli
// (encode_element: the fused stats + encode kernels of fast_encode_fused.cu),
// out[(j - j0) * total + idx] for j0 <= j < j1 (encode_element_range: the
// encode kernel of encode.cu on all the moduli or on one chunk of a
// moduli-chunked call), or out[slot * total + idx] for the moduli a ModSlots
// gives a slot (encode_element_slots: any tuple of distinct moduli in the
// caller's order). The kernel is bound by its integer work, not by bytes,
// so the first two keep each slice's offset a compile-time multiple of
// `total` and stop at the first modulus past the call's; the slots form
// evaluates all 20 conditions and multiplies a run-time slot by `total`.
// At 8192^2, A and B, 13 of 14 moduli, NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 5s): 2.48 ms the first form, 2.79 the range, 3.59
// the slots.
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

// moduli j0 <= j < j1 into slices 0 .. j1 - j0 - 1
template <typename Word>
__device__ __forceinline__ void encode_element_range(
    Word bits, int sft, signed char* __restrict__ out, size_t total,
    size_t idx, int j0, int j1, int q_max) {
  const Shifted v = shifted_value(bits, sft, q_max);
  // J * total + off == (J - j0) * total + idx in size_t's modular arithmetic
  const size_t off = idx - j0 * total;
  // the return past j1 lets the moduli behind the chunk cost nothing, as
  // the monotone J < num_moduli of encode_element does
#define GM8_ENCODE_ONE(J, M)                                                \
  if (J >= j1) return;                                                      \
  if (J >= j0)                                                              \
    out[J * total + off] =                                                  \
        static_cast<signed char>(centered_residue<M>(v.lo, v.hi, v.neg));
  GM8_FOR_MODULI(GM8_ENCODE_ONE)
#undef GM8_ENCODE_ONE
}

// the output slot of each modulus of the table, -1 for a modulus the call
// leaves out
struct ModSlots {
  int s[kMaxModuli];
};

// idx: n distinct indices into the moduli table; output slot l holds
// modulus idx[l]. False when n or an index is out of range or repeated.
inline bool mod_slots(const int* idx, int n, ModSlots* out) {
  if (n < 1 || n > kMaxModuli) return false;
  for (int j = 0; j < kMaxModuli; ++j) out->s[j] = -1;
  for (int l = 0; l < n; ++l) {
    const int j = idx[l];
    if (j < 0 || j >= kMaxModuli || out->s[j] >= 0) return false;
    out->s[j] = l;
  }
  return true;
}

template <typename Word>
__device__ __forceinline__ void encode_element_slots(
    Word bits, int sft, signed char* __restrict__ out, size_t total,
    size_t idx, const ModSlots& slots, int q_max) {
  const Shifted v = shifted_value(bits, sft, q_max);
#define GM8_ENCODE_ONE(J, M)                                                \
  if (slots.s[J] >= 0)                                                      \
    out[slots.s[J] * total + idx] =                                         \
        static_cast<signed char>(centered_residue<M>(v.lo, v.hi, v.neg));
  GM8_FOR_MODULI(GM8_ENCODE_ONE)
#undef GM8_ENCODE_ONE
}

}  // namespace
}  // namespace gm8
