// The moduli of a call's slots. A kernel that works on a subset of the
// moduli (the moduli-chunked schedule) gets, by value, the modulus of each
// of its operand slots: slot l holds modulus MODULI[moduli_idx[l]]. The
// struct is built on the host from the caller's index list, so the kernels
// read one kernel-parameter word and need no table of their own.
#pragma once

#include "common.cuh"

namespace gm8 {

constexpr int kModuli[kMaxModuli] = {
#define GM8_MOD_VALUE(J, M) M,
    GM8_FOR_MODULI(GM8_MOD_VALUE)
#undef GM8_MOD_VALUE
};

struct SlotModuli {
  int m[kMaxModuli];  // modulus of slot l; 0 past the call's slots
};

// idx: n indices into the moduli table, or null for 0..n-1. False when n
// or an index is out of range.
inline bool slot_moduli(const int* idx, int n, SlotModuli* out) {
  if (n < 1 || n > kMaxModuli) return false;
  for (int l = 0; l < kMaxModuli; ++l) out->m[l] = 0;
  for (int l = 0; l < n; ++l) {
    const int j = idx ? idx[l] : l;
    if (j < 0 || j >= kMaxModuli) return false;
    out->m[l] = kModuli[j];
  }
  return true;
}

// canonical residue in [0, mod) of an int32 product; the 256 lane's
// accumulator may have wrapped at 2^31, a multiple of 256
__device__ __forceinline__ int mod_canon(int x, int mod) {
  if (mod == 256) return x & 255;
  const int r = x % mod;
  return r < 0 ? r + mod : r;
}

}  // namespace gm8
