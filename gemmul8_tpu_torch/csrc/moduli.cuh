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

// The CRT constants of the first L moduli (crt.cuh, crt_tail.cuh), built
// on the host (hopper/kernels.py crt_table_bytes): the weights and M as
// kWords 32-bit words, X < 255 * 20 * M < 2^170 fitting six.
constexpr int kWords = 6;

struct CrtTable {
  unsigned w[kMaxModuli][kWords];  // CRT weights, 32-bit words
  unsigned big_m[kWords];          // M
  unsigned half1[kWords];          // floor(M / 2) + 1
  double rinv;                     // 1 / M, rounded
  int pad[2];
};

// canonical residue in [0, mod) of an int32 product; the 256 lane's
// accumulator may have wrapped at 2^31, a multiple of 256
__device__ __forceinline__ int mod_canon(int x, int mod) {
  if (mod == 256) return x & 255;
  const int r = x % mod;
  return r < 0 ? r + mod : r;
}

// Exact residue by multiply and shift (Granlund and Montgomery, "Division
// by invariant integers using multiplication", 1994, Fig. 4.1): for a
// uint32 u and a divisor d in [2, 2^31] with l = ceil(log2 d),
//   mul = floor(2^32 (2^l - d) / d) + 1,  t = mulhi(mul, u),
//   q = (t + ((u - t) >> 1)) >> (l - 1) = floor(u / d),
// for every u. An int32 x enters as u = x + 2^31 (its sign bit flipped),
// so its canonical residue is (u - q d + off) reduced once more, with
// off = (-2^31) mod d. For d = 256: mul = 1 and q = u >> 8, the residue
// x & 255. Built on the host per slot and passed by value beside the
// slot's modulus; gemmul8_tpu_torch/hopper/matmul.py mod_divisor is the
// same arithmetic, held to Python's % by the tests.
struct ModDivisor {
  int d;          // the modulus
  unsigned mul;   // the multiplier
  int sh;         // l - 1
  unsigned off;   // (-2^31) mod d
};

struct SlotDivisors {
  ModDivisor v[kMaxModuli];  // slot l's; d = 0 past the call's slots
};

// With a bias c, off = (-2^31 - c) mod d: mod_div then gives the residue
// of x - c, for an accumulator that started at c (matmul_complex.cu's Im
// chain).
inline ModDivisor mod_divisor(int d, long long bias = 0) {
  int l = 0;
  while ((1ull << l) < static_cast<unsigned long long>(d)) ++l;
  ModDivisor r;
  r.d = d;
  r.mul = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  r.sh = l - 1;
  const long long off = (-(1ll << 31) - bias) % d;
  r.off = static_cast<unsigned>(off < 0 ? off + d : off);
  return r;
}

inline SlotDivisors slot_divisors(const SlotModuli& mods,
                                  long long bias = 0) {
  SlotDivisors out;
  for (int l = 0; l < kMaxModuli; ++l) {
    out.v[l] = mods.m[l] ? mod_divisor(mods.m[l], bias)
                         : ModDivisor{0, 0, 0, 0};
  }
  return out;
}

// canonical residue in [0, d) of any int32 x: the value of mod_canon(x, d)
// in a short fixed sequence (mulhi, two adds, two shifts, a multiply-add
// and an unsigned min) in place of a division by a runtime divisor
__device__ __forceinline__ unsigned mod_div(int x, const ModDivisor& v) {
  const unsigned u = static_cast<unsigned>(x) ^ 0x80000000u;
  const unsigned t = __umulhi(v.mul, u);
  const unsigned q = (t + ((u - t) >> 1)) >> v.sh;
  const unsigned r = u - q * static_cast<unsigned>(v.d) + v.off;  // < 2 d
  return min(r, r - static_cast<unsigned>(v.d));
}

}  // namespace gm8
