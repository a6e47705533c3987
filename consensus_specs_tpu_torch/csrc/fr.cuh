// BLS12-381 scalar-field (Fr) device arithmetic for the KZG and DAS
// kernels K15-K18 (`fr_batch.cu`).
//
// Replaces, on the device, the limb arithmetic of the JAX package's
// `ops/fr_batch.py:48 PrimeFieldKernel` (carry, add, sub, mul, inv,
// pow_uint, tree_sum) for the modulus r, the BLS12-381 subgroup order.
//
// Representation: `mont.cuh`'s core at 8 x 32-bit words, R = 2^256
// (r < 2^255).  `load_fr` accepts the port's lazy (..., 33) limbs in the
// R = 2^396 domain and `store_fr` writes canonical limbs, equal to
// `FR.canon` of the plain result.
//
// Constants (r, r - 2, the Montgomery one, the boundary conversion
// factors, -r^-1 mod 2^32) are not typed in here: the wrapper computes
// them from the modulus and fills the `__constant__` block once through
// `fr_set_constants`.
#pragma once

#include "mont.cuh"

#define FR_NW 8        // 32-bit words of an Fr
#define FR_NL MONT_NL  // 12-bit limbs of the boundary format

struct FrField {
  static constexpr int NW = FR_NW;
  __device__ __forceinline__ static const MontConsts<FR_NW>& k();
};
using Fr = Mont<FrField>;
using FrConstants = MontConsts<FR_NW>;
static_assert(sizeof(FrConstants) == 57 * 4, "constant block layout");

__constant__ FrConstants FRC;

__device__ __forceinline__ const MontConsts<FR_NW>& FrField::k() {
  return FRC;
}

__device__ __forceinline__ void fr_zero(Fr& a) { mont_zero(a); }
__device__ __forceinline__ void fr_mul(Fr& r, const Fr& a, const Fr& b) {
  mont_mul(r, a, b);
}
__device__ __forceinline__ void fr_add(Fr& r, const Fr& a, const Fr& b) {
  mont_add(r, a, b);
}
__device__ __forceinline__ void fr_sub(Fr& r, const Fr& a, const Fr& b) {
  mont_sub(r, a, b);
}
// a^e, e 8 little-endian words
__device__ __forceinline__ void fr_pow(Fr& r, const Fr& a, const uint32_t* e) {
  mont_pow(r, a, e);
}
// Fermat inversion a^(r-2): 254 squarings and 163 products; 0 -> 0
__device__ __forceinline__ void fr_inv(Fr& r, const Fr& a) { mont_inv(r, a); }
// the same inverse by mont.cuh's binary inversion (512 branch-free steps)
__device__ __forceinline__ void fr_inv_binary(Fr& r, const Fr& a) {
  mont_inv_binary(r, a);
}
// (33,) int32 limbs, value x 2^396 (lazy) -> x 2^256
__device__ __forceinline__ void load_fr(Fr& r, const int32_t* src) {
  mont_load(r, src);
}
// x 2^256 -> canonical limbs of x 2^396 mod r
__device__ __forceinline__ void store_fr(int32_t* dst, const Fr& a) {
  mont_store(dst, a);
}
// The same conversions with one non-inlined copy of the product, for
// kernels whose code would otherwise outgrow the instruction cache (K15's
// batch inverse, K18: a launch that runs each step once pays for fetching
// its code, and inlined products make that code several times larger),
// the load skipping the high product where the limbs are canonical; and
// the store with a scale:
// k = mont(s R, c_out) -> canonical limbs of x s 2^396 mod r, the scale
// and the store in one product.
__device__ __noinline__ void fr_mul_call(Fr& r, const Fr& a, const Fr& b) {
  mont_mul(r, a, b);
}
__device__ __forceinline__ void load_fr_call(Fr& r, const int32_t* src) {
  mont_load_by<FrField, true>(r, src, [](Fr& o, const Fr& a, const Fr& b) {
    fr_mul_call(o, a, b);
  });
}
__device__ __forceinline__ void store_fr_times_call(int32_t* dst, const Fr& a,
                                                    const Fr& k) {
  mont_store_times_by(dst, a, k, [](Fr& o, const Fr& x, const Fr& y) {
    fr_mul_call(o, x, y);
  });
}

static int fr_write_constants(const uint32_t* words, int n_words) {
  if (n_words * 4 != (int)sizeof(FrConstants)) return cudaErrorInvalidValue;
  return cudaMemcpyToSymbol(FRC, words, sizeof(FrConstants));
}
