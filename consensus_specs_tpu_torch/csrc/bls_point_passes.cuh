// The group point passes: T <- 2T and T <- T + Q for an affine Q, as
// rounds of independent products that the ranks of a group share.  Two
// callers drive them: the Miller passes of `bls_rlc_body.cuh` (K9, K25,
// K26; F = Fp2, one Fq2 product a rank beside the line's and f^2's
// products) and K8 `rlc_scalar_mul` (`bls_rlc.cu`; F = Fp2 with each Fq2
// product's three Karatsuba Fp products on three ranks, and F = Fp).
//
// A round's products read only earlier rounds' results, so a caller runs
// product j of round k on its own rank: `pt_dbl_operands` /
// `pt_add_operands` pick the operands of product j (a few additions) and
// name the slot its result goes to, and every rank then calls the same
// product, which keeps a warp converged.  After the last round one rank
// runs the finish (additions only, and the addition's special cases).
//
//   T <- 2T  (pt_double_body's point, dbl-2007-bl): X^2, Y^2, Y Z; then
//            C = Y^4, X Y^2, F = E^2 (E = 3 X^2); then E (D - X3) with
//            D = 4 X Y^2, X3 = F - 2D.  Finish: Y3 = E (D - X3) - 8C,
//            Z3 = 2 Y Z.  T at infinity (Z = 0) stays at Z3 = 0.
//   T <- T + Q  (pt_add's point with Z2 = 1: U1 = X, S1 = Y): Z^2; Z^3,
//            U2 = xq Z^2; S2 = yq Z^3, Z H (H = U2 - X), I = (2H)^2;
//            J = H I, V = X I; rr^2 (rr = 2 (S2 - Y)), S1 J;
//            rr (V - X3) with X3 = rr^2 - J - 2V.  Finish with pt_add's
//            cases: T at infinity gives Q, H = 0 doubles T (rr = 0) or
//            gives infinity, else Y3 = rr (V - X3) - 2 S1 J, Z3 = 2 Z H.
// Every value is canonical (`mont.cuh`), so these formulas give the bits
// of curve_jax.py's pt_double and pt_add.
#pragma once

#include "bls12_381.cuh"

// temporaries of the doubling and of the addition (the two never live at
// once, so their slots overlap)
enum { pXX, pYY, pYZ, pC, pXYY, pF, pEDX };
enum { pZZ, pZZZ, pU2, pS2, pZH, pI, pJ, pV, pRR, pYJ, pY3, kPtTemps };

#define PT_DBL_ROUNDS 3
#define PT_ADD_ROUNDS 6

template <class F> struct GroupPoint {
  F X, Y, Z;            // T, Jacobian
  F xq, yq;             // Q, affine
  F t[kPtTemps];
};

__device__ __forceinline__ int pt_dbl_products(int k) { return k < 2 ? 3 : 1; }
__device__ __forceinline__ int pt_add_products(int k) {
  return k == 2 ? 3 : (k == 0 || k == 5 ? 1 : 2);
}

template <class F>
__device__ __forceinline__ void pt_set_infinity(GroupPoint<F>& P) {
  f_one(P.X);
  f_one(P.Y);
  f_zero(P.Z);
}

// product j < pt_dbl_products(k) of doubling round k: its operands, and
// the slot of its result
template <class F>
__device__ __forceinline__ F* pt_dbl_operands(GroupPoint<F>& P, int k, int j,
                                              F& a, F& b) {
  F* t = P.t;
  if (k == 0) {                             // X^2, Y^2, Y Z
    a = j == 0 ? P.X : P.Y;
    b = j == 0 ? P.X : (j == 1 ? P.Y : P.Z);
    return &t[pXX + j];
  }
  if (k == 1) {                             // C = Y^4, X Y^2, F = E^2
    if (j == 0) {
      a = t[pYY];
      b = a;
    } else if (j == 1) {
      a = P.X;
      b = t[pYY];
    } else {
      f_triple(a, t[pXX]);
      b = a;
    }
    return &t[pC + j];
  }
  F u, v;                                   // E (D - X3)
  f_dbl(u, t[pXYY]);
  f_dbl(u, u);
  f_dbl(v, u);
  f_sub(v, t[pF], v);
  f_sub(b, u, v);
  f_triple(a, t[pXX]);
  return &t[pEDX];
}

// after the doubling's rounds: X3 = F - 8 X Y^2, Y3 = E (D - X3) - 8C,
// Z3 = 2 Y Z
template <class F>
__device__ __forceinline__ void pt_dbl_finish(GroupPoint<F>& P) {
  F* t = P.t;
  F u, x3;
  f_dbl(u, t[pXYY]);
  f_dbl(u, u);
  f_dbl(u, u);
  f_sub(x3, t[pF], u);
  f_dbl(u, t[pC]);
  f_dbl(u, u);
  f_dbl(u, u);
  f_sub(P.Y, t[pEDX], u);
  P.X = x3;
  f_dbl(P.Z, t[pYZ]);
}

// product j < pt_add_products(k) of addition round k
template <class F>
__device__ __forceinline__ F* pt_add_operands(GroupPoint<F>& P, int k, int j,
                                              F& a, F& b) {
  F* t = P.t;
  switch (k) {
    case 0:                                 // Z^2
      a = P.Z;
      b = P.Z;
      return &t[pZZ];
    case 1:                                 // Z^3, U2 = xq Z^2
      a = j == 0 ? t[pZZ] : P.xq;
      b = j == 0 ? P.Z : t[pZZ];
      return &t[j == 0 ? pZZZ : pU2];
    case 2:
      if (j == 0) {                         // S2 = yq Z^3
        a = P.yq;
        b = t[pZZZ];
        return &t[pS2];
      }
      if (j == 1) {                         // Z (X - U2) = -Z H
        a = P.Z;
        f_sub(b, P.X, t[pU2]);
        return &t[pZH];
      }
      f_sub(a, t[pU2], P.X);                // I = (2H)^2
      f_dbl(a, a);
      b = a;
      return &t[pI];
    case 3:
      if (j == 0) {                         // J = H I
        f_sub(a, t[pU2], P.X);
        b = t[pI];
        return &t[pJ];
      }
      a = P.X;                              // V = U1 I
      b = t[pI];
      return &t[pV];
    case 4:
      if (j == 0) {                         // rr^2
        f_sub(a, t[pS2], P.Y);
        f_dbl(a, a);
        b = a;
        return &t[pRR];
      }
      a = P.Y;                              // S1 J
      b = t[pJ];
      return &t[pYJ];
    default: {                              // rr (V - X3)
      F x3, v;
      f_dbl(v, t[pV]);
      f_sub(x3, t[pRR], t[pJ]);
      f_sub(x3, x3, v);
      f_sub(b, t[pV], x3);
      f_sub(a, t[pS2], P.Y);
      f_dbl(a, a);
      return &t[pY3];
    }
  }
}

// after the addition's rounds, with pt_add's cases (T at infinity gives
// Q; H = 0 doubles T or gives infinity)
template <class F>
__device__ __noinline__ void pt_add_finish(GroupPoint<F>& P) {
  F* t = P.t;
  if (f_is_zero(P.Z)) {
    P.X = P.xq;
    P.Y = P.yq;
    f_one(P.Z);
    return;
  }
  F h, u;
  f_sub(h, t[pU2], P.X);
  if (f_is_zero(h)) {
    Jac<F> T;
    T.x = P.X;
    T.y = P.Y;
    T.z = P.Z;
    f_sub(u, t[pS2], P.Y);
    if (f_is_zero(u)) pt_double_body(T, T);
    else pt_infinity(T);
    P.X = T.x;
    P.Y = T.y;
    P.Z = T.z;
    return;
  }
  F x3;
  f_dbl(u, t[pV]);
  f_sub(x3, t[pRR], t[pJ]);
  f_sub(x3, x3, u);                         // X3 = rr^2 - J - 2V
  f_dbl(u, t[pYJ]);
  f_sub(P.Y, t[pY3], u);                    // Y3 = rr (V - X3) - 2 S1 J
  P.X = x3;
  f_dbl(u, t[pZH]);
  f_neg(P.Z, u);                            // Z3 = 2 Z H = -2 Z (X - U2)
}
