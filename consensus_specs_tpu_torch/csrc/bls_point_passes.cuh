// The group point passes: T <- 2T, T <- T + Q for an affine Q, and
// T <- T + Q for a Jacobian Q, as rounds of independent products that
// the ranks of a group share.  Three callers drive them: the Miller
// passes of `bls_rlc_body.cuh` (K9, K25, K26; F = Fp2, one Fq2 product a
// rank beside the line's and f^2's products), K8 `rlc_scalar_mul`
// (`bls_rlc.cu`; F = Fp2 with each Fq2 product's three Karatsuba Fp
// products on three ranks, and F = Fp), and K19 and K20 (`g1_fft.cu`;
// F = Fp, the doubling and the general addition).
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
//   T <- T + Q  (pt_add, add-2007-bl, Q Jacobian): Z1^2, Z2^2, Z1 Z2;
//            U1 = X1 Z2^2, U2 = X2 Z1^2, Z1^3, Z2^3; S1 = Y1 Z2^3,
//            S2 = Y2 Z1^3, I = (2H)^2, Z1 Z2 H (H = U2 - U1); J = H I,
//            V = U1 I, rr^2 (rr = 2 (S2 - S1)); S1 J, rr (V - X3) with
//            X3 = rr^2 - J - 2V.  Finish with pt_add's cases in its
//            order: Q at infinity keeps T, T at infinity gives Q, H = 0
//            gives infinity (S1 != S2) or asks the caller for a doubling
//            pass (S1 = S2), else Y3 = rr (V - X3) - 2 S1 J and
//            Z3 = 2 Z1 Z2 H, which is add-2007-bl's
//            ((Z1 + Z2)^2 - Z1^2 - Z2^2) H.
// Every value is canonical (`mont.cuh`), so these formulas give the bits
// of curve_jax.py's pt_double and pt_add.
#pragma once

#include "bls12_381.cuh"

// temporaries of the doubling and of the additions (the passes never
// live at once, so their slots overlap)
enum { pXX, pYY, pYZ, pC, pXYY, pF, pEDX };
enum { pZZ, pZZZ, pU2, pS2, pZH, pI, pJ, pV, pRR, pYJ, pY3, kPtTemps };
enum { gZ1Z1, gZ2Z2, gZ1Z2, gU1, gU2, gZ1C, gZ2C, gS1, gS2, gI, gZH, gJ,
       gV, gRR, gSJ, gY3, kGaddTemps };

#define PT_DBL_ROUNDS 3
#define PT_ADD_ROUNDS 6
#define PT_GADD_ROUNDS 5
#define PT_GADD_WIDTH 4       // the most products of a round

template <class F> struct GroupPoint {
  F X, Y, Z;            // T, Jacobian
  F xq, yq;             // Q, affine
  F t[kPtTemps];
};

// the general addition's point: T and the temporaries; Q (Jacobian) is
// the caller's
template <class F> struct GroupJac {
  F X, Y, Z;            // T, Jacobian
  F t[kGaddTemps];
};

__device__ __forceinline__ int pt_dbl_products(int k) { return k < 2 ? 3 : 1; }
__device__ __forceinline__ int pt_add_products(int k) {
  return k == 2 ? 3 : (k == 0 || k == 5 ? 1 : 2);
}
__device__ __forceinline__ int pt_gadd_products(int k) {
  return k == 1 || k == 2 ? 4 : (k == 4 ? 2 : 3);
}

template <template <class> class P_t, class F>
__device__ __forceinline__ void pt_set_infinity(P_t<F>& P) {
  f_one(P.X);
  f_one(P.Y);
  f_zero(P.Z);
}

// product j < pt_dbl_products(k) of doubling round k: its operands, and
// the slot of its result
template <template <class> class P_t, class F>
__device__ __forceinline__ F* pt_dbl_operands(P_t<F>& P, int k, int j, F& a,
                                              F& b) {
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
template <template <class> class P_t, class F>
__device__ __forceinline__ void pt_dbl_finish(P_t<F>& P) {
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

// product j < pt_gadd_products(k) of general-addition round k
template <class F>
__device__ __forceinline__ F* pt_gadd_operands(GroupJac<F>& P,
                                               const Jac<F>& Q, int k, int j,
                                               F& a, F& b) {
  F* t = P.t;
  switch (k) {
    case 0: {                               // Z1^2, Z2^2, Z1 Z2
      static_assert(gZ2Z2 == gZ1Z1 + 1 && gZ1Z2 == gZ1Z1 + 2, "slots");
      a = j == 1 ? Q.z : P.Z;
      b = j == 0 ? P.Z : Q.z;
      return &t[gZ1Z1 + j];
    }
    case 1:                                 // U1, U2, Z1^3, Z2^3
      static_assert(gU2 == gU1 + 1 && gZ1C == gU1 + 2 && gZ2C == gU1 + 3,
                    "slots");
      a = j == 0 ? P.X : (j == 1 ? Q.x : (j == 2 ? t[gZ1Z1] : t[gZ2Z2]));
      b = j == 0 ? t[gZ2Z2] : (j == 1 ? t[gZ1Z1] : (j == 2 ? P.Z : Q.z));
      return &t[gU1 + j];
    case 2:
      if (j < 2) {                          // S1 = Y1 Z2^3, S2 = Y2 Z1^3
        a = j == 0 ? P.Y : Q.y;
        b = j == 0 ? t[gZ2C] : t[gZ1C];
        return &t[gS1 + j];
      }
      f_sub(b, t[gU2], t[gU1]);             // H
      if (j == 2) {                         // I = (2H)^2
        f_dbl(b, b);
        a = b;
        return &t[gI];
      }
      a = t[gZ1Z2];                         // Z1 Z2 H
      return &t[gZH];
    case 3:
      if (j < 2) {                          // J = H I, V = U1 I
        if (j == 0) f_sub(a, t[gU2], t[gU1]);
        else a = t[gU1];
        b = t[gI];
        return &t[gJ + j];
      }
      f_sub(a, t[gS2], t[gS1]);             // rr^2
      f_dbl(a, a);
      b = a;
      return &t[gRR];
    default: {
      if (j == 0) {                         // S1 J
        a = t[gS1];
        b = t[gJ];
        return &t[gSJ];
      }
      F x3, v;                              // rr (V - X3)
      f_dbl(v, t[gV]);
      f_sub(x3, t[gRR], t[gJ]);
      f_sub(x3, x3, v);
      f_sub(b, t[gV], x3);
      f_sub(a, t[gS2], t[gS1]);
      f_dbl(a, a);
      return &t[gY3];
    }
  }
}

// after the general addition's rounds (run only where T and Q are both
// finite), or in their place where either is at infinity, with
// pt_add's cases in its order.  Returns true where T = Q: T is left as
// it was, for the caller's doubling pass.
template <class F>
__device__ __noinline__ bool pt_gadd_finish(GroupJac<F>& P, const Jac<F>& Q) {
  F* t = P.t;
  if (f_is_zero(Q.z)) return false;         // Q at infinity: T
  if (f_is_zero(P.Z)) {                     // T at infinity: Q
    P.X = Q.x;
    P.Y = Q.y;
    P.Z = Q.z;
    return false;
  }
  F u, x3;
  f_sub(u, t[gU2], t[gU1]);
  if (f_is_zero(u)) {                       // H = 0
    f_sub(u, t[gS2], t[gS1]);
    if (f_is_zero(u)) return true;          // T = Q: double T
    f_one(P.X);                             // T = -Q: infinity
    f_one(P.Y);
    f_zero(P.Z);
    return false;
  }
  f_dbl(u, t[gV]);
  f_sub(x3, t[gRR], t[gJ]);
  f_sub(x3, x3, u);                         // X3 = rr^2 - J - 2V
  f_dbl(u, t[gSJ]);
  f_sub(P.Y, t[gY3], u);                    // Y3 = rr (V - X3) - 2 S1 J
  P.X = x3;
  f_dbl(P.Z, t[gZH]);                       // Z3 = 2 Z1 Z2 H
  return false;
}
