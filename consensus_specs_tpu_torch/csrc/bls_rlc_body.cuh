// The per-lane Miller body, shared by K9 (`bls_rlc.cu`
// rlc_miller_product: the B lanes and the (-G1, sum) lane), K25
// (`bls_shard.cu` rlc_miller_shard: a shard's lanes alone), K26
// (`bls_shard.cu` rlc_shard_combine: the shared lane alone over the
// shards' partial sums) and K12 (`bls_pairing.cu` precomp_miller_product:
// host-precomputed lines, no G2 arithmetic): one Miller loop per lane with
// its own accumulator, and the product of the lanes' values.
//
// The identity it rests on: the shared accumulator of
// pairing_jax.py:133 and :234, f <- f^2 * prod_i line_i, ends as
// prod_i f_i, where f_i <- f_i^2 * line_i is lane i's own Miller value,
// since squaring distributes over the product.  Every value is canonical
// (`mont.cuh`), so conj(prod_i f_i) has the bits of the shared f whatever
// the order of the product.  A dead lane's f_i is one.
//
// Design (a first version ran every lane of a batch in one
// block, multiplied the B + 1 dense lines of each step in an 8-level tree
// and folded them into the one accumulator on thread 0, a serial chain of
// about 40,000 Montgomery products on one SM).  Here:
//   rlc_lanes   one group of LANE_G = 6 threads per lane, LANES_PER_BLOCK
//               lanes (one warp) per block, the pairing lanes over
//               ceil(B / 5) blocks.  Each step's independent Fq2 products
//               are spread over the group through shared memory: the 12
//               Karatsuba products of f^2 and the tangent's or chord's
//               products, then the product by the sparse line (nonzero
//               at w^0, w^jx, w^jy: 18 Fq2 products, three per thread, in
//               place of a dense Fq12 product of 54 Montgomery products).
//               A Miller doubling step is then about 8 Fq2 products deep.
//               Block 0 first sums the signature rows in pt_sum's tree
//               (`g2_tree_sum`: the same pairs in the same order), then,
//               where the kernel has the shared lane, runs it through the
//               same per-lane code as every other lane.
//   precomp_lanes  K12's lanes: the same groups over the live lanes only,
//               each step's line read from rows that K12's first launch
//               evaluated at P, so a doubling step is f^2 (2 Fq2 products
//               a thread) and the sparse line product (3): 5 deep.
//   rlc_fold    one block: the lanes' values conjugated (the negative BLS
//               parameter; conj is a ring map), any extra Fq12 rows
//               appended (K26: the shards' conjugated partials), and
//               their product in a tree, one group of 6 threads per pair.
// What bounds it: the dependent chain of one lane's 68 Miller steps
// (latency); the lanes run side by side on separate SMs.
#pragma once

#include "bls12_381.cuh"
#include "bls_point_passes.cuh"

#define LANE_G 6             // threads per lane
#define LANES_PER_BLOCK 5    // lanes per block: 30 threads, one warp
#define FOLD_GROUPS 16       // pairs multiplied at once by rlc_fold

// An Fq12 in shared or global memory as its 6 Fq2 coefficients in the
// order of `Fp12` (c0.c0, c0.c1, c0.c2, c1.c0, c1.c1, c1.c2): the
// coefficients of w^0, w^2, w^4, w^1, w^3, w^5.
__device__ __forceinline__ int wslot(int i) {
  return (i & 1) ? 3 + (i >> 1) : (i >> 1);
}

// Karatsuba over Fq6 = Fq2[v] / (v^3 - xi): p q from the six products
// m_k = kara(p, k) kara(q, k), k = 0..5: p0 q0, p1 q1, p2 q2,
// (p1 + p2)(q1 + q2), (p0 + p1)(q0 + q1), (p0 + p2)(q0 + q2)
__device__ __forceinline__ void kara_operand(Fp2& out, const Fp2* p, int k) {
  if (k < 3) out = p[k];
  else if (k == 3) fp2_add(out, p[1], p[2]);
  else if (k == 4) fp2_add(out, p[0], p[1]);
  else fp2_add(out, p[0], p[2]);
}

// coefficient c of p q (fp6_mul's formulas)
__device__ __noinline__ void kara_coeff(Fp2& out, const Fp2* m, int c) {
  Fp2 t, u;
  if (c == 0) {                             // m0 + (m3 - m1 - m2) xi
    fp2_sub(t, m[3], m[1]);
    fp2_sub(t, t, m[2]);
    fp2_mul_xi(t, t);
    fp2_add(out, m[0], t);
  } else if (c == 1) {                      // m4 - m0 - m1 + m2 xi
    fp2_sub(t, m[4], m[0]);
    fp2_sub(t, t, m[1]);
    fp2_mul_xi(u, m[2]);
    fp2_add(out, t, u);
  } else {                                  // m5 - m0 - m2 + m1
    fp2_sub(t, m[5], m[0]);
    fp2_sub(t, t, m[2]);
    fp2_add(out, t, m[1]);
  }
}

// --- one lane's Miller loop, by its group of LANE_G threads ---------------

// temporaries of the lines (the point's are in GroupPoint)
enum { lZZ, lXXZZ, lXXX, lYZZZ, lC0a, lC0b, kLineTemps };

struct LaneState {
  Fp2 f[6];          // the lane's Miller value (Fp12 order)
  Fp2 s[6];          // f^2, the factor the line multiplies
  Fp2 prod[12];      // the Karatsuba products of f^2
  GroupPoint<Fp2> P; // T (Jacobian), Q (affine), the point's temporaries
  Fp2 xs, ys;        // SX xp, SY yp: the line's x and y terms per unit
  Fp2 l0, lx, ly;    // the line: c0, cx xp SX at w^jx, cy yp SY at w^jy
  Fp2 t[kLineTemps];
};

// rank r: products r (t = c0 c1) and 6 + r ((c0 + c1)(c0 + v c1)) of
// fp12_sqr's complex squaring
__device__ __noinline__ void sqr_jobs(LaneState& L, int r) {
  Fp2 a, b, x[3], y[3];
  kara_operand(a, L.f, r);
  kara_operand(b, L.f + 3, r);
  fp2_mul(L.prod[r], a, b);
  for (int k = 0; k < 3; ++k) fp2_add(x[k], L.f[k], L.f[3 + k]);
  fp2_mul_xi(y[0], L.f[5]);
  fp2_add(y[0], L.f[0], y[0]);
  fp2_add(y[1], L.f[1], L.f[3]);
  fp2_add(y[2], L.f[2], L.f[4]);
  kara_operand(a, x, r);
  kara_operand(b, y, r);
  fp2_mul(L.prod[6 + r], a, b);
}

// rank r: coefficient r of f^2 = (xy - t - v t) + 2t w
__device__ __noinline__ void sqr_combine(LaneState& L, int r) {
  Fp2 t, u, w;
  if (r < 3) {
    kara_coeff(w, L.prod + 6, r);
    kara_coeff(t, L.prod, r);
    fp2_sub(w, w, t);
    kara_coeff(u, L.prod, (r + 2) % 3);     // (v t)_r
    if (r == 0) fp2_mul_xi(u, u);
    fp2_sub(L.s[r], w, u);
  } else {
    kara_coeff(t, L.prod, r - 3);
    fp2_dbl(L.s[r], t);
  }
}

// rank i: the coefficient of w^i of s * (l0 + lx w^jx + ly w^jy) into f;
// w^6 = xi
__device__ __noinline__ void sparse_line_mul(LaneState& L, int i) {
  const int jx = BLS.jx, jy = BLS.jy;
  Fp2 a, b, c;
  fp2_mul(a, L.s[wslot(i)], L.l0);
  fp2_mul(b, L.s[wslot((i + 6 - jx) % 6)], L.lx);
  if (i < jx) fp2_mul_xi(b, b);
  fp2_mul(c, L.s[wslot((i + 6 - jy) % 6)], L.ly);
  if (i < jy) fp2_mul_xi(c, c);
  fp2_add(a, a, b);
  fp2_add(L.f[wslot(i)], a, c);
}

// The passes below keep the group's warp converged: in each phase every
// rank sets up its own operands (a few additions, by rank) and then all
// ranks call the one Fq2 product, so the products of a phase run side by
// side rather than one branch after another.  Ranks 0-2 run the group
// point passes' products (`bls_point_passes.cuh`), the others the line's.

// f <- f^2 * tangent(T)(P); T <- 2T (dbl_step's line; the point pass's
// rounds, with Z^2 and the line terms X^2 Z^2, X^3, Y Z^3 beside them).
// Every thread of the block calls it.
__device__ __noinline__ void miller_dbl_pass(LaneState& L, int r, bool live) {
  GroupPoint<Fp2>& P = L.P;
  Fp2* t = L.t;
  Fp2 a, b, u, v;
  Fp2* out = nullptr;
  if (live) {
    sqr_jobs(L, r);
    if (r < 3) {                            // X^2, Y^2, Y Z
      out = pt_dbl_operands(P, 0, r, a, b);
    } else if (r == 3) {                    // Z^2
      a = P.Z;
      b = P.Z;
      out = &t[lZZ];
    }
    if (out) fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live) {
    sqr_combine(L, r);
    if (r < 3) {                            // C, X Y^2, F
      out = pt_dbl_operands(P, 1, r, a, b);
    } else {                                // X^2 Z^2, X^3, Y Z^3
      a = r == 5 ? P.t[pYZ] : P.t[pXX];
      b = r == 4 ? P.X : t[lZZ];
      out = &t[lXXZZ + r - 3];
    }
    fp2_mul(*out, a, b);
  }
  __syncthreads();
  out = nullptr;
  if (live) {
    if (r == 0) {                           // E (D - X3)
      out = pt_dbl_operands(P, 2, 0, a, b);
    } else if (r == 1) {                    // cx = -3 X^2 Z^2
      fp2_triple(a, t[lXXZZ]);
      fp2_neg(a, a);
      b = L.xs;
      out = &L.lx;
    } else if (r == 2) {                    // cy = 2 Y Z^3
      fp2_dbl(a, t[lYZZZ]);
      b = L.ys;
      out = &L.ly;
    } else if (r == 3) {                    // c0 = 3 X^3 - 2 Y^2
      fp2_triple(u, t[lXXX]);
      fp2_dbl(v, P.t[pYY]);
      fp2_sub(L.l0, u, v);
    }
    if (out) fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live) {
    if (r == 0) pt_dbl_finish(P);
    sparse_line_mul(L, r);
  }
  __syncthreads();
}

// f <- f * chord(T, Q)(P); T <- T + Q (add_step's line; the point pass's
// rounds, with the line's products c0 = (Y - S2) xq - Z H yq,
// cx = -(Y - S2) xs, cy = Z H ys beside its J and V).  Every thread
// calls it.
__device__ __noinline__ void miller_add_pass(LaneState& L, int r, bool live) {
  GroupPoint<Fp2>& P = L.P;
  Fp2* t = L.t;
  Fp2 a, b, u;
  Fp2* out;
  if (live) {
    L.s[r] = L.f[r];
    if (r == 0) {                           // Z^2
      out = pt_add_operands(P, 0, 0, a, b);
      fp2_mul(*out, a, b);
    }
  }
  __syncthreads();
  if (live && r < 2) {                      // Z^3, U2 = xq Z^2
    out = pt_add_operands(P, 1, r, a, b);
    fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live && r < 3) {                      // S2, Z (X - U2), I = (2H)^2
    out = pt_add_operands(P, 2, r, a, b);
    fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live) {
    if (r < 2) {                            // J, V
      out = pt_add_operands(P, 3, r, a, b);
    } else {
      fp2_sub(u, P.Y, P.t[pS2]);            // Y - yq Z^3
      switch (r) {
        case 2: a = u; b = P.xq; out = &t[lC0a]; break;
        case 3: a = P.t[pZH]; b = P.yq; out = &t[lC0b]; break;
        case 4: fp2_neg(a, u); b = L.xs; out = &L.lx; break;
        default: a = P.t[pZH]; b = L.ys; out = &L.ly; break;
      }
    }
    fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live) {
    if (r < 2) {                            // rr^2, S1 J
      out = pt_add_operands(P, 4, r, a, b);
      fp2_mul(*out, a, b);
    } else if (r == 2) {
      fp2_sub(L.l0, t[lC0a], t[lC0b]);
    }
  }
  __syncthreads();
  if (live && r == 0) {                     // rr (V - X3)
    out = pt_add_operands(P, 5, 0, a, b);
    fp2_mul(*out, a, b);
  }
  __syncthreads();
  if (live) {
    if (r == 0) pt_add_finish(P);
    sparse_line_mul(L, r);
  }
  __syncthreads();
}

// --- the lanes kernel's body ----------------------------------------------

// pt_sum's tree over m >= B rows of `sums`, the rows past B infinity:
// sums[0] is the sum of the B Jacobian rows (sX, sY, sZ)
__device__ __forceinline__ void g2_tree_sum(const int32_t* __restrict__ sX,
                                            const int32_t* __restrict__ sY,
                                            const int32_t* __restrict__ sZ,
                                            int B, int m, Jac<Fp2>* sums) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < m; i += nt) {
    if (i < B) {
      load_fp2(sums[i].x, sX + i * 2 * BLS_NL);
      load_fp2(sums[i].y, sY + i * 2 * BLS_NL);
      load_fp2(sums[i].z, sZ + i * 2 * BLS_NL);
    } else {
      pt_infinity(sums[i]);
    }
  }
  __syncthreads();
  for (int w = m / 2; w >= 1; w /= 2) {
    for (int i = tid; i < w; i += nt) {
      Jac<Fp2> a = sums[i], b = sums[i + w];
      pt_add(a, a, b);
      sums[i] = a;
    }
    __syncthreads();
  }
}

// One lane per group of the block; the lane's raw Miller value (one for a
// dead lane) to its row of F.  kLanes: the B pairing lanes (r_i PK_i,
// H_i), live where mask & ~a_inf & h_ok, lane i in group i % 5 of block
// 1 + i / 5, row i.  kShared: the lane (-G1, sum of the B Jacobian rows
// sX, sY, sZ) in group 0 of block 0, row `lanes`, live where the sum is
// finite; its affine sum and flag go to sum_out and s_inf_out.  Without
// the shared lane, block 0 writes the Jacobian sum to sum_out (X, Y, Z).
// Block 0 always sums the rows (m >= B rows of `sums` scratch).
template <bool kLanes, bool kShared>
__device__ __forceinline__ void rlc_lanes(
    const int32_t* __restrict__ apx, const int32_t* __restrict__ apy,
    const uint8_t* __restrict__ a_inf, const int32_t* __restrict__ sX,
    const int32_t* __restrict__ sY, const int32_t* __restrict__ sZ,
    const int32_t* __restrict__ hx, const int32_t* __restrict__ hy,
    const uint8_t* __restrict__ h_ok, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ g1x, const int32_t* __restrict__ g1y, int B,
    int m, Jac<Fp2>* __restrict__ sums, Fp12* __restrict__ F,
    int32_t* __restrict__ sum_out, uint8_t* __restrict__ s_inf_out) {
  __shared__ LaneState st[LANES_PER_BLOCK];
  __shared__ uint8_t live_s[LANES_PER_BLOCK];
  __shared__ int row_s[LANES_PER_BLOCK];
  const int g = threadIdx.x / LANE_G, r = threadIdx.x % LANE_G;
  const int lanes = kLanes ? B : 0;
  LaneState& L = st[g];
  if (r == 0) {
    live_s[g] = 0;
    row_s[g] = -1;
  }
  if (blockIdx.x == 0) {
    g2_tree_sum(sX, sY, sZ, B, m, sums);
    if (threadIdx.x == 0) {
      if (kShared) {
        bool inf = pt_to_affine(L.P.xq, L.P.yq, sums[0]);
        store_fp2(sum_out, L.P.xq);
        store_fp2(sum_out + 2 * BLS_NL, L.P.yq);
        *s_inf_out = inf;
        live_s[0] = !inf;
        row_s[0] = lanes;
      } else {
        store_fp2(sum_out, sums[0].x);
        store_fp2(sum_out + 2 * BLS_NL, sums[0].y);
        store_fp2(sum_out + 4 * BLS_NL, sums[0].z);
      }
    }
  } else if (r == 0) {
    const int i = (blockIdx.x - 1) * LANES_PER_BLOCK + g;
    if (i < lanes) {
      live_s[g] = mask[i] && !a_inf[i] && h_ok[i];
      row_s[g] = i;
    }
  }
  __syncthreads();
  const bool live = live_s[g];
  const bool shared = kShared && blockIdx.x == 0;
  const int i = row_s[g];
  if (live) {
    Fp p;
    switch (r) {
      case 0:
        load_fp(p, shared ? g1x : apx + i * BLS_NL);
        fp2_mul_fp(L.xs, BLS.sx, p);
        break;
      case 1:
        load_fp(p, shared ? g1y : apy + i * BLS_NL);
        fp2_mul_fp(L.ys, BLS.sy, p);
        break;
      case 2:
        if (!shared) load_fp2(L.P.xq, hx + i * 2 * BLS_NL);
        break;
      case 3:
        if (!shared) load_fp2(L.P.yq, hy + i * 2 * BLS_NL);
        break;
      default: break;
    }
    if (r == 0) fp2_one(L.f[0]);
    else fp2_zero(L.f[r]);
  }
  __syncthreads();
  if (live) {
    if (r == 0) L.P.X = L.P.xq;
    else if (r == 1) L.P.Y = L.P.yq;
    else if (r == 2) fp2_one(L.P.Z);
  }
  bool any = false;
  for (int k = 0; k < LANES_PER_BLOCK; ++k) any = any || live_s[k];
  __syncthreads();
  if (any) {                                // block-uniform
    const uint64_t x_abs = bls_x_abs();
    for (int bit = bls_x_top() - 1; bit >= 0; --bit) {
      miller_dbl_pass(L, r, live);
      if ((x_abs >> bit) & 1) miller_add_pass(L, r, live);
    }
  }
  if (i >= 0) {
    Fp2* row = (Fp2*)&F[i];
    if (live) row[r] = L.f[r];
    else if (r == 0) fp2_one(row[r]);
    else fp2_zero(row[r]);
  }
}

// --- K12: the lanes over precomputed lines ---------------------------------

// live lanes among the B of `mask`
__device__ __forceinline__ int count_live(const uint8_t* __restrict__ mask,
                                          int B) {
  int n = 0;
  for (int i = 0; i < B; ++i) n += mask[i] != 0;
  return n;
}

// One step of a lane on its precomputed line c = (c0, cx xs, cy ys):
// f <- f^2 * line on a doubling step (`square`), f <- f * line on an
// addition.  The line's rows are read while the square's products run.
// Every thread of the block calls it.
__device__ __noinline__ void line_pass(LaneState& L, int r, bool live,
                                       bool square,
                                       const Fp2* __restrict__ c) {
  if (live) {
    if (square) sqr_jobs(L, r);
    else L.s[r] = L.f[r];
    if (r == 0) L.l0 = c[0];
    else if (r == 1) L.lx = c[1];
    else if (r == 2) L.ly = c[2];
  }
  __syncthreads();
  if (square) {
    if (live) sqr_combine(L, r);
    __syncthreads();
  }
  if (live) sparse_line_mul(L, r);
  __syncthreads();
}

// The live lane j (the j-th set entry of `mask`) in group j % 5 of block
// j / 5: its raw Miller value over the rows lines[step][j][0..5] (the
// doubling line's three terms, then the addition's, as
// `precomp_lines_kernel` leaves them) to F[j].  Blocks past the live
// lanes return at once.
__device__ __forceinline__ void precomp_lanes(const Fp2* __restrict__ lines,
                                              const uint8_t* __restrict__ mask,
                                              int B, Fp12* __restrict__ F) {
  __shared__ LaneState st[LANES_PER_BLOCK];
  const int g = threadIdx.x / LANE_G, r = threadIdx.x % LANE_G;
  const int n_live = count_live(mask, B);
  if (blockIdx.x * LANES_PER_BLOCK >= n_live) return;   // block-uniform
  const int j = blockIdx.x * LANES_PER_BLOCK + g;
  const bool live = j < n_live;
  LaneState& L = st[g];
  if (live) {
    if (r == 0) fp2_one(L.f[0]);
    else fp2_zero(L.f[r]);
  }
  __syncthreads();
  const uint64_t x_abs = bls_x_abs();
  const int top = bls_x_top();
  for (int bit = top - 1; bit >= 0; --bit) {
    const Fp2* c = lines + ((int64_t)(top - 1 - bit) * B + j) * 6;
    line_pass(L, r, live, true, c);
    if ((x_abs >> bit) & 1) line_pass(L, r, live, false, c + 3);
  }
  if (live) ((Fp2*)&F[j])[r] = L.f[r];
}

// --- the fold --------------------------------------------------------------

// out = a b by the LANE_G threads of a group (rank r), in two halves
// around a barrier: the 18 Fq2 products (3 per thread) of fp12_mul's
// Karatsuba into prod, then coefficient r of c0 = t0 + v t1,
// c1 = (a0 + a1)(b0 + b1) - t0 - t1.  Product k: kara(a0, k) kara(b0, k)
// for k < 6, kara(a1, k - 6) kara(b1, k - 6) for k < 12, then those of
// (a0 + a1)(b0 + b1).
__device__ __noinline__ void fp12_mul_job(Fp2* prod, const Fp2* a,
                                          const Fp2* b, int k) {
  Fp2 x, y, s[3], u[3];
  const int h = k / 6, j = k % 6;
  if (h < 2) {
    kara_operand(x, a + 3 * h, j);
    kara_operand(y, b + 3 * h, j);
  } else {
    for (int i = 0; i < 3; ++i) {
      fp2_add(s[i], a[i], a[3 + i]);
      fp2_add(u[i], b[i], b[3 + i]);
    }
    kara_operand(x, s, j);
    kara_operand(y, u, j);
  }
  fp2_mul(prod[k], x, y);
}

__device__ __forceinline__ void fp12_mul_jobs(Fp2* prod, const Fp2* a,
                                              const Fp2* b, int r) {
  for (int h = 0; h < 3; ++h) fp12_mul_job(prod, a, b, 6 * h + r);
}

__device__ __noinline__ void fp12_mul_combine(Fp2* out, const Fp2* prod,
                                              int r) {
  Fp2 t, u;
  if (r < 3) {
    kara_coeff(t, prod, r);
    kara_coeff(u, prod + 6, (r + 2) % 3);
    if (r == 0) fp2_mul_xi(u, u);
    fp2_add(out[r], t, u);
  } else {
    kara_coeff(t, prod + 12, r - 3);
    kara_coeff(u, prod, r - 3);
    fp2_sub(t, t, u);
    kara_coeff(u, prod + 6, r - 3);
    fp2_sub(out[r], t, u);
  }
}

// f_out = conj(F[0] ... F[n_raw - 1]) times the n_extra Fq12 rows of
// `extra` (boundary limbs), in a tree over F, in place: F needs
// n_raw + n_extra rows.  One block of FOLD_GROUPS * LANE_G threads.
__device__ __forceinline__ void rlc_fold(Fp12* __restrict__ F, int n_raw,
                                         const int32_t* __restrict__ extra,
                                         int n_extra,
                                         int32_t* __restrict__ f_out) {
  __shared__ Fp2 prod[FOLD_GROUPS][18];
  const int g = threadIdx.x / LANE_G, r = threadIdx.x % LANE_G;
  for (int i = threadIdx.x; i < n_raw; i += blockDim.x) fp12_conj(F[i], F[i]);
  for (int j = threadIdx.x; j < n_extra; j += blockDim.x)
    load_fp12(F[n_raw + j], extra + j * 12 * BLS_NL);
  __syncthreads();
  for (int n = n_raw + n_extra; n > 1;) {
    const int h = (n + 1) / 2, pairs = n - h;
    for (int base = 0; base < pairs; base += FOLD_GROUPS) {
      const int i = base + g;
      const bool act = g < FOLD_GROUPS && i < pairs;
      if (act) fp12_mul_jobs(prod[g], (const Fp2*)&F[i],
                             (const Fp2*)&F[i + h], r);
      __syncthreads();
      if (act) fp12_mul_combine((Fp2*)&F[i], prod[g], r);
      __syncthreads();
    }
    n = h;
  }
  if (threadIdx.x == 0) store_fp12(f_out, F[0]);
}

// --- scratch ---------------------------------------------------------------

// rows of the G2 tree sum: the next power of two >= B
static inline int sum_rows(int B) {
  int m = 1;
  while (m < B) m *= 2;
  return m;
}

// scratch of the lanes and the fold: sum_rows(B) Jacobian rows, then
// n_rows Fq12 rows (the lanes' values and the fold's extra rows)
static inline int64_t rlc_scratch_bytes(int B, int n_rows) {
  return (int64_t)sum_rows(B) * sizeof(Jac<Fp2>) +
         (int64_t)n_rows * sizeof(Fp12);
}

static inline Fp12* rlc_scratch_rows(void* scratch, int B) {
  return (Fp12*)((char*)scratch + (size_t)sum_rows(B) * sizeof(Jac<Fp2>));
}

// blocks of the lanes kernel: block 0, then the pairing lanes
static inline int rlc_lane_blocks(int lanes) {
  return 1 + (lanes + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK;
}
