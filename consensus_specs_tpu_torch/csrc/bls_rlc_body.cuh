// The RLC batch's Miller product over a block of lanes, shared by K9
// (`bls_rlc.cu` rlc_miller_product: the B lanes and the (-G1, sum) lane),
// K25 and K26 (`bls_shard.cu`: a shard's lanes alone; the shared lane
// alone over the shards' partial sums): the G2 tree sum, the lanes'
// affine arguments, the tangent and chord steps and the block's fold, as
// one template with a flag for each kind of lane.
#pragma once

#include "bls12_381.cuh"
#include "bls_miller.cuh"

struct MillerScratch {
  Jac<Fp2>* sums;      // m >= B rows: the signature tree sum
  Jac<Fp2>* T;         // n = B + 1 rows: the running G2 point per lane
  Fp12* L;             // n rows: the lines of one step, then their product
  Fp2* Q;              // n rows x 2: affine G2 argument per lane
  Fp* P;               // n rows x 2: affine G1 argument per lane
  uint8_t* live;       // n rows
};

// tangent at T evaluated at P = (xp, yp); T <- 2T
__device__ __noinline__ void dbl_step(Fp12& line, Jac<Fp2>& T, const Fp& xp,
                                      const Fp& yp) {
  Fp2 XX, YY, ZZ, cx, cy, c0, t;
  fp2_sqr(XX, T.x);
  fp2_sqr(YY, T.y);
  fp2_sqr(ZZ, T.z);
  fp2_mul(cy, T.y, T.z);
  fp2_mul(cy, cy, ZZ);
  fp2_dbl(cy, cy);                          // 2 Y Z^3
  fp2_mul(cx, XX, ZZ);
  fp2_add(t, cx, cx);
  fp2_add(cx, t, cx);
  fp2_neg(cx, cx);                          // -3 X^2 Z^2
  fp2_mul(c0, XX, T.x);
  fp2_add(t, c0, c0);
  fp2_add(c0, t, c0);
  fp2_dbl(t, YY);
  fp2_sub(c0, c0, t);                       // 3 X^3 - 2 Y^2
  line_at(line, c0, cx, cy, xp, yp);
  pt_double(T, T);
}

// chord through T and affine Q = (xq, yq), evaluated at P; T <- T + Q
__device__ __noinline__ void add_step(Fp12& line, Jac<Fp2>& T, const Fp2& xq,
                                      const Fp2& yq, const Fp& xp,
                                      const Fp& yp) {
  Fp2 ZZ, H, I, ZH, c0, t;
  fp2_sqr(ZZ, T.z);
  fp2_mul(t, xq, ZZ);
  fp2_sub(H, T.x, t);                       // H = X - xq Z^2
  fp2_mul(t, ZZ, T.z);
  fp2_mul(t, yq, t);
  fp2_sub(I, T.y, t);                       // I = Y - yq Z^3
  fp2_mul(ZH, T.z, H);
  fp2_mul(c0, I, xq);
  fp2_mul(t, ZH, yq);
  fp2_sub(c0, c0, t);                       // I xq - Z H yq
  fp2_neg(I, I);
  line_at(line, c0, I, ZH, xp, yp);
  Jac<Fp2> q;
  q.x = xq;
  q.y = yq;
  fp2_one(q.z);
  pt_add(T, T, q);
}

// pt_sum's tree over m >= B rows of s.sums, the rows past B infinity:
// s.sums[0] is the sum of the B Jacobian rows (sX, sY, sZ)
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

// The Miller product of the block's lanes; the conjugated f comes back in
// thread 0.  kLanes: the B pairing lanes (r_i PK_i, H_i), live where
// mask & ~a_inf & h_ok.  kShared: the lane (-G1, sum of the B Jacobian
// rows sX, sY, sZ), whose affine sum and infinity flag go to sum_out and
// s_inf_out.  K9 has both, K25 the lanes only (the Jacobian sum to
// sum_out as X, Y, Z), K26 the shared lane only (its B rows the shards'
// partial sums; the lane pointers unused).
template <bool kLanes, bool kShared>
__device__ __forceinline__ Fp12 rlc_miller_body(
    const int32_t* __restrict__ apx, const int32_t* __restrict__ apy,
    const uint8_t* __restrict__ a_inf, const int32_t* __restrict__ sX,
    const int32_t* __restrict__ sY, const int32_t* __restrict__ sZ,
    const int32_t* __restrict__ hx, const int32_t* __restrict__ hy,
    const uint8_t* __restrict__ h_ok, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ g1x, const int32_t* __restrict__ g1y, int B,
    int m, MillerScratch s, int32_t* __restrict__ sum_out,
    uint8_t* __restrict__ s_inf_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lanes = kLanes ? B : 0, n = lanes + (kShared ? 1 : 0);
  // the signature sum: pt_sum's tree (first half plus second), the
  // rows past B infinity
  g2_tree_sum(sX, sY, sZ, B, m, s.sums);
  if (!kShared && tid == 0) {
    store_fp2(sum_out, s.sums[0].x);
    store_fp2(sum_out + 2 * BLS_NL, s.sums[0].y);
    store_fp2(sum_out + 4 * BLS_NL, s.sums[0].z);
  }
  // the lanes: (r_i PK_i, H_i) for i < B, then (-G1, sum)
  for (int i = tid; i < n; i += nt) {
    Fp2 xq, yq;
    if (i < lanes) {
      load_fp(s.P[2 * i], apx + i * BLS_NL);
      load_fp(s.P[2 * i + 1], apy + i * BLS_NL);
      load_fp2(xq, hx + i * 2 * BLS_NL);
      load_fp2(yq, hy + i * 2 * BLS_NL);
      s.live[i] = mask[i] && !a_inf[i] && h_ok[i];
    } else {
      load_fp(s.P[2 * i], g1x);
      load_fp(s.P[2 * i + 1], g1y);
      bool inf = pt_to_affine(xq, yq, s.sums[0]);
      store_fp2(sum_out, xq);
      store_fp2(sum_out + 2 * BLS_NL, yq);
      *s_inf_out = inf;
      s.live[i] = !inf;
    }
    s.Q[2 * i] = xq;
    s.Q[2 * i + 1] = yq;
    s.T[i].x = xq;
    s.T[i].y = yq;
    fp2_one(s.T[i].z);
  }
  __syncthreads();

  Fp12 f;
  fp12_one(f);
  const uint64_t x_abs = bls_x_abs();
  for (int bit = bls_x_top() - 1; bit >= 0; --bit) {
    const bool add = (x_abs >> bit) & 1;
    for (int pass = 0; pass < (add ? 2 : 1); ++pass) {
      for (int i = tid; i < n; i += nt) {
        Fp12 line;
        Jac<Fp2> T = s.T[i];
        if (pass == 0) dbl_step(line, T, s.P[2 * i], s.P[2 * i + 1]);
        else add_step(line, T, s.Q[2 * i], s.Q[2 * i + 1], s.P[2 * i],
                      s.P[2 * i + 1]);
        s.T[i] = T;
        if (!s.live[i]) fp12_one(line);
        s.L[i] = line;
      }
      miller_fold(f, s.L, n, pass == 0);
    }
  }
  if (tid == 0) fp12_conj(f, f);            // negative BLS parameter
  return f;
}

// The scratch of rlc_miller_body at B rows: m >= B sums, then n = B + 1
// rows of each lane array (K9's launcher lays out the same regions)
static inline int64_t rlc_scratch_bytes(int B) {
  int64_t m = 1;
  while (m < B) m *= 2;
  int64_t n = B + 1;
  return m * sizeof(Jac<Fp2>) + n * (sizeof(Jac<Fp2>) + sizeof(Fp12) +
                                     2 * sizeof(Fp2) + 2 * sizeof(Fp) + 1);
}

static inline MillerScratch rlc_scratch(void* scratch, int B, int m) {
  const int n = B + 1;
  char* base = (char*)scratch;
  MillerScratch s;
  s.sums = (Jac<Fp2>*)base;
  base += (size_t)m * sizeof(Jac<Fp2>);
  s.T = (Jac<Fp2>*)base;
  base += (size_t)n * sizeof(Jac<Fp2>);
  s.L = (Fp12*)base;
  base += (size_t)n * sizeof(Fp12);
  s.Q = (Fp2*)base;
  base += (size_t)n * 2 * sizeof(Fp2);
  s.P = (Fp*)base;
  base += (size_t)n * 2 * sizeof(Fp);
  s.live = (uint8_t*)base;
  return s;
}
