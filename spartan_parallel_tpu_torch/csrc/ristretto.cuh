// ristretto255 ENCODE (RFC 9496 section 4.3.2) and the fixed-base comb
// commitment: the per-point arithmetic of the JAX package's
// ops/ristretto_dev.py (pow_p58, sqrt_ratio_m1, compress, comb_commit) on
// fp.cuh and curve.cuh. K9 (csrc/zk_round.cu) compresses a batch of points,
// one per thread; K10 sums comb table entries, one block per commitment;
// K11 runs both inside a sumcheck round. Built with g++ as well for the CPU
// tests (csrc/host_check.cpp).
#pragma once
#include "curve.cuh"
#include "keccak.cuh"

#define FP_SQRT_M1_WORDS                                               \
  {0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u, 0x3dfbd7a7u,    \
   0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u}
#define FP_INVSQRT_A_MINUS_D_WORDS                                     \
  {0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u, 0xfe01d840u,    \
   0x16c27b91u, 0xcfaffca2u, 0x786c8905u}

// One product mod p as a call: the ~300 products of an ENCODE then share
// one copy of the code, which keeps the build of K9-K11 short.
HDN void fp_mul_c(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fp_mul(r, a, b);
}

// The same for a point addition (K10's and K11's comb sums).
HDN void pt_add_c(Point& r, const Point& p, const Point& q) {
  pt_add(r, p, q);
}

HD void fp_nsquare(uint32_t* r, const uint32_t* x, int n) {
  copy8(r, x);
  for (int i = 0; i < n; ++i) fp_mul_c(r, r, r);
}

// x^((p - 5) / 8) = x^(2^252 - 3): the ref10 pow22523 addition chain.
HDN void fp_pow_p58(uint32_t* out, const uint32_t* x) {
  uint32_t t0[8], t1[8], t2[8];
  fp_mul_c(t0, x, x);         // x^2
  fp_nsquare(t1, t0, 2);    // x^8
  fp_mul_c(t1, x, t1);        // x^9
  fp_mul_c(t0, t0, t1);       // x^11
  fp_mul_c(t0, t0, t0);       // x^22
  fp_mul_c(t0, t1, t0);       // x^(2^5 - 1)
  fp_nsquare(t1, t0, 5);
  fp_mul_c(t0, t1, t0);       // x^(2^10 - 1)
  fp_nsquare(t1, t0, 10);
  fp_mul_c(t1, t1, t0);       // x^(2^20 - 1)
  fp_nsquare(t2, t1, 20);
  fp_mul_c(t1, t2, t1);       // x^(2^40 - 1)
  fp_nsquare(t1, t1, 10);
  fp_mul_c(t0, t1, t0);       // x^(2^50 - 1)
  fp_nsquare(t1, t0, 50);
  fp_mul_c(t1, t1, t0);       // x^(2^100 - 1)
  fp_nsquare(t2, t1, 100);
  fp_mul_c(t1, t2, t1);       // x^(2^200 - 1)
  fp_nsquare(t1, t1, 50);
  fp_mul_c(t0, t1, t0);       // x^(2^250 - 1)
  fp_nsquare(t0, t0, 2);    // x^(2^252 - 4)
  fp_mul_c(out, t0, x);       // x^(2^252 - 3)
}

HD bool fp_is_neg(const uint32_t* x) { return x[0] & 1u; }

HD bool fp_eq(const uint32_t* a, const uint32_t* b) {
  uint32_t d = 0;
  for (int k = 0; k < 8; ++k) d |= a[k] ^ b[k];
  return d == 0;
}

HD void fp_neg(uint32_t* r, const uint32_t* a) {
  uint32_t z[8];
  zero8(z);
  fp_sub(r, z, a);
}

HD void fp_abs(uint32_t* r) {
  if (fp_is_neg(r)) fp_neg(r, r);
}

// r = the nonnegative sqrt(u / v), or of sqrt(-1) u / v when u / v is not
// a square (RFC 9496 section 4.2; the square flag is not needed here).
HD void fp_sqrt_ratio_m1(uint32_t* r, const uint32_t* u, const uint32_t* v) {
  const uint32_t sqrt_m1[8] = FP_SQRT_M1_WORDS;
  uint32_t v3[8], v7[8], t[8], check[8], neg_u[8], neg_ui[8];
  fp_mul_c(v3, v, v);
  fp_mul_c(v3, v3, v);
  fp_mul_c(v7, v3, v3);
  fp_mul_c(v7, v7, v);
  fp_mul_c(t, u, v7);
  fp_pow_p58(t, t);
  fp_mul_c(r, u, v3);
  fp_mul_c(r, r, t);
  fp_mul_c(check, r, r);
  fp_mul_c(check, v, check);
  fp_neg(neg_u, u);
  fp_mul_c(neg_ui, neg_u, sqrt_m1);
  if (fp_eq(check, neg_u) || fp_eq(check, neg_ui)) fp_mul_c(r, r, sqrt_m1);
  fp_abs(r);
}

// ENCODE of an extended point into 32 bytes.
HDN void ristretto_compress(uint8_t* out, const Point& p) {
  const uint32_t sqrt_m1[8] = FP_SQRT_M1_WORDS;
  const uint32_t invsqrt_a_minus_d[8] = FP_INVSQRT_A_MINUS_D_WORDS;
  uint32_t u1[8], u2[8], t[8], one[8], invsqrt[8], den1[8], den2[8];
  uint32_t z_inv[8], x[8], y[8], den_inv[8], s[8];
  fp_add(t, p.Z, p.Y);
  fp_sub(u1, p.Z, p.Y);
  fp_mul_c(u1, t, u1);
  fp_mul_c(u2, p.X, p.Y);
  zero8(one);
  one[0] = 1;
  fp_mul_c(t, u2, u2);
  fp_mul_c(t, u1, t);
  fp_sqrt_ratio_m1(invsqrt, one, t);
  fp_mul_c(den1, invsqrt, u1);
  fp_mul_c(den2, invsqrt, u2);
  fp_mul_c(z_inv, den1, den2);
  fp_mul_c(z_inv, z_inv, p.T);
  fp_mul_c(t, p.T, z_inv);
  if (fp_is_neg(t)) {  // rotate
    fp_mul_c(x, p.Y, sqrt_m1);
    fp_mul_c(y, p.X, sqrt_m1);
    fp_mul_c(den_inv, den1, invsqrt_a_minus_d);
  } else {
    copy8(x, p.X);
    copy8(y, p.Y);
    copy8(den_inv, den2);
  }
  fp_mul_c(t, x, z_inv);
  if (fp_is_neg(t)) fp_neg(y, y);
  fp_sub(s, p.Z, y);
  fp_mul_c(s, den_inv, s);
  fp_abs(s);
  bytes_from_words(out, s);
}

// --------------------------------------------------------------------------
// Fixed-base comb commitments: tables T[g, w, v] = (v 16^w) G_g as
// (n, 64, 16, 4, 16) int32 limbs; a commitment sum_g s_g G_g of canonical
// scalars s_g is the sum over g and the 64 nibbles w of T[g, w, s_g's
// nibble w]. Window w's partial sum runs over g in order, starting from
// T[0, w, .] (digit 0 picks the identity entry, which is added like any
// other); the 64 partial sums then add up by halving (the port's
// ops/curve.py tree_sum).
// --------------------------------------------------------------------------
#define COMB_WINDOWS 64

HD int comb_digit(const uint32_t* canon, int w) {
  return (int)((canon[w >> 3] >> (4 * (w & 7))) & 0xFu);
}

HD void comb_window(Point& acc, const int32_t* tab, int n,
                    const uint32_t (*canon)[8], int w) {
  pt_load(acc, tab + (w * 16 + comb_digit(canon[0], w)) * 64);
  for (int g = 1; g < n; ++g) {
    Point q;
    pt_load(q, tab + ((g * COMB_WINDOWS + w) * 16 + comb_digit(canon[g], w))
                         * 64);
    pt_add_c(acc, acc, q);
  }
}

#ifndef __CUDACC__
// The host form of a comb commitment, in the order the kernels use.
static void comb_commit_host(Point& out, const int32_t* tab, int n,
                             const uint32_t (*canon)[8]) {
  Point acc[COMB_WINDOWS];
  for (int w = 0; w < COMB_WINDOWS; ++w) comb_window(acc[w], tab, n, canon, w);
  for (int s = COMB_WINDOWS / 2; s > 0; s >>= 1)
    for (int t = 0; t < s; ++t) pt_add_c(acc[t], acc[t], acc[t + s]);
  out = acc[0];
}
#endif
