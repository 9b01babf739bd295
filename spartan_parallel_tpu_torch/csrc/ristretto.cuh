// ristretto255 ENCODE (RFC 9496 section 4.3.2) and the fixed-base comb
// commitment: the per-point arithmetic of the JAX package's
// ops/ristretto_dev.py (pow_p58, sqrt_ratio_m1, compress, comb_commit).
// An ENCODE is ~285 products in a row, on the ten-lane product
// (csrc/fp10.cuh); a comb sum's additions are lane-split (csrc/lanes.cuh,
// csrc/fe.cuh). K9 (csrc/zk_round.cu) encodes a batch of points, a group
// of ten lanes each; K10 sums comb table entries, a group of four lanes
// per window; K11 runs both inside a sumcheck round. Built with g++ as
// well for the CPU tests (csrc/host_check.cpp).
#pragma once
#include "fp10.cuh"
#include "keccak.cuh"
#include "lanes.cuh"

#define FP_SQRT_M1_WORDS                                               \
  {0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u, 0x3dfbd7a7u,    \
   0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u}
#define FP_INVSQRT_A_MINUS_D_WORDS                                     \
  {0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u, 0xfe01d840u,    \
   0x16c27b91u, 0xcfaffca2u, 0x786c8905u}

// The ENCODE below runs on a group of ten lanes (csrc/fp10.cuh): F is G10
// on the card, G10Host in the host model; F::V is a lane's limb (the
// host model's: the ten limbs). No branch depends on the data (each
// choice is a select), so the four groups of a warp stay in step.
template <class F>
HD typename F::V f_nsqr(const F& f, typename F::V a, int n) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int i = 0; i < n; ++i) a = f.sqr(a);
  return a;
}

// x^((p - 5) / 8) = x^(2^252 - 3): the ref10 pow22523 addition chain, 251
// squarings and 11 products.
template <class F>
HD typename F::V f_pow_p58(const F& f, const typename F::V& x) {
  typedef typename F::V V;
  V t0 = f.sqr(x);                // x^2
  V t1 = f_nsqr(f, t0, 2);        // x^8
  t1 = f.mul(x, t1);              // x^9
  t0 = f.mul(t0, t1);             // x^11
  t0 = f.sqr(t0);                 // x^22
  t0 = f.mul(t1, t0);             // x^(2^5 - 1)
  t1 = f_nsqr(f, t0, 5);
  t0 = f.mul(t1, t0);             // x^(2^10 - 1)
  t1 = f_nsqr(f, t0, 10);
  t1 = f.mul(t1, t0);             // x^(2^20 - 1)
  V t2 = f_nsqr(f, t1, 20);
  t1 = f.mul(t2, t1);             // x^(2^40 - 1)
  t1 = f_nsqr(f, t1, 10);
  t0 = f.mul(t1, t0);             // x^(2^50 - 1)
  t1 = f_nsqr(f, t0, 50);
  t1 = f.mul(t1, t0);             // x^(2^100 - 1)
  t2 = f_nsqr(f, t1, 100);
  t1 = f.mul(t2, t1);             // x^(2^200 - 1)
  t1 = f_nsqr(f, t1, 50);
  t0 = f.mul(t1, t0);             // x^(2^250 - 1)
  t0 = f_nsqr(f, t0, 2);          // x^(2^252 - 4)
  return f.mul(t0, x);            // x^(2^252 - 3)
}

// the nonnegative sqrt(u / v), or of sqrt(-1) u / v when u / v is not a
// square (RFC 9496 section 4.2; the square flag is not needed here)
template <class F>
HD typename F::V f_sqrt_ratio_m1(const F& f, const typename F::V& u,
                                 const typename F::V& v) {
  typedef typename F::V V;
  const uint32_t sm1[8] = FP_SQRT_M1_WORDS;
  const V sqrt_m1 = f.constant(sm1);
  const V v3 = f.mul(f.sqr(v), v);
  const V v7 = f.mul(f.sqr(v3), v);
  const V t = f_pow_p58(f, f.mul(u, v7));
  V r = f.mul(f.mul(u, v3), t);
  const V check = f.mul(v, f.sqr(r));
  const V neg_u = f.neg(u);
  const bool flip = f.eq(check, neg_u) | f.eq(check, f.mul(neg_u, sqrt_m1));
  r = f.select(flip, f.mul(r, sqrt_m1), r);
  return f.select(f.is_neg(r), f.neg(r), r);
}

// ENCODE of the extended point (X, Y, Z, T) into 32 bytes.
template <class F>
HD void ristretto_encode(const F& f, uint8_t* out, const typename F::V& X,
                         const typename F::V& Y, const typename F::V& Z,
                         const typename F::V& T) {
  typedef typename F::V V;
  const uint32_t sm1[8] = FP_SQRT_M1_WORDS;
  const uint32_t isamd[8] = FP_INVSQRT_A_MINUS_D_WORDS;
  const uint32_t one[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  const V u1 = f.mul(f.add(Z, Y), f.sub(Z, Y));
  const V u2 = f.mul(X, Y);
  const V invsqrt =
      f_sqrt_ratio_m1(f, f.constant(one), f.mul(u1, f.sqr(u2)));
  const V den1 = f.mul(invsqrt, u1), den2 = f.mul(invsqrt, u2);
  const V z_inv = f.mul(f.mul(den1, den2), T);
  const V sqrt_m1 = f.constant(sm1);
  const bool rotate = f.is_neg(f.mul(T, z_inv));
  const V x = f.select(rotate, f.mul(Y, sqrt_m1), X);
  V y = f.select(rotate, f.mul(X, sqrt_m1), Y);
  const V den_inv = f.select(rotate, f.mul(den1, f.constant(isamd)), den2);
  y = f.select(f.is_neg(f.mul(x, z_inv)), f.neg(y), y);
  V s = f.mul(den_inv, f.sub(Z, y));
  f.to_bytes(out, f.select(f.is_neg(s), f.neg(s), s));
}

// --------------------------------------------------------------------------
// Fixed-base comb commitments: tables T[g, w, v] = (v 16^w) G_g as
// (n, 64, 16, 4, 16) int32 limbs; a commitment sum_g s_g G_g of canonical
// scalars s_g is the sum over g and the 64 nibbles w of T[g, w, s_g's
// nibble w]. Window w's partial sum runs over g in order, starting from
// T[0, w, .] (digit 0 picks the identity entry, which is added like any
// other); the 64 partial sums then add up by halving (the port's
// ops/curve.py tree_sum). A group of four lanes forms a window's sum; with
// 32 groups a group forms windows w + 32 and w and adds them, the
// halving's first level. zk_round.cu comb_lanes runs it on the card,
// comb_host below on the host, in the same order.
// --------------------------------------------------------------------------
#define COMB_WINDOWS 64

HD int comb_digit(const uint32_t* canon, int w) {
  return (int)((canon[w >> 3] >> (4 * (w & 7))) & 0xFu);
}

HD const int32_t* comb_entry(const int32_t* tab, const uint32_t (*canon)[8],
                             int g, int w) {
  return tab + ((g * COMB_WINDOWS + w) * 16 + comb_digit(canon[g], w)) * 64;
}

#ifndef __CUDACC__
static void comb_window_host(Fe* P, const int32_t* tab, int n,
                             const uint32_t (*canon)[8], int w) {
  const int32_t* e = comb_entry(tab, canon, 0, w);
  for (int c = 0; c < 4; ++c) P[c] = fe_load16(e + 16 * c);
  for (int g = 1; g < n; ++g) {
    e = comb_entry(tab, canon, g, w);
    hq_add(P, [&](int k) { return fe_load16(e + 16 * k); });
  }
}

// The comb sum over ngrp (64 or 32) groups; out: the point's coordinates.
static void comb_host(Fe* out, const int32_t* tab, int n,
                      const uint32_t (*canon)[8], int ngrp) {
  Fe acc[COMB_WINDOWS][4];
  for (int g = 0; g < ngrp; ++g) {
    if (ngrp == 32) {
      Fe hi[4];
      comb_window_host(hi, tab, n, canon, g + 32);
      comb_window_host(acc[g], tab, n, canon, g);
      hq_add(acc[g], [&](int k) { return hi[k]; });
    } else {
      comb_window_host(acc[g], tab, n, canon, g);
    }
  }
  for (int off = ngrp / 2; off > 0; off >>= 1)
    for (int g = 0; g < off; ++g)
      hq_add(acc[g], [&](int k) { return acc[g + off][k]; });
  for (int c = 0; c < 4; ++c) out[c] = acc[0][c];
}
#endif
