// GF(2^255 - 19) in ten unsaturated limbs of 26 and 25 bits (ref10's radix
// 2^25.5): the product of the chains. fp.cuh's product carries row by row
// through one 64-bit word, so one thread runs ~250 dependent instructions a
// product. Here the 100 partial products go into ten independent 64-bit
// column sums (one multiply-add each, no carry between them) and a single
// carry pass follows, so a lone thread keeps ten chains in flight.
//
// Limb i has weight 2^ceil(25.5 i) and W(i) = 26 - (i & 1) bits. A product
// of limbs i and j lands in column i + j, doubled when both are odd (the
// half bits add up), and 2^255 = 19 folds columns 10..18 onto 0..8.
//
// Bounds, per limb i (the host tests hold each at its edge):
//   tight: < 2^W(i) + 2^18, what fe_mul, fe_sqr, fe_carry and
//     fe_from_words return;
//   fe_add of two tight values, or fe_sub(tight, tight): < 3.01 * 2^W(i);
//   fe_mul(f, g): f < 2^(W(i) + 3), g < 3.36 * 2^W(i) (19 g fits a
//     word); fe_sqr(f): f < 3.36 * 2^W(i) (38 f of an odd limb fits). The
//     column sums then stay below 2^63.8.
// A value leaves this form only through fe_to_words, fully reduced (< p).
// Every function is __host__ __device__, built by g++ for the CPU tests
// (csrc/host_check.cpp).
#pragma once
#include "limbs.cuh"

struct Fe {
  uint32_t v[10];
};

#define FE_W(i) (26 - ((i) & 1))
#define FE_MASK(i) ((1u << FE_W(i)) - 1u)

// limb i's bit offset: ceil(25.5 i)
HD int fe_off(int i) { return (51 * i + 1) >> 1; }

// limb i of p = 2^255 - 19
HD uint32_t fe_p(int i) { return i == 0 ? 0x3ffffedu : FE_MASK(i); }

HD Fe fe_zero() {
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = 0;
  return r;
}

HD Fe fe_one() {
  Fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

HD Fe fe_add(const Fe& a, const Fe& b) {
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = a.v[i] + b.v[i];
  return r;
}

// a - b as a + 2p - b (b tight: each limb below 2p's)
HD Fe fe_sub(const Fe& a, const Fe& b) {
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = a.v[i] + 2 * fe_p(i) - b.v[i];
  return r;
}

// a - b as a + 4p - b (b at most the sum of two tight values)
HD Fe fe_sub4(const Fe& a, const Fe& b) {
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = a.v[i] + 4 * fe_p(i) - b.v[i];
  return r;
}

// One carry pass, every limb at once (limbs below 2^32 in, tight out).
HD Fe fe_carry(const Fe& a) {
  uint32_t c[10];
  Fe r;
  for (int i = 0; i < 10; ++i) {
    c[i] = a.v[i] >> FE_W(i);
    r.v[i] = a.v[i] & FE_MASK(i);
  }
  r.v[0] += 19 * c[9];
  for (int i = 1; i < 10; ++i) r.v[i] += c[i - 1];
  return r;
}

// The column sums to tight limbs: carries in ref10's order, two chains
// side by side (0 1 2 3 4 | 4 5 6 7 8 9 0).
HD Fe fe_carry_wide(uint64_t* h) {
  const int order[12] = {0, 4, 1, 5, 2, 6, 3, 7, 4, 8, 9, 0};
  for (int s = 0; s < 12; ++s) {
    const int i = order[s];
    const uint64_t c = h[i] >> FE_W(i);
    h[i] &= FE_MASK(i);
    if (i == 9)
      h[0] += 19 * c;
    else
      h[i + 1] += c;
  }
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = (uint32_t)h[i];
  return r;
}

HD Fe fe_mul(const Fe& f, const Fe& g) {
  uint32_t g19[10], f2[10];
  for (int i = 0; i < 10; ++i) {
    g19[i] = 19 * g.v[i];
    f2[i] = (i & 1) ? 2 * f.v[i] : f.v[i];
  }
  uint64_t h[10];
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = 0; j < 10; ++j)
      h[(i + j) % 10] += (uint64_t)((i & j & 1) ? f2[i] : f.v[i]) *
                         (i + j >= 10 ? g19[j] : g.v[j]);
  return fe_carry_wide(h);
}

// f^2: 55 partial products (each off-diagonal pair once, doubled).
HD Fe fe_sqr(const Fe& f) {
  uint64_t h[10];
  for (int k = 0; k < 10; ++k) h[k] = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i)
#pragma unroll
    for (int j = i; j < 10; ++j) {
      const uint32_t odd = (uint32_t)(i & j & 1) + 1u;  // 2 when both odd
      const uint32_t a = i < j ? 2 * f.v[i] : f.v[i];
      const uint32_t b = f.v[j] * (i + j >= 10 ? 19u * odd : odd);
      h[(i + j) % 10] += (uint64_t)a * b;
    }
  return fe_carry_wide(h);
}

HD Fe fe_nsqr(Fe a, int n) {
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int i = 0; i < n; ++i) a = fe_sqr(a);
  return a;
}

// Any 256-bit value (8 words) to tight limbs: bits 0..254 split by offset,
// bit 255 folds in as 19.
HD Fe fe_from_words(const uint32_t* w) {
  Fe r;
  for (int i = 0; i < 10; ++i) {
    const int o = fe_off(i), k = o >> 5, s = o & 31;
    uint32_t v = w[k] >> s;
    if (s + FE_W(i) > 32) v |= w[k + 1] << (32 - s);
    r.v[i] = v & FE_MASK(i);
  }
  r.v[0] += 19 * (w[7] >> 31);
  return r;
}

// The canonical words (< p) of a (limbs below 2^31).
HD void fe_to_words(uint32_t* w, const Fe& a) {
  uint32_t h[10];
  for (int i = 0; i < 10; ++i) h[i] = a.v[i];
  for (int pass = 0; pass < 2; ++pass)  // every limb within its width
    for (int i = 0; i < 10; ++i) {
      const uint32_t c = h[i] >> FE_W(i);
      h[i] &= FE_MASK(i);
      if (i == 9)
        h[0] += 19 * c;
      else
        h[i + 1] += c;
    }
  // the value is below 2^255; q = 1 iff it is at least p
  uint32_t q = (h[0] + 19) >> 26;
  for (int i = 1; i < 10; ++i) q = (h[i] + q) >> FE_W(i);
  h[0] += 19 * q;
  for (int i = 0; i < 9; ++i) {
    h[i + 1] += h[i] >> FE_W(i);
    h[i] &= FE_MASK(i);
  }
  h[9] &= FE_MASK(9);
  for (int k = 0; k < 8; ++k) w[k] = 0;
  for (int i = 0; i < 10; ++i) {
    const int o = fe_off(i), k = o >> 5, s = o & 31;
    w[k] |= h[i] << s;
    if (s + FE_W(i) > 32) w[k + 1] |= h[i] >> (32 - s);
  }
}

HD Fe fe_load16(const int32_t* p) {
  uint32_t w[8];
  load16(p, w);
  return fe_from_words(w);
}

HD void fe_store16(int32_t* p, const Fe& a) {
  uint32_t w[8];
  fe_to_words(w, a);
  store16(p, w);
}

HD bool fe_is_neg(const Fe& a) {
  uint32_t w[8];
  fe_to_words(w, a);
  return w[0] & 1u;
}

HD bool fe_eq(const Fe& a, const Fe& b) {
  uint32_t x[8], y[8], d = 0;
  fe_to_words(x, a);
  fe_to_words(y, b);
  for (int k = 0; k < 8; ++k) d |= x[k] ^ y[k];
  return d == 0;
}

HD Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
  for (int i = 0; i < 10; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}
