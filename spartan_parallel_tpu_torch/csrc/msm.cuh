// K2's arithmetic (csrc/msm.cu): points in cached form and signed 8-bit
// scalar digits, __host__ __device__ so that g++ builds them for the CPU
// tests (csrc/host_check.cpp, which also holds a host model of the
// kernels' order of work).
#pragma once
#include "curve.cuh"

#define MSM_NWIN 32     // 8-bit windows of a 256-bit scalar
#define MSM_NBUCKET 128  // |signed digit| in 1..128

// A point prepared as an addend: (Y - X, Y + X, 2 Z, 2 d T). Adding it to
// an extended point costs 8 field products (pt_add: 9), and its negative
// is the same words with Y - X and Y + X swapped and 2 d T negated.
struct alignas(16) Cached {
  uint32_t ymx[8], ypx[8], z2[8], t2d[8];
};

HD void pt_to_cached(Cached& c, const Point& p) {
  const uint32_t d2[8] = FP_D2_WORDS;
  fp_sub(c.ymx, p.Y, p.X);
  fp_add(c.ypx, p.Y, p.X);
  fp_add(c.z2, p.Z, p.Z);
  fp_mul(c.t2d, p.T, d2);
}

// -q in cached form: Y - X and Y + X trade places, 2 d T changes sign.
HD void cached_neg(Cached& c) {
  uint32_t zero[8];
  zero8(zero);
  for (int k = 0; k < 8; ++k) {
    const uint32_t t = c.ymx[k];
    c.ymx[k] = c.ypx[k];
    c.ypx[k] = t;
  }
  fp_sub(c.t2d, zero, c.t2d);
}

// r = p + q (r may alias p): add-2008-hwcd-3 with the addend's half of
// the work done once in pt_to_cached.
HD void pt_add_cached(Point& r, const Point& p, const Cached& q) {
  uint32_t a[8], b[8], c[8], d[8], t[8];
  fp_sub(t, p.Y, p.X);
  fp_mul(a, t, q.ymx);
  fp_add(t, p.Y, p.X);
  fp_mul(b, t, q.ypx);
  fp_mul(c, p.T, q.t2d);
  fp_mul(d, p.Z, q.z2);
  uint32_t e[8], f[8], g[8], h[8];
  fp_sub(e, b, a);
  fp_sub(f, d, c);
  fp_add(g, d, c);
  fp_add(h, b, a);
  fp_mul(r.X, e, f);
  fp_mul(r.Y, g, h);
  fp_mul(r.Z, f, g);
  fp_mul(r.T, e, h);
}

// The signed 8-bit digits of a scalar s (8 words): s = sum_w dig[w]
// 2^(8 w), dig[w] in [-128, 128). Byte w plus the carry in becomes
// itself below 128, else itself - 256 and a carry into window w + 1.
// Returns the carry out of window 31: 0 for every s < 127 * 2^248, so
// for every canonical scalar (< l < 2^253).
HD uint32_t signed_digits(int8_t* dig, const uint32_t* s) {
  uint32_t carry = 0;
  for (int w = 0; w < MSM_NWIN; ++w) {
    const uint32_t v = ((s[w >> 2] >> (8 * (w & 3))) & 0xffu) + carry;
    carry = v >= 128u;
    dig[w] = (int8_t)((int)v - (int)(carry << 8));
  }
  return carry;
}
