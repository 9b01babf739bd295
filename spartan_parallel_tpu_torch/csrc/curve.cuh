// curve25519 points in extended twisted-Edwards coordinates (a = -1):
// the per-point arithmetic of the JAX package's ops/curve.py. The addition
// law is complete (add-2008-hwcd-3), so the identity and doubling need no
// branch. Host tensors hold a point as (4, 16) int32: X, Y, Z, T in 16-bit
// limbs.
#pragma once
#include "fp.cuh"

#define FP_D2_WORDS                                                    \
  {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u,    \
   0x198e80f2u, 0x56dffce7u, 0x2406d9dcu}

struct Point {
  uint32_t X[8], Y[8], Z[8], T[8];
};

HD void pt_identity(Point& p) {
  zero8(p.X);
  zero8(p.Y);
  zero8(p.Z);
  zero8(p.T);
  p.Y[0] = 1;
  p.Z[0] = 1;
}

HD void pt_load(Point& p, const int32_t* s) {
  load16(s, p.X);
  load16(s + 16, p.Y);
  load16(s + 32, p.Z);
  load16(s + 48, p.T);
}

HD void pt_store(int32_t* s, const Point& p) {
  store16(s, p.X);
  store16(s + 16, p.Y);
  store16(s + 32, p.Z);
  store16(s + 48, p.T);
}

// r = p + q (r may alias p or q): 9 field multiplications.
HD void pt_add(Point& r, const Point& p, const Point& q) {
  const uint32_t d2[8] = FP_D2_WORDS;
  uint32_t a[8], b[8], c[8], d[8], t[8], u[8];
  fp_sub(t, p.Y, p.X);
  fp_sub(u, q.Y, q.X);
  fp_mul(a, t, u);
  fp_add(t, p.Y, p.X);
  fp_add(u, q.Y, q.X);
  fp_mul(b, t, u);
  fp_mul(t, p.T, d2);
  fp_mul(c, t, q.T);
  fp_mul(t, p.Z, q.Z);
  fp_add(d, t, t);
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

// r = 2p (dbl-2008-hwcd with a = -1; r may alias p).
HD void pt_double(Point& r, const Point& p) {
  uint32_t a[8], b[8], c[8], t[8];
  fp_mul(a, p.X, p.X);
  fp_mul(b, p.Y, p.Y);
  fp_mul(t, p.Z, p.Z);
  fp_add(c, t, t);
  uint32_t zero[8], d[8], e[8], f[8], g[8], h[8];
  zero8(zero);
  fp_sub(d, zero, a);
  fp_add(t, p.X, p.Y);
  fp_mul(e, t, t);
  fp_sub(e, e, a);
  fp_sub(e, e, b);
  fp_add(g, d, b);
  fp_sub(f, g, c);
  fp_sub(h, d, b);
  fp_mul(r.X, e, f);
  fp_mul(r.Y, g, h);
  fp_mul(r.Z, f, g);
  fp_mul(r.T, e, h);
}
