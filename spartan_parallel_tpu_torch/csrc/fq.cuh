// Scalar field mod l (the ristretto255 group order) in Montgomery form,
// R = 2^256: the per-element arithmetic of ops/fq.py and ops/limbs.py of the
// JAX package, re-derived for 8 x 32-bit words. Every input and output is
// fully reduced (< l), so a kernel's result equals the plain version's limb
// for limb.
#pragma once
#include "limbs.cuh"

#define FQ_L_WORDS                                                     \
  {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0x00000000u,    \
   0x00000000u, 0x00000000u, 0x10000000u}
// -l^{-1} mod 2^32
#define FQ_NPRIME 0x12547e1bu
// 1 in Montgomery form: 2^256 mod l
#define FQ_ONE_MONT_WORDS                                              \
  {0x8d98951du, 0xd6ec3174u, 0x737dcf70u, 0xc6ef5bf4u, 0xfffffffeu,    \
   0xffffffffu, 0xffffffffu, 0x0fffffffu}

// r = a * b * 2^-256 mod l (CIOS Montgomery multiplication). a, b < l.
HD void fq_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  const uint32_t l[8] = FQ_L_WORDS;
  uint32_t t[10];
  for (int k = 0; k < 10; ++k) t[k] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * FQ_NPRIME;
    c = ((uint64_t)m * l[0] + t[0]) >> 32;
    for (int j = 1; j < 8; ++j) {
      c += (uint64_t)m * l[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  copy8(r, t);
  csub8(r, l, t[8]);
}

// r = c^e for a Montgomery c, in Montgomery form (square-and-multiply from
// the low bit of e; e = 0 gives the Montgomery one). r may alias c.
HD void fq_pow(uint32_t* r, const uint32_t* c, uint64_t e) {
  const uint32_t one[8] = FQ_ONE_MONT_WORDS;
  uint32_t acc[8], base[8];
  copy8(acc, one);
  copy8(base, c);
  while (e) {
    if (e & 1) fq_mul(acc, acc, base);
    e >>= 1;
    if (e) fq_mul(base, base, base);
  }
  copy8(r, acc);
}

HD void fq_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  const uint32_t l[8] = FQ_L_WORDS;
  uint32_t c = add8(r, a, b);  // a + b < 2l < 2^254: c == 0
  csub8(r, l, c);
}

HD void fq_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  const uint32_t l[8] = FQ_L_WORDS;
  if (sub8(r, a, b)) add8(r, r, l);
}

// lo + r * (hi - lo): one variable of a multilinear table bound to r.
HD void fq_bind(uint32_t* out, const uint32_t* lo, const uint32_t* hi,
                const uint32_t* r) {
  uint32_t d[8];
  fq_sub(d, hi, lo);
  fq_mul(d, r, d);
  fq_add(out, lo, d);
}

// 2 * hi - lo and e + (hi - lo): a table extended to the points 2 and 3.
HD void fq_ext2(uint32_t* out, const uint32_t* lo, const uint32_t* hi) {
  uint32_t t[8];
  fq_add(t, hi, hi);
  fq_sub(out, t, lo);
}

HD void fq_ext3(uint32_t* out, const uint32_t* e2, const uint32_t* lo,
                const uint32_t* hi) {
  uint32_t d[8];
  fq_sub(d, hi, lo);
  fq_add(out, e2, d);
}
