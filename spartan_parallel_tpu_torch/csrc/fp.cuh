// Base field GF(p), p = 2^255 - 19: the per-element arithmetic of the JAX
// package's ops/fp.py for 8 x 32-bit words. Reduction folds the high half
// with 2^256 = 38 (mod p). Every output is fully reduced (< p).
#pragma once
#include "limbs.cuh"

#define FP_P_WORDS                                                     \
  {0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu,    \
   0xffffffffu, 0xffffffffu, 0x7fffffffu}

// r = (lo + 2^256 * hi) mod p for a 512-bit value given as 16 words.
HD void fp_reduce512(uint32_t* r, const uint32_t* w) {
  const uint32_t p[8] = FP_P_WORDS;
  uint64_t c = 0;
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)w[k + 8] * 38u + w[k];
    r[k] = (uint32_t)c;
    c >>= 32;
  }
  // value = r + 2^256 * c with c < 39: fold once more
  c = (uint64_t)r[0] + c * 38u;
  r[0] = (uint32_t)c;
  c >>= 32;
  for (int k = 1; k < 8; ++k) {
    c += r[k];
    r[k] = (uint32_t)c;
    c >>= 32;
  }
  if (c) {  // wrapped past 2^256 (then r is tiny): add 38 once more
    c = (uint64_t)r[0] + 38u;
    r[0] = (uint32_t)c;
    c >>= 32;
    for (int k = 1; k < 8 && c; ++k) {
      c += r[k];
      r[k] = (uint32_t)c;
      c >>= 32;
    }
  }
  // r < 2^256 = 2p + 38
  csub8(r, p);
  csub8(r, p);
}

HD void fp_mul(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint32_t w[16];
  for (int k = 0; k < 16; ++k) w[k] = 0;
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
      c += (uint64_t)a[j] * b[i] + w[i + j];
      w[i + j] = (uint32_t)c;
      c >>= 32;
    }
    w[i + 8] = (uint32_t)c;
  }
  fp_reduce512(r, w);
}

HD void fp_add(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  const uint32_t p[8] = FP_P_WORDS;
  add8(r, a, b);  // a + b < 2p < 2^256
  csub8(r, p);
}

HD void fp_sub(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  const uint32_t p[8] = FP_P_WORDS;
  if (sub8(r, a, b)) add8(r, r, p);
}
