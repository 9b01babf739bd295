// The eq table's per-entry arithmetic, shared by K1's k_eq_evals
// (csrc/fq.cu) and its host build (csrc/host_check.cpp).
//
// eq(r, x) over the boolean hypercube: entry idx of the (2^ell) table is
// the product over j < ell of r[j] where bit ell-1-j of idx is set and of
// 1 - r[j] where it is clear (the index's most significant bit belongs to
// r[0], dense_mlpoly.rs:76-91). The table splits into chunks of 2^k
// consecutive entries (k = eq_chunk_bits(ell)): chunk c's entries share the
// high factor H(c), the product over the top ell - k variables picked by the
// bits of c, and differ in the low k bits. Seeded with H(c), k doubling
// levels build the chunk in place: level m adds variable r[ell-1-m] as bit
// m of the index, entry i splitting into i (factor 1 - r) and i + 2^m
// (factor r) as lo = v - v r, hi = v r: one product an entry. Field
// products are exact and every value is fully reduced, so any order of the
// products gives the plain version's limbs.
#pragma once
#include "fq.cuh"

// log2 of the entries of one chunk (one block of the kernel)
#define EQ_CHUNK_BITS 10
// the high factor is a product over the lanes of one warp
#define EQ_MAX_HIGH 32

HD int eq_chunk_bits(int ell) {
  return ell < EQ_CHUNK_BITS ? ell : EQ_CHUNK_BITS;
}

// bit (h - 1 - j) of the chunk index c: the bit of variable j < h
HD int eq_high_bit(unsigned long long c, int h, int j) {
  return (int)((c >> (h - 1 - j)) & 1ull);
}

// r if bit is set, else 1 - r (both Montgomery)
HD void eq_factor(uint32_t* f, const uint32_t* r, int bit) {
  if (bit) {
    copy8(f, r);
  } else {
    const uint32_t one[8] = FQ_ONE_MONT_WORDS;
    fq_sub(f, one, r);
  }
}

// one doubling step: v splits into lo = v (1 - r) and hi = v r. lo may
// alias v.
HD void eq_split(uint32_t* lo, uint32_t* hi, const uint32_t* v,
                 const uint32_t* r) {
  fq_mul(hi, v, r);
  fq_sub(lo, v, hi);
}
