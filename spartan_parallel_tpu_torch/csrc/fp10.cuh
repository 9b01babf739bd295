// GF(2^255 - 19) on ten lanes: the product of the ENCODE chain. A value
// sits on a group of ten lanes in fe.cuh's unsaturated form, lane k
// holding limb k (26 or 25 bits and a little more). A product's 100
// partial products spread over the lanes, ten each: lane k forms fe_mul's
// column k (the same terms, with their 19 and 2), a 64-bit sum with no
// carry inside it, then two carry passes run on all lanes at once (a
// 64-bit carry from lane k - 1, then a 32-bit one; lane 0 takes 19 times
// lane 9's). Each pass ends in fixed bounds, so no lane votes and no pass
// repeats. Additions, subtractions and negations are limb by limb on each
// lane, with no carry and no shuffle.
//
// Bounds, per limb k (W = 26 - (k & 1), the host tests hold each edge):
//   mul's out: < 2^W + 2^18.2, limb 0 < 2^26 + 2^22.5 (pass 1 leaves
//     < 2^43.2 from column sums < 2^63.8; pass 2's carries are < 2^18.2);
//   mul(f, g): f < 2^(W + 3), g < 3.36 * 2^W (fe.cuh's, the same sums);
//   add of two mul outputs: < 2.18 * 2^W; sub(a, b) = a + 2 p - b and
//   neg(b) = 2 p - b for b <= 2 p limb by limb (a mul output or a neg):
//   sub of a mul output < 3.09 * 2^W.
// A value leaves this form only through words (fe_to_words, fully
// reduced, on every lane of the group).
//
// The steps (fp10_*) read other lanes' limbs only through their Get
// arguments, the same number of times on every lane: on the card G10's
// shuffles within the group, on the host G10Host's arrays, the lanes one
// after another (csrc/host_check.cpp).
#pragma once
#include "fe.cuh"

// lane k's column of f * g (F(i): f's limb i, G(j): g's limb j): the pairs
// i + j = k (mod 10), g's limb times 19 where i + j >= 10, f's doubled
// where both are odd (then k is even)
template <class GetF, class GetG>
HD uint64_t fp10_column(int k, GetF F, GetG G) {
  uint64_t h = 0;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t fi = F(i), gj = G(i > k ? k + 10 - i : k - i);
    const uint32_t a = (i & 1) && !(k & 1) ? 2 * fi : fi;
    h += (uint64_t)a * (i > k ? 19 * gj : gj);
  }
  return h;
}

// carry pass 1 on the column sums: lane k keeps its low W bits and takes
// lane k - 1's carry (lane 0: 19 times lane 9's); C(s): lane s's h >> W
template <class Get>
HD uint64_t fp10_carry64(int k, uint64_t h, Get C) {
  const uint64_t c = C(k ? k - 1 : 9);
  return (h & FE_MASK(k)) + (k ? c : 19 * c);
}

// carry pass 2 (h below 2^44); C(s): lane s's (uint32_t)(h >> W)
template <class Get>
HD uint32_t fp10_carry32(int k, uint64_t h, Get C) {
  const uint32_t c = C(k ? k - 1 : 9);
  return ((uint32_t)h & FE_MASK(k)) + (k ? c : 19 * c);
}

HD uint32_t fp10_sub(int k, uint32_t a, uint32_t b) {
  return a + 2 * fe_p(k) - b;
}

// limb k of the tight limbs of a 256-bit value w (fe_from_words)
HD uint32_t fp10_limb(const uint32_t* w, int k) {
  const int o = fe_off(k), i = o >> 5, s = o & 31;
  uint32_t v = w[i] >> s;
  if (s + FE_W(k) > 32) v |= w[i + 1] << (32 - s);
  v &= FE_MASK(k);
  return k ? v : v + 19 * (w[7] >> 31);
}

// limb k of a, by selects (k may differ by lane: an array indexed at run
// time would live in local memory)
HD uint32_t fe_pick(const Fe& a, int k) {
  uint32_t r = a.v[0];
  for (int i = 1; i < 10; ++i) r = k == i ? a.v[i] : r;
  return r;
}

#ifdef __CUDACC__
// The group's operations on the card: every lane of the warp calls them
// (three groups a warp, lanes 0-9, 10-19 and 20-29; lanes 30 and 31
// repeat lanes 20 and 21 and keep nothing), the same operations in the
// same order: the encoding has no branch on data.
#define FP10_FULL 0xffffffffu

struct G10 {
  int k, base, grp;
  bool live;
  typedef uint32_t V;

  __device__ G10(int lane)
      : k(lane < 30 ? lane % 10 : lane - 30),
        base(lane < 30 ? lane - lane % 10 : 20),
        grp(lane < 30 ? lane / 10 : 2),
        live(lane < 30) {}
  __device__ uint32_t get(uint32_t v, int s) const {
    return __shfl_sync(FP10_FULL, v, base + s);
  }
  __device__ V mul(V a, V b) const {
    const uint64_t h = fp10_column(k, [&](int i) { return get(a, i); },
                                   [&](int j) { return get(b, j); });
    const uint64_t c = h >> FE_W(k);
    const uint64_t h1 = fp10_carry64(k, h, [&](int s) {
      return (uint64_t)__shfl_sync(FP10_FULL, c, base + s);
    });
    const uint32_t c1 = (uint32_t)(h1 >> FE_W(k));
    return fp10_carry32(k, h1, [&](int s) { return get(c1, s); });
  }
  __device__ V sqr(V a) const { return mul(a, a); }
  __device__ V add(V a, V b) const { return a + b; }
  __device__ V sub(V a, V b) const { return fp10_sub(k, a, b); }
  __device__ V neg(V a) const { return fp10_sub(k, 0, a); }
  __device__ V select(bool c, V a, V b) const { return c ? a : b; }
  // this lane's limb of the value whose words are w (any below 2^256):
  // load for w in shared or global memory, constant for w in registers
  __device__ V load(const uint32_t* w) const { return fp10_limb(w, k); }
  __device__ V constant(const uint32_t* w) const {
    return fe_pick(fe_from_words(w), k);
  }
  __device__ void words(uint32_t* w, V a) const {
    Fe r;
    for (int i = 0; i < 10; ++i) r.v[i] = get(a, i);
    fe_to_words(w, r);
  }
  __device__ bool is_neg(V a) const {
    uint32_t w[8];
    words(w, a);
    return w[0] & 1u;
  }
  __device__ bool eq(V a, V b) const {
    uint32_t x[8], y[8], d = 0;
    words(x, a);
    words(y, b);
    for (int j = 0; j < 8; ++j) d |= x[j] ^ y[j];
    return d == 0;
  }
  // the canonical little-endian bytes: lane k < 8 writes bytes 4k..4k+3
  __device__ void to_bytes(uint8_t* out, V a) const {
    uint32_t w[8], wk = 0;
    words(w, a);
    for (int j = 0; j < 8; ++j)
      if (j == k) wk = w[j];
    if (live && k < 8)
      for (int b = 0; b < 4; ++b) out[4 * k + b] = (uint8_t)(wk >> (8 * b));
    __syncwarp();
  }
};
#else
// The host model: a value's ten limbs, each step run for the lanes in
// turn.
struct G10Host {
  typedef Fe V;

  V mul(const V& a, const V& b) const {
    uint64_t h[10], c[10], h1[10];
    uint32_t c1[10];
    V r;
    for (int k = 0; k < 10; ++k)
      h[k] = fp10_column(k, [&](int i) { return a.v[i]; },
                         [&](int j) { return b.v[j]; });
    for (int k = 0; k < 10; ++k) c[k] = h[k] >> FE_W(k);
    for (int k = 0; k < 10; ++k)
      h1[k] = fp10_carry64(k, h[k], [&](int s) { return c[s]; });
    for (int k = 0; k < 10; ++k) c1[k] = (uint32_t)(h1[k] >> FE_W(k));
    for (int k = 0; k < 10; ++k)
      r.v[k] = fp10_carry32(k, h1[k], [&](int s) { return c1[s]; });
    return r;
  }
  V sqr(const V& a) const { return mul(a, a); }
  V add(const V& a, const V& b) const { return fe_add(a, b); }
  V sub(const V& a, const V& b) const {
    V r;
    for (int k = 0; k < 10; ++k) r.v[k] = fp10_sub(k, a.v[k], b.v[k]);
    return r;
  }
  V neg(const V& a) const { return sub(fe_zero(), a); }
  V select(bool c, const V& a, const V& b) const { return c ? a : b; }
  V load(const uint32_t* w) const {
    V r;
    for (int k = 0; k < 10; ++k) r.v[k] = fp10_limb(w, k);
    return r;
  }
  V constant(const uint32_t* w) const { return load(w); }
  void words(uint32_t* w, const V& a) const { fe_to_words(w, a); }
  bool is_neg(const V& a) const { return fe_is_neg(a); }
  bool eq(const V& a, const V& b) const { return fe_eq(a, b); }
  void to_bytes(uint8_t* out, const V& a) const {
    uint32_t w[8];
    fe_to_words(w, a);
    for (int j = 0; j < 32; ++j) out[j] = (uint8_t)(w[j >> 2] >> (8 * (j & 3)));
  }
};
#endif
