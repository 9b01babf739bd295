// Point operations with a point on four lanes: lane c of a group of four
// holds coordinate c (X, Y, Z, T) as an Fe (csrc/fe.cuh), so that each
// operation's independent products run side by side. Every operation is
// two steps: each lane forms one or two products from the group's
// coordinates (the doubling: X^2, Y^2, Z^2, (X + Y)^2; a cached addition:
// (Y1 -+ X1) (Y2 -+ X2), Z1 2 Z2, T1 2 d T2), then each lane combines the
// group's four products into its new coordinate with one more product
// (X3 = E F, Y3 = G H, Z3 = F G, T3 = E H). A doubling or a cached
// addition is two products deep (curve.cuh's pt_double: 8 in a row,
// pt_add: 9); an addition of two extended points three (the addend's
// T2 2d waits for T1).
//
// The steps compute the field values of curve.cuh's formulas exactly, so
// coordinates equal pt_add's and pt_double's after fe_to_words. A step
// function reads other lanes' values only through its Get argument and
// calls it the same number of times on every lane: on the card Get is a
// shuffle within the group (fe_shfl), in the host model (host_check.cpp
// and the hq_* drivers below) it reads the group's array. The addend of
// ls_add_m comes through GetQ, which may read memory and differ by lane.
#pragma once
#include "curve.cuh"
#include "fe.cuh"

HD Fe fe_d2() {
  const uint32_t w[8] = FP_D2_WORDS;
  return fe_from_words(w);
}

HD Fe fe_coord_identity(int c) {  // (0, 1, 1, 0)
  Fe r = fe_zero();
  r.v[0] = (c == 1 || c == 2);
  return r;
}

// lane c's new coordinate from E, F, G, H
HD Fe ls_finish(int c, const Fe& e, const Fe& f, const Fe& g, const Fe& h) {
  return fe_mul(fe_select(c & 1, h, f), fe_select(c == 0 || c == 3, e, g));
}

// Step 2 of an addition: M(0..3) = A, B, D, C.
template <class Get>
HD Fe ls_out_add(int c, Get M) {
  const Fe a = M(0), b = M(1), d = M(2), cc = M(3);
  return ls_finish(c, fe_sub(b, a), fe_sub(d, cc), fe_add(d, cc),
                   fe_add(b, a));
}

// Step 2 of a doubling: M(0..3) = X^2, Y^2, Z^2, (X + Y)^2. With D = -X^2:
// E = (X + Y)^2 - X^2 - Y^2, G = D + Y^2, F = G - 2 Z^2, H = D - Y^2 (E
// and F carried once to keep the products' inputs in bounds).
template <class Get>
HD Fe ls_out_dbl(int c, Get M) {
  const Fe a = M(0), b = M(1), t = M(2), s = M(3);
  const Fe ab = fe_add(a, b), g = fe_sub(b, a);
  const Fe e = fe_carry(fe_sub4(s, ab));
  const Fe f = fe_carry(fe_sub4(g, fe_add(t, t)));
  return ls_finish(c, e, f, g, fe_sub4(fe_zero(), ab));
}

// Step 1 of a doubling.
template <class Get>
HD Fe ls_dbl_m(int c, const Fe& own, Get P) {
  const Fe x = P(0), y = P(1);
  return fe_sqr(fe_select(c == 3, fe_add(x, y), own));
}

// Step 1 of a cached addition; lane c holds the addend's component c of
// (Y - X, Y + X, 2 Z, 2 d T).
template <class Get>
HD Fe ls_addc_m(int c, const Fe& own, const Fe& q, Get P) {
  const Fe x = P(0), y = P(1);
  return fe_mul(
      fe_select(c == 0, fe_sub(y, x), fe_select(c == 1, fe_add(y, x), own)),
      q);
}

// The cached form's component c of the group's point.
template <class Get>
HD Fe ls_cached(int c, const Fe& own, Get P) {
  const Fe x = P(0), y = P(1), t2d = fe_mul(own, fe_d2());
  const Fe zt = fe_select(c == 2, fe_add(own, own), t2d);
  return fe_select(c == 0, fe_sub(y, x), fe_select(c == 1, fe_add(y, x), zt));
}

// Step 1 of an addition of an extended point Q (pt_add's products; lane 3
// forms T1 2d, then times T2).
template <class Get, class GetQ>
HD Fe ls_add_m(int c, const Fe& own, Get P, GetQ Q) {
  const Fe x = P(0), y = P(1);
  const Fe qa = Q(c < 2 ? 0 : 2), qb = Q(c < 2 ? 1 : 3);
  const Fe u =
      fe_select(c == 0, fe_sub(y, x), fe_select(c == 1, fe_add(y, x), own));
  const Fe zd = fe_select(c == 2, fe_add(qa, qa), fe_d2());
  const Fe v = fe_select(c == 0, fe_sub(qb, qa),
                         fe_select(c == 1, fe_add(qb, qa), zd));
  return fe_mul(fe_mul(u, v), fe_select(c == 3, qb, fe_one()));
}

#ifdef __CUDACC__
// The drivers on the card: a group is four neighbouring lanes of a warp
// (base = its first lane); every lane of the warp takes part.
#define LANES_FULL 0xffffffffu

__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src) {
  Fe r;
  for (int i = 0; i < 10; ++i)
    r.v[i] = __shfl_sync(LANES_FULL, a.v[i], src);
  return r;
}

__device__ __forceinline__ void q_double(Fe& own, int c, int base) {
  const Fe m =
      ls_dbl_m(c, own, [&](int s) { return fe_shfl(own, base + s); });
  own = ls_out_dbl(c, [&](int s) { return fe_shfl(m, base + s); });
}

__device__ __forceinline__ void q_add_cached(Fe& own, const Fe& q, int c,
                                             int base) {
  const Fe m =
      ls_addc_m(c, own, q, [&](int s) { return fe_shfl(own, base + s); });
  own = ls_out_add(c, [&](int s) { return fe_shfl(m, base + s); });
}

__device__ __forceinline__ Fe q_cached(const Fe& own, int c, int base) {
  return ls_cached(c, own, [&](int s) { return fe_shfl(own, base + s); });
}

template <class GetQ>
__device__ __forceinline__ void q_add(Fe& own, int c, int base, GetQ Q) {
  const Fe m =
      ls_add_m(c, own, [&](int s) { return fe_shfl(own, base + s); }, Q);
  own = ls_out_add(c, [&](int s) { return fe_shfl(m, base + s); });
}
#else
// The host model: the same steps, lane by lane, on a group's array P[4].
static void hq_double(Fe* P) {
  Fe m[4];
  for (int c = 0; c < 4; ++c)
    m[c] = ls_dbl_m(c, P[c], [&](int s) { return P[s]; });
  for (int c = 0; c < 4; ++c)
    P[c] = ls_out_dbl(c, [&](int s) { return m[s]; });
}

static void hq_add_cached(Fe* P, const Fe* q) {
  Fe m[4];
  for (int c = 0; c < 4; ++c)
    m[c] = ls_addc_m(c, P[c], q[c], [&](int s) { return P[s]; });
  for (int c = 0; c < 4; ++c)
    P[c] = ls_out_add(c, [&](int s) { return m[s]; });
}

static void hq_cached(Fe* out, const Fe* P) {
  for (int c = 0; c < 4; ++c)
    out[c] = ls_cached(c, P[c], [&](int s) { return P[s]; });
}

template <class GetQ>
static void hq_add(Fe* P, GetQ Q) {
  Fe m[4];
  for (int c = 0; c < 4; ++c)
    m[c] = ls_add_m(c, P[c], [&](int s) { return P[s]; }, Q);
  for (int c = 0; c < 4; ++c)
    P[c] = ls_out_add(c, [&](int s) { return m[s]; });
}
#endif

// --------------------------------------------------------------------------
// The bullet generator fold: out = k_l L + k_r R, a joint double-and-add
// over the two shared scalars from their top set bit (fold_top; the start
// is fold_pick's point), with L, R and L + R in cached form: each later bit
// a doubling and, where fold_bits is not 0, one cached addition. k_fold
// (csrc/msm.cu) runs a pair on a group; host_check.cpp host_fold runs the
// same steps on the host.
// --------------------------------------------------------------------------
HD int fold_bits(const uint32_t* kl, const uint32_t* kr, int bit) {
  return (int)((kl[bit >> 5] >> (bit & 31)) & 1u) |
         (int)(((kr[bit >> 5] >> (bit & 31)) & 1u) << 1);
}

// the highest bit set in k_l or k_r (0 when both are 0)
HD int fold_top(const uint32_t* kl, const uint32_t* kr) {
  int top = 252;
  while (top > 0 && !fold_bits(kl, kr, top)) --top;
  return top;
}

HD Fe fold_pick(int sel, int c, const Fe& l, const Fe& r, const Fe& lr) {
  return fe_select(sel == 3, lr,
                   fe_select(sel == 1, l,
                             fe_select(sel == 2, r, fe_coord_identity(c))));
}
