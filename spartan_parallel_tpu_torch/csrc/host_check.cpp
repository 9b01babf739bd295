// Host build of the per-element arithmetic in fq.cuh, fp.cuh, fe.cuh,
// curve.cuh and msm.cuh, of the lane-split point operations and the fold
// in lanes.cuh, and of the device transcript and round tail in keccak.cuh,
// ristretto.cuh and zk_round.cuh (g++, no CUDA), so the CPU tests can hold
// the kernels' arithmetic against the plain PyTorch versions, Python
// integers and the JAX package. Code that runs on several lanes runs here
// through its host model: the same step functions, lane by lane, in the
// kernel's order (lanes.cuh hq_*, keccak.cuh keccak_lanes_host and HostX,
// ristretto.cuh comb_host). Each entry maps over n elements of 16-limb
// int32 values (points: 4 x 16 limbs; states and encodings: one int32 per
// byte).
#include <vector>

#include "curve.cuh"
#include "fe.cuh"
#include "fq.cuh"
#include "lanes.cuh"
#include "msm.cuh"
#include "zk_round.cuh"

// a point's coordinates as the four lanes of a group hold them
static void fe_point_load(Fe* P, const int32_t* s) {
  for (int c = 0; c < 4; ++c) P[c] = fe_load16(s + 16 * c);
}

static void fe_point_store(int32_t* s, const Fe* P) {
  for (int c = 0; c < 4; ++c) fe_store16(s + 16 * c, P[c]);
}

// K2's host model (csrc/msm.cu): the weighted bucket sum in the order the
// window kernel forms it. One warp holds a window's 128 buckets, lane l
// the four B_{l + 1 + 32 i} (i = 0..3: the
// small digits of a top window, which a canonical scalar keeps below 17,
// spread over 16 lanes), and walks them from the top with a running sum:
// r = S_l = sum_i B_{l+1+32i} and w = W_l = sum_i i B_{l+1+32i}
// (lane_sums). Then
//   sum_m m B_m = 32 A + B,  A = sum_l W_l,  B = sum_l Q_l,
//   Q_l = sum_{l' >= l} S_l':
// a suffix scan of the S_l over the lanes (5 levels), then the halving
// trees of A and B side by side (5 levels, 16 lanes each at the first);
// the 5 doublings of A wait for the row combine. bucket_combine is that
// order of additions for `lanes` lanes (a power of two; bucket
// l + 1 + lanes i at lane l), r[l] and w[l] in, A in w[0] and B in r[0]
// (the sum: lanes A + B).
static void lane_sums(Point& r, Point& w, const Point* const* bucket4) {
  pt_identity(r);
  pt_identity(w);
  for (int i = 3; i >= 0; --i) {
    pt_add(r, r, *bucket4[i]);
    if (i > 0) pt_add(w, w, r);
  }
}

static void bucket_combine(Point* r, Point* w, int lanes) {
  for (int off = 1; off < lanes; off <<= 1)  // ascending l reads r[l + off]
    for (int l = 0; l + off < lanes; ++l)    // before this level updates it
      pt_add(r[l], r[l], r[l + off]);
  for (int off = lanes >> 1; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) {
      pt_add(w[l], w[l], w[l + off]);
      pt_add(r[l], r[l], r[l + off]);
    }
}

extern "C" {

void host_fq_mul(const int32_t* a, const int32_t* b, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(a + 16 * i, x);
    load16(b + 16 * i, y);
    fq_mul(z, x, y);
    store16(out + 16 * i, z);
  }
}

void host_fq_bind(const int32_t* lo, const int32_t* hi, const int32_t* r,
                  int32_t* out, long n) {
  uint32_t rr[8];
  load16(r, rr);
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(lo + 16 * i, x);
    load16(hi + 16 * i, y);
    fq_bind(z, x, y, rr);
    store16(out + 16 * i, z);
  }
}

void host_fq_pow(const int32_t* c, const uint64_t* e, int32_t* out,
                 long n) {
  uint32_t x[8], z[8];
  load16(c, x);
  for (long i = 0; i < n; ++i) {
    fq_pow(z, x, e[i]);
    store16(out + 16 * i, z);
  }
}

void host_fp_mul(const int32_t* a, const int32_t* b, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(a + 16 * i, x);
    load16(b + 16 * i, y);
    fp_mul(z, x, y);
    store16(out + 16 * i, z);
  }
}

// Of raw limbs (10 per value, any within the product's bounds): kind 0
// fe_mul, 1 fe_sqr, 2 the ten-lane product through its host model
// (fp10.cuh G10Host), 3 its squaring; out as canonical words (8 per
// value), and the product's limbs (10 per value).
void host_fe_mul(const uint32_t* f, const uint32_t* g, uint32_t* out,
                 uint32_t* limbs, long n, int kind) {
  const G10Host f10;
  for (long i = 0; i < n; ++i) {
    Fe a, b, r;
    for (int k = 0; k < 10; ++k) {
      a.v[k] = f[10 * i + k];
      b.v[k] = g[10 * i + k];
    }
    r = kind == 0 ? fe_mul(a, b)
        : kind == 1 ? fe_sqr(a)
        : kind == 2 ? f10.mul(a, b)
                    : f10.sqr(a);
    fe_to_words(out + 8 * i, r);
    for (int k = 0; k < 10; ++k) limbs[10 * i + k] = r.v[k];
  }
}

// words (8 per value, any 256-bit value) -> fe_from_words -> fe_to_words;
// also the limbs fe_from_words gives and those the ten lanes load
// (fp10.cuh fp10_limb, lane by lane)
void host_fe_words(const uint32_t* w, uint32_t* out, uint32_t* limbs,
                   uint32_t* lane_limbs, long n) {
  for (long i = 0; i < n; ++i) {
    const Fe a = fe_from_words(w + 8 * i);
    for (int k = 0; k < 10; ++k) {
      limbs[10 * i + k] = a.v[k];
      lane_limbs[10 * i + k] = fp10_limb(w + 8 * i, k);
    }
    fe_to_words(out + 8 * i, a);
  }
}

// The lane-split point operations' host models: op 0 p + q (extended,
// ls_add_m), 1 2p (ls_dbl_m), 2 p + q through q's cached form (ls_cached,
// ls_addc_m)
void host_ls_point(const int32_t* p, const int32_t* q, int32_t* out, long n,
                   int op) {
  for (long i = 0; i < n; ++i) {
    Fe P[4], Q[4];
    fe_point_load(P, p + 64 * i);
    fe_point_load(Q, q + 64 * i);
    if (op == 0) {
      hq_add(P, [&](int k) { return Q[k]; });
    } else if (op == 1) {
      hq_double(P);
    } else {
      Fe cq[4];
      hq_cached(cq, Q);
      hq_add_cached(P, cq);
    }
    fe_point_store(out + 64 * i, P);
  }
}

// k_fold's host model: the same steps as csrc/msm.cu, a pair at a time
void host_fold(const int32_t* L, const int32_t* R, const int32_t* k,
               int32_t* out, long n) {
  uint32_t kl[8], kr[8];
  load16(k, kl);
  load16(k + 16, kr);
  for (long i = 0; i < n; ++i) {
    Fe l[4], r[4], lr[4], cl[4], cr[4], clr[4], acc[4];
    fe_point_load(l, L + 64 * i);
    fe_point_load(r, R + 64 * i);
    hq_cached(cr, r);
    for (int c = 0; c < 4; ++c) lr[c] = l[c];
    hq_add_cached(lr, cr);
    hq_cached(cl, l);
    hq_cached(clr, lr);
    const int top = fold_top(kl, kr);
    for (int c = 0; c < 4; ++c)
      acc[c] = fold_pick(fold_bits(kl, kr, top), c, l[c], r[c], lr[c]);
    for (int bit = top - 1; bit >= 0; --bit) {
      hq_double(acc);
      const int sel = fold_bits(kl, kr, bit);
      if (sel) hq_add_cached(acc, sel == 3 ? clr : sel == 1 ? cl : cr);
    }
    fe_point_store(out + 64 * i, acc);
  }
}

void host_pt_add(const int32_t* p, const int32_t* q, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point a, b;
    pt_load(a, p + 64 * i);
    pt_load(b, q + 64 * i);
    pt_add(a, a, b);
    pt_store(out + 64 * i, a);
  }
}

void host_pt_double(const int32_t* p, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point a;
    pt_load(a, p + 64 * i);
    pt_double(a, a);
    pt_store(out + 64 * i, a);
  }
}

void host_signed_digits(const int32_t* s, int32_t* dig, int32_t* carry,
                        long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[8];
    int8_t d[MSM_NWIN];
    load16(s + 16 * i, x);
    carry[i] = (int32_t)signed_digits(d, x);
    for (int w = 0; w < MSM_NWIN; ++w) dig[MSM_NWIN * i + w] = d[w];
  }
}

// out[i] = p[i] + q[i], or p[i] - q[i] where neg[i], through q's cached form
void host_pt_add_cached(const int32_t* p, const int32_t* q,
                        const int32_t* neg, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point a, b;
    Cached c;
    pt_load(a, p + 64 * i);
    pt_load(b, q + 64 * i);
    pt_to_cached(c, b);
    if (neg[i]) cached_neg(c);
    pt_add_cached(a, a, c);
    pt_store(out + 64 * i, a);
  }
}

// sum_m m B_m of 4 x lanes buckets B_1.. (bucket m at index m - 1; lane
// l holds B_{l + 1 + lanes i}) by lane_sums and bucket_combine
void host_bucket_combine(const int32_t* buckets, long lanes, int32_t* out) {
  std::vector<Point> b(4 * lanes), r(lanes), w(lanes);
  for (long m = 0; m < 4 * lanes; ++m) pt_load(b[m], buckets + 64 * m);
  for (long l = 0; l < lanes; ++l) {
    const Point* b4[4];
    for (int i = 0; i < 4; ++i) b4[i] = &b[l + lanes * i];
    lane_sums(r[l], w[l], b4);
  }
  bucket_combine(r.data(), w.data(), (int)lanes);
  for (long k = 1; k < lanes; k <<= 1) pt_double(w[0], w[0]);
  pt_add(w[0], w[0], r[0]);
  pt_store(out, w[0]);
}

// Keccak-f[1600] on n 200-byte states: keccak_f1600 (lanes = 0) or the
// lane steps' host model (lanes = 1)
void host_keccak(const int32_t* in, int32_t* out, long n, int lanes) {
  for (long i = 0; i < n; ++i) {
    uint64_t w[25];
    for (int j = 0; j < 25; ++j) {
      uint64_t v = 0;
      for (int k = 7; k >= 0; --k)
        v = (v << 8) | (uint8_t)in[200 * i + 8 * j + k];
      w[j] = v;
    }
    if (lanes)
      keccak_lanes_host(w);
    else
      keccak_f1600(w);
    for (int j = 0; j < 25; ++j)
      for (int k = 0; k < 8; ++k)
        out[200 * i + 8 * j + k] = (uint8_t)(w[j] >> (8 * k));
  }
}

// One STROBE operation on a (202,) transcript state: op 0 meta_ad, 1 ad
// (data absorbed), 2 prf (n bytes squeezed into out).
void host_strobe_op(int32_t* st_io, int op, const uint8_t* data,
                    uint8_t* out, long n, int more) {
  HostX x;
  uint8_t st[200];
  for (int k = 0; k < 200; ++k) st[k] = (uint8_t)st_io[k];
  Strobe s{st, st_io[200], st_io[201]};
  auto d = [&](int j) { return data[j]; };
  if (op == 0)
    strobe_meta_ad(x, s, d, (int)n, more != 0);
  else if (op == 1)
    strobe_ad(x, s, d, (int)n, more != 0);
  else
    strobe_prf(x, s, out, (int)n, more != 0);
  for (int k = 0; k < 200; ++k) st_io[k] = st[k];
  st_io[200] = s.pos;
  st_io[201] = s.pos_begin;
}

void host_challenge_scalar(int32_t* st_io, const char* label, int32_t* out) {
  HostX x;
  uint8_t st[200], scratch[64];
  uint32_t r[8], tmp[2][8];
  for (int k = 0; k < 200; ++k) st[k] = (uint8_t)st_io[k];
  Strobe s{st, st_io[200], st_io[201]};
  int n = 0;
  while (label[n]) ++n;
  merlin_challenge_scalar(x, s, Label{label, n}, r, scratch, tmp);
  for (int k = 0; k < 200; ++k) st_io[k] = st[k];
  st_io[200] = s.pos;
  st_io[201] = s.pos_begin;
  store16(out, r);
}

void host_from_bytes_wide(const int32_t* by, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint8_t b[64];
    uint32_t r[8];
    for (int k = 0; k < 64; ++k) b[k] = (uint8_t)by[64 * i + k];
    fq_from_bytes_wide(r, b);
    store16(out + 16 * i, r);
  }
}

// ENCODE on the ten-lane product's host model (G10Host)
static void encode_host(uint8_t* out, const uint32_t (*w)[8]) {
  const G10Host f;
  ristretto_encode(f, out, f.load(w[0]), f.load(w[1]), f.load(w[2]),
                   f.load(w[3]));
}

static void encode_fe_host(uint8_t* out, const Fe* P) {
  uint32_t w[4][8];
  for (int c = 0; c < 4; ++c) fe_to_words(w[c], P[c]);
  encode_host(out, w);
}

void host_compress(const int32_t* pts, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t w[4][8];
    uint8_t b[32];
    for (int c = 0; c < 4; ++c) load16(pts + 64 * i + 16 * c, w[c]);
    encode_host(b, w);
    bytes_store(out + 32 * i, b);
  }
}

// batch commitments of n Montgomery scalars each, by comb_host over ngrp
// groups (64 as K10, 32 as K11's Cy and beta)
void host_comb(const int32_t* tab, long n, const int32_t* scal, int32_t* out,
               long batch, long ngrp) {
  for (long b = 0; b < batch; ++b) {
    uint32_t canon[8][8];
    for (long g = 0; g < n; ++g) {
      load16(scal + (b * n + g) * 16, canon[g]);
      fq_canon(canon[g], canon[g]);
    }
    Fe P[4];
    comb_host(P, tab, (int)n, canon, (int)ngrp);
    fe_point_store(out + 64 * b, P);
  }
}

// K11's steps in its order: the scalar steps with HostX, the comb sums by
// comb_host (64 groups, then 32 for Cy and beta), the encodings
void host_zk_round_tail(const int32_t* evs, long k, int32_t* st_io,
                        int32_t* carry, const int32_t* tape, int32_t* out,
                        const int32_t* tab_n, const int32_t* tab_1) {
  static ZkTail z;
  HostX x;
  Strobe s{z.st, 0, 0};
  Fe p[4];
  zk_tail_load(x, s, z, evs, (int)k, st_io, carry, tape);
  comb_host(p, tab_n, 5, z.sc[0], COMB_WINDOWS);
  encode_fe_host(z.comm_poly, p);
  zk_tail_poly(x, s, z);
  comb_host(p, tab_1, 2, z.sc[0], COMB_WINDOWS);
  zk_tail_claim(x, s, z);
  encode_fe_host(z.comm_eval, p);
  zk_tail_eval(x, s, z);
  comb_host(p, tab_1, 2, z.sc[0], 32);
  zk_tail_dpp(x, s, z);
  encode_fe_host(z.cy, p);
  comb_host(p, tab_1, 2, z.sc[1], 32);
  encode_fe_host(z.beta, p);
  zk_tail_finish(x, s, z, st_io, carry, out);
}

}  // extern "C"
