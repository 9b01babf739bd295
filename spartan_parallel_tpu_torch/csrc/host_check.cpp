// Host build of the per-element arithmetic in fq.cuh, fp.cuh, curve.cuh
// and msm.cuh and of the device transcript and round tail in keccak.cuh,
// ristretto.cuh and zk_round.cuh (g++, no CUDA), so the CPU tests can hold
// the kernels' arithmetic against the plain PyTorch versions and the JAX
// package. Each entry maps over n elements of 16-limb int32 values (points:
// 4 x 16 limbs; states and encodings: one int32 per byte).
#include <vector>

#include "curve.cuh"
#include "fq.cuh"
#include "msm.cuh"
#include "zk_round.cuh"

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

void host_keccak(const int32_t* in, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint8_t st[200];
    for (int k = 0; k < 200; ++k) st[k] = (uint8_t)in[200 * i + k];
    keccak_bytes(st);
    for (int k = 0; k < 200; ++k) out[200 * i + k] = st[k];
  }
}

// One STROBE operation on a (202,) transcript state: op 0 meta_ad, 1 ad
// (data absorbed), 2 prf (n bytes squeezed into out).
void host_strobe_op(int32_t* st_io, int op, const uint8_t* data,
                    uint8_t* out, long n, int more) {
  Strobe s;
  strobe_load(s, st_io);
  if (op == 0)
    strobe_meta_ad(s, data, (int)n, more != 0);
  else if (op == 1)
    strobe_ad(s, data, (int)n, more != 0);
  else
    strobe_prf(s, out, (int)n, more != 0);
  strobe_store(st_io, s);
}

void host_challenge_scalar(int32_t* st_io, const char* label, int32_t* out) {
  Strobe s;
  uint32_t r[8];
  strobe_load(s, st_io);
  merlin_challenge_scalar(s, label, r);
  strobe_store(st_io, s);
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

void host_compress(const int32_t* pts, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point p;
    uint8_t b[32];
    pt_load(p, pts + 64 * i);
    ristretto_compress(b, p);
    bytes_store(out + 32 * i, b);
  }
}

// batch commitments of n Montgomery scalars each
void host_comb(const int32_t* tab, long n, const int32_t* scal, int32_t* out,
               long batch) {
  for (long b = 0; b < batch; ++b) {
    uint32_t canon[8][8], x[8];
    for (long g = 0; g < n; ++g) {
      load16(scal + (b * n + g) * 16, x);
      fq_canon(canon[g], x);
    }
    Point p;
    comb_commit_host(p, tab, (int)n, canon);
    pt_store(out + 64 * b, p);
  }
}

void host_zk_round_tail(const int32_t* evs, long k, int32_t* st_io,
                        int32_t* carry, const int32_t* tape, int32_t* out,
                        const int32_t* tab_n, const int32_t* tab_1) {
  static ZkTail z;
  Point p;
  zk_tail_load(z, evs, (int)k, st_io, carry, tape);
  comb_commit_host(p, tab_n, 5, z.sc);
  zk_tail_poly(z, p);
  comb_commit_host(p, tab_1, 2, z.sc);
  zk_tail_eval(z, p);
  comb_commit_host(p, tab_1, 2, z.sc);
  zk_tail_cy(z, p);
  comb_commit_host(p, tab_1, 2, z.sc);
  zk_tail_finish(z, p, st_io, carry, out);
}

}  // extern "C"
