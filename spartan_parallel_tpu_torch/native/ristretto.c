/* Native curve25519/ristretto255 host kernels.
 *
 * The TPU device handles bulk MSMs (ops/msm.py); this library accelerates
 * the *host* protocol layer — the per-round sigma-protocol commitments,
 * bullet-reduction folds, and verifier recombinations — which the
 * reference delegates to curve25519-dalek (src/group.rs). Pure C99 +
 * __int128, no dependencies; exposed to Python via ctypes
 * (core/native.py).
 *
 * Field: GF(2^255-19) as 5 x 51-bit limbs. Points: extended twisted
 * Edwards (a = -1) as 4 field elements, passed as 4 x 32-byte
 * little-endian canonical values (128 bytes per point).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

typedef uint8_t u8;
typedef uint64_t u64;
typedef __uint128_t u128;

typedef struct { u64 v[5]; } fe;

static const u64 MASK51 = ((u64)1 << 51) - 1;

/* ---------------- field element helpers ---------------- */

static void fe_frombytes(fe *h, const u8 *s) {
  u64 w0, w1, w2, w3;
  memcpy(&w0, s, 8); memcpy(&w1, s + 8, 8);
  memcpy(&w2, s + 16, 8); memcpy(&w3, s + 24, 8);
  h->v[0] = w0 & MASK51;
  h->v[1] = ((w0 >> 51) | (w1 << 13)) & MASK51;
  h->v[2] = ((w1 >> 38) | (w2 << 26)) & MASK51;
  h->v[3] = ((w2 >> 25) | (w3 << 39)) & MASK51;
  h->v[4] = (w3 >> 12) & MASK51;
}

static void fe_carry(fe *h) {
  u64 c;
  c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
  c = h->v[1] >> 51; h->v[1] &= MASK51; h->v[2] += c;
  c = h->v[2] >> 51; h->v[2] &= MASK51; h->v[3] += c;
  c = h->v[3] >> 51; h->v[3] &= MASK51; h->v[4] += c;
  c = h->v[4] >> 51; h->v[4] &= MASK51; h->v[0] += 19 * c;
  c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
}

/* fully reduce to canonical representative */
static void fe_reduce(fe *h) {
  fe_carry(h);
  fe_carry(h);
  /* now h < 2^255 + small; subtract p if >= p */
  u64 q = (h->v[0] + 19) >> 51;
  q = (h->v[1] + q) >> 51;
  q = (h->v[2] + q) >> 51;
  q = (h->v[3] + q) >> 51;
  q = (h->v[4] + q) >> 51;
  h->v[0] += 19 * q;
  u64 c;
  c = h->v[0] >> 51; h->v[0] &= MASK51; h->v[1] += c;
  c = h->v[1] >> 51; h->v[1] &= MASK51; h->v[2] += c;
  c = h->v[2] >> 51; h->v[2] &= MASK51; h->v[3] += c;
  c = h->v[3] >> 51; h->v[3] &= MASK51; h->v[4] += c;
  h->v[4] &= MASK51;
}

static void fe_tobytes(u8 *s, const fe *f) {
  fe t = *f;
  fe_reduce(&t);
  u64 w0 = t.v[0] | (t.v[1] << 51);
  u64 w1 = (t.v[1] >> 13) | (t.v[2] << 38);
  u64 w2 = (t.v[2] >> 26) | (t.v[3] << 25);
  u64 w3 = (t.v[3] >> 39) | (t.v[4] << 12);
  memcpy(s, &w0, 8); memcpy(s + 8, &w1, 8);
  memcpy(s + 16, &w2, 8); memcpy(s + 24, &w3, 8);
}

static void fe_0(fe *h) { memset(h, 0, sizeof(fe)); }
static void fe_1(fe *h) { fe_0(h); h->v[0] = 1; }
static void fe_copy(fe *h, const fe *f) { *h = *f; }

static void fe_add(fe *h, const fe *f, const fe *g) {
  for (int i = 0; i < 5; i++) h->v[i] = f->v[i] + g->v[i];
  fe_carry(h);
}

/* h = f - g; assumes f, g loosely reduced (< 2^52 per limb) */
static void fe_sub(fe *h, const fe *f, const fe *g) {
  /* add 2p to avoid underflow */
  h->v[0] = f->v[0] + 0xFFFFFFFFFFFDAULL - g->v[0];
  h->v[1] = f->v[1] + 0xFFFFFFFFFFFFEULL - g->v[1];
  h->v[2] = f->v[2] + 0xFFFFFFFFFFFFEULL - g->v[2];
  h->v[3] = f->v[3] + 0xFFFFFFFFFFFFEULL - g->v[3];
  h->v[4] = f->v[4] + 0xFFFFFFFFFFFFEULL - g->v[4];
  fe_carry(h);
}

static void fe_neg(fe *h, const fe *f) {
  fe z; fe_0(&z);
  fe_sub(h, &z, f);
}

static void fe_mul(fe *h, const fe *f, const fe *g) {
  u128 r0, r1, r2, r3, r4;
  u64 f0 = f->v[0], f1 = f->v[1], f2 = f->v[2], f3 = f->v[3], f4 = f->v[4];
  u64 g0 = g->v[0], g1 = g->v[1], g2 = g->v[2], g3 = g->v[3], g4 = g->v[4];
  u64 g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3, g4_19 = 19 * g4;

  r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
       (u128)f3 * g2_19 + (u128)f4 * g1_19;
  r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
       (u128)f3 * g3_19 + (u128)f4 * g2_19;
  r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
       (u128)f3 * g4_19 + (u128)f4 * g3_19;
  r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
       (u128)f3 * g0 + (u128)f4 * g4_19;
  r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
       (u128)f3 * g1 + (u128)f4 * g0;

  u64 c;
  u64 h0 = (u64)r0 & MASK51; c = (u64)(r0 >> 51); r1 += c;
  u64 h1 = (u64)r1 & MASK51; c = (u64)(r1 >> 51); r2 += c;
  u64 h2 = (u64)r2 & MASK51; c = (u64)(r2 >> 51); r3 += c;
  u64 h3 = (u64)r3 & MASK51; c = (u64)(r3 >> 51); r4 += c;
  u64 h4 = (u64)r4 & MASK51; c = (u64)(r4 >> 51);
  h0 += 19 * c;
  c = h0 >> 51; h0 &= MASK51; h1 += c;
  h->v[0] = h0; h->v[1] = h1; h->v[2] = h2; h->v[3] = h3; h->v[4] = h4;
}

static void fe_sq(fe *h, const fe *f) { fe_mul(h, f, f); }

static int fe_iszero(const fe *f) {
  u8 s[32];
  fe_tobytes(s, f);
  u8 acc = 0;
  for (int i = 0; i < 32; i++) acc |= s[i];
  return acc == 0;
}

static int fe_isnegative(const fe *f) {
  u8 s[32];
  fe_tobytes(s, f);
  return s[0] & 1;
}

static int fe_eq(const fe *f, const fe *g) {
  fe d;
  fe_sub(&d, f, g);
  return fe_iszero(&d);
}

/* h = f ^ (2^252 - 3): the pow used by invsqrt (p = 2^255-19) */
static void fe_pow2523(fe *h, const fe *f) {
  fe t0, t1, t2;
  int i;
  fe_sq(&t0, f);                       /* 2 */
  fe_sq(&t1, &t0); fe_sq(&t1, &t1);    /* 8 */
  fe_mul(&t1, f, &t1);                 /* 9 */
  fe_mul(&t0, &t0, &t1);               /* 11 */
  fe_sq(&t0, &t0);                     /* 22 */
  fe_mul(&t0, &t1, &t0);               /* 31 = 2^5-1 */
  fe_sq(&t1, &t0);
  for (i = 1; i < 5; i++) fe_sq(&t1, &t1);
  fe_mul(&t0, &t1, &t0);               /* 2^10-1 */
  fe_sq(&t1, &t0);
  for (i = 1; i < 10; i++) fe_sq(&t1, &t1);
  fe_mul(&t1, &t1, &t0);               /* 2^20-1 */
  fe_sq(&t2, &t1);
  for (i = 1; i < 20; i++) fe_sq(&t2, &t2);
  fe_mul(&t1, &t2, &t1);               /* 2^40-1 */
  fe_sq(&t1, &t1);
  for (i = 1; i < 10; i++) fe_sq(&t1, &t1);
  fe_mul(&t0, &t1, &t0);               /* 2^50-1 */
  fe_sq(&t1, &t0);
  for (i = 1; i < 50; i++) fe_sq(&t1, &t1);
  fe_mul(&t1, &t1, &t0);               /* 2^100-1 */
  fe_sq(&t2, &t1);
  for (i = 1; i < 100; i++) fe_sq(&t2, &t2);
  fe_mul(&t1, &t2, &t1);               /* 2^200-1 */
  fe_sq(&t1, &t1);
  for (i = 1; i < 50; i++) fe_sq(&t1, &t1);
  fe_mul(&t0, &t1, &t0);               /* 2^250-1 */
  fe_sq(&t0, &t0); fe_sq(&t0, &t0);
  fe_mul(h, &t0, f);                   /* 2^252-3 */
}

/* ---------------- curve constants (injected at init) ---------------- */

static fe K_D, K_D2, K_SQRT_M1, K_ONE_MINUS_D_SQ, K_D_MINUS_ONE_SQ,
    K_SQRT_AD_MINUS_ONE, K_INVSQRT_A_MINUS_D;

void rst_init(const u8 *consts) {
  fe_frombytes(&K_D, consts);
  fe_frombytes(&K_D2, consts + 32);
  fe_frombytes(&K_SQRT_M1, consts + 64);
  fe_frombytes(&K_ONE_MINUS_D_SQ, consts + 96);
  fe_frombytes(&K_D_MINUS_ONE_SQ, consts + 128);
  fe_frombytes(&K_SQRT_AD_MINUS_ONE, consts + 160);
  fe_frombytes(&K_INVSQRT_A_MINUS_D, consts + 192);
}

/* ---------------- points ---------------- */

typedef struct { fe X, Y, Z, T; } ge;

static void ge_frombytes(ge *p, const u8 *b) {
  fe_frombytes(&p->X, b);
  fe_frombytes(&p->Y, b + 32);
  fe_frombytes(&p->Z, b + 64);
  fe_frombytes(&p->T, b + 96);
}

static void ge_tobytes(u8 *b, const ge *p) {
  fe_tobytes(b, &p->X);
  fe_tobytes(b + 32, &p->Y);
  fe_tobytes(b + 64, &p->Z);
  fe_tobytes(b + 96, &p->T);
}

static void ge_identity(ge *p) {
  fe_0(&p->X); fe_1(&p->Y); fe_1(&p->Z); fe_0(&p->T);
}

/* complete addition, a = -1 twisted Edwards extended coords */
static void ge_add(ge *r, const ge *p, const ge *q) {
  fe A, B, C, D, E, F, G, H, t0, t1;
  fe_sub(&t0, &p->Y, &p->X);
  fe_sub(&t1, &q->Y, &q->X);
  fe_mul(&A, &t0, &t1);
  fe_add(&t0, &p->Y, &p->X);
  fe_add(&t1, &q->Y, &q->X);
  fe_mul(&B, &t0, &t1);
  fe_mul(&C, &p->T, &K_D2);
  fe_mul(&C, &C, &q->T);
  fe_mul(&D, &p->Z, &q->Z);
  fe_add(&D, &D, &D);
  fe_sub(&E, &B, &A);
  fe_sub(&F, &D, &C);
  fe_add(&G, &D, &C);
  fe_add(&H, &B, &A);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->T, &E, &H);
  fe_mul(&r->Z, &F, &G);
}

static void ge_dbl(ge *r, const ge *p) {
  fe A, B, C, E, F, G, H, t0;
  fe_sq(&A, &p->X);
  fe_sq(&B, &p->Y);
  fe_sq(&C, &p->Z);
  fe_add(&C, &C, &C);
  fe_add(&H, &A, &B);
  fe_add(&t0, &p->X, &p->Y);
  fe_sq(&t0, &t0);
  fe_sub(&E, &H, &t0);
  fe_sub(&G, &A, &B);
  fe_add(&F, &C, &G);
  fe_mul(&r->X, &E, &F);
  fe_mul(&r->Y, &G, &H);
  fe_mul(&r->T, &E, &H);
  fe_mul(&r->Z, &F, &G);
}

static void ge_neg(ge *r, const ge *p) {
  fe_neg(&r->X, &p->X);
  fe_copy(&r->Y, &p->Y);
  fe_copy(&r->Z, &p->Z);
  fe_neg(&r->T, &p->T);
}

void pt_add(const u8 *p, const u8 *q, u8 *out) {
  ge a, b, c;
  ge_frombytes(&a, p);
  ge_frombytes(&b, q);
  ge_add(&c, &a, &b);
  ge_tobytes(out, &c);
}

void pt_double(const u8 *p, u8 *out) {
  ge a, c;
  ge_frombytes(&a, p);
  ge_dbl(&c, &a);
  ge_tobytes(out, &c);
}

/* TIMING THREAT MODEL: ge_scalar_mul / pt_msm below branch on scalar
 * digits (table lookups indexed by secret data), i.e. they are
 * VARIABLE-TIME, unlike the reference prover's constant-time
 * curve25519-dalek ops. This layer runs only on the PROVER host — a
 * machine assumed free of co-resident adversaries (a prover farm, not a
 * wallet). Zero-knowledge of the produced proofs does not depend on
 * op timing: blinds from the RandomTape enter commitments additively and
 * the transcript binds only point/scalar VALUES. An operator deploying
 * the prover on shared hardware against local timing adversaries should
 * route commitments through the device path (SPARTAN_HOST_MSM_MAX=0),
 * whose lockstep SIMD kernels are data-independent. Documented per the
 * round-1 advisory; see also SURVEY.md §5 "const-time posture". */

/* signed 4-bit windows of a 256-bit LE scalar: 64 digits in [-8, 8) */
static void scalar_snaf4(const u8 *k, int8_t *digits) {
  int8_t naf[64];
  for (int i = 0; i < 32; i++) {
    naf[2 * i] = k[i] & 0xF;
    naf[2 * i + 1] = (k[i] >> 4) & 0xF;
  }
  int carry = 0;
  for (int i = 0; i < 64; i++) {
    int d = naf[i] + carry;
    carry = (d >= 8) ? 1 : 0;
    digits[i] = (int8_t)(d - (carry << 4));
  }
  /* carry out of the top window: scalars are < 2^253 so top digit < 8 */
  digits[63] += (int8_t)(carry << 4);
}

/* table[j] = (j+1) * P for j in 0..7 */
static void ge_table8(ge *table, const ge *p) {
  ge d;
  table[0] = *p;
  ge_dbl(&d, p);
  for (int j = 1; j < 8; j++) ge_add(&table[j], &table[j - 1], p);
  (void)d;
}

static void ge_scalar_mul(ge *r, const ge *p, const u8 *k) {
  int8_t digits[64];
  scalar_snaf4(k, digits);
  ge table[8];
  ge_table8(table, p);
  ge acc;
  ge_identity(&acc);
  for (int i = 63; i >= 0; i--) {
    ge_dbl(&acc, &acc);
    ge_dbl(&acc, &acc);
    ge_dbl(&acc, &acc);
    ge_dbl(&acc, &acc);
    int d = digits[i];
    if (d > 0) {
      ge_add(&acc, &acc, &table[d - 1]);
    } else if (d < 0) {
      ge n;
      ge_neg(&n, &table[-d - 1]);
      ge_add(&acc, &acc, &n);
    }
  }
  *r = acc;
}

void pt_scalar_mul(const u8 *p, const u8 *k, u8 *out) {
  ge a, r;
  ge_frombytes(&a, p);
  ge_scalar_mul(&r, &a, k);
  ge_tobytes(out, &r);
}

/* Straus MSM: n points (n*128 bytes), n scalars (n*32 bytes LE) */
void pt_msm(const u8 *pts, const u8 *scalars, size_t n, u8 *out) {
  enum { CHUNK = 32 };
  ge acc;
  ge_identity(&acc);
  ge tables[CHUNK][8];
  int8_t digits[CHUNK][64];
  for (size_t base = 0; base < n; base += CHUNK) {
    size_t m = n - base < CHUNK ? n - base : CHUNK;
    for (size_t j = 0; j < m; j++) {
      ge p;
      ge_frombytes(&p, pts + (base + j) * 128);
      ge_table8(tables[j], &p);
      scalar_snaf4(scalars + (base + j) * 32, digits[j]);
    }
    ge sub;
    ge_identity(&sub);
    for (int i = 63; i >= 0; i--) {
      ge_dbl(&sub, &sub);
      ge_dbl(&sub, &sub);
      ge_dbl(&sub, &sub);
      ge_dbl(&sub, &sub);
      for (size_t j = 0; j < m; j++) {
        int d = digits[j][i];
        if (d > 0) {
          ge_add(&sub, &sub, &tables[j][d - 1]);
        } else if (d < 0) {
          ge ng;
          ge_neg(&ng, &tables[j][-d - 1]);
          ge_add(&sub, &sub, &ng);
        }
      }
    }
    ge_add(&acc, &acc, &sub);
  }
  ge_tobytes(out, &acc);
}

/* ---------------- ristretto encode / decode / map ---------------- */

/* (was_square, r) = SQRT_RATIO_M1(u, v) */
static int fe_sqrt_ratio(fe *r, const fe *u, const fe *v) {
  fe v3, v7, t, check, u_neg, u_neg_i, r_prime;
  fe_sq(&v3, v);
  fe_mul(&v3, &v3, v);            /* v^3 */
  fe_sq(&v7, &v3);
  fe_mul(&v7, &v7, v);            /* v^7 */
  fe_mul(&t, u, &v7);
  fe_pow2523(&t, &t);             /* (u v^7)^((p-5)/8) */
  fe_mul(r, u, &v3);
  fe_mul(r, r, &t);               /* u v^3 (u v^7)^((p-5)/8) */

  fe_sq(&check, r);
  fe_mul(&check, &check, v);      /* v r^2 */

  fe_neg(&u_neg, u);
  fe_mul(&u_neg_i, &u_neg, &K_SQRT_M1);

  int correct = fe_eq(&check, u);
  int flipped = fe_eq(&check, &u_neg);
  int flipped_i = fe_eq(&check, &u_neg_i);

  fe_mul(&r_prime, r, &K_SQRT_M1);
  if (flipped || flipped_i) fe_copy(r, &r_prime);
  /* abs */
  if (fe_isnegative(r)) fe_neg(r, r);
  return correct || flipped;
}

void pt_compress(const u8 *pb, u8 *out) {
  ge p;
  ge_frombytes(&p, pb);
  fe u1, u2, t0, invsqrt, den1, den2, z_inv, ix0, iy0, ench, x, y, den_inv,
      s, one;
  fe_add(&t0, &p.Z, &p.Y);
  fe_sub(&u1, &p.Z, &p.Y);
  fe_mul(&u1, &u1, &t0);          /* (Z+Y)(Z-Y) */
  fe_mul(&u2, &p.X, &p.Y);
  fe_sq(&t0, &u2);
  fe_mul(&t0, &t0, &u1);          /* u1 u2^2 */
  fe_1(&one);
  fe_sqrt_ratio(&invsqrt, &one, &t0);
  fe_mul(&den1, &invsqrt, &u1);
  fe_mul(&den2, &invsqrt, &u2);
  fe_mul(&z_inv, &den1, &den2);
  fe_mul(&z_inv, &z_inv, &p.T);
  fe_mul(&ix0, &p.X, &K_SQRT_M1);
  fe_mul(&iy0, &p.Y, &K_SQRT_M1);
  fe_mul(&ench, &den1, &K_INVSQRT_A_MINUS_D);
  fe_mul(&t0, &p.T, &z_inv);
  int rotate = fe_isnegative(&t0);
  if (rotate) {
    fe_copy(&x, &iy0);
    fe_copy(&y, &ix0);
    fe_copy(&den_inv, &ench);
  } else {
    fe_copy(&x, &p.X);
    fe_copy(&y, &p.Y);
    fe_copy(&den_inv, &den2);
  }
  fe_mul(&t0, &x, &z_inv);
  if (fe_isnegative(&t0)) fe_neg(&y, &y);
  fe_sub(&s, &p.Z, &y);
  fe_mul(&s, &s, &den_inv);
  if (fe_isnegative(&s)) fe_neg(&s, &s);
  fe_tobytes(out, &s);
}

/* returns 1 on success */
int pt_decompress(const u8 *in, u8 *out) {
  /* canonical check: s < p and even */
  u8 chk[32];
  fe s;
  fe_frombytes(&s, in);
  fe_tobytes(chk, &s);
  if (memcmp(chk, in, 32) != 0) return 0;
  if (in[0] & 1) return 0;

  fe ss, u1, u2, u2s, v, invsqrt, den_x, den_y, x, y, t, one, t0;
  fe_sq(&ss, &s);
  fe_1(&one);
  fe_sub(&u1, &one, &ss);
  fe_add(&u2, &one, &ss);
  fe_sq(&u2s, &u2);
  fe_sq(&t0, &u1);
  fe_mul(&v, &K_D, &t0);
  fe_neg(&v, &v);
  fe_sub(&v, &v, &u2s);           /* -(d u1^2) - u2^2 */
  fe_mul(&t0, &v, &u2s);
  int was_square = fe_sqrt_ratio(&invsqrt, &one, &t0);
  fe_mul(&den_x, &invsqrt, &u2);
  fe_mul(&den_y, &invsqrt, &den_x);
  fe_mul(&den_y, &den_y, &v);
  fe_add(&x, &s, &s);
  fe_mul(&x, &x, &den_x);
  if (fe_isnegative(&x)) fe_neg(&x, &x);
  fe_mul(&y, &u1, &den_y);
  fe_mul(&t, &x, &y);
  if (!was_square || fe_isnegative(&t) || fe_iszero(&y)) return 0;
  fe z;
  fe_1(&z);
  fe_tobytes(out, &x);
  fe_tobytes(out + 32, &y);
  fe_tobytes(out + 64, &z);
  fe_tobytes(out + 96, &t);
  return 1;
}

/* elligator map (RFC 9496 4.3.4) on one field element */
static void ge_elligator(ge *P, const fe *t) {
  fe r, u, v, s, s_prime, c, N, w0, w1, w2, w3, one, t0, t1;
  fe_1(&one);
  fe_sq(&r, t);
  fe_mul(&r, &r, &K_SQRT_M1);     /* r = sqrt(-1) t^2 */
  fe_add(&u, &r, &one);
  fe_mul(&u, &u, &K_ONE_MINUS_D_SQ);
  fe_mul(&t0, &r, &K_D);
  fe_neg(&t0, &t0);
  fe_sub(&t0, &t0, &one);         /* (-1 - r d) */
  fe_add(&t1, &r, &K_D);
  fe_mul(&v, &t0, &t1);
  int was_square = fe_sqrt_ratio(&s, &u, &v);
  fe_mul(&s_prime, &s, t);
  if (!fe_isnegative(&s_prime)) fe_neg(&s_prime, &s_prime); /* -abs */
  if (!was_square) {
    fe_copy(&s, &s_prime);
    fe_copy(&c, &r);
  } else {
    fe_neg(&c, &one);
  }
  fe_sub(&t0, &r, &one);
  fe_mul(&N, &c, &t0);
  fe_mul(&N, &N, &K_D_MINUS_ONE_SQ);
  fe_sub(&N, &N, &v);
  fe_add(&w0, &s, &s);
  fe_mul(&w0, &w0, &v);
  fe_mul(&w1, &N, &K_SQRT_AD_MINUS_ONE);
  fe_sq(&t0, &s);
  fe_sub(&w2, &one, &t0);
  fe_add(&w3, &one, &t0);
  fe_mul(&P->X, &w0, &w3);
  fe_mul(&P->Y, &w2, &w1);
  fe_mul(&P->Z, &w1, &w3);
  fe_mul(&P->T, &w0, &w2);
}

void pt_from_uniform(const u8 *in, u8 *out) {
  fe t1, t2;
  u8 buf[32];
  memcpy(buf, in, 32);
  buf[31] &= 0x7F;
  fe_frombytes(&t1, buf);
  memcpy(buf, in + 32, 32);
  buf[31] &= 0x7F;
  fe_frombytes(&t2, buf);
  ge p1, p2, r;
  ge_elligator(&p1, &t1);
  ge_elligator(&p2, &t2);
  ge_add(&r, &p1, &p2);
  ge_tobytes(out, &r);
}
