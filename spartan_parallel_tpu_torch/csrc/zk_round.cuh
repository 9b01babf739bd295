// One ZK sumcheck round's tail, after its evaluations: the steps of the JAX
// package's ops/zk_round.py _zk_round_tail (the reference's
// sumcheck.rs:973-1048 with the DotProductProof of nizk/mod.rs:305-358).
// The steps that run on one thread are the zk_tail_* functions below; each
// leaves the canonical scalars of the next comb commitment in z.sc, and the
// next step receives the commitment's point. K11 (csrc/zk_round.cu) runs
// the steps on thread 0 of a block and the comb sums on all its threads;
// the host build (csrc/host_check.cpp) runs them in the same order with
// comb_commit_host.
//
// Buffers, all int32:
//   evs    (k, 3, 16)  the round's (e0, e2, e3) for each of k table sets
//   st_io  (202,)      transcript: 200 state bytes, pos, pos_begin
//   carry  (3, 16)     the claim (Montgomery), its commitment (32 bytes)
//   tape   (11, 16)    blinds_poly[j], blinds_evals[j], the claim blind,
//                      d_vec (4), r_delta, r_beta, delta (32 bytes)
//   out    (13, 16)    comm_poly, comm_eval, beta (32 bytes each), z (4),
//                      z_delta, z_beta, r
#pragma once
#include "ristretto.cuh"

#define ZK_TAPE_ROWS 11
#define ZK_OUT_ROWS 13
#define ZK_OUT_R 12

#define FQ_TWO_INV_WORDS                                               \
  {0x75473485u, 0x977f4a47u, 0x8b3ab623u, 0x6de72ae9u, 0xffffffffu,    \
   0xffffffffu, 0xffffffffu, 0x0fffffffu}
#define FQ_SIX_INV_WORDS                                               \
  {0xba664975u, 0xc28c057eu, 0x9b0dfa9au, 0xdd370a37u, 0xffffffffu,    \
   0xffffffffu, 0xffffffffu, 0x0fffffffu}

struct ZkTail {
  Strobe s;
  uint32_t claim[8], bp[8], be[8], bsc[8], dv[4][8], rd[8], rb[8];
  uint32_t coeffs[4][8], r[8], eval[8], w0[8], w1[8], target[8], blind[8];
  uint32_t a[4][8], dp_ad[8];
  uint32_t sc[5][8];  // canonical scalars of the next comb commitment
  uint8_t comm_claim[32], delta[32], comm_poly[32], comm_eval[32], cy[32];
};

HD void strobe_load(Strobe& s, const int32_t* io) {
  for (int k = 0; k < 200; ++k) s.st[k] = (uint8_t)io[k];
  s.pos = io[200];
  s.pos_begin = io[201];
}

HD void strobe_store(int32_t* io, const Strobe& s) {
  for (int k = 0; k < 200; ++k) io[k] = s.st[k];
  io[200] = s.pos;
  io[201] = s.pos_begin;
}

HD void bytes_load(uint8_t* b, const int32_t* p) {
  for (int k = 0; k < 32; ++k) b[k] = (uint8_t)p[k];
}

HD void bytes_store(int32_t* p, const uint8_t* b) {
  for (int k = 0; k < 32; ++k) p[k] = b[k];
}

// One Montgomery product as a call (see fp_mul_c).
HDN void fq_mul_c(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fq_mul(r, a, b);
}

HD void fq_canon(uint32_t* c, const uint32_t* mont) {
  const uint32_t one[8] = FQ_ONE_CANON_WORDS;
  fq_mul_c(c, mont, one);
}

// x * y + z
HD void fq_mul_add(uint32_t* r, const uint32_t* x, const uint32_t* y,
                   const uint32_t* z) {
  uint32_t t[8];
  fq_mul_c(t, x, y);
  fq_add(r, t, z);
}

// Load the round's inputs, sum the evaluations over the table sets, and
// interpolate the cubic (UniPoly::from_evals, unipoly.rs:23-55): coeffs
// [d, c, b, a], constant first. Next: the commitment of coeffs || bp.
HDN void zk_tail_load(ZkTail& z, const int32_t* evs, int k,
                      const int32_t* st_io, const int32_t* carry,
                      const int32_t* tape) {
  const uint32_t two_inv[8] = FQ_TWO_INV_WORDS;
  const uint32_t six_inv[8] = FQ_SIX_INV_WORDS;
  strobe_load(z.s, st_io);
  load16(carry, z.claim);
  bytes_load(z.comm_claim, carry + 16);
  load16(tape, z.bp);
  load16(tape + 16, z.be);
  load16(tape + 32, z.bsc);
  for (int i = 0; i < 4; ++i) load16(tape + 48 + 16 * i, z.dv[i]);
  load16(tape + 112, z.rd);
  load16(tape + 128, z.rb);
  bytes_load(z.delta, tape + 144);
  uint32_t e[3][8], t[8];
  for (int m = 0; m < 3; ++m) {
    load16(evs + 16 * m, e[m]);
    for (int i = 1; i < k; ++i) {
      load16(evs + 48 * i + 16 * m, t);
      fq_add(e[m], e[m], t);
    }
  }
  uint32_t e0[8], e1[8], e2[8], e3[8], u[8], v[8];
  copy8(e0, e[0]);
  copy8(e2, e[1]);
  copy8(e3, e[2]);
  fq_sub(e1, z.claim, e0);
  // a = (e3 - 3 e2 + 3 e1 - e0) / 6
  fq_add(u, e2, e2);
  fq_add(u, u, e2);
  fq_sub(u, e3, u);
  fq_add(v, e1, e1);
  fq_add(v, v, e1);
  fq_add(u, u, v);
  fq_sub(u, u, e0);
  fq_mul_c(z.coeffs[3], six_inv, u);
  // b = (2 e0 + 4 e2 - 5 e1 - e3) / 2
  fq_add(u, e0, e0);
  fq_add(v, e2, e2);
  fq_add(v, v, e2);
  fq_add(v, v, e2);
  fq_add(u, u, v);
  fq_add(v, e1, e1);
  fq_add(v, v, e1);
  fq_add(v, v, e1);
  fq_add(v, v, e1);
  fq_add(v, v, e3);
  fq_sub(u, u, v);
  fq_mul_c(z.coeffs[2], two_inv, u);
  // c = e1 - d - a - b, d = e0
  copy8(z.coeffs[0], e0);
  fq_sub(u, e1, e0);
  fq_sub(u, u, z.coeffs[3]);
  fq_sub(z.coeffs[1], u, z.coeffs[2]);
  for (int i = 0; i < 4; ++i) fq_canon(z.sc[i], z.coeffs[i]);
  fq_canon(z.sc[4], z.bp);
}

// comm_poly, the challenge r and the evaluation at r. Next: the
// commitment of eval || be.
HDN void zk_tail_poly(ZkTail& z, const Point& comm) {
  ristretto_compress(z.comm_poly, comm);
  merlin_append(z.s, "comm_poly", z.comm_poly, 32);
  merlin_challenge_scalar(z.s, "challenge_nextround", z.r);
  copy8(z.eval, z.coeffs[3]);
  for (int i = 2; i >= 0; --i) fq_mul_add(z.eval, z.eval, z.r, z.coeffs[i]);
  fq_canon(z.sc[0], z.eval);
  fq_canon(z.sc[1], z.be);
}

// comm_eval, the two claims combined (target, blind), the vector a and
// <a, d_vec>. Next: the commitment of target || blind (Cy).
HDN void zk_tail_eval(ZkTail& z, const Point& comm) {
  ristretto_compress(z.comm_eval, comm);
  merlin_append(z.s, "comm_claim_per_round", z.comm_claim, 32);
  merlin_append(z.s, "comm_eval", z.comm_eval, 32);
  merlin_challenge_scalar(z.s, "combine_two_claims_to_one", z.w0);
  merlin_challenge_scalar(z.s, "combine_two_claims_to_one", z.w1);
  uint32_t t[8], rp[8];
  fq_mul_c(t, z.w1, z.eval);
  fq_mul_add(z.target, z.w0, z.claim, t);
  fq_mul_c(t, z.w1, z.be);
  fq_mul_add(z.blind, z.w0, z.bsc, t);
  // a = w0 (2, 1, 1, 1) + w1 (1, r, r^2, r^3)
  fq_add(t, z.w0, z.w0);
  fq_add(z.a[0], t, z.w1);
  copy8(rp, z.r);
  for (int i = 1; i < 4; ++i) {
    fq_mul_add(z.a[i], z.w1, rp, z.w0);
    fq_mul_c(rp, rp, z.r);
  }
  fq_mul_c(z.dp_ad, z.a[0], z.dv[0]);
  for (int i = 1; i < 4; ++i) fq_mul_add(z.dp_ad, z.a[i], z.dv[i], z.dp_ad);
  fq_canon(z.sc[0], z.target);
  fq_canon(z.sc[1], z.blind);
}

// Cy. Next: the commitment of <a, d_vec> || r_beta (beta).
HDN void zk_tail_cy(ZkTail& z, const Point& comm) {
  ristretto_compress(z.cy, comm);
  fq_canon(z.sc[0], z.dp_ad);
  fq_canon(z.sc[1], z.rb);
}

// beta, the DotProductProof's transcript and challenge c, its responses;
// then every output.
HDN void zk_tail_finish(ZkTail& z, const Point& comm, int32_t* st_io,
                        int32_t* carry, int32_t* out) {
  uint8_t beta[32];
  ristretto_compress(beta, comm);
  merlin_append(z.s, "protocol-name", (const uint8_t*)"dot product proof",
                17);
  merlin_append(z.s, "Cx", z.comm_poly, 32);
  merlin_append(z.s, "Cy", z.cy, 32);
  merlin_append(z.s, "a", (const uint8_t*)"begin_append_vector", 19);
  for (int i = 0; i < 4; ++i) merlin_append_scalar(z.s, "a", z.a[i]);
  merlin_append(z.s, "a", (const uint8_t*)"end_append_vector", 17);
  merlin_append(z.s, "delta", z.delta, 32);
  merlin_append(z.s, "beta", beta, 32);
  uint32_t c[8], t[8];
  merlin_challenge_scalar(z.s, "c", c);
  bytes_store(out, z.comm_poly);
  bytes_store(out + 32, z.comm_eval);
  bytes_store(out + 64, beta);
  for (int i = 0; i < 4; ++i) {
    fq_mul_add(t, c, z.coeffs[i], z.dv[i]);
    store16(out + 96 + 16 * i, t);
  }
  fq_mul_add(t, c, z.bp, z.rd);
  store16(out + 160, t);
  fq_mul_add(t, c, z.blind, z.rb);
  store16(out + 176, t);
  store16(out + 16 * ZK_OUT_R, z.r);
  store16(carry, z.eval);
  bytes_store(carry + 16, z.comm_eval);
  strobe_store(st_io, z.s);
}
