// One ZK sumcheck round's tail, after its evaluations: the steps of the JAX
// package's ops/zk_round.py _zk_round_tail (the reference's
// sumcheck.rs:973-1048 with the DotProductProof of nizk/mod.rs:305-358).
// The zk_tail_* steps run the transcript and the scalar work on a warp
// (executor X, csrc/keccak.cuh): the transcript's bytes on its lanes, each
// independent scalar product mod l on a lane of its own. Each step leaves
// the canonical scalars of the next comb commitment(s) in z.sc, and the
// next step reads the commitment's encoding. K11 (csrc/zk_round.cu) runs
// the steps on warp 0 and the comb sums and encodings between them; the
// host build (csrc/host_check.cpp) runs them in the same order with HostX
// and comb_host.
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

// The round's state (shared memory in K11): every scalar product reads
// and writes words here, so no step needs a stack frame.
struct ZkTail {
  alignas(16) uint8_t st[200];
  alignas(16) uint8_t scratch[64];
  uint32_t claim[8], bp[8], be[8], bsc[8], dv[4][8], rd[8], rb[8];
  uint32_t k2[8], k6[8];  // 1/2 and 1/6, Montgomery
  uint32_t e[3][8], u[2][8];
  uint32_t coeffs[4][8], r[8], rp[4][8], eval[8], w0[8], w1[8];
  uint32_t target[8], blind[8], a[4][8], m[6][8], dp_ad[8], c[8];
  uint32_t sc[2][5][8];  // canonical scalars of the next comb commitment(s)
  uint32_t pw[2][4][8];  // the comb points' canonical words
  uint8_t comm_claim[32], delta[32], comm_poly[32], comm_eval[32], cy[32];
  uint8_t beta[32], spare[2][32], a_bytes[4][32];
};

HD void bytes_load(uint8_t* b, const int32_t* p) {
  for (int k = 0; k < 32; ++k) b[k] = (uint8_t)p[k];
}

HD void bytes_store(int32_t* p, const uint8_t* b) {
  for (int k = 0; k < 32; ++k) p[k] = b[k];
}

// Load the round's inputs, sum the evaluations over the table sets (lane m
// the evaluation m), and interpolate the cubic (UniPoly::from_evals,
// unipoly.rs:23-55): coeffs [d, c, b, a], constant first, a and b on lanes
// 0 and 1. Next: the commitment of coeffs || bp.
template <class X>
HD void zk_tail_load(X& x, Strobe& s, ZkTail& z, const int32_t* evs, int k,
                     const int32_t* st_io, const int32_t* carry,
                     const int32_t* tape) {
  x.lanes([&](int l, int nl) {
    for (int j = l; j < 200; j += nl) z.st[j] = (uint8_t)st_io[j];
    if (l < 3) {
      load16(evs + 16 * l, z.e[l]);
      for (int i = 1; i < k; ++i) {
        uint32_t t[8];
        load16(evs + 48 * i + 16 * l, t);
        fq_add(z.e[l], z.e[l], t);
      }
    } else if (l == 3) {
      const uint32_t two_inv[8] = FQ_TWO_INV_WORDS;
      const uint32_t six_inv[8] = FQ_SIX_INV_WORDS;
      copy8(z.k2, two_inv);
      copy8(z.k6, six_inv);
      load16(carry, z.claim);
      bytes_load(z.comm_claim, carry + 16);
      load16(tape, z.bp);
      load16(tape + 16, z.be);
      load16(tape + 32, z.bsc);
      for (int i = 0; i < 4; ++i) load16(tape + 48 + 16 * i, z.dv[i]);
      load16(tape + 112, z.rd);
      load16(tape + 128, z.rb);
      bytes_load(z.delta, tape + 144);
    }
  });
  s.pos = st_io[200];
  s.pos_begin = st_io[201];
  x.lanes([&](int l, int nl) {
    if (l > 1) return;
    const uint32_t *e0 = z.e[0], *e2 = z.e[1], *e3 = z.e[2];
    uint32_t e1[8], v[8], *u = z.u[l];
    fq_sub(e1, z.claim, e0);
    if (l == 0) {  // a = (e3 - 3 e2 + 3 e1 - e0) / 6
      fq_add(u, e2, e2);
      fq_add(u, u, e2);
      fq_sub(u, e3, u);
      fq_add(v, e1, e1);
      fq_add(v, v, e1);
      fq_add(u, u, v);
      fq_sub(u, u, e0);
      fq_mul_c(z.coeffs[3], z.k6, u);
    } else {  // b = (2 e0 + 4 e2 - 5 e1 - e3) / 2
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
      fq_mul_c(z.coeffs[2], z.k2, u);
    }
  });
  x.one([&] {  // c = e1 - d - a - b, d = e0
    uint32_t u[8];
    copy8(z.coeffs[0], z.e[0]);
    fq_sub(u, z.claim, z.e[0]);
    fq_sub(u, u, z.e[0]);
    fq_sub(u, u, z.coeffs[3]);
    fq_sub(z.coeffs[1], u, z.coeffs[2]);
  });
  x.lanes([&](int l, int nl) {
    if (l < 5) fq_canon(z.sc[0][l], l < 4 ? z.coeffs[l] : z.bp);
  });
}

// comm_poly, the challenge r and the evaluation at r. Next: the
// commitment of eval || be.
template <class X>
HD void zk_tail_poly(X& x, Strobe& s, ZkTail& z) {
  merlin_append_bytes(x, s, lbl("comm_poly"), z.comm_poly, 32);
  merlin_challenge_scalar(x, s, lbl("challenge_nextround"), z.r, z.scratch, z.u);
  x.one([&] {
    copy8(z.eval, z.coeffs[3]);
    for (int i = 2; i >= 0; --i) {
      fq_mul_c(z.eval, z.eval, z.r);
      fq_add(z.eval, z.eval, z.coeffs[i]);
    }
  });
  x.lanes([&](int l, int nl) {
    if (l < 2) fq_canon(z.sc[0][l], l ? z.be : z.eval);
  });
}

// The transcript's steps before comm_eval (K11 runs them while another
// warp encodes comm_eval).
template <class X>
HD void zk_tail_claim(X& x, Strobe& s, ZkTail& z) {
  merlin_append_bytes(x, s, lbl("comm_claim_per_round"), z.comm_claim, 32);
}

// comm_eval, the two claims combined (target, blind), the vector a and
// <a, d_vec>. Next: the commitments of target || blind (Cy) and of
// <a, d_vec> || r_beta (beta), side by side.
template <class X>
HD void zk_tail_eval(X& x, Strobe& s, ZkTail& z) {
  merlin_append_bytes(x, s, lbl("comm_eval"), z.comm_eval, 32);
  merlin_challenge_scalar(x, s, lbl("combine_two_claims_to_one"), z.w0,
                          z.scratch, z.u);
  merlin_challenge_scalar(x, s, lbl("combine_two_claims_to_one"), z.w1,
                          z.scratch, z.u);
  x.lanes([&](int l, int nl) {
    if (l == 0) {  // target = w0 claim + w1 eval
      fq_mul_c(z.m[0], z.w1, z.eval);
      fq_mul_c(z.target, z.w0, z.claim);
      fq_add(z.target, z.target, z.m[0]);
    } else if (l == 1) {  // blind = w0 bsc + w1 be
      fq_mul_c(z.m[1], z.w1, z.be);
      fq_mul_c(z.blind, z.w0, z.bsc);
      fq_add(z.blind, z.blind, z.m[1]);
    } else if (l == 2) {  // r^2, r^3
      fq_mul_c(z.rp[2], z.r, z.r);
      fq_mul_c(z.rp[3], z.rp[2], z.r);
    }
  });
  x.lanes([&](int l, int nl) {  // a = w0 (2, 1, 1, 1) + w1 (1, r, r^2, r^3)
    if (l >= 4) return;
    if (l == 0) {
      fq_add(z.a[0], z.w0, z.w0);
      fq_add(z.a[0], z.a[0], z.w1);
    } else {
      fq_mul_c(z.a[l], z.w1, l == 1 ? z.r : z.rp[l]);
      fq_add(z.a[l], z.a[l], z.w0);
    }
    fq_mul_c(z.m[l], z.a[l], z.dv[l]);
  });
  x.one([&] {
    fq_add(z.dp_ad, z.m[0], z.m[1]);
    fq_add(z.dp_ad, z.dp_ad, z.m[2]);
    fq_add(z.dp_ad, z.dp_ad, z.m[3]);
  });
  x.lanes([&](int l, int nl) {
    if (l < 4)
      fq_canon(z.sc[l >> 1][l & 1], l == 0   ? z.target
                                    : l == 1 ? z.blind
                                    : l == 2 ? z.dp_ad
                                             : z.rb);
  });
}

// The DotProductProof's transcript steps before Cy, and a's canonical
// bytes (lanes 0-3); K11 runs them while another warp encodes Cy and beta.
template <class X>
HD void zk_tail_dpp(X& x, Strobe& s, ZkTail& z) {
  merlin_append_str(x, s, lbl("protocol-name"), lbl("dot product proof"));
  merlin_append_bytes(x, s, lbl("Cx"), z.comm_poly, 32);
  x.lanes([&](int l, int nl) {
    if (l < 4) {
      fq_canon(z.m[l], z.a[l]);
      bytes_from_words(z.a_bytes[l], z.m[l]);
    }
  });
}

// The rest of the DotProductProof's transcript and its challenge c, its
// responses; then every output.
template <class X>
HD void zk_tail_finish(X& x, Strobe& s, ZkTail& z, int32_t* st_io,
                       int32_t* carry, int32_t* out) {
  merlin_append_bytes(x, s, lbl("Cy"), z.cy, 32);
  merlin_append_str(x, s, lbl("a"), lbl("begin_append_vector"));
  for (int i = 0; i < 4; ++i)
    merlin_append_bytes(x, s, lbl("a"), z.a_bytes[i], 32);
  merlin_append_str(x, s, lbl("a"), lbl("end_append_vector"));
  merlin_append_bytes(x, s, lbl("delta"), z.delta, 32);
  merlin_append_bytes(x, s, lbl("beta"), z.beta, 32);
  merlin_challenge_scalar(x, s, lbl("c"), z.c, z.scratch, z.u);
  const int pos = s.pos, pos_begin = s.pos_begin;
  x.lanes([&](int l, int nl) {
    if (l < 6) {  // z = c coeffs + d_vec, z_delta = c bp + r_delta,
                  // z_beta = c blind + r_beta
      fq_mul_c(z.m[l], z.c, l < 4 ? z.coeffs[l] : l == 4 ? z.bp : z.blind);
      fq_add(z.m[l], z.m[l], l < 4 ? z.dv[l] : l == 4 ? z.rd : z.rb);
      store16(out + 96 + 16 * l, z.m[l]);
    } else if (l == 6) {
      store16(out + 16 * ZK_OUT_R, z.r);
      store16(carry, z.eval);
      bytes_store(carry + 16, z.comm_eval);
      st_io[200] = pos;
      st_io[201] = pos_begin;
    }
    for (int j = l; j < 96; j += nl)
      out[j] = j < 32 ? z.comm_poly[j] : j < 64 ? z.comm_eval[j - 32]
                                                : z.beta[j - 64];
    for (int j = l; j < 200; j += nl) st_io[j] = z.st[j];
  });
}
