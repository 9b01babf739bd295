// Keccak-f[1600], the STROBE-128 subset that merlin uses, and the merlin
// transcript operations of the reference's ProofTranscript
// (src/transcript.rs), on one 200-byte sponge state: the device transcript
// of the JAX package's ops/transcript_dev.py, byte for byte the port's host
// utils/strobe.py and utils/transcript.py. K8 (csrc/zk_round.cu) runs the
// permutation alone on a batch of states; K11 runs the whole transcript of
// a sumcheck round on one thread.
//
// Every function is __host__ __device__ so that g++ builds the same code
// into the host library of the CPU tests (csrc/host_check.cpp). The large
// ones are not inlined (HDN): a round's transcript calls them from dozens
// of places.
#pragma once
#include "fq.cuh"

#ifdef __CUDACC__
#define HDN __host__ __device__ __noinline__
#else
#define HDN static
#endif

#define STROBE_R 166
#define STROBE_FLAG_I 1
#define STROBE_FLAG_A 2
#define STROBE_FLAG_C 4
#define STROBE_FLAG_M 16
#define STROBE_FLAG_K 32

#define KECCAK_RC                                                        \
  {0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,  \
   0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,  \
   0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,  \
   0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,  \
   0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,  \
   0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,  \
   0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,  \
   0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull}

// rho offsets of lane x + 5 y, as ROT[x][y] in utils/keccak.py
#define KECCAK_ROT                                                       \
  {{0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},          \
   {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}}

HD uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

// The permutation on 25 lanes, lane (x, y) at index x + 5 y.
HDN void keccak_f1600(uint64_t* a) {
  const uint64_t rc[24] = KECCAK_RC;
  const int rot[5][5] = KECCAK_ROT;
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
#pragma unroll
    for (int x = 0; x < 5; ++x)
#pragma unroll
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], rot[x][y]);
#pragma unroll
    for (int y = 0; y < 5; ++y)
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^
                       (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= rc[round];
  }
}

// The permutation on a 200-byte state (little-endian lanes).
HDN void keccak_bytes(uint8_t* st) {
  uint64_t a[25];
  for (int i = 0; i < 25; ++i) {
    uint64_t v = 0;
    for (int k = 7; k >= 0; --k) v = (v << 8) | st[8 * i + k];
    a[i] = v;
  }
  keccak_f1600(a);
  for (int i = 0; i < 25; ++i)
    for (int k = 0; k < 8; ++k) st[8 * i + k] = (uint8_t)(a[i] >> (8 * k));
}

// --------------------------------------------------------------------------
// STROBE-128 (utils/strobe.py): absorb, squeeze and begin-op, byte by byte
// --------------------------------------------------------------------------
struct Strobe {
  uint8_t st[200];
  int pos, pos_begin;
};

HDN void strobe_run_f(Strobe& s) {
  s.st[s.pos] ^= (uint8_t)s.pos_begin;
  s.st[s.pos + 1] ^= 0x04;
  s.st[STROBE_R + 1] ^= 0x80;
  keccak_bytes(s.st);
  s.pos = 0;
  s.pos_begin = 0;
}

HDN void strobe_absorb(Strobe& s, const uint8_t* d, int n) {
  for (int i = 0; i < n; ++i) {
    s.st[s.pos++] ^= d[i];
    if (s.pos == STROBE_R) strobe_run_f(s);
  }
}

HDN void strobe_squeeze(Strobe& s, uint8_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    out[i] = s.st[s.pos];
    s.st[s.pos++] = 0;
    if (s.pos == STROBE_R) strobe_run_f(s);
  }
}

// pos_begin becomes pos + 1 before the two flag bytes are absorbed; a C or
// K operation starts on a fresh block.
HDN void strobe_begin_op(Strobe& s, int flags, bool more) {
  if (more) return;
  uint8_t d[2] = {(uint8_t)s.pos_begin, (uint8_t)flags};
  s.pos_begin = s.pos + 1;
  strobe_absorb(s, d, 2);
  if ((flags & (STROBE_FLAG_C | STROBE_FLAG_K)) && s.pos != 0)
    strobe_run_f(s);
}

HD void strobe_meta_ad(Strobe& s, const uint8_t* d, int n, bool more) {
  strobe_begin_op(s, STROBE_FLAG_M | STROBE_FLAG_A, more);
  strobe_absorb(s, d, n);
}

HD void strobe_ad(Strobe& s, const uint8_t* d, int n, bool more) {
  strobe_begin_op(s, STROBE_FLAG_A, more);
  strobe_absorb(s, d, n);
}

HD void strobe_prf(Strobe& s, uint8_t* out, int n, bool more) {
  strobe_begin_op(s, STROBE_FLAG_I | STROBE_FLAG_A | STROBE_FLAG_C, more);
  strobe_squeeze(s, out, n);
}

// --------------------------------------------------------------------------
// merlin and the reference's ProofTranscript (utils/transcript.py)
// --------------------------------------------------------------------------
HD void u32_le(uint8_t* b, uint32_t n) {
  for (int k = 0; k < 4; ++k) b[k] = (uint8_t)(n >> (8 * k));
}

HDN void merlin_append(Strobe& s, const char* label, const uint8_t* msg,
                       int n) {
  int ll = 0;
  while (label[ll]) ++ll;
  uint8_t len[4];
  u32_le(len, (uint32_t)n);
  strobe_meta_ad(s, (const uint8_t*)label, ll, false);
  strobe_meta_ad(s, len, 4, true);
  strobe_ad(s, msg, n, false);
}

HDN void merlin_challenge_bytes(Strobe& s, const char* label, uint8_t* out,
                                int n) {
  int ll = 0;
  while (label[ll]) ++ll;
  uint8_t len[4];
  u32_le(len, (uint32_t)n);
  strobe_meta_ad(s, (const uint8_t*)label, ll, false);
  strobe_meta_ad(s, len, 4, true);
  strobe_prf(s, out, n, false);
}

// 1 as a canonical integer: a Montgomery product with it leaves the
// Montgomery form.
#define FQ_ONE_CANON_WORDS {1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}
// R^2 mod l: a Montgomery product with it enters the form; also the
// Montgomery form of 2^256 = R.
#define FQ_R2_WORDS                                                    \
  {0x449c0f01u, 0xa40611e3u, 0x68859347u, 0xd00e1ba7u, 0x17f5be65u,    \
   0xceec73d2u, 0x7c309a3du, 0x0399411bu}

HD void words_from_bytes(uint32_t* w, const uint8_t* b) {
  for (int k = 0; k < 8; ++k)
    w[k] = (uint32_t)b[4 * k] | ((uint32_t)b[4 * k + 1] << 8) |
           ((uint32_t)b[4 * k + 2] << 16) | ((uint32_t)b[4 * k + 3] << 24);
}

HD void bytes_from_words(uint8_t* b, const uint32_t* w) {
  for (int k = 0; k < 32; ++k) b[k] = (uint8_t)(w[k >> 2] >> (8 * (k & 3)));
}

// Scalar::from_bytes_wide of 64 bytes, in Montgomery form: lo R + hi R *
// 2^256. Each half may be >= l (up to 2^256 - 1); the CIOS product of a
// value below 2^256 with one below l is below 2 l before its final
// subtraction, so both products come out fully reduced.
HD void fq_from_bytes_wide(uint32_t* out, const uint8_t* b) {
  const uint32_t r2[8] = FQ_R2_WORDS;
  uint32_t lo[8], hi[8];
  words_from_bytes(lo, b);
  words_from_bytes(hi, b + 32);
  fq_mul(lo, lo, r2);
  fq_mul(hi, hi, r2);
  fq_mul(hi, hi, r2);
  fq_add(out, lo, hi);
}

HDN void merlin_challenge_scalar(Strobe& s, const char* label,
                                 uint32_t* out) {
  uint8_t b[64];
  merlin_challenge_bytes(s, label, b, 64);
  fq_from_bytes_wide(out, b);
}

// A Montgomery scalar appended as its 32 canonical little-endian bytes.
HDN void merlin_append_scalar(Strobe& s, const char* label,
                              const uint32_t* mont) {
  const uint32_t one[8] = FQ_ONE_CANON_WORDS;
  uint32_t c[8];
  uint8_t b[32];
  fq_mul(c, mont, one);
  bytes_from_words(b, c);
  merlin_append(s, label, b, 32);
}
