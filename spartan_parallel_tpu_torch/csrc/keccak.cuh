// Keccak-f[1600], the STROBE-128 subset that merlin uses, and the merlin
// transcript operations of the reference's ProofTranscript
// (src/transcript.rs), on one 200-byte sponge state: the device transcript
// of the JAX package's ops/transcript_dev.py, byte for byte the port's host
// utils/strobe.py and utils/transcript.py.
//
// On the card a warp runs the transcript (K11, csrc/zk_round.cu): the
// state stays in shared memory as bytes, so STROBE absorbs and squeezes
// byte by byte in its own order, each chunk's bytes on the warp's lanes;
// the permutation loads the state into 25 lanes, one 64-bit word a lane,
// takes theta's column parities, rho-pi's moves and chi's row neighbours
// by shuffles, and stores it back. K8 runs the same permutation alone on
// a batch of states. The lane steps (kl_*) read other lanes' words only
// through their Get argument, the same number of times on every lane: a
// shuffle on the card, an array in the host model (keccak_lanes_host).
//
// The transcript functions take an executor X: on the card WarpX (every
// lane of the warp calls them with the same arguments), on the host HostX,
// which runs each lane step in turn (csrc/host_check.cpp). Every function
// is __host__ __device__ so that g++ builds the same code.
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

// rho offsets of lane (x, y) at index x + 5 y, as ROT[x][y] in
// utils/keccak.py
#define KECCAK_ROT                                                       \
  {{0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},          \
   {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14}}

HD uint64_t rotl64(uint64_t v, int n) {
  return n == 0 ? v : (v << n) | (v >> (64 - n));
}

// The permutation on 25 words, word (x, y) at index x + 5 y, on one
// thread: the reference the lane steps are held against.
HD void keccak_f1600(uint64_t* a) {
  const uint64_t rc[24] = KECCAK_RC;
  const int rot[5][5] = KECCAK_ROT;
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
    for (int x = 0; x < 5; ++x)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; ++x) {
      uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
      for (int y = 0; y < 5; ++y) a[x + 5 * y] ^= d;
    }
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y], rot[x][y]);
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x)
        a[x + 5 * y] = b[x + 5 * y] ^
                       (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    a[0] ^= rc[round];
  }
}

// --------------------------------------------------------------------------
// One round on lanes: lane l < 25 holds word l (lanes 25..31 compute
// values no one keeps, from valid sources).
// --------------------------------------------------------------------------
// theta: the parity of lane l's column
template <class Get>
HD uint64_t kl_parity(int l, Get A) {
  const int x = (l < 25 ? l : 0) % 5;
  return A(x) ^ A(x + 5) ^ A(x + 10) ^ A(x + 15) ^ A(x + 20);
}

// theta: a ^ C[x - 1] ^ rotl(C[x + 1], 1), C read from the column's lanes
template <class Get>
HD uint64_t kl_theta(int l, uint64_t a, Get C) {
  const int x = (l < 25 ? l : 0) % 5;
  return a ^ C((x + 4) % 5) ^ rotl64(C((x + 1) % 5), 1);
}

// KECCAK_ROT by word index x + 5 y, six bits each, ten to a constant (no
// table in memory: the lanes index it by their own word)
HD int kl_rot(int i) {
  const uint64_t k = i < 10 ? 0x5371ac91b73e040ull
                            : i < 20 ? 0x2153eda6766b283ull : 0xee3d092ull;
  return (int)((k >> (6 * (i % 10))) & 63u);
}

// rho and pi: lane l = X + 5 Y receives word x + 5 y, rotated, where
// X = y and Y = (2 x + 3 y) % 5, so y = X and x = 3 (Y - 3 y) % 5
template <class Get>
HD uint64_t kl_rho_pi(int l, Get A) {
  const int d = l < 25 ? l : 0, y = d % 5;
  const int src = (3 * (d / 5 - 3 * y + 15)) % 5 + 5 * y;
  return rotl64(A(src), kl_rot(src));
}

// chi and iota (rc: the round constant)
template <class Get>
HD uint64_t kl_chi(int l, uint64_t rc, uint64_t b, Get B) {
  const int d = l < 25 ? l : 0, x = d % 5, y5 = d - x;
  const uint64_t r = b ^ (~B((x + 1) % 5 + y5) & B((x + 2) % 5 + y5));
  return l == 0 ? r ^ rc : r;
}

#ifdef __CUDACC__
__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

// The permutation of a 200-byte state in shared memory (8-byte aligned)
// by the 32 lanes of a warp: one copy of the code, its 24 rounds unrolled
// (their constants immediate).
__device__ __noinline__ void keccak_lanes(uint8_t* st, int lane) {
  const uint64_t rc[24] = KECCAK_RC;
  uint64_t* w = reinterpret_cast<uint64_t*>(st);
  __syncwarp();
  uint64_t a = lane < 25 ? w[lane] : 0;
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    const uint64_t c = kl_parity(lane, [&](int s) { return shfl64(a, s); });
    a = kl_theta(lane, a, [&](int s) { return shfl64(c, s); });
    const uint64_t b = kl_rho_pi(lane, [&](int s) { return shfl64(a, s); });
    a = kl_chi(lane, rc[round], b, [&](int s) { return shfl64(b, s); });
  }
  if (lane < 25) w[lane] = a;
  __syncwarp();
}

// the transcript's executor on the card: every lane of one warp
struct WarpX {
  int lane;
  template <class F>
  __device__ void lanes(F f) {
    f(lane, 32);
    __syncwarp();
  }
  template <class F>
  __device__ void one(F f) {
    if (lane == 0) f();
    __syncwarp();
  }
  __device__ void permute(uint8_t* st) { keccak_lanes(st, lane); }
};
#else
// The host model of keccak_lanes: each step on 32 lanes in turn.
static void keccak_lanes_host(uint64_t* w) {
  const uint64_t rc[24] = KECCAK_RC;
  uint64_t a[32], c[32], b[32];
  for (int l = 0; l < 32; ++l) a[l] = l < 25 ? w[l] : 0;
  for (int round = 0; round < 24; ++round) {
    uint64_t t[32];
    for (int l = 0; l < 32; ++l)
      c[l] = kl_parity(l, [&](int s) { return a[s]; });
    for (int l = 0; l < 32; ++l)
      t[l] = kl_theta(l, a[l], [&](int s) { return c[s]; });
    for (int l = 0; l < 32; ++l)
      b[l] = kl_rho_pi(l, [&](int s) { return t[s]; });
    for (int l = 0; l < 32; ++l)
      a[l] = kl_chi(l, rc[round], b[l], [&](int s) { return b[s]; });
  }
  for (int l = 0; l < 25; ++l) w[l] = a[l];
}

// the transcript's executor on the host: the lanes one after another
struct HostX {
  template <class F>
  void lanes(F f) {
    for (int l = 0; l < 32; ++l) f(l, 32);
  }
  template <class F>
  void one(F f) {
    f();
  }
  void permute(uint8_t* st) {
    uint64_t w[25];
    for (int i = 0; i < 25; ++i) {
      uint64_t v = 0;
      for (int k = 7; k >= 0; --k) v = (v << 8) | st[8 * i + k];
      w[i] = v;
    }
    keccak_lanes_host(w);
    for (int i = 0; i < 25; ++i)
      for (int k = 0; k < 8; ++k) st[8 * i + k] = (uint8_t)(w[i] >> (8 * k));
  }
};
#endif

// --------------------------------------------------------------------------
// STROBE-128 (utils/strobe.py): absorb, squeeze and begin-op. st is the
// shared 200-byte state; every lane keeps its own copy of pos and
// pos_begin (they move the same on every lane).
// --------------------------------------------------------------------------
struct Strobe {
  uint8_t* st;
  int pos, pos_begin;
};

template <class X>
HD void strobe_run_f(X& x, Strobe& s) {
  uint8_t* st = s.st;
  const int pos = s.pos, pb = s.pos_begin;
  x.one([&] {
    st[pos] ^= (uint8_t)pb;
    st[pos + 1] ^= 0x04;
    st[STROBE_R + 1] ^= 0x80;
  });
  x.permute(st);
  s.pos = 0;
  s.pos_begin = 0;
}

// absorb n bytes d(0..n-1), a chunk up to the rate at a time
template <class X, class Src>
HD void strobe_absorb(X& x, Strobe& s, Src d, int n) {
  for (int i = 0; i < n;) {
    const int k = n - i < STROBE_R - s.pos ? n - i : STROBE_R - s.pos;
    uint8_t* st = s.st + s.pos;
    x.lanes([&](int l, int nl) {
      for (int j = l; j < k; j += nl) st[j] ^= d(i + j);
    });
    s.pos += k;
    i += k;
    if (s.pos == STROBE_R) strobe_run_f(x, s);
  }
}

template <class X>
HD void strobe_squeeze(X& x, Strobe& s, uint8_t* out, int n) {
  for (int i = 0; i < n;) {
    const int k = n - i < STROBE_R - s.pos ? n - i : STROBE_R - s.pos;
    uint8_t* st = s.st + s.pos;
    x.lanes([&](int l, int nl) {
      for (int j = l; j < k; j += nl) {
        out[i + j] = st[j];
        st[j] = 0;
      }
    });
    s.pos += k;
    i += k;
    if (s.pos == STROBE_R) strobe_run_f(x, s);
  }
}

// pos_begin becomes pos + 1 before the two flag bytes are absorbed; a C or
// K operation starts on a fresh block.
template <class X>
HD void strobe_begin_op(X& x, Strobe& s, int flags, bool more) {
  if (more) return;
  const int old = s.pos_begin;
  s.pos_begin = s.pos + 1;
  strobe_absorb(x, s, [&](int j) { return (uint8_t)(j ? flags : old); }, 2);
  if ((flags & (STROBE_FLAG_C | STROBE_FLAG_K)) && s.pos != 0)
    strobe_run_f(x, s);
}

template <class X, class Src>
HD void strobe_meta_ad(X& x, Strobe& s, Src d, int n, bool more) {
  strobe_begin_op(x, s, STROBE_FLAG_M | STROBE_FLAG_A, more);
  strobe_absorb(x, s, d, n);
}

template <class X, class Src>
HD void strobe_ad(X& x, Strobe& s, Src d, int n, bool more) {
  strobe_begin_op(x, s, STROBE_FLAG_A, more);
  strobe_absorb(x, s, d, n);
}

template <class X>
HD void strobe_prf(X& x, Strobe& s, uint8_t* out, int n, bool more) {
  strobe_begin_op(x, s, STROBE_FLAG_I | STROBE_FLAG_A | STROBE_FLAG_C, more);
  strobe_squeeze(x, s, out, n);
}

// --------------------------------------------------------------------------
// merlin and the reference's ProofTranscript (utils/transcript.py)
// --------------------------------------------------------------------------
// A string and its length, known when it is compiled (lbl of a literal):
// no loop over its bytes to find the end.
struct Label {
  const char* p;
  int n;
};

template <int N>
HD Label lbl(const char (&s)[N]) {
  return Label{s, N - 1};
}

template <class X, class Src>
HD void merlin_append(X& x, Strobe& s, Label label, Src msg, int n) {
  strobe_meta_ad(x, s, [&](int j) { return (uint8_t)label.p[j]; }, label.n,
                 false);
  strobe_meta_ad(x, s, [&](int j) { return (uint8_t)((uint32_t)n >> (8 * j)); },
                 4, true);
  strobe_ad(x, s, msg, n, false);
}

template <class X>
HD void merlin_append_bytes(X& x, Strobe& s, Label label, const uint8_t* msg,
                            int n) {
  merlin_append(x, s, label, [&](int j) { return msg[j]; }, n);
}

// a string's bytes as the message
template <class X>
HD void merlin_append_str(X& x, Strobe& s, Label label, Label msg) {
  merlin_append(x, s, label, [&](int j) { return (uint8_t)msg.p[j]; },
                msg.n);
}

template <class X>
HD void merlin_challenge_bytes(X& x, Strobe& s, Label label, uint8_t* out,
                               int n) {
  strobe_meta_ad(x, s, [&](int j) { return (uint8_t)label.p[j]; }, label.n,
                 false);
  strobe_meta_ad(x, s, [&](int j) { return (uint8_t)((uint32_t)n >> (8 * j)); },
                 4, true);
  strobe_prf(x, s, out, n, false);
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

// One Montgomery product as a call, on words in memory (shared memory in
// K11): the round's scalar steps share one copy of the code.
HDN void fq_mul_c(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  fq_mul(r, a, b);
}

// the canonical words of a Montgomery scalar (c may alias mont)
HDN void fq_canon(uint32_t* c, const uint32_t* mont) {
  const uint32_t one[8] = FQ_ONE_CANON_WORDS;
  fq_mul(c, mont, one);
}

// Scalar::from_bytes_wide of 64 bytes, in Montgomery form: lo R + hi R *
// 2^256. Each half may be >= l (up to 2^256 - 1); the CIOS product of a
// value below 2^256 with one below l is below 2 l before its final
// subtraction, so both products come out fully reduced.
HDN void fq_wide_half(uint32_t* out, const uint8_t* b, int h) {
  const uint32_t r2[8] = FQ_R2_WORDS;  // half h: lo R or hi R^2
  uint32_t t[8];
  words_from_bytes(t, b + 32 * h);
  fq_mul(t, t, r2);
  if (h) fq_mul(t, t, r2);
  copy8(out, t);
}

HD void fq_from_bytes_wide(uint32_t* out, const uint8_t* b) {
  uint32_t lo[8], hi[8];
  fq_wide_half(lo, b, 0);
  fq_wide_half(hi, b, 1);
  fq_add(out, lo, hi);
}

// a challenge scalar into out (Montgomery words): its two halves reduce
// on lanes 0 and 1 (tmp: two words of eight), then add; scratch: 64 bytes
template <class X>
HD void merlin_challenge_scalar(X& x, Strobe& s, Label label, uint32_t* out,
                                uint8_t* scratch, uint32_t (*tmp)[8]) {
  merlin_challenge_bytes(x, s, label, scratch, 64);
  x.lanes([&](int l, int nl) {
    if (l < 2) fq_wide_half(tmp[l], scratch, l);
  });
  x.one([&] { fq_add(out, tmp[0], tmp[1]); });
}
