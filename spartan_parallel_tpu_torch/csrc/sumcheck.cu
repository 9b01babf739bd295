// K4 and K5: sumcheck round kernels for the two R1CS sumchecks.
//
// Replaces the JAX package's ops/sumcheck.py p1_evals / p1_step and
// p2_evals / p2_step (and, through K1's bind, p1_bind / p2_bind). Tables
// keep the JAX layout; n_half is half of the live length along the axis
// being bound.
//
//   phase 1: sum over x of eq_p(p) eq_q(q) eq_x(x) (B C - D) at t = 0, 2, 3
//     for the variable being bound (axis 0 = p, 1 = q, 2 = x);
//   phase 2: sum of eq_p(p) ABC(p, w, y) Z(p, w, y) at t = 0, 2, 3
//     (axis 0 = p, 1 = w, 2 = y); ABC may hold one instance shared by all p.
//
// K4 (k_p1_round, k_p2_round): a round's work follows its live pairs.
// The JAX package keeps every table at its full size for the whole
// sumcheck (XLA sees static shapes) and writes the dead region's zeros
// each round, so each round costs the whole buffer. Here the grid covers
// the live pairs
// (outer x n_half x inner) only, and a fused step (bind = 1: the previous
// round's challenge r bound first, the JAX package's p1_step / p2_step,
// same axis only) writes new tables of the new live length 2 n_half along
// the axis (ops/sumcheck.py allocates them): the thread of pair i reads
// entries i, i + n_half, i + 2 n_half, i + 3 n_half of the old tables and
// writes i and i + n_half of the new. The grid is bounded (the blocks
// resident at once, each on a contiguous range of pairs), so the second
// pass sums a few hundred partials; a line's pairs (those sharing the eq
// factors of the axes not bound) are summed before one product by the
// line's factor. Loads and stores move 16 bytes (4 limbs) at a time.
// Bound on the card: bytes. A round reads every live entry once (64 B
// each) and, fused, writes the bound half; a pair needs 14 field products
// (8 binds, 6 evaluations), below the card's multiply rate at these bytes.
//
// K5, the size-classed phase 1 (k_pc_round), replaces ops/sumcheck.py
// pc_evals / pc_step for one q-size class of instances: its (P_c, Q_c, X)
// tables sit at p offset p0 and q stride S of the shared eq tables, which
// it only reads (eq_fold binds them once per round for every class, where
// K4 binds its own eq table in the owner threads). An active round binds
// x or q as K4 does; an inactive q round (the class is bound on q, one
// live entry per instance) evaluates with eq_q = (tq[0], tq[n_half]) and a
// zero high half, and its fused bind is the (1 - r) scale.
//
// K5 keeps the first design: one thread per entry of the full buffer, the
// dead region written with zeros, one block sum per 256 entries.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tables.cuh"

// value of a table at pair index ii, bound to r when bind is set:
// T[ii] + r (T[ii + nhp] - T[ii])
__device__ __forceinline__ void pair_val(uint32_t* v, const int32_t* T,
                                         long long idx, long long step,
                                         int bind, const uint32_t* r) {
  load16(T + 16 * idx, v);
  if (bind) {
    uint32_t h[8];
    load16(T + 16 * (idx + step), h);
    fq_bind(v, v, h, r);
  }
}

// e (B C - D) at t = 0, 2, 3 from the pair's (lo, hi) values; the sums
// s0, s2, s3 are overwritten.
__device__ __forceinline__ void eval3(uint32_t* s0, uint32_t* s2,
                                      uint32_t* s3,
                                      const uint32_t* el, const uint32_t* eh,
                                      const uint32_t* Bl, const uint32_t* Bh,
                                      const uint32_t* Cl, const uint32_t* Ch,
                                      const uint32_t* Dl, const uint32_t* Dh) {
  uint32_t b[8], c[8], d[8], e[8], g[8];
  // t = 0
  fq_mul(g, Bl, Cl);
  fq_sub(g, g, Dl);
  fq_mul(s0, g, el);
  // t = 2
  uint32_t b2[8], c2[8], d2[8], e2[8];
  fq_ext2(b2, Bl, Bh);
  fq_ext2(c2, Cl, Ch);
  fq_ext2(d2, Dl, Dh);
  fq_ext2(e2, el, eh);
  fq_mul(g, b2, c2);
  fq_sub(g, g, d2);
  fq_mul(s2, g, e2);
  // t = 3
  fq_ext3(b, b2, Bl, Bh);
  fq_ext3(c, c2, Cl, Ch);
  fq_ext3(d, d2, Dl, Dh);
  fq_ext3(e, e2, el, eh);
  fq_mul(g, b, c);
  fq_sub(g, g, d);
  fq_mul(s3, g, e);
}

__device__ void finish_block(uint32_t* s0, uint32_t* s2, uint32_t* s3,
                             uint32_t* part) {
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  block_sum(s0, sh);
  block_sum(s2, sh);
  block_sum(s3, sh);
  if (threadIdx.x == 0) {
    copy8(part + 8 * (0 * gridDim.x + blockIdx.x), s0);
    copy8(part + 8 * (1 * gridDim.x + blockIdx.x), s2);
    copy8(part + 8 * (2 * gridDim.x + blockIdx.x), s3);
  }
}

// ---------------------------------------------------------------------------
// K4: a round's grid and bytes follow its live pairs
// ---------------------------------------------------------------------------
#define K4_THREADS 128
// at most this many blocks (partials) a launch; ops/sumcheck.py sizes the
// scratch from it
#define K4_MAX_BLOCKS 2048
// phase 1's registers are capped for 4 blocks an SM (128 a thread, a few
// bytes spilled): on the H100 its fused rounds ran faster so than with 3
// blocks or with the compiler's own 184 registers (2 blocks); phase 2's
// times did not move with the cap
#define K4_P1_MIN_BLOCKS 4

// a thread's running sums at t = 0, 2, 3 in shared memory (word-major,
// thread-minor: no bank conflicts), which frees their registers for the
// pairs; they are touched once a line
typedef uint32_t K4Sums[3][8][K4_THREADS];

// x[t] = B_t C_t at t = 0, 2, 3 of the pairs (Bl, Bh), (Cl, Ch)
__device__ __forceinline__ void k4_prod3(uint32_t (*x)[8], const uint32_t* Bl,
                                         const uint32_t* Bh,
                                         const uint32_t* Cl,
                                         const uint32_t* Ch) {
  uint32_t b[8], c[8];
  fq_mul(x[0], Bl, Cl);
  fq_ext2(b, Bl, Bh);
  fq_ext2(c, Cl, Ch);
  fq_mul(x[1], b, c);
  fq_ext3(b, b, Bl, Bh);
  fq_ext3(c, c, Cl, Ch);
  fq_mul(x[2], b, c);
}

// x[t] -= D_t (SUB) or x[t] *= D_t at t = 0, 2, 3 of the pair (Dl, Dh)
template <bool SUB>
__device__ __forceinline__ void k4_apply3(uint32_t (*x)[8],
                                          const uint32_t* Dl,
                                          const uint32_t* Dh) {
  uint32_t d[8];
  if (SUB) fq_sub(x[0], x[0], Dl); else fq_mul(x[0], x[0], Dl);
  fq_ext2(d, Dl, Dh);
  if (SUB) fq_sub(x[1], x[1], d); else fq_mul(x[1], x[1], d);
  fq_ext3(d, d, Dl, Dh);
  if (SUB) fq_sub(x[2], x[2], d); else fq_mul(x[2], x[2], d);
}

__device__ __forceinline__ void add3(uint32_t (*s)[8], uint32_t (*x)[8]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) fq_add(s[t], s[t], x[t]);
}

// s += W ln and ln = 0: the sums of a line (pairs sharing the eq factors of
// the axes not bound) scaled once by their factor W
__device__ __forceinline__ void k4_flush(K4Sums& s, uint32_t (*ln)[8],
                                         const uint32_t* W) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint32_t v[8];
    fq_mul(ln[t], ln[t], W);
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = s[t][w][threadIdx.x];
    fq_add(v, v, ln[t]);
#pragma unroll
    for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = v[w];
    zero8(ln[t]);
  }
}

__device__ __forceinline__ void k4_start(K4Sums& s, uint32_t (*ln)[8]) {
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = 0;
    zero8(ln[t]);
  }
}

// the block's three sums into part[t * gridDim.x + blockIdx.x], or, from a
// grid of one block, into out (3, 16 limbs) with no second pass
__device__ void k4_block_sum(K4Sums& s, uint32_t* part, int32_t* out) {
  __shared__ uint32_t sh[3][K4_THREADS / 32][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint32_t v[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = s[t][w][threadIdx.x];
    warp_sum8(v);
    if (lane == 0) copy8(sh[t][warp], v);
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      uint32_t v[8];
      if (lane < K4_THREADS / 32) copy8(v, sh[t][lane]); else zero8(v);
      warp_sum8(v);
      if (lane == 0) {
        if (gridDim.x == 1)
          store16(out + 16 * t, v);
        else
          copy8(part + 8 * (t * gridDim.x + blockIdx.x), v);
      }
    }
  }
}

// this block's contiguous range [e0, e1) of the pairs; its threads stride
// through it, neighbouring threads on neighbouring entries
__device__ __forceinline__ void k4_range(unsigned npairs, unsigned& e0,
                                         unsigned& e1) {
  const unsigned per = (npairs + gridDim.x - 1) / gridDim.x;
  e0 = blockIdx.x * per;
  e1 = min(e0 + per, npairs);
}

struct P1Args {
  const int32_t *tp, *tq, *tx;
  Tab B, C, D;
  int32_t* neq;         // the bound eq table of the axis (2 n_half)
  unsigned P, Q, X;     // the input tables' dims
  unsigned n_half;      // along AXIS
  const int32_t* r;
  uint32_t* part;
  int32_t* out;
};

// Phase 1: the pairs (o, i, in), i < n_half, along AXIS of (P, Q, X).
template <int AXIS, bool BIND>
__global__ void __launch_bounds__(K4_THREADS, K4_P1_MIN_BLOCKS)
    k_p1_round(P1Args a) {
  const unsigned n_in = AXIS == 0 ? a.P : (AXIS == 1 ? a.Q : a.X);
  const unsigned inner = AXIS == 0 ? a.Q * a.X : (AXIS == 1 ? a.X : 1u);
  const unsigned outer = AXIS == 0 ? 1u : (AXIS == 1 ? a.P : a.P * a.Q);
  const unsigned nh = a.n_half;
  const int32_t* eqa = AXIS == 0 ? a.tp : (AXIS == 1 ? a.tq : a.tx);
  uint32_t rr[8];
  if (BIND) load16(a.r, rr);
  __shared__ K4Sums s;
  uint32_t ln[3][8], W[8];
  k4_start(s, ln);
  zero8(W);
  unsigned key = 0xffffffffu, e0, e1;
  k4_range(outer * nh * inner, e0, e1);
  for (unsigned e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const unsigned in = e % inner, rest = e / inner;
    const unsigned i = rest % nh, o = rest / nh;
    const size_t half = (size_t)nh * inner;
    const size_t lo = ((size_t)o * n_in + i) * inner + in;
    const size_t out = ((size_t)o * 2 * nh + i) * inner + in;
    uint32_t x[3][8];
    {
      uint32_t Bl[8], Bh[8], Cl[8], Ch[8];
      tab_pair<BIND>(Bl, Bh, a.B, lo, half, out, rr, true);
      tab_pair<BIND>(Cl, Ch, a.C, lo, half, out, rr, true);
      k4_prod3(x, Bl, Bh, Cl, Ch);
    }
    {
      uint32_t Dl[8], Dh[8];
      tab_pair<BIND>(Dl, Dh, a.D, lo, half, out, rr, true);
      k4_apply3<true>(x, Dl, Dh);
    }
    {
      uint32_t el[8], eh[8];
      tab_pair<BIND>(el, eh, Tab{eqa, a.neq}, i, nh, i, rr,
                     o == 0 && in == 0);
      k4_apply3<false>(x, el, eh);
    }
    // the line o * inner + in: the eq factors of the two axes not bound
    const unsigned line = o * inner + in;
    if (line != key) {
      if (key != 0xffffffffu) k4_flush(s, ln, W);
      key = line;
      uint32_t f[8];
      if (AXIS == 2) {
        load16(a.tp + 16 * (o / a.Q), W);
        load16(a.tq + 16 * (o % a.Q), f);
      } else if (AXIS == 1) {
        load16(a.tp + 16 * o, W);
        load16(a.tx + 16 * in, f);
      } else {
        load16(a.tq + 16 * (in / a.X), W);
        load16(a.tx + 16 * (in % a.X), f);
      }
      fq_mul(W, W, f);
    }
    add3(ln, x);
  }
  if (key != 0xffffffffu) k4_flush(s, ln, W);
  k4_block_sum(s, a.part, a.out);
}

struct P2Args {
  const int32_t* ep;
  Tab A, Z;
  int32_t* nep;           // the bound eq_p table (AXIS 0)
  unsigned P, PB, Wn, Y;  // Z (P, Wn, Y), ABC (PB, Wn, Y), PB = P or 1
  unsigned n_half;
  const int32_t* r;
  uint32_t* part;
  int32_t* out;
};

// Phase 2: the pairs (o, i, in) along AXIS of Z (P, Wn, Y); ABC is bound
// along the axis unless the axis is p and ABC is shared (PB = 1); eq_p
// scales a line (AXIS 1, 2) or is bound with the pair (AXIS 0).
template <int AXIS, bool BIND>
__global__ void __launch_bounds__(K4_THREADS) k_p2_round(P2Args a) {
  const unsigned n_in = AXIS == 0 ? a.P : (AXIS == 1 ? a.Wn : a.Y);
  const unsigned inner = AXIS == 0 ? a.Wn * a.Y : (AXIS == 1 ? a.Y : 1u);
  const unsigned outer = AXIS == 0 ? 1u : (AXIS == 1 ? a.P : a.P * a.Wn);
  const unsigned nh = a.n_half;
  const bool fold_a = !(AXIS == 0 && a.PB == 1);
  uint32_t rr[8];
  if (BIND) load16(a.r, rr);
  __shared__ K4Sums s;
  uint32_t ln[3][8], W[8];
  k4_start(s, ln);
  zero8(W);
  unsigned key = 0xffffffffu, e0, e1;
  k4_range(outer * nh * inner, e0, e1);
  for (unsigned e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    const unsigned in = e % inner, rest = e / inner;
    const unsigned i = rest % nh, o = rest / nh;
    const unsigned p = AXIS == 2 ? o / a.Wn : (AXIS == 1 ? o : i);
    const size_t half = (size_t)nh * inner;
    const size_t lo = ((size_t)o * n_in + i) * inner + in;
    const size_t out = ((size_t)o * 2 * nh + i) * inner + in;
    uint32_t x[3][8];
    {
      uint32_t Al[8], Ah[8], Zl[8], Zh[8];
      if (fold_a) {
        // ABC's line: Z's, with p = 0 when one instance is shared
        const unsigned oa = a.PB > 1 ? o : (AXIS == 2 ? o % a.Wn : 0u);
        const size_t la = ((size_t)oa * n_in + i) * inner + in;
        const size_t oa_out = ((size_t)oa * 2 * nh + i) * inner + in;
        tab_pair<BIND>(Al, Ah, a.A, la, half, oa_out, rr,
                       a.PB > 1 || p == 0);
      } else {
        ld_el(Al, a.A.src + 16 * (size_t)in);
        copy8(Ah, Al);
      }
      tab_pair<BIND>(Zl, Zh, a.Z, lo, half, out, rr, true);
      k4_prod3(x, Al, Ah, Zl, Zh);
    }
    if (AXIS == 0) {  // eq_p varies along the axis: one line, factor 1
      uint32_t el[8], eh[8];
      tab_pair<BIND>(el, eh, Tab{a.ep, a.nep}, i, nh, i, rr, in == 0);
      k4_apply3<false>(x, el, eh);
      if (key != 0u) {
        key = 0u;
        const uint32_t one[8] = FQ_ONE_MONT_WORDS;
        copy8(W, one);
      }
    } else if (p != key) {
      if (key != 0xffffffffu) k4_flush(s, ln, W);
      key = p;
      load16(a.ep + 16 * p, W);
    }
    add3(ln, x);
  }
  if (key != 0xffffffffu) k4_flush(s, ln, W);
  k4_block_sum(s, a.part, a.out);
}

// K5: one q-size class. Tables (Pc, Qn, Xn), at instance offset p0 and q
// stride S of the global eq tables tp, tq, tx (read-only). axis 2 binds x,
// axis 1 binds q; inactive (axis 1 only) takes Qn = Xn = 1.
__global__ void k_pc_round(const int32_t* __restrict__ tp,
                           const int32_t* __restrict__ tq,
                           const int32_t* __restrict__ tx, Tab B, Tab C,
                           Tab D, long long Pc, long long Qn, long long Xn,
                           int axis, int active, long long n_half,
                           long long p0, long long S, int bind,
                           const int32_t* __restrict__ r,
                           uint32_t* __restrict__ part) {
  uint32_t s0[8], s2[8], s3[8];
  zero8(s0);
  zero8(s2);
  zero8(s3);
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e < Pc * Qn * Xn) {
    uint32_t rr[8];
    if (bind) load16(r, rr);
    uint32_t Bl[8], Bh[8], Cl[8], Ch[8], Dl[8], Dh[8], el[8], eh[8], W[8],
        f[8];
    bool live = true;
    if (!active) {
      // T' = T - r T = (1 - r) T; the high half of the q pair is zero
      load16(B.src + 16 * e, Bl);
      load16(C.src + 16 * e, Cl);
      load16(D.src + 16 * e, Dl);
      if (bind) {
        fq_mul(f, Bl, rr);
        fq_sub(Bl, Bl, f);
        fq_mul(f, Cl, rr);
        fq_sub(Cl, Cl, f);
        fq_mul(f, Dl, rr);
        fq_sub(Dl, Dl, f);
        store16(B.dst + 16 * e, Bl);
        store16(C.dst + 16 * e, Cl);
        store16(D.dst + 16 * e, Dl);
      }
      zero8(Bh);
      zero8(Ch);
      zero8(Dh);
      load16(tq, el);
      load16(tq + 16 * n_half, eh);
      load16(tp + 16 * (p0 + e), W);
      load16(tx, f);
    } else {
      const long long n_axis = axis == 1 ? Qn : Xn;
      const long long inner = axis == 1 ? Xn : 1;
      const long long in = e % inner, rest = e / inner;
      const long long i = rest % n_axis, o = rest / n_axis;
      const long long nhp = 2 * n_half;
      live = i < n_half;
      if (live) {
        const long long lo = (o * n_axis + i) * inner + in;
        const long long hi = lo + n_half * inner;
        const long long step = nhp * inner;
        pair_val(Bl, B.src, lo, step, bind, rr);
        pair_val(Bh, B.src, hi, step, bind, rr);
        pair_val(Cl, C.src, lo, step, bind, rr);
        pair_val(Ch, C.src, hi, step, bind, rr);
        pair_val(Dl, D.src, lo, step, bind, rr);
        pair_val(Dh, D.src, hi, step, bind, rr);
        if (bind) {
          store16(B.dst + 16 * lo, Bl);
          store16(B.dst + 16 * hi, Bh);
          store16(C.dst + 16 * lo, Cl);
          store16(C.dst + 16 * hi, Ch);
          store16(D.dst + 16 * lo, Dl);
          store16(D.dst + 16 * hi, Dh);
        }
        if (axis == 2) {  // o = p Qn + j
          load16(tx + 16 * i, el);
          load16(tx + 16 * (i + n_half), eh);
          load16(tp + 16 * (p0 + o / Qn), W);
          load16(tq + 16 * (S * (o % Qn)), f);
        } else {  // o = p
          load16(tq + 16 * (S * i), el);
          load16(tq + 16 * (S * (i + n_half)), eh);
          load16(tp + 16 * (p0 + o), W);
          load16(tx + 16 * in, f);
        }
      } else if (bind && i >= nhp) {
        const long long at = (o * n_axis + i) * inner + in;
        uint32_t z[8];
        zero8(z);
        store16(B.dst + 16 * at, z);
        store16(C.dst + 16 * at, z);
        store16(D.dst + 16 * at, z);
      }
    }
    if (live) {
      fq_mul(W, W, f);
      eval3(s0, s2, s3, el, eh, Bl, Bh, Cl, Ch, Dl, Dh);
      fq_mul(s0, s0, W);
      fq_mul(s2, s2, W);
      fq_mul(s3, s3, W);
    }
  }
  finish_block(s0, s2, s3, part);
}

static unsigned blocks(long long n) {
  return (unsigned)((n + REDUCE_THREADS - 1) / REDUCE_THREADS);
}

// K4's grid: one block per K4_THREADS pairs, at most the blocks that are
// resident at once (SMs x the kernel's blocks an SM, read once a kernel)
// and K4_MAX_BLOCKS. Returns the blocks launched (the partials).
template <typename Args>
static unsigned k4_go(void (*fn)(Args), int slot, const Args& a,
                      unsigned npairs, cudaStream_t s) {
  static int nsm = 0;
  static int occ[12] = {0};
  if (nsm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (occ[slot] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[slot], fn, K4_THREADS,
                                                  0);
    if (occ[slot] < 1) occ[slot] = 1;
  }
  unsigned nb = (npairs + K4_THREADS - 1) / K4_THREADS;
  const unsigned cap = (unsigned)(nsm * occ[slot]);
  if (nb > cap) nb = cap;
  if (nb > K4_MAX_BLOCKS) nb = K4_MAX_BLOCKS;
  if (nb < 1) nb = 1;
  fn<<<nb, K4_THREADS, 0, s>>>(a);
  return nb;
}

extern "C" {

// part: 3 * min(ceil(npairs / K4_THREADS), K4_MAX_BLOCKS) scratch values of
// 8 words; out (3, 16). With bind, nB/nC/nD/neq have 2 n_half entries along
// the axis.
int p1_round_launch(const int32_t* tp, const int32_t* tq, const int32_t* tx,
                    const int32_t* B, const int32_t* C, const int32_t* D,
                    int32_t* nB, int32_t* nC, int32_t* nD, int32_t* neq,
                    long long P, long long Q, long long X, int axis,
                    long long n_half, int bind, const int32_t* r,
                    uint32_t* part, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const P1Args a{tp, tq, tx, Tab{B, nB}, Tab{C, nC}, Tab{D, nD}, neq,
                 (unsigned)P, (unsigned)Q, (unsigned)X, (unsigned)n_half, r,
                 part, out};
  const long long dims[3] = {P, Q, X};
  const unsigned np = (unsigned)(P * Q * X / dims[axis] * n_half);
  unsigned nb = 0;
  switch (axis * 2 + (bind ? 1 : 0)) {
    case 0: nb = k4_go(k_p1_round<0, false>, 0, a, np, s); break;
    case 1: nb = k4_go(k_p1_round<0, true>, 1, a, np, s); break;
    case 2: nb = k4_go(k_p1_round<1, false>, 2, a, np, s); break;
    case 3: nb = k4_go(k_p1_round<1, true>, 3, a, np, s); break;
    case 4: nb = k4_go(k_p1_round<2, false>, 4, a, np, s); break;
    case 5: nb = k4_go(k_p1_round<2, true>, 5, a, np, s); break;
    default: return -1;
  }
  if (nb > 1) reduce_partials<<<3, REDUCE_THREADS, 0, s>>>(part, nb, out);
  return (int)cudaGetLastError();
}

// part and out as p1_round_launch's; with bind, nZ, nABC (unless the axis
// is p and ABC is shared) and nep (axis p) have 2 n_half entries along it.
int p2_round_launch(const int32_t* ep, const int32_t* ABC, const int32_t* Z,
                    int32_t* nABC, int32_t* nZ, int32_t* nep, long long P,
                    long long PB, long long Wn, long long Y, int axis,
                    long long n_half, int bind, const int32_t* r,
                    uint32_t* part, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const P2Args a{ep, Tab{ABC, nABC}, Tab{Z, nZ}, nep, (unsigned)P,
                 (unsigned)PB, (unsigned)Wn, (unsigned)Y, (unsigned)n_half, r,
                 part, out};
  const long long dims[3] = {P, Wn, Y};
  const unsigned np = (unsigned)(P * Wn * Y / dims[axis] * n_half);
  unsigned nb = 0;
  switch (axis * 2 + (bind ? 1 : 0)) {
    case 0: nb = k4_go(k_p2_round<0, false>, 6, a, np, s); break;
    case 1: nb = k4_go(k_p2_round<0, true>, 7, a, np, s); break;
    case 2: nb = k4_go(k_p2_round<1, false>, 8, a, np, s); break;
    case 3: nb = k4_go(k_p2_round<1, true>, 9, a, np, s); break;
    case 4: nb = k4_go(k_p2_round<2, false>, 10, a, np, s); break;
    case 5: nb = k4_go(k_p2_round<2, true>, 11, a, np, s); break;
    default: return -1;
  }
  if (nb > 1) reduce_partials<<<3, REDUCE_THREADS, 0, s>>>(part, nb, out);
  return (int)cudaGetLastError();
}

// part: 3 * ceil(Pc Qn Xn / 256) scratch values of 8 words; out (3, 16).
int pc_round_launch(const int32_t* tp, const int32_t* tq, const int32_t* tx,
                    const int32_t* B, const int32_t* C, const int32_t* D,
                    int32_t* nB, int32_t* nC, int32_t* nD, long long Pc,
                    long long Qn, long long Xn, int axis, int active,
                    long long n_half, long long p0, long long S, int bind,
                    const int32_t* r, uint32_t* part, int32_t* out,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = blocks(Pc * Qn * Xn);
  k_pc_round<<<nb, REDUCE_THREADS, 0, s>>>(tp, tq, tx, Tab{B, nB}, Tab{C, nC},
                                           Tab{D, nD}, Pc, Qn, Xn, axis,
                                           active, n_half, p0, S, bind, r,
                                           part);
  reduce_partials<<<3, REDUCE_THREADS, 0, s>>>(part, nb, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
