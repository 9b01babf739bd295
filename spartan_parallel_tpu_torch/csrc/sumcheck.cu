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
// pc_evals / pc_step: a round of every q-size class of instances in one
// launch. Class c's (P_c, Q_c, X) tables sit at p offset p0 and q stride S
// of the shared eq tables, which it only reads (eq_fold binds them once a
// round for every class, one K1 launch). The launch takes a descriptor a
// class (its tables, strides, p0, S, n_half, the previous round's bind)
// in its parameters; the classes' blocks split the resident grid in
// proportion to their live pairs, each block on a contiguous range of one
// class's pairs, and the last block to take a ticket sums each class's
// partials into its row of the (classes, 3, 16) evaluations. As in K4 the
// grid and the bytes follow the live pairs and the dead region is not
// written: a bind (the previous round's challenge) writes new tables of
// the live length. The bind of each class is the one its previous round
// asks for: along the same axis (x, or q while the class is active), the
// axis change x -> q (each new entry from two x entries), the class's last
// q variable at its change of activity, or, inactive, the (1 - r) scale.
// An active round pairs entries i and i + n_half along x or q; an
// inactive q round (the class bound on q, one live entry per instance)
// evaluates with eq_q = (tq[0], tq[n_half]) and a zero high half.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tables.cuh"

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

// the block's three sums into tot (thread 0's)
__device__ void k4_block_total(K4Sums& s, uint32_t (*tot)[8]) {
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
      if (lane == 0) copy8(tot[t], v);
    }
  }
}

// the block's three sums into part[t * gridDim.x + blockIdx.x], or, from a
// grid of one block, into out (3, 16 limbs) with no second pass
__device__ void k4_block_sum(K4Sums& s, uint32_t* part, int32_t* out) {
  uint32_t tot[3][8];
  k4_block_total(s, tot);
  if (threadIdx.x == 0) {
    for (int t = 0; t < 3; ++t) {
      if (gridDim.x == 1)
        store16(out + 16 * t, tot[t]);
      else
        copy8(part + 8 * (t * gridDim.x + blockIdx.x), tot[t]);
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

// ---------------------------------------------------------------------------
// K5: every class of a classed phase-1 round in one launch
// ---------------------------------------------------------------------------
#define PC_MAX_CLASSES 16
// blocks of k_pc_round an SM its register cap is set for: K4 phase 1's 4
// (of 2 to 8 tried, none ran K5's rows faster)
#define PC_MIN_BLOCKS K4_P1_MIN_BLOCKS
// values of one class descriptor from the host (pc_round_launch)
#define PC_DESC 18

struct PcClass {
  const int32_t *B, *C, *D;  // the tables read, through (sp, sq, sx)
  int32_t *nB, *nC, *nD;     // with a bind: the new (Pc, Qn, Xn) tables
  long long sp, sq, sx;
  unsigned Pc, Qn, Xn;  // the dims evaluated (the new tables' with a bind)
  unsigned p0, S;
  unsigned nh;  // active: pairs (i, i + nh); inactive: eq_q's high entry
  unsigned h;   // the bind pairs entry i with i + h along its axis
  int bax;      // bind: 0 none, 1 q, 2 x, 3 the (1 - r) scale
  int active;
  unsigned blk0, nblk, npairs;
};

struct PcArgs {
  const int32_t *tp, *tq, *tx;
  const int32_t* r;
  uint32_t* part;  // 3 x 8 words a block
  int32_t* out;    // (n, 3, 16)
  int n;
  PcClass c[PC_MAX_CLASSES];
};

// blocks of the running k_pc_round launch that have written their partial
// (one launch at a time on a device: the rounds are sequential)
__device__ unsigned pc_ticket;

// entry (p, j, k) of the table evaluated: T's entry, or with a bind the
// bound value of T's entries (p, j, k) and (p, j, k) + h along the bind's
// axis (zero for the scale), stored to the new table. An x round's bind
// is along x; a q round's is the class's own (q, x or the scale).
template <int AXIS, bool BIND>
__device__ __forceinline__ void pc_val(uint32_t* v, const PcClass& c,
                                       const int32_t* T, int32_t* nT,
                                       unsigned p, unsigned j, unsigned k,
                                       const uint32_t* r) {
  const size_t at = p * c.sp + j * c.sq + k * c.sx;
  ld_el(v, T + 16 * at);
  if (BIND) {
    uint32_t hi[8];
    if (AXIS == 1 && c.bax == 3)
      zero8(hi);
    else
      ld_el(hi, T + 16 * (at + c.h * (AXIS == 1 && c.bax == 1 ? c.sq
                                                                : c.sx)));
    fq_bind(v, v, hi, r);
    st_el(nT + 16 * (((size_t)p * c.Qn + j) * c.Xn + k), v);
  }
}

// A classed round along AXIS (2 x, 1 q), every class bound first with
// BIND: the block's class, its range of the class's pairs, their
// evaluations summed a line at a time as in K4.
template <int AXIS, bool BIND>
__global__ void __launch_bounds__(K4_THREADS, PC_MIN_BLOCKS)
    k_pc_round(const __grid_constant__ PcArgs a) {
  int ci = 0;
  while (ci + 1 < a.n && blockIdx.x >= a.c[ci + 1].blk0) ++ci;
  const PcClass& c = a.c[ci];
  uint32_t rr[8];
  if (BIND) load16(a.r, rr);
  __shared__ K4Sums s;
  uint32_t ln[3][8], W[8];
  k4_start(s, ln);
  zero8(W);
  unsigned key = 0xffffffffu;
  const unsigned per = (c.npairs + c.nblk - 1) / c.nblk;
  const unsigned e0 = (blockIdx.x - c.blk0) * per;
  const unsigned e1 = min(e0 + per, c.npairs);
  for (unsigned e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    uint32_t x[3][8], el[8], eh[8];
    unsigned p, line;
    const int32_t* fac;  // the line's second eq factor (tp's is p's)
    {
      uint32_t Bl[8], Bh[8], Cl[8], Ch[8];
      uint32_t Dl[8], Dh[8];
      if (AXIS == 1 && !c.active) {
        p = e;
        line = p;
        pc_val<AXIS, BIND>(Bl, c, c.B, c.nB, p, 0, 0, rr);
        pc_val<AXIS, BIND>(Cl, c, c.C, c.nC, p, 0, 0, rr);
        pc_val<AXIS, BIND>(Dl, c, c.D, c.nD, p, 0, 0, rr);
        zero8(Bh);
        zero8(Ch);
        zero8(Dh);
        load16(a.tq, el);
        load16(a.tq + 16 * (size_t)c.nh, eh);
        fac = a.tx;
      } else if (AXIS == 2) {
        const unsigned i = e % c.nh, o = e / c.nh, j = o % c.Qn;
        p = o / c.Qn;
        line = o;
        pc_val<AXIS, BIND>(Bl, c, c.B, c.nB, p, j, i, rr);
        pc_val<AXIS, BIND>(Bh, c, c.B, c.nB, p, j, i + c.nh, rr);
        pc_val<AXIS, BIND>(Cl, c, c.C, c.nC, p, j, i, rr);
        pc_val<AXIS, BIND>(Ch, c, c.C, c.nC, p, j, i + c.nh, rr);
        pc_val<AXIS, BIND>(Dl, c, c.D, c.nD, p, j, i, rr);
        pc_val<AXIS, BIND>(Dh, c, c.D, c.nD, p, j, i + c.nh, rr);
        ld_el(el, a.tx + 16 * (size_t)i);
        ld_el(eh, a.tx + 16 * (size_t)(i + c.nh));
        fac = a.tq + 16 * (size_t)c.S * j;
      } else {
        const unsigned k = e % c.Xn, rest = e / c.Xn, i = rest % c.nh;
        p = rest / c.nh;
        line = p * c.Xn + k;
        pc_val<AXIS, BIND>(Bl, c, c.B, c.nB, p, i, k, rr);
        pc_val<AXIS, BIND>(Bh, c, c.B, c.nB, p, i + c.nh, k, rr);
        pc_val<AXIS, BIND>(Cl, c, c.C, c.nC, p, i, k, rr);
        pc_val<AXIS, BIND>(Ch, c, c.C, c.nC, p, i + c.nh, k, rr);
        pc_val<AXIS, BIND>(Dl, c, c.D, c.nD, p, i, k, rr);
        pc_val<AXIS, BIND>(Dh, c, c.D, c.nD, p, i + c.nh, k, rr);
        ld_el(el, a.tq + 16 * (size_t)c.S * i);
        ld_el(eh, a.tq + 16 * (size_t)c.S * (i + c.nh));
        fac = a.tx + 16 * (size_t)k;
      }
      k4_prod3(x, Bl, Bh, Cl, Ch);
      k4_apply3<true>(x, Dl, Dh);
    }
    k4_apply3<false>(x, el, eh);
    if (line != key) {
      if (key != 0xffffffffu) k4_flush(s, ln, W);
      key = line;
      uint32_t f[8];
      load16(a.tp + 16 * (size_t)(c.p0 + p), W);
      load16(fac, f);
      fq_mul(W, W, f);
    }
    add3(ln, x);
  }
  if (key != 0xffffffffu) k4_flush(s, ln, W);
  __shared__ bool last;
  uint32_t tot[3][8];
  k4_block_total(s, tot);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0)
      for (int t = 0; t < 3; ++t) store16(a.out + 16 * t, tot[t]);
    return;
  }
  if (threadIdx.x == 0) {
    for (int t = 0; t < 3; ++t)
      copy8(a.part + 8 * (3 * blockIdx.x + t), tot[t]);
    __threadfence();
    last = atomicInc(&pc_ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // each class's partials, all threads over its blocks
  for (int q = 0; q < a.n; ++q) {
    const unsigned b0 = a.c[q].blk0, nb = a.c[q].nblk;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      uint32_t v[8];
      zero8(v);
      for (unsigned u = threadIdx.x; u < nb; u += K4_THREADS) {
        const uint4* pp =
            reinterpret_cast<const uint4*>(a.part + 8 * (3 * (b0 + u) + t));
        const uint4 lo = __ldcg(pp), hi = __ldcg(pp + 1);
        const uint32_t y[8] = {lo.x, lo.y, lo.z, lo.w,
                               hi.x, hi.y, hi.z, hi.w};
        fq_add(v, v, y);
      }
#pragma unroll
      for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = v[w];
    }
    __syncthreads();
    k4_block_total(s, tot);
    if (threadIdx.x == 0)
      for (int t = 0; t < 3; ++t) store16(a.out + 16 * (3 * q + t), tot[t]);
    __syncthreads();
  }
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

// desc: n x PC_DESC values a class (PcHost order): the tables read and
// the new ones, the read strides, the evaluated dims, p0, S, n_half, the
// bind's offset and kind, active. out (n, 3, 16); part: 3 x 8 words for
// each of at most K4_MAX_BLOCKS + n blocks. axis: 2 x, 1 q.
int pc_round_launch(const int32_t* tp, const int32_t* tq, const int32_t* tx,
                    const int32_t* r, const long long* desc, int n, int axis,
                    uint32_t* part, int32_t* out, void* stream) {
  if (n < 1 || n > PC_MAX_CLASSES || (axis != 1 && axis != 2)) return -1;
  PcArgs a{};
  a.tp = tp;
  a.tq = tq;
  a.tx = tx;
  a.r = r;
  a.part = part;
  a.out = out;
  a.n = n;
  unsigned long long total = 0;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + PC_DESC * i;
    PcClass& c = a.c[i];
    c.B = (const int32_t*)d[0];
    c.C = (const int32_t*)d[1];
    c.D = (const int32_t*)d[2];
    c.nB = (int32_t*)d[3];
    c.nC = (int32_t*)d[4];
    c.nD = (int32_t*)d[5];
    c.sp = d[6];
    c.sq = d[7];
    c.sx = d[8];
    c.Pc = (unsigned)d[9];
    c.Qn = (unsigned)d[10];
    c.Xn = (unsigned)d[11];
    c.p0 = (unsigned)d[12];
    c.S = (unsigned)d[13];
    c.nh = (unsigned)d[14];
    c.h = (unsigned)d[15];
    c.bax = (int)d[16];
    c.active = (int)d[17];
    if ((c.bax != 0) != (a.c[0].bax != 0) || (axis == 2 && c.bax > 2) ||
        (axis == 2 && !c.active))
      return -1;
    const unsigned long long np =
        !c.active ? c.Pc
                  : (unsigned long long)c.Pc * c.nh * (axis == 2 ? c.Qn : c.Xn);
    if (np < 1 || np >= (1ull << 31)) return -1;
    c.npairs = (unsigned)np;
    total += np;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const bool bind = a.c[0].bax != 0;
  void (*fn)(const PcArgs) =
      axis == 2 ? (bind ? k_pc_round<2, true> : k_pc_round<2, false>)
                : (bind ? k_pc_round<1, true> : k_pc_round<1, false>);
  static int nsm = 0, occ[4] = {0, 0, 0, 0};
  if (nsm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  }
  int& o = occ[2 * (axis - 1) + (bind ? 1 : 0)];
  if (o == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o, fn, K4_THREADS, 0);
    if (o < 1) o = 1;
  }
  unsigned long long nb = (total + K4_THREADS - 1) / K4_THREADS;
  if (nb > (unsigned long long)nsm * o) nb = (unsigned long long)nsm * o;
  if (nb > K4_MAX_BLOCKS) nb = K4_MAX_BLOCKS;
  unsigned blk = 0;
  for (int i = 0; i < n; ++i) {
    PcClass& c = a.c[i];
    unsigned long long want = nb * c.npairs / total;
    const unsigned long long most = (c.npairs + K4_THREADS - 1) / K4_THREADS;
    if (want > most) want = most;
    c.blk0 = blk;
    c.nblk = want < 1 ? 1u : (unsigned)want;
    blk += c.nblk;
  }
  fn<<<blk, K4_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
