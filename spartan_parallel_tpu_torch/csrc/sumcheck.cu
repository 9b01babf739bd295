// K4 and K5: sumcheck round kernels for the two R1CS sumchecks.
//
// Replaces the JAX package's ops/sumcheck.py p1_evals / p1_step and
// p2_evals / p2_step (and, through K1's bind, p1_bind / p2_bind). Tables
// keep the JAX layout and its fixed-buffer semantics: a table never shrinks,
// n_half is half of the live length along the axis being bound, and the
// dead region beyond the live length is the field zero.
//
//   phase 1: sum over x of eq_p(p) eq_q(q) eq_x(x) (B C - D) at t = 0, 2, 3
//     for the variable being bound (axis 0 = p, 1 = q, 2 = x);
//   phase 2: sum of eq_p(p) ABC(p, w, y) Z(p, w, y) at t = 0, 2, 3
//     (axis 0 = p, 1 = w, 2 = y); ABC may hold one instance shared by all p.
//
// One thread per element of the table: thread i < n_half owns the pair
// (i, i + n_half) and adds its three evaluations; a block sums them in
// shared memory and a second kernel sums the per-block partials. With
// bind = 1 the kernel first binds the previous round's challenge r (the
// fused p1_step / p2_step of the JAX package, same axis only): the thread
// computes the bound values of its pair from the four entries it needs,
// writes them to the new tables, and threads past the previous live length
// write the dead region's zeros.
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
// Bound on the card: bytes. A round reads every live table entry once
// (64 B each) and, fused, writes the bound half; the ~20 products per pair
// are far below the card's multiply rate.
#include <cuda_runtime.h>

#include "reduce.cuh"

struct Tab {
  const int32_t* src;
  int32_t* dst;
};

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

// Phase 1. dims = (P, Q, X); eq tables tp (P), tq (Q), tx (X).
__global__ void k_p1_round(const int32_t* __restrict__ tp,
                           const int32_t* __restrict__ tq,
                           const int32_t* __restrict__ tx, Tab B, Tab C,
                           Tab D, int32_t* __restrict__ neq, long long P,
                           long long Q, long long X, int axis,
                           long long n_half, int bind,
                           const int32_t* __restrict__ r,
                           uint32_t* __restrict__ part) {
  uint32_t s0[8], s2[8], s3[8];
  zero8(s0);
  zero8(s2);
  zero8(s3);
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long dims[3] = {P, Q, X};
  const long long n_axis = dims[axis];
  const long long inner = axis == 0 ? Q * X : (axis == 1 ? X : 1);
  const int32_t* eqa = axis == 0 ? tp : (axis == 1 ? tq : tx);
  if (e < P * Q * X) {
    const long long in = e % inner, rest = e / inner;
    const long long i = rest % n_axis, o = rest / n_axis;
    const long long nhp = 2 * n_half;
    const bool owner = o == 0 && in == 0;
    if (i < n_half) {
      uint32_t rr[8];
      if (bind) load16(r, rr);
      const long long lo = (o * n_axis + i) * inner + in;
      const long long hi = lo + n_half * inner;
      const long long step = nhp * inner;
      uint32_t Bl[8], Bh[8], Cl[8], Ch[8], Dl[8], Dh[8], el[8], eh[8];
      pair_val(Bl, B.src, lo, step, bind, rr);
      pair_val(Bh, B.src, hi, step, bind, rr);
      pair_val(Cl, C.src, lo, step, bind, rr);
      pair_val(Ch, C.src, hi, step, bind, rr);
      pair_val(Dl, D.src, lo, step, bind, rr);
      pair_val(Dh, D.src, hi, step, bind, rr);
      pair_val(el, eqa, i, nhp, bind, rr);
      pair_val(eh, eqa, i + n_half, nhp, bind, rr);
      if (bind) {
        store16(B.dst + 16 * lo, Bl);
        store16(B.dst + 16 * hi, Bh);
        store16(C.dst + 16 * lo, Cl);
        store16(C.dst + 16 * hi, Ch);
        store16(D.dst + 16 * lo, Dl);
        store16(D.dst + 16 * hi, Dh);
        if (owner) {
          store16(neq + 16 * i, el);
          store16(neq + 16 * (i + n_half), eh);
        }
      }
      // product of the eq factors of the two axes not being bound
      uint32_t W[8], f[8];
      if (axis == 2) {
        load16(tp + 16 * (o / Q), W);
        load16(tq + 16 * (o % Q), f);
      } else if (axis == 1) {
        load16(tp + 16 * o, W);
        load16(tx + 16 * in, f);
      } else {
        load16(tq + 16 * (in / X), W);
        load16(tx + 16 * (in % X), f);
      }
      fq_mul(W, W, f);
      eval3(s0, s2, s3, el, eh, Bl, Bh, Cl, Ch, Dl, Dh);
      fq_mul(s0, s0, W);
      fq_mul(s2, s2, W);
      fq_mul(s3, s3, W);
    } else if (bind && i >= nhp) {
      const long long at = (o * n_axis + i) * inner + in;
      uint32_t z[8];
      zero8(z);
      store16(B.dst + 16 * at, z);
      store16(C.dst + 16 * at, z);
      store16(D.dst + 16 * at, z);
      if (owner) store16(neq + 16 * i, z);
    }
  }
  finish_block(s0, s2, s3, part);
}

// Phase 2. Z (P, W, Y), ABC (PB, W, Y) with PB == P or PB == 1, ep (P).
__global__ void k_p2_round(const int32_t* __restrict__ ep, Tab A, Tab Z,
                           int32_t* __restrict__ nep, long long P,
                           long long PB, long long Wn, long long Y, int axis,
                           long long n_half, int bind,
                           const int32_t* __restrict__ r,
                           uint32_t* __restrict__ part) {
  uint32_t s0[8], s2[8], s3[8];
  zero8(s0);
  zero8(s2);
  zero8(s3);
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long dims[3] = {P, Wn, Y};
  const long long n_axis = dims[axis];
  const long long inner = axis == 0 ? Wn * Y : (axis == 1 ? Y : 1);
  // ABC is bound along the axis unless the axis is p and ABC is shared
  const bool fold_a = !(axis == 0 && PB == 1);
  if (e < P * Wn * Y) {
    const long long in = e % inner, rest = e / inner;
    const long long i = rest % n_axis, o = rest / n_axis;
    const long long nhp = 2 * n_half;
    long long p, w, y;
    if (axis == 2) {
      p = o / Wn; w = o % Wn; y = i;
    } else if (axis == 1) {
      p = o; w = i; y = in;
    } else {
      p = i; w = in / Y; y = in % Y;
    }
    const long long pa = PB == 1 ? 0 : p;
    const bool a_owner = PB > 1 || p == 0;
    // ABC index of this thread's element; along the axis it moves like Z
    const long long a_at = (pa * Wn + w) * Y + y;
    const long long a_step = axis == 0 ? Wn * Y : (axis == 1 ? Y : 1);
    if (i < n_half) {
      uint32_t rr[8];
      if (bind) load16(r, rr);
      const long long lo = (o * n_axis + i) * inner + in;
      const long long hi = lo + n_half * inner;
      const long long step = nhp * inner;
      uint32_t Zl[8], Zh[8], Al[8], Ah[8], el[8], eh[8];
      pair_val(Zl, Z.src, lo, step, bind, rr);
      pair_val(Zh, Z.src, hi, step, bind, rr);
      if (fold_a) {
        pair_val(Al, A.src, a_at, nhp * a_step, bind, rr);
        pair_val(Ah, A.src, a_at + n_half * a_step, nhp * a_step, bind, rr);
      } else {
        load16(A.src + 16 * a_at, Al);
        copy8(Ah, Al);
      }
      if (axis == 0) {
        pair_val(el, ep, i, nhp, bind, rr);
        pair_val(eh, ep, i + n_half, nhp, bind, rr);
      } else {
        load16(ep + 16 * p, el);
        copy8(eh, el);
      }
      if (bind) {
        store16(Z.dst + 16 * lo, Zl);
        store16(Z.dst + 16 * hi, Zh);
        if (fold_a && a_owner) {
          store16(A.dst + 16 * a_at, Al);
          store16(A.dst + 16 * (a_at + n_half * a_step), Ah);
        }
        if (axis == 0 && in == 0) {
          store16(nep + 16 * i, el);
          store16(nep + 16 * (i + n_half), eh);
        }
      }
      // E * A * Z at t = 0, 2, 3: eval3 with B = A, C = Z, D = 0
      uint32_t z8[8];
      zero8(z8);
      eval3(s0, s2, s3, el, eh, Al, Ah, Zl, Zh, z8, z8);
    } else if (bind && i >= nhp) {
      const long long at = (o * n_axis + i) * inner + in;
      uint32_t z[8];
      zero8(z);
      store16(Z.dst + 16 * at, z);
      if (fold_a && a_owner) store16(A.dst + 16 * a_at, z);
      if (axis == 0 && in == 0) store16(nep + 16 * i, z);
    }
  }
  finish_block(s0, s2, s3, part);
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

extern "C" {

// part: 3 * ceil(P Q X / 256) scratch values of 8 words; out (3, 16).
int p1_round_launch(const int32_t* tp, const int32_t* tq, const int32_t* tx,
                    const int32_t* B, const int32_t* C, const int32_t* D,
                    int32_t* nB, int32_t* nC, int32_t* nD, int32_t* neq,
                    long long P, long long Q, long long X, int axis,
                    long long n_half, int bind, const int32_t* r,
                    uint32_t* part, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = blocks(P * Q * X);
  k_p1_round<<<nb, REDUCE_THREADS, 0, s>>>(tp, tq, tx, Tab{B, nB},
                                           Tab{C, nC}, Tab{D, nD}, neq, P, Q,
                                           X, axis, n_half, bind, r, part);
  reduce_partials<<<3, REDUCE_THREADS, 0, s>>>(part, nb, out);
  return (int)cudaGetLastError();
}

// part: 3 * ceil(P W Y / 256) scratch values of 8 words; out (3, 16).
int p2_round_launch(const int32_t* ep, const int32_t* ABC, const int32_t* Z,
                    int32_t* nABC, int32_t* nZ, int32_t* nep, long long P,
                    long long PB, long long Wn, long long Y, int axis,
                    long long n_half, int bind, const int32_t* r,
                    uint32_t* part, int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned nb = blocks(P * Wn * Y);
  k_p2_round<<<nb, REDUCE_THREADS, 0, s>>>(ep, Tab{ABC, nABC}, Tab{Z, nZ},
                                           nep, P, PB, Wn, Y, axis, n_half,
                                           bind, r, part);
  reduce_partials<<<3, REDUCE_THREADS, 0, s>>>(part, nb, out);
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
