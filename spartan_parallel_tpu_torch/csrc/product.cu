// K6: the grand-product circuits of SPARK on the card.
//
// Replaces the JAX package's models/product_tree.py kernels:
//   _layer_mul (:42), once a layer in ProductCircuit (:50): the layers of
//     a product tree; here k_pt_tree_pass and k_pt_tree_final build several
//     layers of a stack of B trees a launch, down to the roots;
//   _batched_cubic_evals (:102), _batched_cubic_evals_seq (:119),
//     _batched_fold (:136) and the coefficient sum of prove_cubic_batched
//     (:160-166): one round of the batched layer sumcheck is one launch of
//     k_pt_round, and a layer's last bind one launch of k_pt_bind.
//
// Layout: (rows, n, 16) int32 limb tables, the JAX layout, each stack's
// rows at a row stride (a layer of a tree stack is read in place: its
// left and right halves are the two halves of one row).
//
// k_pt_round. The product stack: Bp rows of A and B sharing one C (the eq
// table); the dot-product stack: S rows of A, B and C. Per instance k the
// round's evaluations are the sums over the pairs (i, i + n/2) of A B C at
// the points 0, 2 and 3 of the top variable, and the round needs only
// their sum weighted by the layer's coefficients, sum_k coef_k (e0, e2,
// e3)_k. With the previous round's challenge r (PT_STEP) each table is
// first bound to r into a new table of half the length (one allocation for
// all of a round's new tables); the thread that owns pair i of the new
// tables reads entries i, i + n/4, i + n/2, i + 3n/4 of the old, writes the
// two bound entries and evaluates on them. A work item is one pair of a
// group of G product rows (the shared C bound and multiplied once a group:
// sum_b (coef_b A_b) B_b, then times C) or one pair of one dot-product
// row. G is all the product rows when the round has pairs enough to fill
// the card (one C bind a pair), else 1 (more items in flight);
// chip_smoke.py's `k6_choices` line times both at a large and a small
// round. The grid is the blocks resident at once, each on a contiguous
// range of the flat index (group, pair), so no grid.y limit; the blocks
// split between the two stacks in proportion to their field products,
// since an item of G rows outweighs a dot-product row's. The blocks' sums
// go to partials and the last block to finish (a ticket taken with
// atomicInc after __threadfence, which wraps it back to 0) sums them into
// the (3, 16) output. k_pt_bind binds a layer's last challenge (tables of
// 2 entries): the new tables' single entries are the layer's claims.
//
// k_pt_tree_pass: entry j of layer k + m of a tree is the product of
// entries j + t n/2^m (t < 2^m) of layer k (n entries). A thread owns one
// j: it reads those 2^m entries (neighbouring threads on neighbouring j,
// so every access is contiguous across a warp), forms the product tree
// over t depth-first (m values live) and writes every node, i.e. the
// entries j + u n/2^m of each of the m layers. k_pt_tree_final takes a
// layer of at most 2 PT_FIN entries, a block a tree, down to the root in
// shared memory, writing every layer on the way.
//
// Bound on the card: bytes. A bind round reads each live table entry once
// and writes half as many (64 B an entry) and does 6 products a new pair
// for the evaluations and one a bound entry; a tree reads its leaves once
// and writes every layer once, one product a written entry. Both sit
// below the card's multiply rate at those bytes.
#include <cuda_runtime.h>

#include "tables.cuh"

#define PT_THREADS 128
// at most this many blocks (partials) a launch; ops/product.py sizes the
// scratch from it
#define PT_MAX_BLOCKS 2048
#define PT_MIN_BLOCKS 4
#define PT_TREE_THREADS 128
// entries of one layer a block of k_pt_tree_final keeps in shared memory
#define PT_FIN 1024
#define PT_FIN_THREADS 256

struct PtArgs {
  const int32_t *A, *B, *C;         // product stack (C shared, n entries)
  const int32_t *Aq, *Bq, *Cq;      // dot-product stack
  long long sa, sb, saq, sbq, scq;  // row strides, in entries
  unsigned Bp, S, G;                // rows; product rows a work item takes
  unsigned len;                     // live length of the tables read
  unsigned nbp;                     // blocks on the product stack's items
  const int32_t* r;
  const int32_t* coef;              // (Bp + S, 16)
  // new tables: A (Bp rows), B (Bp), C, Aq (S), Bq (S), Cq (S), each row of
  // the new length
  int32_t* nt;
  uint32_t* part;  // 3 x 8 words a block
  int32_t* out;    // (3, 16)
};

// blocks of the running k_pt_round launch that have written their partial
// (one launch at a time on a device: the port's rounds are sequential)
__device__ unsigned pt_ticket;

// a thread's running sums at t = 0, 2, 3 (word-major, thread-minor)
typedef uint32_t PtSums[3][8][PT_THREADS];

// y[t] += A_t B_t at t = 0, 2, 3 of the pairs (Al, Ah), (Bl, Bh)
__device__ __forceinline__ void pt_prod3_acc(uint32_t (*y)[8],
                                             const uint32_t* Al,
                                             const uint32_t* Ah,
                                             const uint32_t* Bl,
                                             const uint32_t* Bh) {
  uint32_t a[8], b[8], x[8];
  fq_mul(x, Al, Bl);
  fq_add(y[0], y[0], x);
  fq_ext2(a, Al, Ah);
  fq_ext2(b, Bl, Bh);
  fq_mul(x, a, b);
  fq_add(y[1], y[1], x);
  fq_ext3(a, a, Al, Ah);
  fq_ext3(b, b, Bl, Bh);
  fq_mul(x, a, b);
  fq_add(y[2], y[2], x);
}

// s[t] += y[t] C_t at t = 0, 2, 3 of the pair (Cl, Ch)
__device__ __forceinline__ void pt_times_c(PtSums& s, uint32_t (*y)[8],
                                           const uint32_t* Cl,
                                           const uint32_t* Ch) {
  uint32_t c[8], v[8];
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    if (t == 0) copy8(c, Cl);
    else if (t == 1) fq_ext2(c, Cl, Ch);
    else fq_ext3(c, c, Cl, Ch);
    fq_mul(y[t], y[t], c);
#pragma unroll
    for (int w = 0; w < 8; ++w) v[w] = s[t][w][threadIdx.x];
    fq_add(v, v, y[t]);
#pragma unroll
    for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = v[w];
  }
}

// the block's sums s[t] into tot[t] of thread 0
__device__ void pt_block_total(PtSums& s, uint32_t (*tot)[8]) {
  __shared__ uint32_t sh[3][PT_THREADS / 32][8];
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
      if (lane < PT_THREADS / 32) copy8(v, sh[t][lane]); else zero8(v);
      warp_sum8(v);
      if (lane == 0) copy8(tot[t], v);
    }
  }
  __syncthreads();
}

// the launch's sum into out: from a grid of one block directly; else each
// block writes its partial and the last block to take a ticket sums them
__device__ void pt_finish(PtSums& s, uint32_t* part, int32_t* out) {
  __shared__ bool last;
  uint32_t tot[3][8];
  pt_block_total(s, tot);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0)
      for (int t = 0; t < 3; ++t) store16(out + 16 * t, tot[t]);
    return;
  }
  if (threadIdx.x == 0) {
    for (int t = 0; t < 3; ++t) copy8(part + 8 * (3 * blockIdx.x + t), tot[t]);
    __threadfence();
    last = atomicInc(&pt_ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    uint32_t v[8];
    zero8(v);
    for (unsigned j = threadIdx.x; j < gridDim.x; j += PT_THREADS) {
      const uint4* p = reinterpret_cast<const uint4*>(part + 8 * (3 * j + t));
      const uint4 lo = __ldcg(p), hi = __ldcg(p + 1);
      const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      fq_add(v, v, x);
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = v[w];
  }
  pt_block_total(s, tot);
  if (threadIdx.x == 0)
    for (int t = 0; t < 3; ++t) store16(out + 16 * t, tot[t]);
}

// One round: with BIND the tables are bound to r first (len -> len / 2).
template <bool BIND>
__global__ void __launch_bounds__(PT_THREADS, PT_MIN_BLOCKS)
    k_pt_round(PtArgs a) {
  const unsigned M = BIND ? a.len / 2 : a.len;  // the length evaluated
  const unsigned P = M / 2;                     // pairs a row
  const unsigned ng = (a.Bp + a.G - 1) / a.G;
  const unsigned items = (ng + a.S) * P;
  const size_t Mz = M;
  __shared__ uint32_t rr[8];
  __shared__ PtSums s;
  if (BIND && threadIdx.x == 0) load16(a.r, rr);
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int w = 0; w < 8; ++w) s[t][w][threadIdx.x] = 0;
  __syncthreads();
  // the first nbp blocks share the product stack's items, the others the
  // dot-product stack's (an item of G product rows weighs more than one
  // of a dot-product row); one block takes every item
  unsigned lo = 0, hi = items, nb = gridDim.x, blk = blockIdx.x;
  if (nb > 1 && a.S) {
    if (blk < a.nbp) {
      hi = ng * P;
      nb = a.nbp;
    } else {
      lo = ng * P;
      nb -= a.nbp;
      blk -= a.nbp;
    }
  }
  const unsigned per = (hi - lo + nb - 1) / nb;
  const unsigned e0 = lo + blk * per, e1 = min(e0 + per, hi);
  for (unsigned e = e0 + threadIdx.x; e < e1; e += PT_THREADS) {
    const unsigned g = e / P, i = e % P;
    uint32_t y[3][8], Cl[8], Ch[8], co[8];
#pragma unroll
    for (int t = 0; t < 3; ++t) zero8(y[t]);
    if (g < ng) {
      tab_pair<BIND>(Cl, Ch, Tab{a.C, a.nt + 16 * (2 * (size_t)a.Bp) * Mz},
                     i, P, i, rr, g == 0);
      const unsigned b1 = min((g + 1) * a.G, a.Bp);
      for (unsigned b = g * a.G; b < b1; ++b) {
        uint32_t Al[8], Ah[8], Bl[8], Bh[8];
        tab_pair<BIND>(Al, Ah,
                       Tab{a.A + 16 * (size_t)b * a.sa, a.nt + 16 * b * Mz},
                       i, P, i, rr, true);
        tab_pair<BIND>(Bl, Bh,
                       Tab{a.B + 16 * (size_t)b * a.sb,
                           a.nt + 16 * (a.Bp + (size_t)b) * Mz},
                       i, P, i, rr, true);
        // coef_b A_b, from the scaled pair (A is linear in it)
        load16(a.coef + 16 * (size_t)b, co);
        fq_mul(Al, Al, co);
        fq_mul(Ah, Ah, co);
        pt_prod3_acc(y, Al, Ah, Bl, Bh);
      }
    } else {
      const unsigned q = g - ng;
      const size_t base = 2 * (size_t)a.Bp + 1;
      uint32_t Al[8], Ah[8], Bl[8], Bh[8];
      tab_pair<BIND>(Cl, Ch,
                     Tab{a.Cq + 16 * (size_t)q * a.scq,
                         a.nt + 16 * (base + 2 * (size_t)a.S + q) * Mz},
                     i, P, i, rr, true);
      tab_pair<BIND>(Al, Ah,
                     Tab{a.Aq + 16 * (size_t)q * a.saq,
                         a.nt + 16 * (base + q) * Mz},
                     i, P, i, rr, true);
      tab_pair<BIND>(Bl, Bh,
                     Tab{a.Bq + 16 * (size_t)q * a.sbq,
                         a.nt + 16 * (base + a.S + (size_t)q) * Mz},
                     i, P, i, rr, true);
      load16(a.coef + 16 * ((size_t)a.Bp + q), co);
      fq_mul(Al, Al, co);
      fq_mul(Ah, Ah, co);
      pt_prod3_acc(y, Al, Ah, Bl, Bh);
    }
    pt_times_c(s, y, Cl, Ch);
  }
  pt_finish(s, a.part, a.out);
}

// A layer's last bind: every table of 2 entries to 1 (thread t: table t of
// A, B, C, Aq, Bq, Cq in the order of nt).
__global__ void k_pt_bind(PtArgs a) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned Bp = a.Bp, S = a.S;
  if (t >= 2 * Bp + 1 + 3 * S) return;
  const int32_t* T;
  if (t < Bp) {
    T = a.A + 16 * (size_t)t * a.sa;
  } else if (t < 2 * Bp) {
    T = a.B + 16 * (size_t)(t - Bp) * a.sb;
  } else if (t == 2 * Bp) {
    T = a.C;
  } else {
    const unsigned q = t - 2 * Bp - 1;
    if (q < S) T = a.Aq + 16 * (size_t)q * a.saq;
    else if (q < 2 * S) T = a.Bq + 16 * (size_t)(q - S) * a.sbq;
    else T = a.Cq + 16 * (size_t)(q - 2 * S) * a.scq;
  }
  uint32_t rr[8], v[8];
  load16(a.r, rr);
  tab_val<true>(v, T, 0, 1, rr);
  st_el(a.nt + 16 * (size_t)t, v);
}

// ---------------------------------------------------------------------------
// The product trees
// ---------------------------------------------------------------------------
struct TreeArgs {
  const int32_t* src;  // layer k: B rows of n
  // layer k + 1 (B rows of n / 2), then k + 2 (n / 4), ... back to back
  int32_t* dst;
  unsigned B, n;
};

// v = entry j + u stride of layer k + L of row b (the product of entries
// j + (u + v 2^(m-L)) stride of layer k, v < 2^L), every node of levels
// 1..L written on the way
template <int L>
__device__ __forceinline__ void pt_node(uint32_t* v, const TreeArgs& a,
                                        size_t b, unsigned j, unsigned u,
                                        unsigned stride, int m) {
  if constexpr (L == 0) {
    ld_el(v, a.src + 16 * (b * a.n + j + (size_t)u * stride));
  } else {
    uint32_t w[8];
    pt_node<L - 1>(v, a, b, j, u, stride, m);
    pt_node<L - 1>(w, a, b, j, u + (1u << (m - L)), stride, m);
    fq_mul(v, v, w);
    // layer k + L: n / 2^L entries a row, after the B rows of each of the
    // layers k + 1 .. k + L - 1
    const size_t len = a.n >> L;
    const size_t off = (size_t)a.B * (a.n - (a.n >> (L - 1)));
    st_el(a.dst + 16 * (off + b * len + j + (size_t)u * stride), v);
  }
}

// layers k + 1 .. k + M of B trees from layer k
template <int M>
__global__ void __launch_bounds__(PT_TREE_THREADS) k_pt_tree_pass(TreeArgs a) {
  const unsigned stride = a.n >> M;
  const size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (e >= (size_t)a.B * stride) return;
  uint32_t v[8];
  pt_node<M>(v, a, e / stride, (unsigned)(e % stride), 0, stride, M);
}

// every layer from layer k (n <= 2 PT_FIN entries) down to the root, a
// block a tree
__global__ void __launch_bounds__(PT_FIN_THREADS) k_pt_tree_final(TreeArgs a) {
  __shared__ uint32_t sm[8][PT_FIN];
  const size_t b = blockIdx.x;
  unsigned len = a.n / 2;
  size_t off = 0;
  for (unsigned j = threadIdx.x; j < len; j += blockDim.x) {
    uint32_t x[8], y[8];
    ld_el(x, a.src + 16 * (b * a.n + j));
    ld_el(y, a.src + 16 * (b * a.n + j + len));
    fq_mul(x, x, y);
    st_el(a.dst + 16 * (off + b * len + j), x);
#pragma unroll
    for (int w = 0; w < 8; ++w) sm[w][j] = x[w];
  }
  __syncthreads();
  while (len > 1) {
    off += (size_t)a.B * len;
    const unsigned h = len / 2;
    for (unsigned j = threadIdx.x; j < h; j += blockDim.x) {
      uint32_t x[8], y[8];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        x[w] = sm[w][j];
        y[w] = sm[w][j + h];
      }
      fq_mul(x, x, y);
      st_el(a.dst + 16 * (off + b * h + j), x);
#pragma unroll
      for (int w = 0; w < 8; ++w) sm[w][j] = x[w];
    }
    __syncthreads();
    len = h;
  }
}

// the round kernel's grid: one block per PT_THREADS items, at most the
// blocks resident at once and PT_MAX_BLOCKS
template <bool BIND>
static unsigned pt_blocks(unsigned items) {
  static int nsm = 0, occ = 0;
  if (nsm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k_pt_round<BIND>,
                                                  PT_THREADS, 0);
    if (occ < 1) occ = 1;
  }
  unsigned nb = (items + PT_THREADS - 1) / PT_THREADS;
  const unsigned cap = (unsigned)(nsm * occ);
  if (nb > cap) nb = cap;
  if (nb > PT_MAX_BLOCKS) nb = PT_MAX_BLOCKS;
  return nb < 1 ? 1 : nb;
}

extern "C" {

// mode 0: the evaluations of tables of len entries; 1: bind to r (len ->
// len / 2, len >= 4), then evaluate; 2: bind to r only (len = 2), nt gets
// the 2 Bp + 1 + 3 S claims. part: 24 words a block (ops/product.py sizes
// it); out (3, 16).
int pt_round_launch(const int32_t* A, const int32_t* B, const int32_t* C,
                    long long sa, long long sb, const int32_t* Aq,
                    const int32_t* Bq, const int32_t* Cq, long long saq,
                    long long sbq, long long scq, long long Bp, long long S,
                    long long G, long long len, int mode, const int32_t* r,
                    const int32_t* coef, int32_t* nt, uint32_t* part,
                    int32_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  PtArgs a{A, B, C, Aq, Bq, Cq, sa, sb, saq, sbq, scq,
           (unsigned)Bp, (unsigned)S, (unsigned)G, (unsigned)len, 0, r,
           coef, nt, part, out};
  const long long P = mode == 1 ? len / 4 : len / 2;
  const long long ng = (Bp + G - 1) / G;
  const unsigned items = (unsigned)((ng + S) * P);
  if (mode == 0 || mode == 1) {
    const unsigned nb = mode ? pt_blocks<true>(items)
                             : pt_blocks<false>(items);
    // the blocks split by the two stacks' field products: a product row
    // 9 a pair (5 with no bind), a group 5 more (its C), a dot-product
    // row 14 (8)
    const double wp = (double)ng * ((double)G * (mode ? 9 : 5) + 5);
    const double wq = (double)S * (mode ? 14 : 8);
    long long nbp = (long long)(nb * wp / (wp + wq) + 0.5);
    a.nbp = (unsigned)(nbp < 1 ? 1 : (nbp >= nb ? nb - 1 : nbp));
    if (mode)
      k_pt_round<true><<<nb, PT_THREADS, 0, s>>>(a);
    else
      k_pt_round<false><<<nb, PT_THREADS, 0, s>>>(a);
  } else if (mode == 2) {
    const unsigned n = (unsigned)(2 * Bp + 1 + 3 * S);
    k_pt_bind<<<(n + 127) / 128, 128, 0, s>>>(a);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

// layers k + 1 .. k + m (1 <= m <= 4) of B trees from layer k (src, n
// entries a row) into dst.
int pt_tree_pass_launch(const int32_t* src, int32_t* dst, long long B,
                        long long n, int m, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const TreeArgs a{src, dst, (unsigned)B, (unsigned)n};
  const long long items = B * (n >> m);
  const unsigned nb = (unsigned)((items + PT_TREE_THREADS - 1) /
                                 PT_TREE_THREADS);
  switch (m) {
    case 1: k_pt_tree_pass<1><<<nb, PT_TREE_THREADS, 0, s>>>(a); break;
    case 2: k_pt_tree_pass<2><<<nb, PT_TREE_THREADS, 0, s>>>(a); break;
    case 3: k_pt_tree_pass<3><<<nb, PT_TREE_THREADS, 0, s>>>(a); break;
    case 4: k_pt_tree_pass<4><<<nb, PT_TREE_THREADS, 0, s>>>(a); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// every layer from layer k (src, 2 <= n <= 2 PT_FIN entries a row) to the
// roots into dst.
int pt_tree_final_launch(const int32_t* src, int32_t* dst, long long B,
                         long long n, void* stream) {
  const TreeArgs a{src, dst, (unsigned)B, (unsigned)n};
  unsigned threads = (unsigned)(n / 2);
  if (threads < 32) threads = 32;
  if (threads > PT_FIN_THREADS) threads = PT_FIN_THREADS;
  k_pt_tree_final<<<(unsigned)B, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
