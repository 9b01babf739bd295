// K1: scalar-field tensors mod l on the card.
//
// Replaces the JAX package's ops/fq.py (mul/_redc_impl, add, sub, dot,
// sum_reduce) and the limb primitives of ops/limbs.py, plus the binds of
// models/dense_mlpoly.py (_bound_top, _bound_bot), ops/sumcheck.py
// (fold_chain, p1_bind, p2_bind) and the L*Z contraction (_bound_L, _dot_dev),
// the eq table of models/dense_mlpoly.py _eq_evals_dev (k_eq_evals), the
// per-polynomial evaluations of models/sparse_mlpoly.py (p.evaluate over
// one eq table, :364-387: k_dot over a list of tables) and SPARK's hash
// layer (models/sparse_mlpoly.py :289-293, k_hash).
//
// Bound on the card: bytes. The elementwise ops, the bind and the hash move
// 64 B per operand per element and do one to two Montgomery products (64
// 32x32-bit multiply-adds for the product, 64 for the reduction), below
// the card's multiply rate at those bytes. A warp moves its 32 elements
// through shared memory (tables.cuh warp_ld_el / warp_st_el), so every
// global access is 16 bytes a lane with neighbouring lanes on neighbouring
// addresses; the first design read a thread's element as 16 4-byte words,
// 64 bytes apart across a warp. The elementwise kernels, the bind and the
// hash launch at most the blocks resident at once, each warp striding over
// chunks of 32 elements (on an H100 a few percent faster than one element
// a thread for the product and the bind: PERF.md, K1's design).
//
// dot is one launch: a block sums a chunk of the reduced axis of one
// output (chunks of 256 to 4096 terms, as many as fill the card), and the
// last block of the output to take a ticket (atomicInc
// after __threadfence, which wraps the ticket back to 0) sums the output's
// partials. The same kernel takes a list of equal-length tables against one
// eq table (fq_dot_many: one output a table, the table pointers passed by
// value in the launch's parameters), so the evaluations of a list of
// polynomials are one launch.
//
// The hash layer h = ts r^2 + val r + addr - rm is one pass over operands
// that broadcast (each with its own strides); it can also write the
// write-timestamp hash h + r^2 = hash(addr, val, ts + 1) from the same read.
//
// The eq table (k_eq_evals, csrc/eq.cuh) is one launch for any ell >= 1:
// the JAX package builds it by doubling and, above 2^13 entries, as the
// product of two half tables (XLA's (8,128) tile ran the TPU out of HBM on
// the straight build), two elementwise passes a variable. Here a block
// owns a chunk of 2^k consecutive entries: warp 0 forms the chunk's high
// factor by a product tree over its lanes (one factor a lane, log2(ell -
// k) products deep), the block doubles it in shared memory through the k
// low variables (one product an entry, k levels deep) and stores the
// chunk 16 bytes a thread, neighbouring threads on neighbouring
// addresses. Bound: the bytes written, 64 an entry.
//
// Layout: a field element is 16 int32 lanes of 16-bit limbs (the JAX
// layout); the kernels pack to 8 x 32-bit words in registers.
#include <cuda_runtime.h>

#include "eq.cuh"
#include "reduce.cuh"
#include "tables.cuh"

// the reduced axis of a dot splits into chunks of at most this many terms,
// a block a chunk (ops/fq.py picks the chunk so that the grid covers the
// card)
#define DOT_CHUNK 4096
#define K1_THREADS 128
#define K1_WARPS (K1_THREADS / 32)
// tables a fq_dot_many launch takes (their pointers are launch parameters)
#define DOT_MANY_MAX 256
// outputs of one dot launch whose partials a ticket can sum
#define DOT_TICKETS 65536

// the launch's chunks of 32 elements, one a warp at a time
#define FOR_WARP_CHUNKS(c, n)                                               \
  for (long long c = (long long)blockIdx.x * K1_WARPS + (threadIdx.x >> 5); \
       (c) * 32 < (n); c += (long long)gridDim.x * K1_WARPS)

template <int OP>
__global__ void __launch_bounds__(K1_THREADS)
    k_binop(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
            int32_t* __restrict__ out, long long n, int bcast) {
  __shared__ int4 tiles[K1_WARPS][128];
  int4* tile = tiles[threadIdx.x >> 5];
  uint32_t y[8];
  if (bcast) load16(b, y);
  FOR_WARP_CHUNKS(c, n) {
    const long long i = c * 32 + (threadIdx.x & 31);
    const bool ok = i < n;
    uint32_t x[8], z[8];
    warp_ld_el(tile, a + 16 * i, ok, x);
    if (!bcast) warp_ld_el(tile, b + 16 * i, ok, y);
    if (ok) {
      if (OP == 0)
        fq_mul(z, x, y);
      else if (OP == 1)
        fq_add(z, x, y);
      else
        fq_sub(z, x, y);
    }
    warp_st_el(tile, out + 16 * i, ok, z);
  }
}

// out[o, i, in] = t[o, i, in] + r (t[o, i + n_half, in] - t[o, i, in]) for
// i < n_half, and 0 for n_half <= i < n_out (the dead region of a
// fixed-size sumcheck buffer).
__global__ void __launch_bounds__(K1_THREADS)
    k_bind(const int32_t* __restrict__ t, const int32_t* __restrict__ r,
           int32_t* __restrict__ out, long long outer, long long n_in,
           long long n_out, long long n_half, long long inner) {
  __shared__ int4 tiles[K1_WARPS][128];
  int4* tile = tiles[threadIdx.x >> 5];
  uint32_t rr[8];
  load16(r, rr);
  const long long n = outer * n_out * inner;
  FOR_WARP_CHUNKS(c, n) {
    const long long e = c * 32 + (threadIdx.x & 31);
    const bool ok = e < n;
    const long long in = e % inner, rest = e / inner;
    const long long i = rest % n_out, o = rest / n_out;
    const bool live = ok && i < n_half;
    const long long lo = (o * n_in + i) * inner + in;
    uint32_t l[8], h[8], v[8];
    warp_ld_el(tile, t + 16 * lo, live, l);
    warp_ld_el(tile, t + 16 * (lo + n_half * inner), live, h);
    if (live)
      fq_bind(v, l, h, rr);
    else
      zero8(v);
    warp_st_el(tile, out + 16 * e, ok, v);
  }
}

// fq_dot: output j = (o, in) of a (outer, K, inner) and b through its own
// strides; fq_dot_many: output j is table tab[j] (K entries) against b.
struct DotArgs {
  const int32_t* a;
  const int32_t* b;
  long long K, inner, sbo, sbk, sbi, chunk;
  uint32_t* part;  // outputs x gridDim.y partials of 8 words
  int32_t* out;
  int many;
  const int32_t* tab[DOT_MANY_MAX];
};

__device__ unsigned dot_tickets[DOT_TICKETS];

// block (j, y) sums chunk y of output j's products; one chunk: the sum is
// the output, else the output's last block sums its partials
__global__ void __launch_bounds__(REDUCE_THREADS)
    k_dot(const __grid_constant__ DotArgs a) {
  __shared__ int4 tiles[REDUCE_THREADS / 32][128];
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  int4* tile = tiles[threadIdx.x >> 5];
  const long long j = blockIdx.x;
  const long long o = a.many ? 0 : j / a.inner, in = a.many ? 0 : j % a.inner;
  const int32_t* pa = a.many ? a.tab[j] : a.a + 16 * (o * a.K * a.inner + in);
  const long long sak = a.many ? 1 : a.inner;
  const int32_t* pb = a.b + 16 * (o * a.sbo + in * a.sbi);
  const long long k0 = (long long)blockIdx.y * a.chunk;
  const long long k1 = a.K < k0 + a.chunk ? a.K : k0 + a.chunk;
  uint32_t acc[8];
  zero8(acc);
  for (long long k = k0 + (threadIdx.x & ~31); k < k1; k += REDUCE_THREADS) {
    const long long kk = k + (threadIdx.x & 31);
    const bool ok = kk < k1;
    uint32_t x[8], y[8];
    warp_ld_el(tile, pa + 16 * kk * sak, ok, x);
    warp_ld_el(tile, pb + 16 * kk * a.sbk, ok, y);
    if (ok) {
      fq_mul(x, x, y);
      fq_add(acc, acc, x);
    }
  }
  ticket_sum(acc, sh, a.part, j * gridDim.y, blockIdx.y, gridDim.y,
             &dot_tickets[j], a.out + 16 * j);
}

// SPARK's hash layer over (outer, n): each operand at o * s_o + i * s_i
// elements (a stride 0 where it broadcasts); hw, when given, gets h + r^2
struct HashArgs {
  const int32_t *addr, *val, *ts;
  long long sao, sai, svo, svi, sto, sti;
  const int32_t *r2, *r1, *rm;
  int32_t *h, *hw;
  long long outer, n;
};

__global__ void __launch_bounds__(K1_THREADS) k_hash(const HashArgs a) {
  __shared__ int4 tiles[K1_WARPS][128];
  int4* tile = tiles[threadIdx.x >> 5];
  uint32_t r2[8], r1[8], rm[8];
  load16(a.r2, r2);
  load16(a.r1, r1);
  load16(a.rm, rm);
  const long long total = a.outer * a.n;
  FOR_WARP_CHUNKS(c, total) {
    const long long e = c * 32 + (threadIdx.x & 31);
    const bool ok = e < total;
    const long long o = e / a.n, i = e % a.n;
    uint32_t x[8], y[8], h[8];
    warp_ld_el(tile, a.ts + 16 * (o * a.sto + i * a.sti), ok, x);
    warp_ld_el(tile, a.val + 16 * (o * a.svo + i * a.svi), ok, y);
    if (ok) {
      fq_mul(h, x, r2);
      fq_mul(y, y, r1);
      fq_add(h, h, y);
    }
    warp_ld_el(tile, a.addr + 16 * (o * a.sao + i * a.sai), ok, x);
    if (ok) {
      fq_add(h, h, x);
      fq_sub(h, h, rm);
    }
    warp_st_el(tile, a.h + 16 * e, ok, h);
    if (a.hw != nullptr) {
      if (ok) fq_add(h, h, r2);
      warp_st_el(tile, a.hw + 16 * e, ok, h);
    }
  }
}

#define EQ_THREADS 256

// One block a chunk: rs (ell, 16) Montgomery challenges, out (2^ell, 16).
__global__ void __launch_bounds__(EQ_THREADS)
    k_eq_evals(const int32_t* __restrict__ rs, int ell,
               int32_t* __restrict__ out) {
  __shared__ uint32_t r_sh[EQ_CHUNK_BITS + EQ_MAX_HIGH][8];
  __shared__ __align__(16) uint32_t tab[1 << EQ_CHUNK_BITS][8];
  const int k = eq_chunk_bits(ell), h = ell - k;
  const unsigned long long c = blockIdx.x;
  for (int j = threadIdx.x; j < ell; j += blockDim.x)
    load16(rs + 16 * j, r_sh[j]);
  __syncthreads();
  if (threadIdx.x < 32) {
    // the high factor: lane j < h holds variable j's factor, the others
    // the Montgomery one; a halving tree leaves the product in lane 0
    const int lane = threadIdx.x;
    uint32_t f[8];
    if (lane < h) {
      eq_factor(f, r_sh[lane], eq_high_bit(c, h, lane));
    } else {
      const uint32_t one[8] = FQ_ONE_MONT_WORDS;
      copy8(f, one);
    }
    for (int s = 1; s < h; s <<= 1) {
      uint32_t g[8];
      for (int w = 0; w < 8; ++w) g[w] = __shfl_down_sync(0xffffffffu, f[w], s);
      fq_mul(f, f, g);
    }
    if (lane == 0) copy8(tab[0], f);
  }
  __syncthreads();
  for (int m = 0; m < k; ++m) {
    const int half = 1 << m;
    for (int i = threadIdx.x; i < half; i += blockDim.x)
      eq_split(tab[i], tab[i + half], tab[i], r_sh[ell - 1 - m]);
    __syncthreads();
  }
  // 16 bytes (4 limbs, 2 words) a thread a step
  int4* dst = reinterpret_cast<int4*>(out + 16 * (c << k));
  for (int q = threadIdx.x; q < (4 << k); q += blockDim.x) {
    const uint32_t* w = &tab[q >> 2][2 * (q & 3)];
    dst[q] = make_int4((int)(w[0] & 0xffffu), (int)(w[0] >> 16),
                       (int)(w[1] & 0xffffu), (int)(w[1] >> 16));
  }
}

// blocks of K1_THREADS for n elements, at most the blocks of `fn` resident
// at once (SMs x its blocks an SM, read once a kernel: `slot`)
template <typename F>
static unsigned k1_blocks(F fn, int slot, long long n) {
  static int nsm = 0;
  static int occ[5] = {0};
  if (nsm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (occ[slot] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[slot], fn, K1_THREADS,
                                                  0);
    if (occ[slot] < 1) occ[slot] = 1;
  }
  const long long nb = (n + K1_THREADS - 1) / K1_THREADS;
  const long long cap = (long long)nsm * occ[slot];
  return (unsigned)(nb < cap ? nb : cap);
}

template <int OP>
static int binop(const int32_t* a, const int32_t* b, int32_t* out,
                 long long n, int bcast, void* stream) {
  if (n > 0)
    k_binop<OP><<<k1_blocks(k_binop<OP>, OP, n), K1_THREADS, 0,
                  (cudaStream_t)stream>>>(a, b, out, n, bcast);
  return (int)cudaGetLastError();
}

extern "C" {

int fq_mul_launch(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int bcast, void* stream) {
  return binop<0>(a, b, out, n, bcast, stream);
}

int fq_add_launch(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int bcast, void* stream) {
  return binop<1>(a, b, out, n, bcast, stream);
}

int fq_sub_launch(const int32_t* a, const int32_t* b, int32_t* out,
                  long long n, int bcast, void* stream) {
  return binop<2>(a, b, out, n, bcast, stream);
}

int fq_bind_launch(const int32_t* t, const int32_t* r, int32_t* out,
                   long long outer, long long n_in, long long n_out,
                   long long n_half, long long inner, void* stream) {
  const long long total = outer * n_out * inner;
  if (total > 0)
    k_bind<<<k1_blocks(k_bind, 3, total), K1_THREADS, 0,
             (cudaStream_t)stream>>>(t, r, out, outer, n_in, n_out, n_half,
                                     inner);
  return (int)cudaGetLastError();
}

static int dot_go(DotArgs& a, long long outputs, cudaStream_t s) {
  if (a.chunk < 1 || a.chunk > DOT_CHUNK) return -1;
  const long long nchunks = (a.K + a.chunk - 1) / a.chunk;
  if (outputs < 1 || nchunks < 1) return 0;
  if (nchunks > 65535 || outputs > 0x7fffffffLL ||
      (nchunks > 1 && outputs > DOT_TICKETS))
    return -1;
  k_dot<<<dim3((unsigned)outputs, (unsigned)nchunks), REDUCE_THREADS, 0,
          s>>>(a);
  return (int)cudaGetLastError();
}

// part: outer * inner * ceil(K / chunk) scratch values of 8 words.
int fq_dot_launch(const int32_t* a, const int32_t* b, uint32_t* part,
                  int32_t* out, long long outer, long long K, long long inner,
                  long long sbo, long long sbk, long long sbi,
                  long long chunk, void* stream) {
  DotArgs d{};
  d.a = a;
  d.b = b;
  d.K = K;
  d.inner = inner;
  d.sbo = sbo;
  d.sbk = sbk;
  d.sbi = sbi;
  d.chunk = chunk;
  d.part = part;
  d.out = out;
  d.many = 0;
  return dot_go(d, outer * inner, (cudaStream_t)stream);
}

// tabs: n host pointers to (K, 16) tables; b the (K, 16) table they are
// all dotted with; out (n, 16); part: n * ceil(K / chunk) x 8 words.
int fq_dot_many_launch(const int32_t* const* tabs, int n, const int32_t* b,
                       uint32_t* part, int32_t* out, long long K,
                       long long chunk, void* stream) {
  if (n < 0 || n > DOT_MANY_MAX) return -1;
  DotArgs d{};
  d.b = b;
  d.K = K;
  d.inner = 1;
  d.sbk = 1;
  d.chunk = chunk;
  d.part = part;
  d.out = out;
  d.many = 1;
  for (int j = 0; j < n; ++j) d.tab[j] = tabs[j];
  return dot_go(d, n, (cudaStream_t)stream);
}

// strides: the 6 element strides (addr o, i; val o, i; ts o, i); hw may be
// null.
int hash_poly_launch(const int32_t* addr, const int32_t* val,
                     const int32_t* ts, const long long* strides,
                     const int32_t* r2, const int32_t* r1, const int32_t* rm,
                     int32_t* h, int32_t* hw, long long outer, long long n,
                     void* stream) {
  const HashArgs a{addr, val, ts, strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5], r2, r1, rm, h, hw,
                   outer, n};
  if (outer * n > 0)
    k_hash<<<k1_blocks(k_hash, 4, outer * n), K1_THREADS, 0,
             (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The (2^ell, 16) eq table of ell >= 1 challenges; out 16-byte aligned.
int eq_evals_launch(const int32_t* rs, int ell, int32_t* out, void* stream) {
  if (ell < 1 || ell - eq_chunk_bits(ell) > 31) return -1;  // grid.x
  const unsigned nb = 1u << (ell - eq_chunk_bits(ell));
  k_eq_evals<<<nb, EQ_THREADS, 0, (cudaStream_t)stream>>>(rs, ell, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
