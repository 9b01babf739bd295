// K1: scalar-field tensors mod l on the card.
//
// Replaces the JAX package's ops/fq.py (mul/_redc_impl, add, sub, dot,
// sum_reduce) and the limb primitives of ops/limbs.py, plus the binds of
// models/dense_mlpoly.py (_bound_top, _bound_bot), ops/sumcheck.py
// (fold_chain, p1_bind, p2_bind) and the L*Z contraction (_bound_L, _dot_dev),
// and the eq table of models/dense_mlpoly.py _eq_evals_dev (k_eq_evals).
//
// Bound on the card: the elementwise ops and bind move 64 B per operand per
// element and do one Montgomery product (64 32x32-bit multiply-adds for the
// product, 64 for the reduction); at 2^20 elements both bounds are tens of
// microseconds, so launch overhead dominates. dot is a two-pass reduction:
// a block sums a chunk of the reduced axis in shared memory, a second kernel
// sums the per-block partials.
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

#define DOT_CHUNK 4096

template <int OP>
__global__ void k_binop(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ out, long long n, int bcast) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], y[8], z[8];
  load16(a + 16 * i, x);
  load16(b + (bcast ? 0 : 16 * i), y);
  if (OP == 0)
    fq_mul(z, x, y);
  else if (OP == 1)
    fq_add(z, x, y);
  else
    fq_sub(z, x, y);
  store16(out + 16 * i, z);
}

// out[o, i, in] = t[o, i, in] + r (t[o, i + n_half, in] - t[o, i, in]) for
// i < n_half, and 0 for n_half <= i < n_out (the dead region of a
// fixed-size sumcheck buffer).
__global__ void k_bind(const int32_t* __restrict__ t,
                       const int32_t* __restrict__ r,
                       int32_t* __restrict__ out, long long outer,
                       long long n_in, long long n_out, long long n_half,
                       long long inner) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= outer * n_out * inner) return;
  const long long in = e % inner;
  const long long rest = e / inner;
  const long long i = rest % n_out;
  const long long o = rest / n_out;
  uint32_t v[8];
  if (i < n_half) {
    uint32_t lo[8], hi[8], rr[8];
    load16(t + 16 * ((o * n_in + i) * inner + in), lo);
    load16(t + 16 * ((o * n_in + i + n_half) * inner + in), hi);
    load16(r, rr);
    fq_bind(v, lo, hi, rr);
  } else {
    zero8(v);
  }
  store16(out + 16 * e, v);
}

// Partial sums of a[o, k, in] * b[o, k, in] over one DOT_CHUNK of k; b is
// addressed through its own strides (0 where it is broadcast).
__global__ void k_dot_partial(const int32_t* __restrict__ a,
                              const int32_t* __restrict__ b,
                              uint32_t* __restrict__ part, long long K,
                              long long inner, long long sbo, long long sbk,
                              long long sbi) {
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  const long long j = blockIdx.x;
  const long long o = j / inner, in = j % inner;
  const long long k0 = (long long)blockIdx.y * DOT_CHUNK;
  const long long k1 = K < k0 + DOT_CHUNK ? K : k0 + DOT_CHUNK;
  uint32_t acc[8];
  zero8(acc);
  for (long long k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
    uint32_t x[8], y[8];
    load16(a + 16 * ((o * K + k) * inner + in), x);
    load16(b + 16 * (o * sbo + k * sbk + in * sbi), y);
    fq_mul(x, x, y);
    fq_add(acc, acc, x);
  }
  block_sum(acc, sh);
  if (threadIdx.x == 0) copy8(part + 8 * (j * gridDim.y + blockIdx.y), acc);
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

static unsigned blocks(long long n, int t) { return (unsigned)((n + t - 1) / t); }

template <int OP>
static int binop(const int32_t* a, const int32_t* b, int32_t* out,
                 long long n, int bcast, void* stream) {
  if (n > 0)
    k_binop<OP><<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(a, b, out,
                                                                  n, bcast);
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
    k_bind<<<blocks(total, 256), 256, 0, (cudaStream_t)stream>>>(
        t, r, out, outer, n_in, n_out, n_half, inner);
  return (int)cudaGetLastError();
}

// part: outer * inner * ceil(K / DOT_CHUNK) scratch values of 8 words.
int fq_dot_launch(const int32_t* a, const int32_t* b, uint32_t* part,
                  int32_t* out, long long outer, long long K, long long inner,
                  long long sbo, long long sbk, long long sbi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nchunks = (K + DOT_CHUNK - 1) / DOT_CHUNK;
  dim3 grid((unsigned)(outer * inner), (unsigned)nchunks);
  k_dot_partial<<<grid, REDUCE_THREADS, 0, s>>>(a, b, part, K, inner, sbo,
                                                sbk, sbi);
  reduce_partials<<<(unsigned)(outer * inner), REDUCE_THREADS, 0, s>>>(
      part, nchunks, out);
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
