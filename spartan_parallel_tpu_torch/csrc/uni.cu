// K7: the powers of one scalar c, and tables read as univariate
// polynomials evaluated at c.
//
// Replaces the JAX package's models/dense_mlpoly.py _powers_dev (:200), a
// log-depth associative scan of fq.mul over [1, c, c, ..., c], and its
// partner _rlc_eval_dev (:211), sum_i Z_i c^i, which uni_evaluate runs
// for every table of ShiftProofs (models/snark.py ShiftProofs.prove).
//
// Design: thread t of block b owns the entries e = b span + t + s 256 (s <
// per_thread, span = 256 per_thread). It forms c^e from the table of
// c^(2^k) (a product for each set bit of e: about log2 n products on its
// chain), then steps by c^256 = c^(2^8). k_uni<false> (fq_powers) writes
// the powers, a warp's 32 at a time, 16 bytes a lane (tables.cuh
// warp_st_el); k_uni<true> (uni_eval_many) never writes them: it multiplies
// each into the table's entry (read 16 bytes a lane) and sums, and the
// table's last block to take a ticket sums its blocks' partials, so every
// table of a call is one launch. uni_eval_many takes c^(2^k) by value in
// the launch's parameters (made on the host from c); fq_powers, whose c
// lies on the device, has each block square c in shared memory first.
//
// Bound on the card: at the path's shapes (ShiftProofs' tables, 512 to
// 1,024 entries at find_min) the launch and the chain of products; at
// 2^20 the powers' products (operations), above the n x 64 B written.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tables.cuh"

#define UNI_THREADS 256
#define UNI_LOG_THREADS 8
#define UNI_BITS 40       // c^(2^k), k < UNI_BITS: up to 2^40 entries
#define UNI_MANY_MAX 64   // tables of one uni_eval_many launch

struct UniArgs {
  uint32_t pw[UNI_BITS][8];  // c^(2^k) in Montgomery words (uni_eval_many)
  const int32_t* c;          // fq_powers: (16,) Montgomery limbs
  int nbits, per_thread, ntab;
  long long n;   // fq_powers: entries
  int32_t* out;  // fq_powers: (n, 16); uni_eval_many: (ntab, 16)
  uint32_t* part;  // a partial of 8 words a block
  const int32_t* tab[UNI_MANY_MAX];
  long long len[UNI_MANY_MAX];
  int chunk0[UNI_MANY_MAX + 1];  // first block of each table
};

__device__ unsigned uni_tickets[UNI_MANY_MAX];

template <bool MANY>
__global__ void __launch_bounds__(UNI_THREADS)
    k_uni(const __grid_constant__ UniArgs a) {
  __shared__ int4 tiles[UNI_THREADS / 32][128];
  __shared__ uint32_t pw[UNI_BITS][8];
  __shared__ uint32_t sh[UNI_THREADS * 8];
  int4* tile = tiles[threadIdx.x >> 5];
  int t = 0;
  long long blk = blockIdx.x, n = a.n;
  if (MANY) {  // the last table whose first block <= b
    int hi = a.ntab - 1;
    while (t < hi) {
      const int mid = (t + hi + 1) >> 1;
      if (a.chunk0[mid] <= (int)blockIdx.x)
        t = mid;
      else
        hi = mid - 1;
    }
    blk -= a.chunk0[t];
    n = a.len[t];
    for (int i = threadIdx.x; i < a.nbits * 8; i += UNI_THREADS)
      pw[i >> 3][i & 7] = a.pw[i >> 3][i & 7];
  } else if (threadIdx.x == 0) {
    load16(a.c, pw[0]);
    for (int k = 1; k < a.nbits; ++k) fq_mul(pw[k], pw[k - 1], pw[k - 1]);
  }
  __syncthreads();
  const long long e0 =
      blk * ((long long)UNI_THREADS * a.per_thread) + threadIdx.x;
  uint32_t p[8] = FQ_ONE_MONT_WORDS, acc[8];
  for (int k = 0; k < a.nbits; ++k)
    if ((e0 >> k) & 1) fq_mul(p, p, pw[k]);
  zero8(acc);
  for (int s = 0; s < a.per_thread; ++s) {
    const long long e = e0 + ((long long)s << UNI_LOG_THREADS);
    const bool ok = e < n;
    if (MANY) {
      uint32_t z[8];
      warp_ld_el(tile, a.tab[t] + 16 * (ok ? e : 0), ok, z);
      if (ok) {
        fq_mul(z, z, p);
        fq_add(acc, acc, z);
      }
    } else {
      warp_st_el(tile, a.out + 16 * (ok ? e : 0), ok, p);
    }
    if (s + 1 < a.per_thread) fq_mul(p, p, pw[UNI_LOG_THREADS]);
  }
  if (!MANY) return;
  ticket_sum(acc, sh, a.part, a.chunk0[t], blk,
             a.chunk0[t + 1] - a.chunk0[t], &uni_tickets[t], a.out + 16 * t);
}

extern "C" {

// c (16,) Montgomery limbs; out (n, 16); nbits: 2^nbits > n - 1 and
// nbits > UNI_LOG_THREADS.
int fq_powers_launch(const int32_t* c, int32_t* out, long long n, int nbits,
                     int per_thread, void* stream) {
  if (nbits <= UNI_LOG_THREADS || nbits > UNI_BITS || per_thread < 1)
    return -1;
  UniArgs a{};
  a.c = c;
  a.nbits = nbits;
  a.per_thread = per_thread;
  a.n = n;
  a.out = out;
  const long long span = (long long)UNI_THREADS * per_thread;
  if (n > 0)
    k_uni<false><<<(unsigned)((n + span - 1) / span), UNI_THREADS, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// tabs: ntab host pointers to (len[t], 16) tables; pw: nbits x 8 words of
// c^(2^k); chunk0: ntab + 1 first blocks (every table at least one);
// part: chunk0[ntab] x 8 words; out (ntab, 16).
int uni_eval_many_launch(const int32_t* const* tabs, const long long* len,
                         int ntab, const uint32_t* pw, int nbits,
                         const int* chunk0, int per_thread, uint32_t* part,
                         int32_t* out, void* stream) {
  if (ntab < 1 || ntab > UNI_MANY_MAX || nbits <= UNI_LOG_THREADS ||
      nbits > UNI_BITS || per_thread < 1)
    return -1;
  UniArgs a{};
  a.nbits = nbits;
  a.per_thread = per_thread;
  a.ntab = ntab;
  a.out = out;
  a.part = part;
  for (int k = 0; k < 8 * nbits; ++k) a.pw[k >> 3][k & 7] = pw[k];
  for (int t = 0; t < ntab; ++t) {
    a.tab[t] = tabs[t];
    a.len[t] = len[t];
  }
  for (int t = 0; t <= ntab; ++t) a.chunk0[t] = chunk0[t];
  k_uni<true><<<(unsigned)chunk0[ntab], UNI_THREADS, 0,
                (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
