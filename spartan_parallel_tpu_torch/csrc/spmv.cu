// K3: sparse R1CS products over the scalar field.
//
// Replaces the JAX package's ops/spmv.py (spmv_batched :52, eval_table
// :71, sparse_eval :87) and the per-matrix loops of its callers in
// models/r1csinstance.py (multiply_vec_block, _classed,
// compute_eval_table_sparse_disjoint_rounds, multi_evaluate). The TPU
// version summed lazily in uint32 limbs through a cumsum difference, which
// capped a row at 2^15 entries; here sums are exact in the field.
//
//   k_spmv: every matrix of a call and every right-hand side in one
//     launch: out[s] = sum over segment s's entries of val * x[idx] (Az,
//     Bz, Cz over the rows of a CSR; the phase-2 tables M^T eq(rx) over
//     the columns of a CSC). The work is split by items, entries and empty
//     segments alike (csrc/spmv.cuh): a warp walks its range 32 items a
//     step, a lane an item, and sums runs of one segment by a segmented
//     scan over the lanes, carrying the run open at a step's end into the
//     next. A segment is written by the lane of its last item (empty ones
//     as a zero), bit-reversed in q and s where the caller asks. Segments
//     longer than SPMV_CAP leave partials, which the last block to take a
//     ticket adds up (one warp a long segment).
//   k_sparse_eval: M(rx, ry) = sum val * eq_rx[row] * eq_ry[col] of every
//     matrix in one launch: a block sums a chunk of one matrix's entries
//     and the matrix's last block to take a ticket sums its partials.
//
// Every element (values, gathered x / eq entries, outputs) moves through
// shared memory 16 bytes a lane, neighbouring lanes on neighbouring
// addresses (tables.cuh warp_ld_el / warp_st_el). Bound on the card:
// bytes. An entry reads a 64 B value, a 64 B gathered operand and a few
// 4 B indices and does one (sparse_eval: two) Montgomery products; a
// segment writes 64 B.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "spmv.cuh"
#include "tables.cuh"

#define SPMV_WARPS 4
#define SPMV_THREADS (32 * SPMV_WARPS)
// instances of one launch (their counts and matrices are launch
// parameters) and so problems: kk <= 3 matrices an instance
#define SPMV_MAX_INST 64
#define SPMV_MAX_PROBS (3 * SPMV_MAX_INST)
#define LANES 0xffffffffu

struct SpmvArgs {
  const int32_t *ptr, *seg, *idx, *vals, *empty;
  const long long* meta;  // SPMV_META a matrix
  const int32_t* x;
  int32_t* out;
  SpmvMap map;
  long long total;  // items
  int nprob, has_long;
  uint32_t* pend;     // 2 partials of 8 words a warp (long segments)
  long long* longs;   // (warp, end, output) of each long segment's owner
  int minst[SPMV_MAX_INST];  // instance i's matrices: kk minst[i] + k
  int q[SPMV_MAX_INST];      // instance i's right-hand sides
  long long off[SPMV_MAX_PROBS + 1];
};

__device__ unsigned spmv_ticket;
__device__ unsigned spmv_nlong;

__device__ __forceinline__ void st_partial(uint32_t* p, const uint32_t* v) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(v[0], v[1], v[2], v[3]);
  q[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// warp w's range (every lane of the warp takes part)
__device__ __forceinline__ void spmv_warp(const SpmvArgs& A,
                                          const SpmvProbs& P, int4* tile,
                                          long long w) {
  const int lane = threadIdx.x & 31;
  const SpmvRange R = spmv_range(P, A.ptr, A.seg, A.empty, w, A.total);
  uint32_t cv[8];  // the run carried from the previous step
  long long ck = -1;
  zero8(cv);
  for (long long t = R.start; t < R.end; t += 32) {
    const long long d = t + lane;
    const bool ok = d < R.end;
    SpmvItem it;
    long long key = -2 - lane, xo = 0, e = 0;
    bool ent = false, ends = false, head = false;
    if (ok) {
      spmv_decode(P, A.ptr, A.seg, A.empty, d, it);
      key = spmv_out(A.map, it);
      ent = it.e >= 0;
      if (ent) {
        e = it.e;
        xo = spmv_x(A.map, it, A.idx);
      }
      ends = d + 1 == it.b;
      head = d < R.head_b;
    }
    uint32_t v[8], x[8];
    warp_ld_el(tile, A.vals + 16 * e, ent, v);
    warp_ld_el(tile, A.x + 16 * xo, ent, x);
    if (ent)
      fq_mul(v, v, x);
    else
      zero8(v);
    if (lane == 0 && key == ck) fq_add(v, v, cv);
    // inclusive sums over the runs of equal keys
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) u[k] = __shfl_up_sync(LANES, v[k], o);
      const long long ko = __shfl_up_sync(LANES, key, o);
      if (lane >= o && ko == key) fq_add(v, v, u);
    }
    // the step's last item carries its run on unless the run ends there
    const int last = (int)(R.end - 1 - t < 31 ? R.end - 1 - t : 31);
    ck = __shfl_sync(LANES, (int)ends, last) ? -1
                                              : __shfl_sync(LANES, key, last);
#pragma unroll
    for (int k = 0; k < 8; ++k) cv[k] = __shfl_sync(LANES, v[k], last);
    if (ends && head) st_partial(A.pend + 16 * w, v);
    warp_st_el(tile, A.out + 16 * (ends && !head ? key : 0), ends && !head,
               v);
  }
  if (ck >= 0 && lane == 0) {  // the range ends inside a long segment
    if (R.head_b > R.end) {    // one that began before the range
      st_partial(A.pend + 16 * w, cv);
    } else {                   // the warp owns it
      st_partial(A.pend + 16 * w + 8, cv);
      const unsigned r = atomicAdd(&spmv_nlong, 1u);
      A.longs[3 * r] = w;
      A.longs[3 * r + 1] = R.tail_b;
      A.longs[3 * r + 2] = ck;
    }
  }
}

__global__ void __launch_bounds__(SPMV_THREADS)
    k_spmv(const __grid_constant__ SpmvArgs A) {
  __shared__ int4 tiles[SPMV_WARPS][128];
  __shared__ long long s_off[SPMV_MAX_PROBS + 1], s_nnz[SPMV_MAX_PROBS],
      s_nemp[SPMV_MAX_PROBS], s_ent[SPMV_MAX_PROBS], s_emp[SPMV_MAX_PROBS],
      s_ptr[SPMV_MAX_PROBS];
  __shared__ int s_q[SPMV_MAX_PROBS];
  __shared__ bool last;
  for (int j = threadIdx.x; j <= A.nprob; j += SPMV_THREADS) {
    s_off[j] = A.off[j];
    if (j < A.nprob) {
      const int i = j / A.map.kk;
      const long long* m =
          A.meta + SPMV_META * (A.map.kk * A.minst[i] + j % A.map.kk);
      s_ptr[j] = m[0];
      s_ent[j] = m[1];
      s_nnz[j] = m[2];
      s_emp[j] = m[3];
      s_nemp[j] = m[4];
      s_q[j] = A.q[i];
    }
  }
  __syncthreads();
  const SpmvProbs P{s_off, s_nnz, s_nemp, s_ent, s_emp, s_ptr, s_q, A.nprob};
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * SPMV_WARPS + (threadIdx.x >> 5);
  if (w * SPMV_RANGE < A.total)
    spmv_warp(A, P, tiles[threadIdx.x >> 5], w);
  if (!A.has_long) return;
  // the last block adds up each long segment's partials, a warp a segment
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&spmv_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const unsigned nl = *(volatile unsigned*)&spmv_nlong;
  for (unsigned r = threadIdx.x >> 5; r < nl; r += SPMV_WARPS) {
    const long long ow = __ldcg(A.longs + 3 * r);
    const long long wl = (__ldcg(A.longs + 3 * r + 1) - 1) / SPMV_RANGE;
    const long long key = __ldcg(A.longs + 3 * r + 2);
    uint32_t acc[8];
    zero8(acc);
    for (long long v = ow + lane; v <= wl; v += 32) {
      uint32_t x[8];
      ld_partial(x, A.pend + 16 * v + (v == ow ? 8 : 0));
      fq_add(acc, acc, x);
    }
    warp_sum8(acc);
    if (lane == 0) st_el(A.out + 16 * key, acc);
  }
  __syncthreads();
  if (threadIdx.x == 0) spmv_nlong = 0;
}

// M(rx, ry) of matrices 0..nmat-1 of a stack: block b sums chunk b -
// chunk0[m] of matrix m (per_thread * REDUCE_THREADS entries)
struct EvalArgs {
  const int32_t *seg, *idx, *vals, *rx, *ry;
  const long long* meta;
  uint32_t* part;  // a partial of 8 words a block
  int32_t* out;    // (nmat, 16)
  int nmat, per_thread;
  int chunk0[SPMV_MAX_PROBS + 1];
};

__device__ unsigned eval_tickets[SPMV_MAX_PROBS];

__global__ void __launch_bounds__(REDUCE_THREADS)
    k_sparse_eval(const __grid_constant__ EvalArgs a) {
  __shared__ int4 tiles[REDUCE_THREADS / 32][128];
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  int4* tile = tiles[threadIdx.x >> 5];
  int m = 0, hi = a.nmat - 1;  // the last matrix whose first block <= b
  while (m < hi) {
    const int mid = (m + hi + 1) >> 1;
    if (a.chunk0[mid] <= (int)blockIdx.x)
      m = mid;
    else
      hi = mid - 1;
  }
  const unsigned c = blockIdx.x - a.chunk0[m];
  const unsigned nc = a.chunk0[m + 1] - a.chunk0[m];
  const long long ent = a.meta[SPMV_META * m + 1];
  const long long nnz = a.meta[SPMV_META * m + 2];
  const long long span = (long long)REDUCE_THREADS * a.per_thread;
  const long long e0 = c * span;
  const long long e1 = nnz < e0 + span ? nnz : e0 + span;
  uint32_t acc[8];
  zero8(acc);
  for (long long k = e0 + (threadIdx.x & ~31); k < e1; k += REDUCE_THREADS) {
    const long long e = ent + k + (threadIdx.x & 31);
    const bool ok = k + (threadIdx.x & 31) < e1;
    const long long r = ok ? a.seg[e] : 0, col = ok ? a.idx[e] : 0;
    uint32_t v[8], x[8], y[8];
    warp_ld_el(tile, a.vals + 16 * (ok ? e : 0), ok, v);
    warp_ld_el(tile, a.rx + 16 * r, ok, x);
    warp_ld_el(tile, a.ry + 16 * col, ok, y);
    if (ok) {
      fq_mul(x, x, y);
      fq_mul(v, v, x);
      fq_add(acc, acc, v);
    }
  }
  ticket_sum(acc, sh, a.part, a.chunk0[m], c, nc, &eval_tickets[m],
             a.out + 16 * m);
}

extern "C" {

// Every problem (instance i < ninst, matrix k < kk of it) of a stack in
// one launch. geom: the host's xis, xqs, oks, ois, oqs; flags: kk, qbits,
// sbits, has_long; minst, q: ninst each; off: ninst * kk + 1 item offsets;
// pend: 2 * 8 words and longs: 3 words a warp when has_long.
int spmv_many_launch(const int32_t* ptr, const int32_t* seg,
                     const int32_t* idx, const int32_t* vals,
                     const int32_t* empty, const long long* meta,
                     const int32_t* x, int32_t* out, const long long* geom,
                     const int* flags, const int* minst, const int* q,
                     int ninst, const long long* off, uint32_t* pend,
                     long long* longs, void* stream) {
  const int kk = flags[0];
  if (ninst < 1 || ninst > SPMV_MAX_INST || kk < 1 || kk > 3) return -1;
  SpmvArgs a{};
  a.ptr = ptr;
  a.seg = seg;
  a.idx = idx;
  a.vals = vals;
  a.empty = empty;
  a.meta = meta;
  a.x = x;
  a.out = out;
  a.map = SpmvMap{geom[0], geom[1], geom[2], geom[3], geom[4],
                  kk,      flags[1], flags[2]};
  a.nprob = ninst * kk;
  a.has_long = flags[3];
  a.pend = pend;
  a.longs = longs;
  for (int i = 0; i < ninst; ++i) {
    a.minst[i] = minst[i];
    a.q[i] = q[i];
  }
  for (int j = 0; j <= a.nprob; ++j) a.off[j] = off[j];
  a.total = off[a.nprob];
  if (a.total <= 0) return 0;
  const long long warps = (a.total + SPMV_RANGE - 1) / SPMV_RANGE;
  const long long blocks = (warps + SPMV_WARPS - 1) / SPMV_WARPS;
  if (blocks > 0x7fffffffLL) return -1;
  k_spmv<<<(unsigned)blocks, SPMV_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// M(rx, ry) of the stack's matrices 0..nmat-1; chunk0: nmat + 1 first
// blocks (every matrix at least one); part: chunk0[nmat] x 8 words.
int sparse_eval_many_launch(const int32_t* seg, const int32_t* idx,
                            const int32_t* vals, const long long* meta,
                            const int32_t* rx, const int32_t* ry,
                            const int* chunk0, int nmat, int per_thread,
                            uint32_t* part, int32_t* out, void* stream) {
  if (nmat < 1 || nmat > SPMV_MAX_PROBS || per_thread < 1) return -1;
  EvalArgs a{};
  a.seg = seg;
  a.idx = idx;
  a.vals = vals;
  a.rx = rx;
  a.ry = ry;
  a.meta = meta;
  a.part = part;
  a.out = out;
  a.nmat = nmat;
  a.per_thread = per_thread;
  for (int m = 0; m <= nmat; ++m) a.chunk0[m] = chunk0[m];
  k_sparse_eval<<<(unsigned)chunk0[nmat], REDUCE_THREADS, 0,
                  (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
