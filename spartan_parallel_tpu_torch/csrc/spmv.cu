// K3: sparse R1CS products over the scalar field.
//
// Replaces the JAX package's ops/spmv.py (spmv_batched, eval_table,
// sparse_eval). The TPU version summed lazily in uint32 limbs through a
// cumsum difference, which capped a row at 2^15 entries (ops/spmv.py:36-40).
// Here every thread accumulates exactly in the field, so the cap is lifted:
//
//   spmv: one thread per (right-hand side q, row) walks the row's CSR
//     entries: out[q, row] = sum val * z[q, col].
//   eval_table: one thread per column walks its CSC entries:
//     out[col] = sum val * eq_rx[row].
//   sparse_eval: a block sums val * eq_rx[row] * eq_ry[col] over a chunk of
//     entries, a second kernel sums the partials.
//
// Bound on the card: bytes. Each entry reads a 4 B index, a 64 B value and a
// 64 B gathered operand and does one or two Montgomery products; R1CS rows
// are short, so the gathers' scattered 64 B reads set the pace.
#include <cuda_runtime.h>

#include "reduce.cuh"

#define EVAL_CHUNK 4096

__global__ void k_spmv(const int32_t* __restrict__ ptr,
                       const int32_t* __restrict__ idx,
                       const int32_t* __restrict__ vals,
                       const int32_t* __restrict__ z, int32_t* __restrict__ out,
                       long long nrows, long long ncols) {
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long q = blockIdx.y;
  if (row >= nrows) return;
  uint32_t acc[8];
  zero8(acc);
  for (int e = ptr[row]; e < ptr[row + 1]; ++e) {
    uint32_t v[8], x[8];
    load16(vals + 16LL * e, v);
    load16(z + 16 * (q * ncols + idx[e]), x);
    fq_mul(v, v, x);
    fq_add(acc, acc, v);
  }
  store16(out + 16 * (q * nrows + row), acc);
}

__global__ void k_sparse_eval_partial(const int32_t* __restrict__ rows,
                                      const int32_t* __restrict__ cols,
                                      const int32_t* __restrict__ vals,
                                      const int32_t* __restrict__ rx,
                                      const int32_t* __restrict__ ry,
                                      uint32_t* __restrict__ part,
                                      long long nnz) {
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  const long long e0 = (long long)blockIdx.x * EVAL_CHUNK;
  const long long e1 = nnz < e0 + EVAL_CHUNK ? nnz : e0 + EVAL_CHUNK;
  uint32_t acc[8];
  zero8(acc);
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    uint32_t v[8], a[8], b[8];
    load16(vals + 16 * e, v);
    load16(rx + 16LL * rows[e], a);
    load16(ry + 16LL * cols[e], b);
    fq_mul(a, a, b);
    fq_mul(v, v, a);
    fq_add(acc, acc, v);
  }
  block_sum(acc, sh);
  if (threadIdx.x == 0) copy8(part + 8 * blockIdx.x, acc);
}

extern "C" {

// CSR product for Q right-hand sides: ptr (nrows + 1), idx/vals (nnz);
// z (Q, ncols, 16) -> out (Q, nrows, 16). eval_table is the same kernel on
// the CSC form with z = eq_rx, ncols = the number of rows of the matrix.
int spmv_launch(const int32_t* ptr, const int32_t* idx, const int32_t* vals,
                const int32_t* z, int32_t* out, long long Q, long long nrows,
                long long ncols, void* stream) {
  if (nrows > 0 && Q > 0) {
    dim3 grid((unsigned)((nrows + 255) / 256), (unsigned)Q);
    k_spmv<<<grid, 256, 0, (cudaStream_t)stream>>>(ptr, idx, vals, z, out,
                                                   nrows, ncols);
  }
  return (int)cudaGetLastError();
}

// part: ceil(nnz / EVAL_CHUNK) scratch values of 8 words; out (16,).
int sparse_eval_launch(const int32_t* rows, const int32_t* cols,
                       const int32_t* vals, const int32_t* rx,
                       const int32_t* ry, uint32_t* part, int32_t* out,
                       long long nnz, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nchunks = (nnz + EVAL_CHUNK - 1) / EVAL_CHUNK;
  k_sparse_eval_partial<<<(unsigned)nchunks, REDUCE_THREADS, 0, s>>>(
      rows, cols, vals, rx, ry, part, nnz);
  reduce_partials<<<1, REDUCE_THREADS, 0, s>>>(part, nchunks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
