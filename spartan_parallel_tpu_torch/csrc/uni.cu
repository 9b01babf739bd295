// K7: the powers 1, c, c^2, ..., c^(n-1) of one scalar, the table of the
// univariate evaluations of ShiftProofs.
//
// Replaces the JAX package's models/dense_mlpoly.py _powers_dev (:200), a
// log-depth associative scan of fq.mul over [1, c, c, ..., c]. Its
// partner _rlc_eval_dev (:211), sum_i Z_i c^i, is one K1 fq_dot.
//
// Design: no scan. Block b owns the tile of POW_CHUNK * blockDim
// consecutive indices from base = b * POW_CHUNK * blockDim; thread t starts
// at base + t with fq_pow (square-and-multiply, fq.cuh) and steps by
// blockDim, multiplying by c^blockDim (fq_pow once more). So the threads
// of a warp write neighbouring elements at every step, and each element
// costs one Montgomery product, plus two powers of O(log n) products per
// thread.
//
// Bound on the card: at the path's shapes (the shift polynomials, 512 to
// 1024 entries at find_min) the launch; at 2^20 the n - 1 products
// (operations), above the n x 64 B written.
#include <cuda_runtime.h>

#include "fq.cuh"

#define POW_CHUNK 16     // powers per thread
#define POW_THREADS 256

__global__ void k_powers(const int32_t* __restrict__ c,
                         int32_t* __restrict__ out, long long n) {
  const long long base =
      (long long)blockIdx.x * POW_CHUNK * blockDim.x + threadIdx.x;
  if (base >= n) return;
  uint32_t cc[8], acc[8], step[8];
  load16(c, cc);
  fq_pow(acc, cc, (uint64_t)base);
  fq_pow(step, cc, (uint64_t)blockDim.x);
  long long i = base;
  for (int k = 0; k < POW_CHUNK && i < n; ++k, i += blockDim.x) {
    store16(out + 16 * i, acc);
    fq_mul(acc, acc, step);
  }
}

extern "C" {

// c (16,) Montgomery limbs; out (n, 16); n >= 1.
int fq_powers_launch(const int32_t* c, int32_t* out, long long n,
                     void* stream) {
  const long long tile = (long long)POW_CHUNK * POW_THREADS;
  if (n > 0)
    k_powers<<<(unsigned)((n + tile - 1) / tile), POW_THREADS, 0,
               (cudaStream_t)stream>>>(c, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
