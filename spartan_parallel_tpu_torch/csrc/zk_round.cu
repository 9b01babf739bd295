// K8-K11: the device-resident ZK sumcheck round of the JAX package's
// ops/transcript_dev.py, ops/ristretto_dev.py and ops/zk_round.py.
//
// K8 keccak_kernel: replaces transcript_dev.py _f1600/permute. N
//   independent 200-byte states, one thread each. The path runs this code
//   inside K11; K8 alone is the kernel-level check of it. Bound by
//   operations (24 rounds of ~100 64-bit logic operations a state, each
//   two 32-bit ones): per thread a serial chain.
// K9 compress_kernel: replaces ristretto_dev.py compress (with pow_p58 and
//   sqrt_ratio_m1). One point a thread: ~265 field products of the
//   (p - 5) / 8 power, latency-bound on one thread, so the batch needs
//   many points to fill the card. Bound by operations.
// K10 comb_kernel: replaces ristretto_dev.py comb_commit, zk_round.py
//   comb_commit and the point sum of curve.py tree_reduce. One block of 64
//   threads per commitment: thread w adds the n table entries of nibble w
//   (n point additions), then the 64 sums add up by halving in shared
//   memory. Bound by operations (about 64 n + 63 additions); a commitment
//   reads 64 n table entries of 256 bytes.
// K11 zk_round_tail_kernel: replaces zk_round.py _zk_round_tail (with
//   _coeffs_from_evals and _poly_eval). One block per round: thread 0 runs
//   the transcript and the scalar steps (csrc/zk_round.cuh), the 64
//   threads the four comb sums. A round is a dependent chain of four
//   compressions, ~15 Keccak permutations and four comb sums on one SM, so
//   its bound is one SM's share of the card, not the card's.
//
// Each entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "zk_round.cuh"

#define COMB_MAX_GENS 8

__global__ void keccak_kernel(const int32_t* __restrict__ in,
                              int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint8_t st[200];
  for (int k = 0; k < 200; ++k) st[k] = (uint8_t)in[200 * i + k];
  keccak_bytes(st);
  for (int k = 0; k < 200; ++k) out[200 * i + k] = st[k];
}

__global__ void compress_kernel(const int32_t* __restrict__ pts,
                                int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p;
  pt_load(p, pts + 64 * i);
  uint8_t b[32];
  ristretto_compress(b, p);
  bytes_store(out + 32 * i, b);
}

// The comb sum of one commitment over the block's 64 threads; the point
// lands in sh[0], visible to every thread on return.
__device__ void comb_block(Point* sh, const int32_t* tab, int n,
                           const uint32_t (*canon)[8]) {
  const int t = threadIdx.x;
  comb_window(sh[t], tab, n, canon, t);
  __syncthreads();
  for (int s = COMB_WINDOWS / 2; s > 0; s >>= 1) {
    if (t < s) pt_add_c(sh[t], sh[t], sh[t + s]);
    __syncthreads();
  }
}

__global__ void comb_kernel(const int32_t* __restrict__ tab, int n,
                            const int32_t* __restrict__ scal,
                            int32_t* __restrict__ out) {
  __shared__ uint32_t canon[COMB_MAX_GENS][8];
  __shared__ Point sh[COMB_WINDOWS];
  const int t = threadIdx.x;
  if (t < n) {
    uint32_t x[8];
    load16(scal + (blockIdx.x * (long long)n + t) * 16, x);
    fq_canon(canon[t], x);
  }
  __syncthreads();
  comb_block(sh, tab, n, canon);
  if (t == 0) pt_store(out + 64 * (long long)blockIdx.x, sh[0]);
}

__global__ void zk_round_tail_kernel(const int32_t* __restrict__ evs, int k,
                                     int32_t* st_io, int32_t* carry,
                                     const int32_t* __restrict__ tape,
                                     int32_t* __restrict__ out,
                                     const int32_t* __restrict__ tab_n,
                                     int n_n,
                                     const int32_t* __restrict__ tab_1) {
  __shared__ ZkTail z;
  __shared__ Point sh[COMB_WINDOWS];
  const bool lead = threadIdx.x == 0;
  if (lead) zk_tail_load(z, evs, k, st_io, carry, tape);
  __syncthreads();
  comb_block(sh, tab_n, n_n, z.sc);
  if (lead) zk_tail_poly(z, sh[0]);
  __syncthreads();
  comb_block(sh, tab_1, 2, z.sc);
  if (lead) zk_tail_eval(z, sh[0]);
  __syncthreads();
  comb_block(sh, tab_1, 2, z.sc);
  if (lead) zk_tail_cy(z, sh[0]);
  __syncthreads();
  comb_block(sh, tab_1, 2, z.sc);
  if (lead) zk_tail_finish(z, sh[0], st_io, carry, out);
}

extern "C" {

int keccak_launch(const int32_t* in, int32_t* out, long long n,
                  cudaStream_t stream) {
  const int threads = 128;
  keccak_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                  stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

int compress_launch(const int32_t* pts, int32_t* out, long long n,
                    cudaStream_t stream) {
  const int threads = 128;
  compress_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                    stream>>>(pts, out, n);
  return (int)cudaGetLastError();
}

int comb_launch(const int32_t* tab, int n, const int32_t* scal,
                int32_t* out, long long batch, cudaStream_t stream) {
  if (n < 1 || n > COMB_MAX_GENS) return (int)cudaErrorInvalidValue;
  comb_kernel<<<(unsigned)batch, COMB_WINDOWS, 0, stream>>>(tab, n, scal,
                                                            out);
  return (int)cudaGetLastError();
}

int zk_round_tail_launch(const int32_t* evs, int k, int32_t* st_io,
                         int32_t* carry, const int32_t* tape, int32_t* out,
                         const int32_t* tab_n, int n_n,
                         const int32_t* tab_1, cudaStream_t stream) {
  if (n_n != 5) return (int)cudaErrorInvalidValue;
  zk_round_tail_kernel<<<1, COMB_WINDOWS, 0, stream>>>(
      evs, k, st_io, carry, tape, out, tab_n, n_n, tab_1);
  return (int)cudaGetLastError();
}

}  // extern "C"
