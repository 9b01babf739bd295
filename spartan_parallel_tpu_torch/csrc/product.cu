// K6: the grand-product circuits of SPARK on the card.
//
// Replaces the JAX package's models/product_tree.py kernels:
//   _layer_mul (:42): the next layer of a product tree, left * right split
//     into its two halves; here for a stack of B trees in one launch;
//   _batched_cubic_evals (:102) and _batched_cubic_evals_seq (:119): one
//     round of the batched layer sumcheck, per instance b the sums over
//     the pairs (i, i + h) of A B C at the points 0, 2 and 3 of the top
//     variable, with C one table shared by every instance (the eq table,
//     batch stride 0) or one per instance (the dot-product circuits,
//     batch stride n).
// The fold of the round's challenge (_batched_fold, :136) is K1's fq_bind.
//
// Bound on the card: bytes. A layer reads 2 and writes 1 element per
// product (64 B each, one Montgomery product); a round reads the A, B and
// C tables once and does 6 products per pair (e0, e2, e3 of a triple
// product), which is below the card's multiply rate at these byte counts.
//
// Layout: (B, n, 16) int32 limb tensors, the JAX layout. The round kernel
// gives a block one chunk of one instance's pairs (grid.y = instance) and
// sums the block's three values in shared memory (reduce.cuh); a second
// kernel sums the per-chunk partials into the (B, 3, 16) output.
#include <cuda_runtime.h>

#include "reduce.cuh"

#define PT_CHUNK 2048  // pairs per block of k_cubic

// nl[b, i] = left[b, i] right[b, i] and nr[b, i] = left[b, h + i]
// right[b, h + i] for i < h = n / 2.
__global__ void k_layer_mul(const int32_t* __restrict__ left,
                            const int32_t* __restrict__ right,
                            int32_t* __restrict__ nl, int32_t* __restrict__ nr,
                            long long B, long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= B * n) return;
  const long long b = e / n, i = e % n, h = n / 2;
  uint32_t x[8], y[8];
  load16(left + 16 * e, x);
  load16(right + 16 * e, y);
  fq_mul(x, x, y);
  store16(i < h ? nl + 16 * (b * h + i) : nr + 16 * (b * h + i - h), x);
}

// Partial sums over one chunk of instance blockIdx.y's pairs; A and B are
// (B, 2h), C is addressed at batch stride c_stride (0: shared).
__global__ void k_cubic(const int32_t* __restrict__ A,
                        const int32_t* __restrict__ Bt,
                        const int32_t* __restrict__ C, long long h,
                        long long c_stride, uint32_t* __restrict__ part) {
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  const long long b = blockIdx.y;
  const long long i0 = (long long)blockIdx.x * PT_CHUNK;
  const long long i1 = h < i0 + PT_CHUNK ? h : i0 + PT_CHUNK;
  const int32_t* a = A + 16 * b * 2 * h;
  const int32_t* bb = Bt + 16 * b * 2 * h;
  const int32_t* c = C + 16 * b * c_stride;
  uint32_t s0[8], s2[8], s3[8];
  zero8(s0);
  zero8(s2);
  zero8(s3);
  for (long long i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    uint32_t al[8], ah[8], bl[8], bh[8], cl[8], ch[8], t[8];
    load16(a + 16 * i, al);
    load16(a + 16 * (i + h), ah);
    load16(bb + 16 * i, bl);
    load16(bb + 16 * (i + h), bh);
    load16(c + 16 * i, cl);
    load16(c + 16 * (i + h), ch);
    // t = 0
    fq_mul(t, al, bl);
    fq_mul(t, t, cl);
    fq_add(s0, s0, t);
    // t = 2: 2 hi - lo; then t = 3: that + (hi - lo), in place
    uint32_t a2[8], b2[8], c2[8];
    fq_ext2(a2, al, ah);
    fq_ext2(b2, bl, bh);
    fq_ext2(c2, cl, ch);
    fq_mul(t, a2, b2);
    fq_mul(t, t, c2);
    fq_add(s2, s2, t);
    fq_ext3(a2, a2, al, ah);
    fq_ext3(b2, b2, bl, bh);
    fq_ext3(c2, c2, cl, ch);
    fq_mul(t, a2, b2);
    fq_mul(t, t, c2);
    fq_add(s3, s3, t);
  }
  block_sum(s0, sh);
  block_sum(s2, sh);
  block_sum(s3, sh);
  if (threadIdx.x == 0) {
    const long long nch = gridDim.x;
    copy8(part + 8 * ((3 * b + 0) * nch + blockIdx.x), s0);
    copy8(part + 8 * ((3 * b + 1) * nch + blockIdx.x), s2);
    copy8(part + 8 * ((3 * b + 2) * nch + blockIdx.x), s3);
  }
}

extern "C" {

// left, right (B, n, 16); nl, nr (B, n / 2, 16); n even.
int pt_layer_mul_launch(const int32_t* left, const int32_t* right,
                        int32_t* nl, int32_t* nr, long long B, long long n,
                        void* stream) {
  const long long total = B * n;
  if (total > 0)
    k_layer_mul<<<(unsigned)((total + 255) / 256), 256, 0,
                  (cudaStream_t)stream>>>(left, right, nl, nr, B, n);
  return (int)cudaGetLastError();
}

// A, B (Bn, 2h, 16); C (2h, 16) with c_stride 0 or (Bn, 2h, 16) with
// c_stride 2h; part: Bn * 3 * ceil(h / PT_CHUNK) scratch values of 8
// words; out (Bn, 3, 16). h >= 1, Bn <= 65535.
int pt_cubic_launch(const int32_t* A, const int32_t* B, const int32_t* C,
                    uint32_t* part, int32_t* out, long long Bn, long long h,
                    long long c_stride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nch = (h + PT_CHUNK - 1) / PT_CHUNK;
  dim3 grid((unsigned)nch, (unsigned)Bn);
  k_cubic<<<grid, REDUCE_THREADS, 0, s>>>(A, B, C, h, c_stride, part);
  reduce_partials<<<(unsigned)(3 * Bn), REDUCE_THREADS, 0, s>>>(part, nch,
                                                                out);
  return (int)cudaGetLastError();
}

}  // extern "C"
