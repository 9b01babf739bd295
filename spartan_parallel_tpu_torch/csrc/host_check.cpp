// Host build of the per-element arithmetic in fq.cuh, fp.cuh and curve.cuh
// (g++, no CUDA), so the CPU tests can hold the kernels' arithmetic against
// the plain PyTorch versions. Each entry maps over n elements of 16-limb
// int32 values (points: 4 x 16 limbs).
#include "curve.cuh"
#include "fq.cuh"

extern "C" {

void host_fq_mul(const int32_t* a, const int32_t* b, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(a + 16 * i, x);
    load16(b + 16 * i, y);
    fq_mul(z, x, y);
    store16(out + 16 * i, z);
  }
}

void host_fq_bind(const int32_t* lo, const int32_t* hi, const int32_t* r,
                  int32_t* out, long n) {
  uint32_t rr[8];
  load16(r, rr);
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(lo + 16 * i, x);
    load16(hi + 16 * i, y);
    fq_bind(z, x, y, rr);
    store16(out + 16 * i, z);
  }
}

void host_fq_pow(const int32_t* c, const uint64_t* e, int32_t* out,
                 long n) {
  uint32_t x[8], z[8];
  load16(c, x);
  for (long i = 0; i < n; ++i) {
    fq_pow(z, x, e[i]);
    store16(out + 16 * i, z);
  }
}

void host_fp_mul(const int32_t* a, const int32_t* b, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    uint32_t x[8], y[8], z[8];
    load16(a + 16 * i, x);
    load16(b + 16 * i, y);
    fp_mul(z, x, y);
    store16(out + 16 * i, z);
  }
}

void host_pt_add(const int32_t* p, const int32_t* q, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point a, b;
    pt_load(a, p + 64 * i);
    pt_load(b, q + 64 * i);
    pt_add(a, a, b);
    pt_store(out + 64 * i, a);
  }
}

void host_pt_double(const int32_t* p, int32_t* out, long n) {
  for (long i = 0; i < n; ++i) {
    Point a;
    pt_load(a, p + 64 * i);
    pt_double(a, a);
    pt_store(out + 64 * i, a);
  }
}

}  // extern "C"
