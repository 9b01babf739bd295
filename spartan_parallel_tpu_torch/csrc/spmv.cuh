// K3's work split (csrc/spmv.cu), shared with its host model
// (host_check.cpp host_spmv_many), which the CPU tests hold against the
// plain version on crowded and ragged matrices.
//
// A launch's items are, for each problem j (a matrix and an instance, Q_j
// right-hand sides) in turn, the entries of every right-hand side (rhs q's
// entry e is item off_j + q nnz_j + e, entries sorted by segment: the row
// of a CSR, the column of a CSC), then the segments without an entry, one
// item each (a zero write). Every item adds to one segment, and a
// segment's items are consecutive: [a, b). Warp w owns the items
// [w R, (w + 1) R), R = SPMV_RANGE, and a segment belongs to the warp
// whose range holds its first item. The owner of the segment open at its
// range's end finishes it when it ends at most SPMV_CAP items past the
// range; the next warp then skips those items. A longer segment is "long":
// each warp it crosses sums its items in the range into a partial (the
// owner's tail partial, the others' head partials), and the launch's last
// block adds them up. So a warp walks at most SPMV_RANGE + SPMV_CAP items.
#pragma once
#include "limbs.cuh"

#define SPMV_RANGE 256  // items a warp owns: 8 steps of 32
#define SPMV_CAP 256    // items past its range a warp finishes a segment
#define SPMV_META 5     // a matrix: ptr offset, entry offset, nnz, empty
                        // offset, empty segments

// A launch's problems (the kernel keeps them in shared memory): the first
// item of each, and its matrix's offsets into the stacked arrays.
struct SpmvProbs {
  const long long* off;  // nprob + 1
  const long long *nnz, *nemp, *ent, *emp, *ptr;
  const int* q;  // right-hand sides
  int nprob;
};

// where a problem's operand and output lie: instance i = j / kk reads
// x[i xis + q xqs + idx] and matrix k = j % kk of it writes
// out[k oks + i ois + rev(q) oqs + rev(s)] (element offsets; rev reverses
// the low `bits` bits, none when bits is 0)
struct SpmvMap {
  long long xis, xqs, oks, ois, oqs;
  int kk, qbits, sbits;
};

struct SpmvItem {
  int j;           // problem
  long long q, s;  // right-hand side, segment
  long long e;     // stacked entry index, -1 for an empty segment
  long long a, b;  // the segment's items
};

// the last problem whose first item is at most d (problems without items
// share their offset with the next one)
HD int spmv_prob(const SpmvProbs& P, long long d) {
  int lo = 0, hi = P.nprob - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (P.off[mid] <= d)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

HD void spmv_decode(const SpmvProbs& P, const int32_t* ptr,
                    const int32_t* seg, const int32_t* empty, long long d,
                    SpmvItem& it) {
  const int j = spmv_prob(P, d);
  const long long u = d - P.off[j], nnz = P.nnz[j];
  const long long ents = (long long)P.q[j] * nnz;
  it.j = j;
  if (u < ents) {
    const long long q = u < nnz ? 0 : u / nnz, e = u - q * nnz;
    const long long base = P.off[j] + q * nnz;
    it.q = q;
    it.e = P.ent[j] + e;
    it.s = seg[it.e];
    it.a = base + ptr[P.ptr[j] + it.s];
    it.b = base + ptr[P.ptr[j] + it.s + 1];
  } else {
    const long long v = u - ents, ne = P.nemp[j];
    const long long q = v < ne ? 0 : v / ne;
    it.q = q;
    it.e = -1;
    it.s = empty[P.emp[j] + v - q * ne];
    it.a = d;
    it.b = d + 1;
  }
}

HD long long spmv_rev(long long v, int bits) {
  if (!bits) return v;
#ifdef __CUDA_ARCH__
  return (long long)(__brev((unsigned)v) >> (32 - bits));
#else
  long long r = 0;
  for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1) << (bits - 1 - i);
  return r;
#endif
}

// the output element an item adds to (the key of its segment)
HD long long spmv_out(const SpmvMap& M, const SpmvItem& it) {
  return (it.j % M.kk) * M.oks + (it.j / M.kk) * M.ois +
         spmv_rev(it.q, M.qbits) * M.oqs + spmv_rev(it.s, M.sbits);
}

// the operand element an entry item multiplies its value by
HD long long spmv_x(const SpmvMap& M, const SpmvItem& it,
                    const int32_t* idx) {
  return (it.j / M.kk) * M.xis + it.q * M.xqs + idx[it.e];
}

// The items warp w processes, [start, end); head_b > 0: the segment open
// at the range's start is long, and its items before head_b go to the
// warp's head partial; tail_b > 0: the warp owns the long segment open at
// its range's end (its items end at tail_b), and its items up to `end`
// go to the warp's tail partial.
struct SpmvRange {
  long long start, end, head_b, tail_b;
};

HD SpmvRange spmv_range(const SpmvProbs& P, const int32_t* ptr,
                        const int32_t* seg, const int32_t* empty,
                        long long w, long long total) {
  const long long r0 = w * SPMV_RANGE;
  const long long r1 = total < r0 + SPMV_RANGE ? total : r0 + SPMV_RANGE;
  SpmvRange r{r0, r1, 0, 0};
  SpmvItem it;
  spmv_decode(P, ptr, seg, empty, r0, it);
  if (it.a < r0) {  // a segment that began in an earlier range
    const long long owner_end = (it.a / SPMV_RANGE + 1) * SPMV_RANGE;
    if (it.b <= owner_end + SPMV_CAP)
      r.start = it.b < r1 ? it.b : r1;  // its owner finishes it
    else
      r.head_b = it.b;
  }
  if (r.start < r1) {
    spmv_decode(P, ptr, seg, empty, r1 - 1, it);
    if (it.b > r1 && it.a >= r0) {
      if (it.b <= r1 + SPMV_CAP)
        r.end = it.b;
      else
        r.tail_b = it.b;
    }
  }
  return r;
}
