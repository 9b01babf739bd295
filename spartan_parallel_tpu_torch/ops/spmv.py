"""Sparse R1CS products over the scalar field (K3).

Counterpart of the JAX package's ops/spmv.py. Matrices of one shape live
on a device as a `Stack`, built once on the host (models/r1csinstance.py):
every matrix's entries sorted by segment (the row of a CSR for Az/Bz/Cz,
the column of a CSC for the phase-2 tables M^T eq(rx)), with each entry's
segment, its index into the operand, its value in Montgomery form, each
matrix's pointer and its segments without an entry. `spmv_many` computes
every product of a call, every matrix and right-hand side, in one launch
of csrc/spmv.cu k_spmv; `sparse_eval_many` every M(rx, ry) of a stack in
one launch of k_sparse_eval. The single-matrix entry points
(`spmv_batched`, `eval_table`, `sparse_eval`) run on the same kernels.
CUDA tensors launch the kernels; CPU tensors take the plain versions.
Accumulation is exact in the field, so the JAX package's 2^15
entries-a-row bound does not apply. Bound on the card by bytes, see
csrc/spmv.cu.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import fq, kernels

SPMV_RANGE = 256     # csrc/spmv.cuh: items a warp owns
SPMV_CAP = 256       # csrc/spmv.cuh: a longer segment leaves partials
SPMV_MAX_INST = 64   # csrc/spmv.cu: instances of one launch
_EVAL_THREADS = 256  # csrc/reduce.cuh REDUCE_THREADS
# blocks of k_sparse_eval an SM its entries a thread aim at (up to 16 a
# thread): at 2^20 entries 2 ran faster than 4 on an H100 (PERF.md)
_EVAL_BLOCKS_PER_SM = 2


class Stack(NamedTuple):
    """Matrices with `nseg` segments each, stacked. ptr: every matrix's
    pointer (nseg + 1 entry offsets from 0); seg, idx, vals: every entry's
    segment, operand index and (16,) Montgomery value, sorted by segment
    within its matrix; empty: each matrix's segments without an entry;
    meta (device) and host: a matrix's (ptr offset, entry offset, nnz,
    empty offset, empty segments); longest: the most entries of a
    segment."""
    ptr: torch.Tensor
    seg: torch.Tensor
    idx: torch.Tensor
    vals: torch.Tensor
    empty: torch.Tensor
    meta: torch.Tensor
    host: np.ndarray
    nseg: int
    longest: int


def stack(mats, nseg: int, device) -> Stack:
    """mats: (major, minor, vals) numpy arrays of each matrix, the entries
    in any order, major < nseg (the segment), vals (nnz, 16) Montgomery
    limbs. The pointers and empty segments come from counts on the host;
    the entries go to `device` once and are sorted there (a matrix already
    sorted by segment is copied as it is)."""
    mats = [(np.asarray(a, dtype=np.int32), np.asarray(b, dtype=np.int32),
             np.asarray(v, dtype=np.int32).reshape(-1, 16))
            for a, b, v in mats]
    counts = [np.bincount(a, minlength=nseg) for a, _, _ in mats]
    emps = [np.flatnonzero(c == 0).astype(np.int32) for c in counts]
    m, nnz, ne = len(mats), [len(a) for a, _, _ in mats], \
        [len(e) for e in emps]
    host = np.zeros((m, 5), dtype=np.int64)
    host[:, 0] = np.arange(m) * (nseg + 1)
    host[:, 1] = np.cumsum([0] + nnz)[:m]
    host[:, 2] = nnz
    host[:, 3] = np.cumsum([0] + ne)[:m]
    host[:, 4] = ne
    ptr = np.zeros(m * (nseg + 1), dtype=np.int32)
    seg = torch.empty(sum(nnz), dtype=torch.int32, device=device)
    idx = torch.empty_like(seg)
    vals = torch.empty((sum(nnz), 16), dtype=torch.int32, device=device)
    for (major, minor, vm), cnt, (po, eo, n, _, _) in zip(mats, counts,
                                                          host.tolist()):
        np.cumsum(cnt, dtype=np.int32, out=ptr[po + 1:po + nseg + 1])
        sl = slice(eo, eo + n)
        if n == 0 or np.all(major[1:] >= major[:-1]):
            for dst, src in ((seg, major), (idx, minor), (vals, vm)):
                dst[sl].copy_(torch.from_numpy(src))
            continue
        major_d = torch.from_numpy(major).to(device)
        perm = torch.argsort(major_d, stable=True)
        torch.index_select(major_d, 0, perm, out=seg[sl])
        for dst, src in ((idx, minor), (vals, vm)):
            torch.index_select(torch.from_numpy(src).to(device), 0, perm,
                               out=dst[sl])
    empty = np.concatenate(emps) if m else np.zeros(0, dtype=np.int32)
    longest = max((int(c.max()) for c in counts if len(c)), default=0)
    return Stack(torch.from_numpy(ptr).to(device), seg, idx, vals,
                 torch.from_numpy(empty).to(device),
                 torch.from_numpy(host).to(device), host, nseg, longest)


def matrix(st: Stack, m: int):
    """Matrix m of a stack: (ptr, seg, idx, vals) views."""
    po, eo, nnz, _, _ = (int(v) for v in st.host[m])
    return (st.ptr[po:po + st.nseg + 1], st.seg[eo:eo + nnz],
            st.idx[eo:eo + nnz], st.vals[eo:eo + nnz])


def _segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """Field sums of vals (..., nnz, 16) by segment id along the entry axis:
    lazy int64 limb sums, then one resolve."""
    shape = vals.shape[:-2] + (n, 16)
    acc = torch.zeros(shape, dtype=torch.int64, device=vals.device)
    acc.index_add_(vals.dim() - 2, seg, vals.to(torch.int64))
    return fq.resolve_plain(acc)


def _rev(v: torch.Tensor, bits: int) -> torch.Tensor:
    """v with its low `bits` bits reversed (v itself when bits is 0)."""
    if not bits:
        return v
    out = torch.zeros_like(v)
    for i in range(bits):
        out |= ((v >> i) & 1) << (bits - 1 - i)
    return out


def spmv_many_plain(st: Stack, x, out, counts, mats, kk: int, x_strides,
                    out_strides, bits=(0, 0)) -> torch.Tensor:
    """The plain version of spmv_many, into out; returns out."""
    xs, os_ = x.reshape(-1, 16), out.view(-1, 16)
    xis, xqs = x_strides
    oks, ois, oqs = out_strides
    srev = _rev(torch.arange(st.nseg, device=out.device), bits[1])
    for i, q_count in enumerate(counts):
        q = torch.arange(q_count, device=out.device)
        for k in range(kk):
            _, seg, idx, vals = matrix(st, kk * mats[i] + k)
            xg = xs[(i * xis + q * xqs)[:, None] + idx.to(torch.int64)]
            res = _segment_sum_plain(fq.mul_plain(vals, xg),
                                     seg.to(torch.int64), st.nseg)
            at = k * oks + i * ois + _rev(q, bits[0])[:, None] * oqs + srev
            os_[at.reshape(-1)] = res.reshape(-1, 16)
    return out


def spmv_many(st: Stack, x: torch.Tensor, out: torch.Tensor, counts, mats,
              kk: int, x_strides, out_strides, bits=(0, 0),
              counter: str = "spmv_batched") -> torch.Tensor:
    """Every product of a call: for instance i (counts[i] right-hand sides
    q) and its matrix k < kk (the stack's matrix kk * mats[i] + k),

        out[k oks + i ois + rev(q) oqs + rev(s)] =
            sum over segment s's entries of val * x[i xis + q xqs + idx]

    with offsets in elements of x and out (each a contiguous (..., 16)
    tensor), (xis, xqs) = x_strides, (oks, ois, oqs) = out_strides, and
    rev reversing the low bits[0] bits of q and bits[1] of s (bits of 0:
    none). Every segment of every (instance, k, q) is written, empty ones
    as zero; nothing else of out is. On the card one launch (counted under
    `counter`) for up to SPMV_MAX_INST instances. Returns out."""
    if out.device.type == "cpu":
        return spmv_many_plain(st, x, out, counts, mats, kk, x_strides,
                               out_strides, bits)
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("spmv_many takes contiguous tensors")
    kernels.require_cuda(x, out, st.ptr, st.seg, st.idx, st.vals, st.empty)
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("spmv_many reads and writes 16-byte aligned tables")
    has_long = st.longest > SPMV_CAP
    ni, per = len(counts), st.host[:, 2] + st.host[:, 4]
    for g in range(0, ni, SPMV_MAX_INST):
        cs = [int(c) for c in counts[g:g + SPMV_MAX_INST]]
        ms = [int(m) for m in mats[g:g + SPMV_MAX_INST]]
        off = [0]
        for c, m in zip(cs, ms):
            for k in range(kk):
                off.append(off[-1] + c * int(per[kk * m + k]))
        total = off[-1]
        if total == 0:
            continue
        warps = -(-total // SPMV_RANGE)
        pend = longs = None
        if has_long:
            pend = torch.empty((warps, 16), dtype=torch.int32,
                               device=out.device)
            longs = torch.empty((warps, 3), dtype=torch.int64,
                                device=out.device)
        # the launch reads these host arrays: keep them alive until then
        geom = (ctypes.c_longlong * 5)(*x_strides, *out_strides)
        flags = (ctypes.c_int * 4)(kk, bits[0], bits[1], int(has_long))
        minst = (ctypes.c_int * len(ms))(*ms)
        q = (ctypes.c_int * len(cs))(*cs)
        offs = (ctypes.c_longlong * len(off))(*off)
        kernels.launch(
            counter, "spmv_many_launch", st.ptr.data_ptr(),
            st.seg.data_ptr(), st.idx.data_ptr(), st.vals.data_ptr(),
            st.empty.data_ptr(), st.meta.data_ptr(),
            x.data_ptr() + 64 * g * x_strides[0],
            out.data_ptr() + 64 * g * out_strides[1], ctypes.addressof(geom),
            ctypes.addressof(flags), ctypes.addressof(minst),
            ctypes.addressof(q), len(cs), ctypes.addressof(offs),
            0 if pend is None else pend.data_ptr(),
            0 if longs is None else longs.data_ptr(), kernels.stream(out))
    return out


def sparse_eval_many_plain(st: Stack, rx_tab, ry_tab) -> torch.Tensor:
    out = []
    for m in range(len(st.host)):
        _, seg, idx, vals = matrix(st, m)
        t = fq.mul_plain(rx_tab[seg.to(torch.int64)],
                         ry_tab[idx.to(torch.int64)])
        out.append(fq.sum_plain(fq.mul_plain(t, vals), 0))
    return torch.stack(out)


def sparse_eval_many(st: Stack, rx_tab: torch.Tensor,
                     ry_tab: torch.Tensor) -> torch.Tensor:
    """M(rx, ry) = sum val * eq_rx[seg] * eq_ry[idx] of every matrix of
    the stack (sparse_mlpoly.rs:427; a CSR stack: seg the row, idx the
    column), as (M, 16) Montgomery. On the card one launch for up to
    3 * SPMV_MAX_INST matrices, counted as sparse_eval."""
    if rx_tab.device.type == "cpu":
        return sparse_eval_many_plain(st, rx_tab, ry_tab)
    rx_tab, ry_tab = rx_tab.contiguous(), ry_tab.contiguous()
    kernels.require_cuda(rx_tab, ry_tab, st.seg, st.idx, st.vals)
    if rx_tab.data_ptr() % 16 or ry_tab.data_ptr() % 16:
        raise ValueError("sparse_eval reads 16-byte aligned tables")
    n_mat = len(st.host)
    out = torch.empty((n_mat, 16), dtype=torch.int32, device=rx_tab.device)
    nnz = st.host[:, 2]
    # entries a thread: enough blocks for _EVAL_BLOCKS_PER_SM an SM
    per = -(-int(nnz.sum()) // (_EVAL_THREADS * _EVAL_BLOCKS_PER_SM
                                * kernels.sms(rx_tab.device)))
    per = min(max(per, 1), 16)
    span = _EVAL_THREADS * per
    group = 3 * SPMV_MAX_INST
    for g in range(0, n_mat, group):
        chunk0 = [0]  # every matrix at least one block
        for n in nnz[g:g + group].tolist():
            chunk0.append(chunk0[-1] + max(1, -(-n // span)))
        part = torch.empty((chunk0[-1], 8), dtype=torch.int32,
                           device=rx_tab.device)
        first = (ctypes.c_int * len(chunk0))(*chunk0)
        kernels.launch(
            "sparse_eval", "sparse_eval_many_launch", st.seg.data_ptr(),
            st.idx.data_ptr(), st.vals.data_ptr(),
            st.meta[g:].data_ptr(), rx_tab.data_ptr(), ry_tab.data_ptr(),
            ctypes.addressof(first), len(chunk0) - 1, per, part.data_ptr(),
            out[g].data_ptr(), kernels.stream(rx_tab))
    return out


# --------------------------------------------------------------------------
# One matrix (a stack of one)
# --------------------------------------------------------------------------
def spmv_plain(st: Stack, z: torch.Tensor) -> torch.Tensor:
    out = torch.empty((z.shape[0], st.nseg, 16), dtype=torch.int32,
                      device=z.device)
    return spmv_many_plain(st, z, out, [z.shape[0]], [0], 1, (0, z.shape[1]),
                           (0, 0, st.nseg))


def spmv_batched(st: Stack, z: torch.Tensor) -> torch.Tensor:
    """out[q, row] = sum over the row's entries of val * z[q, col]: st a
    CSR stack of one matrix, z (Q, ncols, 16) Montgomery. Returns (Q,
    nrows, 16)."""
    out = torch.empty((z.shape[0], st.nseg, 16), dtype=torch.int32,
                      device=z.device)
    return spmv_many(st, z.contiguous(), out, [z.shape[0]], [0], 1,
                     (0, z.shape[1]), (0, 0, st.nseg))


def eval_table_plain(st: Stack, rx_tab: torch.Tensor) -> torch.Tensor:
    return spmv_plain(st, rx_tab[None])[0]


def eval_table(st: Stack, rx_tab: torch.Tensor) -> torch.Tensor:
    """M^T eq(rx): out[col] = sum over the column's entries of
    eq_rx[row] * val; st a CSC stack of one matrix, rx_tab (nrows, 16).
    Returns (ncols, 16)."""
    out = torch.empty((st.nseg, 16), dtype=torch.int32,
                      device=rx_tab.device)
    return spmv_many(st, rx_tab.contiguous(), out, [1], [0], 1, (0, 0),
                     (0, 0, 0), counter="eval_table")


def sparse_eval_plain(st: Stack, rx_tab, ry_tab) -> torch.Tensor:
    return sparse_eval_many_plain(st, rx_tab, ry_tab)[0]


def sparse_eval(st: Stack, rx_tab, ry_tab) -> torch.Tensor:
    """M(rx, ry) of a CSR stack of one matrix as a (16,) tensor."""
    return sparse_eval_many(st, rx_tab, ry_tab)[0]
