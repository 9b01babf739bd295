"""Sparse R1CS products over the scalar field (K3).

Counterpart of the JAX package's ops/spmv.py. The matrix arrives in
compressed form, built once on the host (models/r1csinstance.py): CSR for
Az/Bz/Cz, CSC for the phase-2 tables M^T eq(rx), COO for the verifier's
M(rx, ry). Each wrapper launches csrc/spmv.cu on CUDA tensors and takes
its plain version on CPU tensors. Accumulation is exact in the field, so
the JAX package's 2^15-entries-per-row bound does not apply. Bound on the
card by bytes (scattered 64 B gathers per entry), see csrc/spmv.cu.
"""

from __future__ import annotations

import torch

from . import fq, kernels

_EVAL_CHUNK = 4096  # csrc/spmv.cu EVAL_CHUNK


def _segment_sum_plain(vals: torch.Tensor, seg: torch.Tensor, n: int):
    """Field sums of vals (..., nnz, 16) by segment id along the entry axis:
    lazy int64 limb sums, then one resolve."""
    shape = vals.shape[:-2] + (n, 16)
    acc = torch.zeros(shape, dtype=torch.int64, device=vals.device)
    acc.index_add_(vals.dim() - 2, seg, vals.to(torch.int64))
    return fq.resolve_plain(acc)


def _expand(ptr: torch.Tensor) -> torch.Tensor:
    """CSR/CSC pointer -> the major index of every entry."""
    counts = (ptr[1:] - ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(ptr.shape[0] - 1, device=ptr.device), counts)


def spmv_plain(ptr, idx, vals, z):
    nrows = ptr.shape[0] - 1
    prod = fq.mul_plain(vals, z[:, idx.to(torch.int64)])  # (Q, nnz, 16)
    return _segment_sum_plain(prod, _expand(ptr), nrows)


def eval_table_plain(ptr, idx, vals, rx_tab):
    ncols = ptr.shape[0] - 1
    prod = fq.mul_plain(vals, rx_tab[idx.to(torch.int64)])
    return _segment_sum_plain(prod, _expand(ptr), ncols)


def sparse_eval_plain(rows, cols, vals, rx_tab, ry_tab):
    t = fq.mul_plain(rx_tab[rows.to(torch.int64)],
                     ry_tab[cols.to(torch.int64)])
    return fq.sum_plain(fq.mul_plain(t, vals), 0)


def _spmv_launch(counter, ptr, idx, vals, z3):
    q, ncols = z3.shape[:2]
    nrows = ptr.shape[0] - 1
    if q > 65535:  # right-hand sides are the kernel's grid.y
        raise ValueError(f"spmv takes at most 65535 right-hand sides, got {q}")
    ptr, idx, vals, z3 = (t.contiguous() for t in (ptr, idx, vals, z3))
    kernels.require_cuda(ptr, idx, vals, z3)
    out = torch.empty((q, nrows, 16), dtype=torch.int32, device=z3.device)
    kernels.launch(counter, "spmv_launch", ptr.data_ptr(), idx.data_ptr(),
                   vals.data_ptr(), z3.data_ptr(), out.data_ptr(), q, nrows,
                   ncols, kernels.stream(z3))
    return out


def spmv_batched(row_ptr, cols, vals, z):
    """out[q, row] = sum over the row's entries of val * z[q, col].

    row_ptr: (nrows + 1,) int32; cols, vals: (nnz,) / (nnz, 16) sorted by
    row; z: (Q, ncols, 16) Montgomery. Returns (Q, nrows, 16)."""
    if z.device.type == "cpu":
        return spmv_plain(row_ptr, cols, vals, z)
    return _spmv_launch("spmv_batched", row_ptr, cols, vals, z)


def eval_table(col_ptr, rows, vals, rx_tab):
    """M^T eq(rx): out[col] = sum over the column's entries of
    eq_rx[row] * val. col_ptr: (ncols + 1,); rows, vals sorted by column;
    rx_tab: (nrows, 16). Returns (ncols, 16)."""
    if rx_tab.device.type == "cpu":
        return eval_table_plain(col_ptr, rows, vals, rx_tab)
    return _spmv_launch("eval_table", col_ptr, rows, vals, rx_tab[None])[0]


def sparse_eval(rows, cols, vals, rx_tab, ry_tab):
    """M(rx, ry) = sum val * eq_rx[row] * eq_ry[col] (sparse_mlpoly.rs:427)
    as a (16,) Montgomery tensor."""
    if rx_tab.device.type == "cpu":
        return sparse_eval_plain(rows, cols, vals, rx_tab, ry_tab)
    rows, cols, vals, rx_tab, ry_tab = (
        t.contiguous() for t in (rows, cols, vals, rx_tab, ry_tab))
    kernels.require_cuda(rows, cols, vals, rx_tab, ry_tab)
    nnz = rows.shape[0]
    out = torch.empty((16,), dtype=torch.int32, device=rx_tab.device)
    if nnz == 0:
        return out.zero_()
    part = torch.empty((-(-nnz // _EVAL_CHUNK), 8), dtype=torch.int32,
                       device=rx_tab.device)
    kernels.launch("sparse_eval", "sparse_eval_launch", rows.data_ptr(),
                   cols.data_ptr(), vals.data_ptr(), rx_tab.data_ptr(),
                   ry_tab.data_ptr(), part.data_ptr(), out.data_ptr(), nnz,
                   kernels.stream(rx_tab))
    return out
