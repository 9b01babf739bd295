"""Batched multi-scalar multiplication (K2).

Counterpart of the JAX package's ops/msm.py: B rows of scalars share one
set of N points (the Hyrax row-commitment shape), out[b] = sum_n
scalars[b, n] * points[n]. `msm_dev` launches csrc/msm.cu on CUDA tensors
(Pippenger with signed 8-bit digits: cached points and digits prepared
once, one warp per row, window and chunk of points, the windows combined
in the same launch) and takes `msm_plain` on CPU tensors.
Replaces ops/msm.py _msm_sorted; bound on the card by operations (bucket
additions of 8 products mod p), see csrc/msm.cu.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.edwards import RistrettoPoint
from . import curve, fp, kernels

NWIN = 32  # 8-bit windows of a 256-bit scalar (csrc/msm.cuh)
MAX_ROWS = 1 << 26  # the window kernel's grid: 32 blocks a row at most


def signed_digits(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 16) canonical limbs -> (..., 32) int64 digits in [-128, 128)
    with s = sum_w d_w 2^(8 w): byte w plus the carry in, less 256 with a
    carry out from 128 up (csrc/msm.cuh signed_digits). A canonical scalar
    (< l) leaves no carry out of window 31."""
    by = torch.stack([scalars & 0xFF, (scalars >> 8) & 0xFF],
                     -1).flatten(-2).long()
    carry = torch.zeros_like(by[..., 0])
    out = []
    for w in range(NWIN):
        v = by[..., w] + carry
        carry = (v >= 128).long()
        out.append(v - (carry << 8))
    return torch.stack(out, -1)


def _neg(p: torch.Tensor) -> torch.Tensor:
    x, y, z, t = p.unbind(-2)
    return torch.stack([fp.neg(x), y, z, fp.neg(t)], -2)


def msm_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """The kernel's signed 8-bit windows: a table of k P for k = 0..128
    of every point, then per window the multiple |d| of each (row,
    point), negated where d < 0, summed by halving, and Horner over the
    windows from the top."""
    n = points.shape[0]
    tab = curve.multiples(points, 128)
    tab = torch.cat([tab, curve.point_double(tab[64])[None]])
    dig = signed_digits(scalars)
    cols = torch.arange(n, device=points.device)
    acc = None
    for w in range(NWIN - 1, -1, -1):
        if acc is not None:
            for _ in range(8):
                acc = curve.point_double(acc)
        d = dig[..., w]
        sel = tab[d.abs(), cols]
        sel = torch.where((d < 0)[..., None, None], _neg(sel), sel)
        s = curve.tree_sum(sel, dim=1)
        acc = s if acc is None else curve.point_add(acc, s)
    return acc


def msm_dev(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """points (N, 4, 16); scalars (B, N, 16) or (N, 16) canonical limbs
    (< l). Returns (B, 4, 16) points on the tensors' device. A launch takes
    up to `chunking(B)[1]` points; more points go in chunks whose sums K12
    adds."""
    if scalars.dim() == 2:
        scalars = scalars[None]
    b, n = scalars.shape[:2]
    if points.shape != (n, 4, 16) or scalars.shape[-1] != 16:
        raise ValueError(f"msm shapes {tuple(points.shape)} x "
                         f"{tuple(scalars.shape)}")
    if points.device.type == "cpu":
        return msm_plain(points, scalars)
    if b >= MAX_ROWS:
        raise ValueError(f"msm_dev takes fewer than {MAX_ROWS} rows, got {b}")
    split, per = chunking(b)
    if n > per:
        return curve.point_sum(torch.stack([
            msm_dev(points[i:i + per], scalars[:, i:i + per])
            for i in range(0, n, per)]))
    points, scalars = points.contiguous(), scalars.contiguous()
    kernels.require_cuda(points, scalars)
    dev = points.device
    cached = torch.empty((n, 32), dtype=torch.int32, device=dev)
    dig = torch.empty((b, NWIN, n), dtype=torch.int8, device=dev)
    part = torch.empty((2 * b * NWIN * split, 32), dtype=torch.int32,
                       device=dev)
    done = torch.empty(b, dtype=torch.int32, device=dev)
    out = torch.empty((b, 4, 16), dtype=torch.int32, device=dev)
    kernels.launch("msm_batched", "msm_launch", points.data_ptr(),
                   scalars.data_ptr(), cached.data_ptr(), dig.data_ptr(),
                   part.data_ptr(), done.data_ptr(), out.data_ptr(), b, n,
                   kernels.stream(points))
    return out


def chunking(rows: int) -> tuple:
    """(chunks a window splits into, most points of one launch) at `rows`
    rows (csrc/msm.cu msm_chunking)."""
    split, most = ctypes.c_int(0), ctypes.c_longlong(0)
    kernels._lib("msm").msm_chunking(rows, ctypes.addressof(split),
                                     ctypes.addressof(most))
    return split.value, most.value


def window_occupancy() -> int:
    """Blocks of the window kernel that fit on one SM of the current card
    (CUDA's occupancy calculator)."""
    blocks = ctypes.c_int(0)
    rc = kernels._lib("msm").msm_window_occupancy(ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"msm_window_occupancy: CUDA error {rc}")
    return blocks.value


def msm(points: torch.Tensor, scalars: torch.Tensor) -> list:
    """Batched MSM; returns a list of B RistrettoPoint (host)."""
    return curve.decode_points(msm_dev(points, scalars))


def msm_single(points: torch.Tensor, scalars: torch.Tensor) -> RistrettoPoint:
    return msm(points, scalars)[0]
