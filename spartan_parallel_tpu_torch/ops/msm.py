"""Batched multi-scalar multiplication (K2).

Counterpart of the JAX package's ops/msm.py: B rows of scalars share one
set of N points (the Hyrax row-commitment shape), out[b] = sum_n
scalars[b, n] * points[n]. `msm_dev` launches csrc/msm.cu (Pippenger with
8-bit windows, one block per row and window) on CUDA tensors and takes
`msm_plain` on CPU tensors. Replaces ops/msm.py _msm_sorted; bound on the
card by operations (point additions of 9 products mod p), see csrc/msm.cu.
"""

from __future__ import annotations

import torch

from ..core.edwards import RistrettoPoint
from . import curve, kernels

NWIN = 32  # 8-bit windows of a 256-bit scalar (csrc/msm.cu)


def msm_plain(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Fixed 8-bit windows: a table of 256 multiples of every point, then
    per window one gathered point per (row, point), summed by halving, and
    Horner over the windows from the top."""
    n = points.shape[0]
    tab = curve.multiples(points, 256)  # (256, N, 4, 16)
    cols = torch.arange(n, device=points.device)
    acc = None
    for w in range(NWIN - 1, -1, -1):
        if acc is not None:
            for _ in range(8):
                acc = curve.point_double(acc)
        s = curve.tree_sum(tab[curve._digits(scalars, w), cols], dim=1)
        acc = s if acc is None else curve.point_add(acc, s)
    return acc


def msm_dev(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """points (N, 4, 16); scalars (B, N, 16) or (N, 16) canonical limbs
    (< l). Returns (B, 4, 16) points on the tensors' device."""
    if scalars.dim() == 2:
        scalars = scalars[None]
    b, n = scalars.shape[:2]
    if points.shape != (n, 4, 16) or scalars.shape[-1] != 16:
        raise ValueError(f"msm shapes {tuple(points.shape)} x "
                         f"{tuple(scalars.shape)}")
    if points.device.type == "cpu":
        return msm_plain(points, scalars)
    if b > 65535:  # rows are the kernel's grid.y
        raise ValueError(f"msm_dev takes at most 65535 rows, got {b}")
    points, scalars = points.contiguous(), scalars.contiguous()
    kernels.require_cuda(points, scalars)
    win = torch.empty((b * NWIN, 32), dtype=torch.int32, device=points.device)
    out = torch.empty((b, 4, 16), dtype=torch.int32, device=points.device)
    kernels.launch("msm_batched", "msm_launch", points.data_ptr(),
                   scalars.data_ptr(), win.data_ptr(), out.data_ptr(), b, n,
                   kernels.stream(points))
    return out


def msm(points: torch.Tensor, scalars: torch.Tensor) -> list:
    """Batched MSM; returns a list of B RistrettoPoint (host)."""
    return curve.decode_points(msm_dev(points, scalars))


def msm_single(points: torch.Tensor, scalars: torch.Tensor) -> RistrettoPoint:
    return msm(points, scalars)[0]
