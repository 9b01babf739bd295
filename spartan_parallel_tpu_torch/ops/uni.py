"""The powers of one scalar, 1, c, ..., c^(n-1): kernel K7.

Counterpart of the JAX package's models/dense_mlpoly.py _powers_dev
(:200), the table of the univariate evaluations of ShiftProofs
(models/dense_mlpoly.py uni_evaluate, whose sum_i Z_i c^i is one K1
fq_dot counted as rlc_eval). A table is (n, 16) int32 Montgomery limbs,
equal limb for limb to the JAX scan's.

`fq_powers` launches csrc/uni.cu on a CUDA tensor and takes its plain
version, `fq_powers_plain` (a doubling of the table on K1's plain
product), on a CPU tensor. Bound on the card: the launch at the path's
shapes, the n - 1 products at 2^20; see csrc/uni.cu.
"""

from __future__ import annotations

import torch

from . import fq, kernels
from . import limbs as lb


def fq_powers_plain(c: torch.Tensor, n: int) -> torch.Tensor:
    """(16,) Montgomery c -> (n, 16) table [1, c, ..., c^(n-1)]: the
    table doubles, its upper half the lower times c^len."""
    tab = lb.to_device(fq.ONE_MONT, c.device)[None]
    cm = c.reshape(1, 16)
    while tab.shape[0] < n:
        tab = torch.cat([tab, fq.mul_plain(tab, cm)])
        cm = fq.mul_plain(cm, cm)
    return tab[:n]


def fq_powers(c: torch.Tensor, n: int) -> torch.Tensor:
    """(16,) Montgomery c -> (n, 16) Montgomery table [1, c, ...,
    c^(n-1)], n >= 1 (counted as fq_powers)."""
    if c.numel() != 16:
        raise ValueError(f"expected one (16,) element, got {tuple(c.shape)}")
    if n < 1:
        raise ValueError("at least one power")
    if c.device.type == "cpu":
        return fq_powers_plain(c, n)
    c = c.reshape(16).contiguous()
    kernels.require_cuda(c)
    out = torch.empty((n, 16), dtype=torch.int32, device=c.device)
    kernels.launch("fq_powers", "fq_powers_launch", c.data_ptr(),
                   out.data_ptr(), n, kernels.stream(c))
    return out
