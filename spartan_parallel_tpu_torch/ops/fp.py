"""Base field GF(p), p = 2^255 - 19, as limb tensors: plain PyTorch.

Counterpart of the JAX package's ops/fp.py. Values are fully reduced
(..., 16) int32 limb tensors. On the card this arithmetic runs inside the
K2 kernels (csrc/fp.cuh); these plain versions serve the K2 plain versions
in ops/curve.py and ops/msm.py and the header tests.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.consts import P
from . import limbs as lb

P_LIMBS = lb.int_to_limbs(P)


def encode(xs) -> np.ndarray:
    return lb.ints_to_limbs([int(x) % P for x in xs])


def decode(a) -> list:
    return lb.limbs_to_ints(a)


def const(x: int) -> np.ndarray:
    return lb.int_to_limbs(int(x) % P)


def _reduce(w: torch.Tensor) -> torch.Tensor:
    """(..., 32) canonical int64 limbs -> value mod p, folding the high
    half with 2^256 = 38 (mod p)."""
    x = lb.carry(w[..., :16] + 38 * w[..., 16:], 17)  # < 39 * 2^256
    for _ in range(2):
        y = x[..., :16].clone()
        y[..., 0] += 38 * x[..., 16]
        x = lb.carry(y, 17)
    # x < 2^256 = 2p + 38
    z = lb.cond_sub(x[..., :16], P_LIMBS)
    return lb.cond_sub(z, P_LIMBS)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _reduce(lb.carry(lb.mul_cols(a, b), 32)).to(torch.int32)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = lb.carry(a.to(torch.int64) + b.to(torch.int64), 16)  # < 2p
    return lb.cond_sub(s, P_LIMBS).to(torch.int32)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    pt = torch.as_tensor(P_LIMBS.astype(np.int64), device=a.device)
    s = lb.carry(a.to(torch.int64) + pt - b.to(torch.int64), 16)
    return lb.cond_sub(s, P_LIMBS).to(torch.int32)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)
