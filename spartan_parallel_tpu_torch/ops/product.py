"""Grand-product circuit kernels of SPARK (K6).

Counterpart of the JAX package's models/product_tree.py kernels: the next
layer of a product tree (_layer_mul, :42), one round of the batched layer
sumcheck (_batched_cubic_evals, :102, with one C table shared by every
instance, and _batched_cubic_evals_seq, :119, with one per instance) and
the bind of its challenge (_batched_fold, :136). Tables are (B, n, 16)
int32 Montgomery limb tensors, B circuits stacked, as in the JAX module.

`layer_mul` and `cubic_evals` launch csrc/product.cu on CUDA tensors and
take their plain versions (*_plain) on CPU tensors; `fold` is K1's
fq_bind, counted as pt_fold. Bound on the card by bytes, see
csrc/product.cu.
"""

from __future__ import annotations

import torch

from . import fq, kernels
from .sumcheck import _ext2, _ext3

_CHUNK = 2048  # csrc/product.cu PT_CHUNK


def _check_stack(*ts) -> None:
    for t in ts:
        if t.dim() != 3 or t.shape[-1] != 16 or t.shape[1] % 2:
            raise ValueError("expected (B, n, 16) limbs with n even, got "
                             f"{tuple(t.shape)}")


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def layer_mul_plain(left: torch.Tensor, right: torch.Tensor):
    prod = fq.mul_plain(left, right)
    h = prod.shape[1] // 2
    return prod[:, :h].contiguous(), prod[:, h:].contiguous()


def cubic_evals_plain(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    h = A.shape[1] // 2
    Al, Ah = A[:, :h], A[:, h:]
    Bl, Bh = B[:, :h], B[:, h:]
    C = C[None] if C.dim() == 2 else C
    Cl, Ch = C[:, :h], C[:, h:]

    def ev(a, b, c):
        return fq.sum_plain(fq.mul_plain(fq.mul_plain(a, b), c), 1)

    A2, B2, C2 = _ext2(Al, Ah), _ext2(Bl, Bh), _ext2(Cl, Ch)
    return torch.stack([
        ev(Al, Bl, Cl), ev(A2, B2, C2),
        ev(_ext3(A2, Al, Ah), _ext3(B2, Bl, Bh), _ext3(C2, Cl, Ch))], 1)


def fold_plain(T: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    axis = T.dim() - 2
    h = T.shape[axis] // 2
    return fq.bind_plain(T, r, axis, h, h)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def layer_mul(left: torch.Tensor, right: torch.Tensor):
    """(B, n, 16) x (B, n, 16) -> the next layer of B product trees as its
    two halves, each (B, n/2, 16)."""
    _check_stack(left, right)
    if left.shape != right.shape:
        raise ValueError("left and right differ in shape")
    if left.device.type == "cpu" and right.device.type == "cpu":
        return layer_mul_plain(left, right)
    left, right = left.contiguous(), right.contiguous()
    kernels.require_cuda(left, right)
    B, n = left.shape[:2]
    nl = torch.empty((B, n // 2, 16), dtype=torch.int32, device=left.device)
    nr = torch.empty_like(nl)
    kernels.launch("pt_layer_mul", "pt_layer_mul_launch", left.data_ptr(),
                   right.data_ptr(), nl.data_ptr(), nr.data_ptr(), B, n,
                   kernels.stream(left))
    return nl, nr


def cubic_evals(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor):
    """Per instance b: (e0, e2, e3) of sum_i A B C over the pairs of the
    top variable, as a (B, 3, 16) tensor. A, B: (B, n, 16); C: (n, 16)
    shared by every instance (counted as pt_cubic_round) or (B, n, 16) one
    per instance (pt_cubic_round_seq)."""
    _check_stack(A, B, C if C.dim() == 3 else C[None])
    shared = C.dim() == 2
    if A.shape != B.shape or C.shape != (A.shape[1:] if shared else A.shape):
        raise ValueError("cubic round table shapes disagree")
    if A.device.type == "cpu":
        return cubic_evals_plain(A, B, C)
    A, B, C = A.contiguous(), B.contiguous(), C.contiguous()
    kernels.require_cuda(A, B, C)
    Bn, n = A.shape[:2]
    h = n // 2
    if Bn > 65535 or h == 0:
        raise ValueError("at most 65535 instances of at least one pair")
    nch = -(-h // _CHUNK)
    part = torch.empty((3 * Bn * nch, 8), dtype=torch.int32, device=A.device)
    out = torch.empty((Bn, 3, 16), dtype=torch.int32, device=A.device)
    kernels.launch("pt_cubic_round" if shared else "pt_cubic_round_seq",
                   "pt_cubic_launch", A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), part.data_ptr(), out.data_ptr(), Bn, h,
                   0 if shared else n, kernels.stream(A))
    return out


def fold(T: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Bind the top variable of each table, lo + r (hi - lo) over the
    halves of axis -2: (..., n, 16) -> (..., n/2, 16) (K1 fq_bind, counted
    as pt_fold)."""
    axis = T.dim() - 2
    h = T.shape[axis] // 2
    return fq.bind(T, r, axis, h, h, counter="pt_fold")
