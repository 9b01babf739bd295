"""Grand-product circuit kernels of SPARK (K6).

Counterpart of the JAX package's models/product_tree.py kernels: the
layers of a product tree (_layer_mul, :42, once a layer), one round of the
batched layer sumcheck (_batched_cubic_evals, :102, with one C table
shared by every product instance, and _batched_cubic_evals_seq, :119, with
one per dot-product instance), the bind of its challenge (_batched_fold,
:136) and the round's coefficient sum (prove_cubic_batched, :160-166).
Tables are (rows, n, 16) int32 Montgomery limb tensors, as in the JAX
module; a stack's rows may sit at any row stride (a tree layer's left and
right halves are read in place).

`pt_tree` builds every layer of a stack of trees and its roots, a few
layers a launch; `pt_round` is one round (the bind of the previous
challenge, the evaluations and their sum weighted by the layer's
coefficients) in one launch; `pt_fold` binds a layer's last challenge and
returns its claims in one launch. They launch csrc/product.cu on CUDA
tensors and take their plain versions (*_plain, built from
`layer_mul_plain`, `cubic_evals_plain` and `fold_plain`) on CPU tensors.
Bound on the card by bytes, see csrc/product.cu.
"""

from __future__ import annotations

import torch

from . import fq, kernels
from .sumcheck import _ext2, _ext3

_PT_THREADS = 128  # csrc/product.cu PT_THREADS
_PT_MAX_BLOCKS = 2048  # csrc/product.cu PT_MAX_BLOCKS
_PT_FIN = 1024  # csrc/product.cu PT_FIN
# layers a k_pt_tree_pass launch builds, at most: the time a layer of the
# first pass is least at 4 (chip_smoke.py's `k6_choices` line times 1-4)
_PT_MAX_PASS = 4
# work items a round aims at (about two waves of resident threads) before
# it lets one item take several product rows (their shared C bound once)
_PT_ITEMS = 1 << 17


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"expected a power of two, got {n}")
    return n.bit_length() - 1


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


def pt_tree_plain(leaves: torch.Tensor) -> list:
    """Every layer of B product trees over the rows of leaves (B, N, 16):
    [leaves, layer 1 (B, N/2, 16), ..., the roots (B, 1, 16)], layer k + 1
    the products of the two halves of layer k."""
    layers = [leaves]
    while layers[-1].shape[1] > 1:
        layers.append(torch.cat(layer_mul_plain(
            *torch.chunk(layers[-1], 2, 1)), 1))
    return layers


def pt_round_plain(A, B, C, coef, r=None, seq=None):
    """One round of the batched layer sumcheck: with r, every table bound
    to r first (fold_plain); then sum_k coef_k (e0, e2, e3)_k over the
    product instances (A, B: (Bp, n, 16), C: (n, 16) shared) and the
    dot-product instances (seq: (Aq, Bq, Cq), each (S, n, 16)), as a
    (3, 16) tensor. Returns (evaluations, the bound tables (A, B, C, seq)
    or None)."""
    tabs = (A, B, C) + (tuple(seq) if seq is not None else ())
    if r is not None:
        tabs = tuple(fold_plain(t, r) for t in tabs)
    evs = cubic_evals_plain(*tabs[:3])
    if seq is not None:
        evs = torch.cat([evs, cubic_evals_plain(*tabs[3:])])
    out = fq.sum_plain(fq.mul_plain(evs, coef[:, None]), 0)
    if r is None:
        return out, None
    return out, (*tabs[:3], tabs[3:] if seq is not None else None)


def pt_fold_plain(A, B, C, r, seq=None) -> torch.Tensor:
    """A layer's last bind: every table of 2 entries bound to r; the
    claims A[:, 0], B[:, 0], C[0] and each of seq's [:, 0], stacked as
    (2 Bp + 1 + 3 S, 16)."""
    tabs = [fold_plain(t, r) for t in (A, B, C)]
    tabs = [tabs[0][:, 0], tabs[1][:, 0], tabs[2][:1]]
    if seq is not None:
        tabs += [fold_plain(t, r)[:, 0] for t in seq]
    return torch.cat(tabs)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check_rows(*ts) -> None:
    """(rows, n, 16) int32 limbs on one device, each row contiguous and
    16-byte aligned (the row stride is free)."""
    for t in ts:
        if t.dim() != 3 or t.shape[-1] != 16 or t.stride(2) != 1 or \
                t.stride(1) != 16:
            raise ValueError("expected (rows, n, 16) limbs with contiguous "
                             f"rows, got {tuple(t.shape)} {t.stride()}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 limbs, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError("tensors on different devices")
        if t.data_ptr() % 16:
            raise ValueError("K6 reads 16-byte aligned tables")


def _round_args(A, B, C, seq):
    """The checks of a round's tables and their pointers and row strides
    (in entries) as the C entry takes them."""
    Bp, n = A.shape[:2]
    if Bp < 1 or B.shape != A.shape or C.shape != (n, 16) or \
            not C.is_contiguous():
        raise ValueError("product-stack table shapes disagree")
    tabs = [A, B, C]
    if seq is not None:
        if len(seq) != 3 or any(t.shape != seq[0].shape for t in seq) or \
                seq[0].shape[1] != n:
            raise ValueError("dot-product stack table shapes disagree")
        tabs += list(seq)
    _check_rows(A, B, C[None], *tabs[3:])
    S = seq[0].shape[0] if seq is not None else 0
    q = tuple(seq) if seq is not None else (A, A, A)
    return ([A.data_ptr(), B.data_ptr(), C.data_ptr(), A.stride(0) // 16,
             B.stride(0) // 16, q[0].data_ptr(), q[1].data_ptr(),
             q[2].data_ptr(), q[0].stride(0) // 16, q[1].stride(0) // 16,
             q[2].stride(0) // 16, Bp, S], n, S, C.device)


def _new_tables(Bp: int, S: int, m: int, device):
    """All of a round's new tables in one allocation (rows of m entries):
    A, B (Bp rows each), C, and the dot-product stack's (S rows each)."""
    nt = torch.empty((2 * Bp + 1 + 3 * S, m, 16), dtype=torch.int32,
                     device=device)
    q = 2 * Bp + 1
    seq = (nt[q:q + S], nt[q + S:q + 2 * S], nt[q + 2 * S:]) if S else None
    return nt, (nt[:Bp], nt[Bp:2 * Bp], nt[2 * Bp], seq)


def pt_round(A, B, C, coef, r=None, seq=None):
    """One round of the batched layer sumcheck (see pt_round_plain) in one
    launch, counted as pt_round: with r the tables are bound to it into
    new tables (one allocation) and the evaluations taken on those; the
    sum over the instances weighted by coef (Bp + S, 16) comes back as
    (3, 16)."""
    if A.device.type == "cpu":
        return pt_round_plain(A, B, C, coef, r, seq)
    args, n, S, dev = _round_args(A, B, C, seq)
    Bp = A.shape[0]
    if n < 2 or n % (2 if r is None else 4):
        raise ValueError(f"a round of tables of {n} entries")
    coef = coef.contiguous()
    if coef.shape != (Bp + S, 16):
        raise ValueError("one coefficient an instance")
    pairs = n // 4 if r is not None else n // 2
    # product rows a work item takes: one, unless the round has pairs
    # enough to fill the card without splitting the product stack
    G = max(1, min(Bp, Bp * pairs // _PT_ITEMS))
    items = (-(-Bp // G) + S) * pairs
    if items >= 1 << 31:
        raise ValueError("K6 indexes a round's pairs below 2^31")
    nb = max(1, min(-(-items // _PT_THREADS), _PT_MAX_BLOCKS))
    scratch = torch.empty(48 + 24 * nb, dtype=torch.int32, device=dev)
    out = scratch[:48].view(3, 16)
    if r is not None:
        r = r.reshape(16).contiguous()
        kernels.require_cuda(r, coef)
        nt, tables = _new_tables(Bp, S, n // 2, dev)
    else:
        kernels.require_cuda(coef)
        nt, tables = scratch, None
    kernels.launch("pt_round", "pt_round_launch", *args, G, n,
                   0 if r is None else 1,
                   coef.data_ptr() if r is None else r.data_ptr(),
                   coef.data_ptr(), nt.data_ptr(), scratch[48:].data_ptr(),
                   out.data_ptr(), kernels.stream(C))
    return out, tables


def pt_fold(A, B, C, r, seq=None) -> torch.Tensor:
    """A layer's last bind (see pt_fold_plain) in one launch, counted as
    pt_fold."""
    if A.device.type == "cpu":
        return pt_fold_plain(A, B, C, r, seq)
    args, n, S, dev = _round_args(A, B, C, seq)
    if n != 2:
        raise ValueError("the last bind of a layer takes tables of 2 "
                         "entries")
    r = r.reshape(16).contiguous()
    kernels.require_cuda(r)
    nt = torch.empty((2 * A.shape[0] + 1 + 3 * S, 16), dtype=torch.int32,
                     device=dev)
    kernels.launch("pt_fold", "pt_round_launch", *args, 1, 2, 2,
                   r.data_ptr(), r.data_ptr(), nt.data_ptr(), nt.data_ptr(),
                   nt.data_ptr(), kernels.stream(C))
    return nt


def tree_plan(n: int) -> list:
    """The launches that build a tree of n leaves: the layers of each
    k_pt_tree_pass (at most _PT_MAX_PASS) while a layer is longer than
    2 PT_FIN entries, then 0 for k_pt_tree_final down to the root."""
    plan = []
    k, fin = _log2(n), _log2(2 * _PT_FIN)
    while k > fin:
        m = min(_PT_MAX_PASS, k - fin)
        plan.append(m)
        k -= m
    return plan + [0]


def tree_step(src: torch.Tensor, dst: torch.Tensor, m: int) -> None:
    """One launch of the tree build, counted as pt_tree: layers k + 1 ..
    k + m of B trees from their layer k, src (B, n, 16), into dst, layer
    after layer (k_pt_tree_pass); with m = 0 every layer down to the roots
    (k_pt_tree_final, n <= 2 PT_FIN)."""
    B, n = src.shape[:2]
    if m:
        kernels.launch("pt_tree", "pt_tree_pass_launch", src.data_ptr(),
                       dst.data_ptr(), B, n, m, kernels.stream(src))
    else:
        kernels.launch("pt_tree", "pt_tree_final_launch", src.data_ptr(),
                       dst.data_ptr(), B, n, kernels.stream(src))


def pt_tree(leaves: torch.Tensor) -> list:
    """Every layer of B product trees over the rows of leaves (B, N, 16),
    as pt_tree_plain gives them, the layers below the leaves and the roots
    in one allocation, a launch (tree_step) for each entry of
    tree_plan(N)."""
    if leaves.dim() != 3 or leaves.shape[-1] != 16:
        raise ValueError(f"expected (B, N, 16) leaves, got "
                         f"{tuple(leaves.shape)}")
    if leaves.device.type == "cpu":
        return pt_tree_plain(leaves)
    leaves = leaves.contiguous()
    kernels.require_cuda(leaves)
    B, N = leaves.shape[:2]
    if _log2(N) < 1:
        raise ValueError("a tree of at least 2 leaves")
    # layer k (n = N / 2^k entries a row) sits at B (N - 2n) of buf
    buf = torch.empty((B * (N - 1), 16), dtype=torch.int32,
                      device=leaves.device)
    layers, n = [leaves], N
    while n > 1:
        n //= 2
        layers.append(buf[B * (N - 2 * n):B * (N - n)].view(B, n, 16))
    k = 0
    for m in tree_plan(N):
        tree_step(layers[k], buf[B * (N - (N >> k)):], m)
        k += m
    return layers
