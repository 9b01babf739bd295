"""Scalar-field tensors mod l in Montgomery form (R = 2^256): kernel K1.

Counterpart of the JAX package's ops/fq.py. A field element is a (..., 16)
int32 tensor of 16-bit limbs holding x*R mod l, fully reduced. Each
wrapper (mul, add, sub, bind, dot) launches csrc/fq.cu on a CUDA tensor and
takes its plain PyTorch version (the *_plain functions, int64 columns) on a
CPU tensor. chip_smoke.py holds each kernel against its plain version on
the card. Replaces ops/fq.py _mul_impl, _add_impl, _sub_impl, _dot_impl
(with sum_reduce) and the binds of ops/sumcheck.py and
models/dense_mlpoly.py; `dot_many` evaluates a list of tables against one
eq table in one launch (the JAX package's per-polynomial evaluate). Bound
on the card by bytes (64 B per element per operand), see csrc/fq.cu.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.consts import L
from . import kernels
from . import limbs as lb

R = (1 << 256) % L
R2 = (R * R) % L
# -l^{-1} mod 2^16, the word-by-word REDC factor of the plain version
NPRIME16 = (-pow(L, -1, 1 << 16)) % (1 << 16)

L_LIMBS = lb.int_to_limbs(L)
R2_LIMBS = lb.int_to_limbs(R2)
ONE_LIMBS = lb.int_to_limbs(1)
ONE_MONT = lb.int_to_limbs(R)  # 1 in Montgomery form

_DOT_CHUNK = 4096  # csrc/fq.cu DOT_CHUNK: the most terms a block sums
_DOT_TICKETS = 65536  # csrc/fq.cu DOT_TICKETS
DOT_MANY_MAX = 256  # csrc/fq.cu DOT_MANY_MAX


# --------------------------------------------------------------------------
# Host codecs
# --------------------------------------------------------------------------
def encode(xs) -> np.ndarray:
    """Python ints / Scalars -> (n, 16) int32 Montgomery limbs."""
    return lb.ints_to_limbs([(int(x) % L) * R % L for x in xs])


def decode(a) -> list:
    """(..., 16) Montgomery limbs (numpy or tensor) -> canonical ints."""
    rinv = pow(R, -1, L)
    return [(v * rinv) % L for v in lb.limbs_to_ints(a)]


def const(x: int) -> np.ndarray:
    return lb.int_to_limbs((int(x) % L) * R % L)


# --------------------------------------------------------------------------
# Plain PyTorch versions (int64 columns; any device)
# --------------------------------------------------------------------------
def _redc_cols(t: torch.Tensor) -> torch.Tensor:
    """(..., 33) int64 columns of a value < l*2^256 -> (..., 16) canonical
    limbs of value * 2^-256 mod l (word-by-word Montgomery reduction)."""
    t = t.clone()
    lt = torch.as_tensor(L_LIMBS.astype(np.int64), device=t.device)
    for i in range(lb.NLIMBS):
        m = ((t[..., i] & lb.MASK) * NPRIME16) & lb.MASK
        t[..., i:i + lb.NLIMBS] += m[..., None] * lt
        t[..., i + 1] += t[..., i] >> lb.LIMB_BITS
    r = lb.carry(t[..., lb.NLIMBS:], lb.NLIMBS + 1)  # < 2l < 2^254
    return lb.cond_sub(r[..., :lb.NLIMBS], L_LIMBS)


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _redc_cols(lb.mul_cols(a, b, extra=1)).to(torch.int32)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = lb.carry(a.to(torch.int64) + b.to(torch.int64), lb.NLIMBS)
    return lb.cond_sub(s, L_LIMBS).to(torch.int32)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lt = torch.as_tensor(L_LIMBS.astype(np.int64), device=a.device)
    s = lb.carry(a.to(torch.int64) + lt - b.to(torch.int64), lb.NLIMBS)
    return lb.cond_sub(s, L_LIMBS).to(torch.int32)


def bind_plain(t: torch.Tensor, r: torch.Tensor, axis: int, n_half: int,
               out_len: int | None = None) -> torch.Tensor:
    """lo + r*(hi - lo) with lo = t[:n_half], hi = t[n_half:2 n_half] along
    `axis`; the result has out_len (default: t's length) along the axis,
    zero past n_half."""
    axis = axis % (t.dim() - 1)
    lo = t.narrow(axis, 0, n_half)
    hi = t.narrow(axis, n_half, n_half)
    v = add_plain(lo, mul_plain(r, sub_plain(hi, lo)))
    shape = list(t.shape)
    shape[axis] = t.shape[axis] if out_len is None else out_len
    out = torch.zeros(shape, dtype=torch.int32, device=t.device)
    out.narrow(axis, 0, n_half).copy_(v)
    return out


def resolve_plain(s: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limb-wise sums of Montgomery values -> their field
    sum in Montgomery form: one REDC, then one product by R^2."""
    r = _redc_cols(lb.carry(s, 2 * lb.NLIMBS + 1)).to(torch.int32)
    return mul_plain(r, lb.to_device(R2_LIMBS, s.device))


def sum_plain(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum of field elements along `axis`: lazy int64 column sums, then
    one resolve."""
    return resolve_plain(a.to(torch.int64).sum(dim=axis % (a.dim() - 1)))


def dot_plain(a: torch.Tensor, b: torch.Tensor, axis: int = 0):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return sum_plain(mul_plain(a.expand(shape), b.expand(shape)), axis)


def dot_many_plain(tables, b: torch.Tensor) -> torch.Tensor:
    """dot_plain of each (K, 16) table with b, stacked to (n, 16)."""
    return torch.stack([dot_plain(t, b, 0) for t in tables])


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
def _check_limbs(t: torch.Tensor) -> None:
    if t.shape[-1] != 16:
        raise ValueError(f"expected (..., 16) limbs, got {tuple(t.shape)}")


def _binop(name: str, plain, a: torch.Tensor, b: torch.Tensor,
           counter: str | None = None):
    _check_limbs(a)
    _check_limbs(b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return plain(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape).contiguous()
    bcast = b.numel() == 16
    b = b.contiguous() if bcast else b.expand(shape).contiguous()
    kernels.require_cuda(a, b)
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    kernels.launch(name, name + "_launch", a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), a.numel() // 16, int(bcast),
                   kernels.stream(a))
    if counter is not None:
        kernels.count(counter)
    return out


def mul(a: torch.Tensor, b: torch.Tensor, counter: str | None = None):
    """Montgomery product a*b*R^-1: the field multiply. b may be a single
    element broadcast over a. A launch counts as fq_mul and, when a
    caller's own function runs on this kernel, also under `counter`."""
    return _binop("fq_mul", mul_plain, a, b, counter)


def add(a: torch.Tensor, b: torch.Tensor, counter: str | None = None):
    return _binop("fq_add", add_plain, a, b, counter)


def sub(a: torch.Tensor, b: torch.Tensor, counter: str | None = None):
    return _binop("fq_sub", sub_plain, a, b, counter)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def bind(t: torch.Tensor, r: torch.Tensor, axis: int, n_half: int,
         out_len: int | None = None, counter: str | None = None):
    """One variable bound to r along `axis` (see bind_plain); `counter` as
    in mul."""
    _check_limbs(t)
    axis = axis % (t.dim() - 1)
    if t.device.type == "cpu":
        return bind_plain(t, r, axis, n_half, out_len)
    t = t.contiguous()
    r = r.reshape(16).contiguous()
    kernels.require_cuda(t, r)
    n_in = t.shape[axis]
    n_out = n_in if out_len is None else out_len
    assert 2 * n_half <= n_in and n_half <= n_out
    shape = list(t.shape)
    shape[axis] = n_out
    out = torch.empty(shape, dtype=torch.int32, device=t.device)
    outer = math.prod(t.shape[:axis])
    inner = math.prod(t.shape[axis + 1:-1])
    kernels.launch("fq_bind", "fq_bind_launch", t.data_ptr(), r.data_ptr(),
                   out.data_ptr(), outer, n_in, n_out, n_half, inner,
                   kernels.stream(t))
    if counter is not None:
        kernels.count(counter)
    return out


def _dot_chunk(outputs: int, K: int, device) -> int:
    """Terms a block of K1's dot sums: halved from _DOT_CHUNK down to 256
    (a term a thread) until the grid has six blocks an SM, two waves of
    the blocks resident at once."""
    nsm = kernels.sms(device)
    chunk = _DOT_CHUNK
    while chunk > 256 and outputs * -(-K // chunk) < 6 * nsm:
        chunk //= 2
    if -(-K // chunk) > 65535:  # chunks of the reduced axis are the grid.y
        raise ValueError(f"dot reduces at most 65535 * {chunk} terms")
    return chunk


def dot(a: torch.Tensor, b: torch.Tensor, axis: int = 0,
        counter: str | None = None) -> torch.Tensor:
    """sum_k a*b along `axis`; b broadcasts against a. `counter` as in
    mul."""
    _check_limbs(a)
    _check_limbs(b)
    if a.device.type == "cpu":
        return dot_plain(a, b, axis)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    axis = axis % (len(shape) - 1)
    a = a.expand(shape).contiguous()
    outer = math.prod(shape[:axis])
    K = shape[axis]
    inner = math.prod(shape[axis + 1:-1])
    b = b.contiguous()
    kernels.require_cuda(a, b)
    # b's strides over (outer, K, inner) are 0 where it broadcasts
    b3 = b.expand(shape).reshape(outer, K, inner, 16)
    if b3.stride(-1) != 1:
        b3 = b3.contiguous()
    out = torch.empty(shape[:axis] + shape[axis + 1:], dtype=torch.int32,
                      device=a.device)
    if K == 0:
        return out.zero_()
    chunk = _dot_chunk(outer * inner, K, a.device)
    nchunks = -(-K // chunk)
    if nchunks > 1 and outer * inner > _DOT_TICKETS:
        raise ValueError(f"dot sums the chunks of at most {_DOT_TICKETS} "
                         f"outputs in one launch")
    part = torch.empty((outer * inner * nchunks, 8), dtype=torch.int32,
                       device=a.device)
    sbo, sbk, sbi = (s // 16 for s in b3.stride()[:3])
    kernels.launch("fq_dot", "fq_dot_launch", a.data_ptr(), b3.data_ptr(),
                   part.data_ptr(), out.data_ptr(), outer, K, inner, sbo, sbk,
                   sbi, chunk, kernels.stream(a))
    if counter is not None:
        kernels.count(counter)
    return out


def dot_many(tables, b: torch.Tensor, counter: str | None = None):
    """(n, 16): each of the equal-length (K, 16) tables dotted with the
    (K, 16) table b. On the card one launch for up to DOT_MANY_MAX tables
    (the tables may be views into one allocation; each is read where it
    lies), counted as fq_dot_many and under `counter`."""
    for t in tables:
        _check_limbs(t)
    if b.device.type == "cpu":
        return dot_many_plain(tables, b)
    return _dot_many_launch(tables, b, counter)


def _dot_many_launch(tables, b: torch.Tensor, counter: str | None):
    K = b.shape[0]
    b = b.contiguous()
    tables = [t if t.is_contiguous() else t.contiguous() for t in tables]
    kernels.require_cuda(b, *tables)
    if any(tuple(t.shape) != (K, 16) for t in tables) or b.dim() != 2:
        raise ValueError("dot_many takes (K, 16) tables and a (K, 16) b")
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("dot_many reads 16-byte aligned tables")
    n = len(tables)
    out = torch.empty((n, 16), dtype=torch.int32, device=b.device)
    if K == 0 or n == 0:
        return out.zero_()
    chunk = _dot_chunk(min(n, DOT_MANY_MAX), K, b.device)
    nchunks = -(-K // chunk)
    part = torch.empty((min(n, DOT_MANY_MAX) * nchunks, 8),
                       dtype=torch.int32, device=b.device)
    for j in range(0, n, DOT_MANY_MAX):
        group = tables[j:j + DOT_MANY_MAX]
        ptrs = (ctypes.c_void_p * len(group))(*(t.data_ptr() for t in group))
        kernels.launch("fq_dot_many", "fq_dot_many_launch",
                       ctypes.addressof(ptrs), len(group), b.data_ptr(),
                       part.data_ptr(), out[j].data_ptr(), K, chunk,
                       kernels.stream(b))
        if counter is not None:
            kernels.count(counter)
    return out


_ONE_ON = {}


def sum_reduce(a: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum of field elements along `axis` (a dot with the field one, which
    goes up to each device once: a later call uploads nothing)."""
    one = _ONE_ON.get(a.device)
    if one is None:
        one = _ONE_ON[a.device] = lb.to_device(ONE_MONT, a.device)
    return dot(a, one, axis)


# --------------------------------------------------------------------------
# Montgomery conversions
# --------------------------------------------------------------------------
def from_canonical(a: torch.Tensor) -> torch.Tensor:
    """Canonical limbs (< l) -> Montgomery form: a product with R^2."""
    return mul(a, lb.to_device(R2_LIMBS, a.device))


def to_canonical(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical limbs: a product with the integer 1."""
    return mul(a, lb.to_device(ONE_LIMBS, a.device))


def encode_to_device(xs, device) -> torch.Tensor:
    """ints/Scalars -> (n, 16) Montgomery tensor; the R-scaling runs on
    the device (one product by R^2) instead of one host bigint multiply
    per element."""
    canon = lb.ints_to_limbs([int(x) % L for x in xs])
    return from_canonical(lb.to_device(canon, device))
