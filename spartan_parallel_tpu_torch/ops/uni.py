"""The powers of one scalar and tables read as univariate polynomials:
kernel K7.

Counterpart of the JAX package's models/dense_mlpoly.py _powers_dev
(:200), the powers 1, c, ..., c^(n-1), and _rlc_eval_dev (:211),
sum_i Z_i c^i, the univariate evaluation of ShiftProofs. A table is
(n, 16) int32 Montgomery limbs, equal limb for limb to the JAX scan's.

`uni_eval_many` evaluates every table of a call at one c in one launch of
csrc/uni.cu (k_uni<true>, counted as uni_evaluate): c^(2^k) go by value
in the launch's parameters, the powers never reach memory, and one output
a table comes back. `fq_powers` writes the powers (k_uni<false>); on no
main path since ShiftProofs evaluates its tables in one launch. Each
launches on CUDA tensors and takes its plain version on CPU tensors.
Bound on the card: the launch and the chain of products at the path's
shapes, the products at 2^20; see csrc/uni.cu.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.consts import L
from . import fq, kernels
from . import limbs as lb

_THREADS = 256        # csrc/uni.cu UNI_THREADS
_LOG_THREADS = 8      # csrc/uni.cu UNI_LOG_THREADS
_BITS = 40            # csrc/uni.cu UNI_BITS
UNI_MANY_MAX = 64     # csrc/uni.cu: tables of one launch
# blocks an SM the entries a thread aim at: fq_powers at 2^20 ran
# fastest at 2 of 2, 4 and 8 on an H100 (PERF.md)
_BLOCKS_PER_SM = 2


def fq_powers_plain(c: torch.Tensor, n: int) -> torch.Tensor:
    """(16,) Montgomery c -> (n, 16) table [1, c, ..., c^(n-1)]: the
    table doubles, its upper half the lower times c^len."""
    tab = lb.to_device(fq.ONE_MONT, c.device)[None]
    cm = c.reshape(1, 16)
    while tab.shape[0] < n:
        tab = torch.cat([tab, fq.mul_plain(tab, cm)])
        cm = fq.mul_plain(cm, cm)
    return tab[:n]


def _nbits(n: int) -> int:
    """Powers of two of c a launch takes: every exponent below n, and
    c^256, a thread's step."""
    return max(_LOG_THREADS + 1, (n - 1).bit_length())


def _per_thread(total: int, device) -> int:
    """Entries a thread: one, or as many (up to 16) as keep
    _BLOCKS_PER_SM blocks an SM."""
    per = -(-total // (_THREADS * _BLOCKS_PER_SM * kernels.sms(device)))
    return 1 << max(0, min(4, (per - 1).bit_length()))


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
                   out.data_ptr(), n, _nbits(n),
                   _per_thread(n, c.device), kernels.stream(c))
    return out


def uni_eval_many_plain(tables, c: int) -> torch.Tensor:
    """sum_i T[i] c^i of each (n_t, 16) table, stacked to (T, 16)."""
    cm = lb.to_device(fq.encode([c]), tables[0].device)[0]
    return torch.stack([fq.dot_plain(t, fq_powers_plain(cm, t.shape[0]), 0)
                        for t in tables])


def _pow2_words(c: int, nbits: int):
    """c^(2^k), k < nbits, in Montgomery form as 8 little-endian 32-bit
    words each (a ctypes array)."""
    raw, x = [], int(c) % L
    for _ in range(nbits):
        raw.append((x * fq.R % L).to_bytes(32, "little"))
        x = x * x % L
    return (ctypes.c_uint32 * (8 * nbits)).from_buffer_copy(b"".join(raw))


def uni_eval_many(tables, c: int) -> torch.Tensor:
    """(T, 16) Montgomery: each (n_t, 16) table (n_t >= 1) read as the
    coefficients of a univariate polynomial, evaluated at the scalar c.
    On the card one launch for up to UNI_MANY_MAX tables (counted as
    uni_evaluate), c^(2^k) by value in its parameters."""
    if not tables:
        raise ValueError("no table to evaluate")
    for t in tables:
        fq._check_limbs(t)
        if t.dim() != 2 or t.shape[0] < 1:
            raise ValueError("uni_eval_many takes (n, 16) tables, n >= 1")
    dev = tables[0].device
    if dev.type == "cpu":
        return uni_eval_many_plain(tables, c)
    tables = [t if t.is_contiguous() else t.contiguous() for t in tables]
    kernels.require_cuda(*tables)
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError("uni_eval_many reads 16-byte aligned tables")
    lens = [int(t.shape[0]) for t in tables]
    nbits = _nbits(max(lens))
    if nbits > _BITS:
        raise ValueError(f"a table of {max(lens)} entries")
    per = _per_thread(sum(lens), dev)
    pw = _pow2_words(c, nbits)
    out = torch.empty((len(tables), 16), dtype=torch.int32, device=dev)
    for g in range(0, len(tables), UNI_MANY_MAX):
        group, glen = tables[g:g + UNI_MANY_MAX], lens[g:g + UNI_MANY_MAX]
        chunk0 = [0]
        for n in glen:
            chunk0.append(chunk0[-1] + -(-n // (_THREADS * per)))
        part = torch.empty((chunk0[-1], 8), dtype=torch.int32, device=dev)
        # the launch reads these host arrays: keep them alive until then
        ptrs = (ctypes.c_void_p * len(group))(*(t.data_ptr() for t in group))
        sizes = (ctypes.c_longlong * len(glen))(*glen)
        first = (ctypes.c_int * len(chunk0))(*chunk0)
        kernels.launch(
            "uni_evaluate", "uni_eval_many_launch", ctypes.addressof(ptrs),
            ctypes.addressof(sizes), len(group), ctypes.addressof(pw), nbits,
            ctypes.addressof(first), per, part.data_ptr(), out[g].data_ptr(),
            kernels.stream(out))
    return out
