"""256-bit integers as 16 little-endian 16-bit limbs.

The JAX package's layout (its ops/limbs.py): an element is a (..., 16)
tensor, one limb per lane. The port stores limbs as int32. Host codecs go
between Python ints and numpy; the plain PyTorch helpers below compute in
int64, where a column of sixteen 32-bit products cannot overflow (torch's
CPU uint32 lacks +, -, >> and comparisons).
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 16
LIMB_BITS = 16
MASK = 0xFFFF


# --------------------------------------------------------------------------
# Host codecs (numpy, exact)
# --------------------------------------------------------------------------
def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    assert 0 <= x < (1 << (LIMB_BITS * n))
    return np.array(
        [(x >> (LIMB_BITS * i)) & 0xFFFF for i in range(n)], dtype=np.int32
    )


def ints_to_limbs(xs, n: int = NLIMBS) -> np.ndarray:
    """list/iterable of ints < 2^(16n) -> (len, n) int32 (one to_bytes per
    element, reinterpreted as little-endian u16)."""
    nbytes = 2 * n
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), n).astype(
        np.int32)


def limbs_to_ints(a) -> list:
    """(..., n) canonical limbs (numpy or tensor) -> flat list of ints."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    flat = np.asarray(a).reshape(-1, np.asarray(a).shape[-1])
    buf = np.ascontiguousarray(flat.astype("<u2")).tobytes()
    nb = 2 * flat.shape[1]
    return [int.from_bytes(buf[i:i + nb], "little")
            for i in range(0, len(buf), nb)]


def to_device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(
        device)


# --------------------------------------------------------------------------
# Plain PyTorch bignum helpers (int64 columns)
# --------------------------------------------------------------------------
def carry(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """Propagate carries over the last axis: int64 columns of any sign ->
    limbs in [0, 2^16), except the top one, which keeps what is left (it
    is in [0, 2^16) when the value fits n_out limbs, negative when the
    value is). All columns move their carries up at once, until none is
    left: a few passes for random data. `>>` on int64 floors, so negative
    columns borrow."""
    n = cols.shape[-1]
    if n > n_out:
        raise ValueError("carry cannot shrink the limb count")
    x = torch.zeros(cols.shape[:-1] + (n_out,), dtype=torch.int64,
                    device=cols.device)
    x[..., :n] = cols
    while True:
        c = x[..., :-1] >> LIMB_BITS
        if not bool(c.any()):
            return x
        x[..., :-1] -= c << LIMB_BITS
        x[..., 1:] += c


def cond_sub(a: torch.Tensor, m_limbs) -> torch.Tensor:
    """a - m where a >= m, else a (canonical int64 limbs; m a host
    constant with as many limbs as a)."""
    m = torch.as_tensor(np.asarray(m_limbs, dtype=np.int64), device=a.device)
    d = carry(a - m, a.shape[-1])
    return torch.where(d[..., -1:] < 0, a, d)


# batches up to this many elements form all their limb products at once
# (2 KiB an element); larger ones accumulate one row of products at a time
MUL_COLS_SMALL = 1024


def mul_cols(a: torch.Tensor, b: torch.Tensor, extra: int = 0) -> torch.Tensor:
    """Unnormalized product columns of two (..., 16) limb tensors
    (broadcast over batch dims): (..., 32 + extra) int64. A small batch
    adds its 256 limb products to their columns i + j in one index_add
    (the round tail's scalars); a large one sums sixteen shifted rows,
    whose peak is the output's size."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    t = torch.zeros(shape + (2 * NLIMBS + extra,), dtype=torch.int64,
                    device=a.device)
    if t[..., 0].numel() <= MUL_COLS_SMALL:
        i = torch.arange(NLIMBS, device=a.device)
        prod = a.unsqueeze(-1) * b.unsqueeze(-2)
        return t.index_add_(-1, (i[:, None] + i).flatten(),
                            prod.flatten(-2))
    for i in range(NLIMBS):
        t[..., i:i + NLIMBS] += a[..., i:i + 1] * b
    return t
