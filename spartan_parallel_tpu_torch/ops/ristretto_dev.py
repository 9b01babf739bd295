"""ristretto255 ENCODE and fixed-base comb commitments on the device (K9,
K10).

Counterpart of the JAX package's ops/ristretto_dev.py and the batched
comb_commit of its ops/zk_round.py. A ZK sumcheck round commits its round
polynomial and claims and absorbs the compressed points, so the
device-resident rounds need compression and the small fixed-generator
commitments on the card too.

- `compress`: RFC 9496 section 4.3.2 on ops/fp.py values, with the
  (p - 5) / 8 power as the ref10 pow22523 chain; K9 on a CUDA tensor.
- comb tables: `make_comb_tables` builds T[g, w, v] = (v 16^w) G_g on the
  host once per generator list (long-lived protocol state); a commitment
  is then 64 table entries per generator and a sum, with no doubling.
  `comb_commit` sums them: K10 on a CUDA tensor. Its sum is the port's
  counterpart of ops/curve.py tree_reduce (the plain form is
  ops/curve.py tree_sum).

The plain versions here serve the CPU and the plain round tail; the
kernels are csrc/zk_round.cu on csrc/ristretto.cuh: K9 encodes a point on
a group of ten lanes (csrc/fp10.cuh), K10 sums a window on a group of
four (csrc/lanes.cuh). Both bound by operations, see there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.consts import INVSQRT_A_MINUS_D, SQRT_M1
from ..core.edwards import RistrettoPoint
from . import curve, fp, fq, kernels
from . import limbs as lb
from .transcript_dev import limbs_to_bytes

SQRT_M1_LIMBS = fp.const(SQRT_M1)
INVSQRT_A_MINUS_D_LIMBS = fp.const(INVSQRT_A_MINUS_D)
COMB_WINDOWS = 64
COMB_MAX_GENS = 8  # csrc/zk_round.cu


# --------------------------------------------------------------------------
# ENCODE, plain
# --------------------------------------------------------------------------
def _nsquare(x, n: int):
    for _ in range(n):
        x = fp.mul(x, x)
    return x


def pow_p58(x):
    """x^((p - 5) / 8) = x^(2^252 - 3)."""
    t0 = fp.mul(x, x)                      # x^2
    t1 = _nsquare(t0, 2)                   # x^8
    t1 = fp.mul(x, t1)                     # x^9
    t0 = fp.mul(t0, t1)                    # x^11
    t0 = fp.mul(t0, t0)                    # x^22
    t0 = fp.mul(t1, t0)                    # x^(2^5 - 1)
    t1 = _nsquare(t0, 5)
    t0 = fp.mul(t1, t0)                    # x^(2^10 - 1)
    t1 = _nsquare(t0, 10)
    t1 = fp.mul(t1, t0)                    # x^(2^20 - 1)
    t2 = _nsquare(t1, 20)
    t1 = fp.mul(t2, t1)                    # x^(2^40 - 1)
    t1 = _nsquare(t1, 10)
    t0 = fp.mul(t1, t0)                    # x^(2^50 - 1)
    t1 = _nsquare(t0, 50)
    t1 = fp.mul(t1, t0)                    # x^(2^100 - 1)
    t2 = _nsquare(t1, 100)
    t1 = fp.mul(t2, t1)                    # x^(2^200 - 1)
    t1 = _nsquare(t1, 50)
    t0 = fp.mul(t1, t0)                    # x^(2^250 - 1)
    t0 = _nsquare(t0, 2)                   # x^(2^252 - 4)
    return fp.mul(t0, x)                   # x^(2^252 - 3)


def _is_neg(x):
    return (x[..., 0] & 1) == 1


def _select(c, a, b):
    return torch.where(c[..., None], a, b)


def _ct_abs(x):
    return _select(_is_neg(x), fp.neg(x), x)


def _eq(a, b):
    return (a == b).all(-1)


def sqrt_ratio_m1(u, v):
    """(was_square, r): RFC 9496 section 4.2 (core/edwards.py)."""
    sqrt_m1 = lb.to_device(SQRT_M1_LIMBS, u.device)
    v3 = fp.mul(fp.mul(v, v), v)
    v7 = fp.mul(fp.mul(v3, v3), v)
    r = fp.mul(fp.mul(u, v3), pow_p58(fp.mul(u, v7)))
    check = fp.mul(v, fp.mul(r, r))
    neg_u = fp.neg(u)
    correct_sign = _eq(check, u)
    flipped_sign = _eq(check, neg_u)
    flipped_sign_i = _eq(check, fp.mul(neg_u, sqrt_m1))
    r = _select(flipped_sign | flipped_sign_i, fp.mul(r, sqrt_m1), r)
    return correct_sign | flipped_sign, _ct_abs(r)


def compress_plain(pt: torch.Tensor) -> torch.Tensor:
    """(..., 4, 16) extended points -> (..., 32) encodings (int32 bytes)."""
    X, Y, Z, T = pt.unbind(-2)
    dev = pt.device
    sqrt_m1 = lb.to_device(SQRT_M1_LIMBS, dev)
    u1 = fp.mul(fp.add(Z, Y), fp.sub(Z, Y))
    u2 = fp.mul(X, Y)
    one = torch.zeros_like(u1)
    one[..., 0] = 1
    _, invsqrt = sqrt_ratio_m1(one, fp.mul(u1, fp.mul(u2, u2)))
    den1 = fp.mul(invsqrt, u1)
    den2 = fp.mul(invsqrt, u2)
    z_inv = fp.mul(fp.mul(den1, den2), T)
    ix0 = fp.mul(X, sqrt_m1)
    iy0 = fp.mul(Y, sqrt_m1)
    enchanted = fp.mul(den1, lb.to_device(INVSQRT_A_MINUS_D_LIMBS, dev))
    rotate = _is_neg(fp.mul(T, z_inv))
    x = _select(rotate, iy0, X)
    y = _select(rotate, ix0, Y)
    den_inv = _select(rotate, enchanted, den2)
    y = _select(_is_neg(fp.mul(x, z_inv)), fp.neg(y), y)
    s = _ct_abs(fp.mul(den_inv, fp.sub(Z, y)))
    return limbs_to_bytes(s).to(torch.int32)


def compress(pt: torch.Tensor) -> torch.Tensor:
    """Ristretto ENCODE of (..., 4, 16) points: K9 on a CUDA tensor (one
    thread per point), the plain version on a CPU tensor."""
    if pt.shape[-2:] != (4, 16):
        raise ValueError(f"expected (..., 4, 16) points, got "
                         f"{tuple(pt.shape)}")
    if pt.device.type == "cpu":
        return compress_plain(pt)
    pt = pt.contiguous()
    kernels.require_cuda(pt)
    out = torch.empty(pt.shape[:-2] + (32,), dtype=torch.int32,
                      device=pt.device)
    if pt.numel():
        kernels.launch("ristretto_compress", "compress_launch",
                       pt.data_ptr(), out.data_ptr(), pt.numel() // 64,
                       kernels.stream(pt))
    return out


# --------------------------------------------------------------------------
# Fixed-base 4-bit comb tables
# --------------------------------------------------------------------------
def make_comb_tables(gens) -> np.ndarray:
    """list of n RistrettoPoint -> (n, 64, 16, 4, 16) int32 host array with
    T[g, w, v] = (v 16^w) G_g (v = 0: the identity), built by the same
    chain of host additions as the JAX package's."""
    rows = []
    ident = RistrettoPoint.identity()
    for G in gens:
        base = G
        for _ in range(COMB_WINDOWS):
            acc = None
            rows.append(ident)
            for _v in range(1, 16):
                acc = base if acc is None else acc + base
                rows.append(acc)
            base = acc + base  # 16^(w+1) G (acc = 15 base here)
    return curve.encode_points(rows).reshape(len(gens), COMB_WINDOWS, 16,
                                             4, 16)


def _digits(scalars_mont: torch.Tensor) -> torch.Tensor:
    """(..., n, 16) Montgomery -> (..., n, 64) nibbles of the canonical
    scalars, least significant first."""
    canon = fq.mul_plain(scalars_mont,
                         lb.to_device(fq.ONE_LIMBS, scalars_mont.device))
    sh = torch.tensor([0, 4, 8, 12], device=canon.device)
    return ((canon.to(torch.int64)[..., None] >> sh) & 0xF).flatten(-2)


def comb_commit_plain(tables: torch.Tensor,
                      scalars_mont: torch.Tensor) -> torch.Tensor:
    """tables (n, 64, 16, 4, 16), scalars (..., n, 16) Montgomery ->
    (..., 4, 16) points sum_g s_g G_g, summed as K10 sums: window w over g
    in order from T[0, w, .], then the 64 window sums by halving."""
    n = tables.shape[0]
    d = _digits(scalars_mont)  # (..., n, 64)
    g = torch.arange(n, device=d.device)[:, None]
    w = torch.arange(COMB_WINDOWS, device=d.device)
    picked = tables[g, w, d]  # (..., n, 64, 4, 16)
    acc = picked[..., 0, :, :, :]
    for i in range(1, n):
        acc = curve.point_add(acc, picked[..., i, :, :, :])
    return curve.tree_sum(acc, dim=-3)


def comb_commit(tables: torch.Tensor,
                scalars_mont: torch.Tensor) -> torch.Tensor:
    """Batched fixed-base commitments: K10 on a CUDA tensor (one block per
    commitment), the plain version on a CPU tensor."""
    n = tables.shape[0]
    if tables.shape[1:] != (COMB_WINDOWS, 16, 4, 16) or \
            scalars_mont.shape[-2:] != (n, 16):
        raise ValueError("comb tables (n, 64, 16, 4, 16) and scalars "
                         "(..., n, 16) disagree")
    if scalars_mont.device.type == "cpu":
        return comb_commit_plain(tables, scalars_mont)
    if not 1 <= n <= COMB_MAX_GENS:
        raise ValueError(f"comb_commit takes 1 to {COMB_MAX_GENS} "
                         f"generators, got {n}")
    tables = tables.contiguous()
    sc = scalars_mont.contiguous()
    kernels.require_cuda(tables, sc)
    batch = sc.numel() // (16 * n)
    out = torch.empty(sc.shape[:-2] + (4, 16), dtype=torch.int32,
                      device=sc.device)
    if batch:
        kernels.launch("comb_commit", "comb_launch", tables.data_ptr(), n,
                       sc.data_ptr(), out.data_ptr(), batch,
                       kernels.stream(sc))
    return out
