"""curve25519 points as limb tensors, and the bullet generator fold (K2).

Counterpart of the JAX package's ops/curve.py. A point is a (..., 4, 16)
int32 tensor: extended twisted-Edwards coordinates (X, Y, Z, T) over
GF(2^255 - 19), fully reduced. The addition law is complete, so the plain
versions below are branch-free tensor code. Two results that are the same
group element may hold different coordinates, so points are compared after
ristretto compression.

`fold_points` launches csrc/msm.cu's fold kernel on a CUDA tensor and takes
`fold_points_plain` on a CPU tensor. It replaces ops/curve.py
_fold_scan; bound on the card by operations (a joint double-and-add over
the shared scalars per pair, its point operations split over four lanes),
see csrc/msm.cu. `point_sum` (K12, the sum of
the sharded MSM's per-rank partials; replaces ops/curve.py tree_reduce)
and `scale_points` (K13, k * P; replaces ops/curve.py _scale_scan /
scale_points) launch msm.cu's kernels the same way, with `tree_sum` and
`scale_points_plain` as their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.consts import EDWARDS_D2, L as L_MOD
from ..core.edwards import RistrettoPoint
from . import fp, kernels
from . import limbs as lb

D2_LIMBS = fp.const(EDWARDS_D2)


# --------------------------------------------------------------------------
# Host codecs
# --------------------------------------------------------------------------
def encode_points(points) -> np.ndarray:
    """list[RistrettoPoint] -> (n, 4, 16) int32."""
    coords = [c for pt in points for c in (pt.X, pt.Y, pt.Z, pt.T)]
    return lb.ints_to_limbs(coords).reshape(len(points), 4, 16)


def decode_points(arr) -> list:
    """(..., 4, 16) limbs (numpy or tensor) -> list[RistrettoPoint]."""
    vals = lb.limbs_to_ints(arr)
    return [RistrettoPoint(*vals[4 * i:4 * i + 4])
            for i in range(len(vals) // 4)]


def identity(shape=()) -> np.ndarray:
    """Identity points (0, 1, 1, 0) with the given batch shape."""
    pt = np.zeros((4, 16), dtype=np.int32)
    pt[1, 0] = 1
    pt[2, 0] = 1
    return np.broadcast_to(pt, tuple(shape) + (4, 16)).copy()


def scalar_limbs(ks, device) -> torch.Tensor:
    """host scalars -> (n, 16) canonical limbs (mod l) on `device`."""
    return lb.to_device(lb.ints_to_limbs([int(k) % L_MOD for k in ks]),
                        device)


# --------------------------------------------------------------------------
# Plain PyTorch point arithmetic
# --------------------------------------------------------------------------
def point_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete addition (add-2008-hwcd-3, a = -1): 9 field products."""
    x1, y1, z1, t1 = p.unbind(-2)
    x2, y2, z2, t2 = q.unbind(-2)
    d2 = torch.as_tensor(D2_LIMBS, device=p.device)
    a = fp.mul(fp.sub(y1, x1), fp.sub(y2, x2))
    b = fp.mul(fp.add(y1, x1), fp.add(y2, x2))
    c = fp.mul(fp.mul(t1, d2), t2)
    zz = fp.mul(z1, z2)
    d = fp.add(zz, zz)
    e, f, g, h = fp.sub(b, a), fp.sub(d, c), fp.add(d, c), fp.add(b, a)
    return torch.stack([fp.mul(e, f), fp.mul(g, h), fp.mul(f, g),
                        fp.mul(e, h)], dim=-2)


def point_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2008-hwcd with a = -1."""
    x1, y1, z1, _ = p.unbind(-2)
    a = fp.mul(x1, x1)
    b = fp.mul(y1, y1)
    zz = fp.mul(z1, z1)
    c = fp.add(zz, zz)
    d = fp.neg(a)
    xy = fp.add(x1, y1)
    e = fp.sub(fp.sub(fp.mul(xy, xy), a), b)
    g = fp.add(d, b)
    f = fp.sub(g, c)
    h = fp.sub(d, b)
    return torch.stack([fp.mul(e, f), fp.mul(g, h), fp.mul(f, g),
                        fp.mul(e, h)], dim=-2)


def tree_sum(pts: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Sum of points along `dim` by halving (identity-padded)."""
    pts = pts.movedim(dim, 0)
    while pts.shape[0] > 1:
        if pts.shape[0] % 2:
            ident = torch.as_tensor(identity((1,) + pts.shape[1:-2]),
                                    device=pts.device)
            pts = torch.cat([pts, ident])
        h = pts.shape[0] // 2
        pts = point_add(pts[:h], pts[h:])
    return pts[0]


def multiples(pts: torch.Tensor, count: int) -> torch.Tensor:
    """(count, ...) table of k * P for k < count (a power of two), built a
    level at a time: T[m + k] = T[k] + m P."""
    ident = torch.as_tensor(identity(pts.shape[:-2]), device=pts.device)
    tab = torch.stack([ident, pts])
    while tab.shape[0] < count:
        m = tab.shape[0]
        mp = point_double(tab[m // 2])
        tab = torch.cat([tab, point_add(tab, mp[None].expand_as(tab))])
    return tab


def _digits(limbs: torch.Tensor, w: int) -> torch.Tensor:
    """byte w of (..., 16) canonical scalar limbs -> (...) int64."""
    return (limbs[..., w >> 1].to(torch.int64) >> ((w & 1) * 8)) & 0xFF


def fold_points_plain(pts_l: torch.Tensor, pts_r: torch.Tensor,
                      k: torch.Tensor) -> torch.Tensor:
    """k[0] * L_i + k[1] * R_i for every i: 8-bit fixed windows over the
    two shared scalars, tables of 256 multiples per point."""
    tl = multiples(pts_l, 256)
    tr = multiples(pts_r, 256)
    acc = None
    for w in range(31, -1, -1):
        if acc is not None:
            for _ in range(8):
                acc = point_double(acc)
        dl = int(_digits(k[0], w))
        dr = int(_digits(k[1], w))
        term = point_add(tl[dl], tr[dr])
        acc = term if acc is None else point_add(acc, term)
    return acc


def fold_points(pts_l: torch.Tensor, pts_r: torch.Tensor, k_l: int,
                k_r: int) -> torch.Tensor:
    """k_l * P_l + k_r * P_r elementwise: the bullet generator fold
    (JAX ops/curve.py fold_points)."""
    k = scalar_limbs([k_l, k_r], pts_l.device)
    if pts_l.device.type == "cpu":
        return fold_points_plain(pts_l, pts_r, k)
    if pts_l.shape != pts_r.shape or pts_l.shape[-2:] != (4, 16):
        raise ValueError("fold_points takes two (n, 4, 16) point tensors")
    pts_l, pts_r = pts_l.contiguous(), pts_r.contiguous()
    kernels.require_cuda(pts_l, pts_r, k)
    out = torch.empty_like(pts_l)
    kernels.launch("fold_points", "fold_points_launch", pts_l.data_ptr(),
                   pts_r.data_ptr(), k.data_ptr(), out.data_ptr(),
                   pts_l.numel() // 64, kernels.stream(pts_l))
    return out


def _aligned(pts: torch.Tensor) -> torch.Tensor:
    """pts contiguous and 16-byte aligned: K12 and K13 load a coordinate
    as four 16-byte vectors."""
    pts = pts.contiguous()
    return pts.clone() if pts.data_ptr() % 16 else pts


def point_sum(parts: torch.Tensor) -> torch.Tensor:
    """(D, B, 4, 16) -> (B, 4, 16): the sum over the leading axis by
    tree_sum's halving tree (K12 on a CUDA tensor)."""
    if parts.dim() != 4 or parts.shape[-2:] != (4, 16):
        raise ValueError(f"point_sum takes (D, B, 4, 16), got "
                         f"{tuple(parts.shape)}")
    if parts.device.type == "cpu":
        return tree_sum(parts, 0)
    d, b = parts.shape[:2]
    parts = _aligned(parts)
    kernels.require_cuda(parts)
    scratch = torch.empty(((d + 1) // 2, b, 4, 16), dtype=torch.int32,
                          device=parts.device)
    out = torch.empty((b, 4, 16), dtype=torch.int32, device=parts.device)
    kernels.launch("point_sum", "point_sum_launch", parts.data_ptr(),
                   scratch.data_ptr(), out.data_ptr(), d, b,
                   kernels.stream(parts))
    return out


SCALAR_BITS = 253


def scale_points_plain(pts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k * P for every point: the JAX package's scan, bit i from the
    bottom adds the running 2^i P, which then doubles (the doublings past
    k's top bit, which change no sum, are left out). k: (16,) canonical
    limbs."""
    kv = int(lb.limbs_to_ints(k.reshape(1, 16))[0])
    acc = torch.as_tensor(identity(pts.shape[:-2]), device=pts.device)
    add = pts
    for bit in range(min(kv.bit_length(), SCALAR_BITS)):
        if (kv >> bit) & 1:
            acc = point_add(acc, add)
        add = point_double(add)
    return acc


def scale_points(pts: torch.Tensor, k: int) -> torch.Tensor:
    """k * P for every point of (..., 4, 16); k is a host scalar, taken
    mod l first (JAX ops/curve.py scale_points)."""
    if pts.shape[-2:] != (4, 16):
        raise ValueError("scale_points takes (..., 4, 16) points")
    kl = scalar_limbs([k], pts.device)[0]
    if pts.device.type == "cpu":
        return scale_points_plain(pts, kl)
    pts = _aligned(pts)
    kernels.require_cuda(pts, kl)
    out = torch.empty_like(pts)
    kernels.launch("scale_points", "scale_points_launch", pts.data_ptr(),
                   kl.data_ptr(), out.data_ptr(), pts.numel() // 64,
                   kernels.stream(pts))
    return out
