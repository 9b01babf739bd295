"""The MSM with its points split over the ranks of a mesh.

Counterpart of the JAX package's parallel/msm_sharded.py, the sharded form
of the one parallel site of the reference (the Hyrax row commitments,
src/dense_mlpoly.rs:183-212). Each rank runs K2 (ops/msm.py msm_dev) on
its contiguous block of the point axis; the (B, 4, 16) partials of all
ranks are gathered (one all_gather) and added by K12 (ops/curve.py
point_sum). An MSM is a group sum and ristretto compression is canonical,
so any split gives the same commitments.

Points that do not divide by the number of ranks are padded with the
identity and zero scalars (the JAX package asserts divisibility instead).
"""

from __future__ import annotations

import torch

from ..ops import curve, msm
from .mesh import Mesh


def msm_sharded_dev(mesh: Mesh, points_dev: torch.Tensor,
                    scalar_limbs: torch.Tensor) -> torch.Tensor:
    """points (N, 4, 16) and scalars (B, N, 16) canonical limbs, both whole
    on every rank; returns the (B, 4, 16) sums on every rank."""
    if scalar_limbs.dim() == 2:
        scalar_limbs = scalar_limbs[None]
    n_dev, idx = mesh.size, mesh.rank
    n = points_dev.shape[0]
    pad = -n % n_dev
    if pad:
        points_dev = torch.cat([points_dev, torch.as_tensor(
            curve.identity((pad,)), device=points_dev.device)])
        scalar_limbs = torch.cat([scalar_limbs, scalar_limbs.new_zeros(
            (scalar_limbs.shape[0], pad, 16))], 1)
    blk = (n + pad) // n_dev
    local = msm.msm_dev(points_dev[idx * blk:(idx + 1) * blk],
                        scalar_limbs[:, idx * blk:(idx + 1) * blk])
    return curve.point_sum(mesh.all_gather(local))


def msm_sharded(mesh: Mesh, points_dev: torch.Tensor,
                scalar_limbs: torch.Tensor) -> list:
    """As msm_sharded_dev; returns B host RistrettoPoints (cf.
    ops/msm.py msm)."""
    return curve.decode_points(msm_sharded_dev(mesh, points_dev,
                                               scalar_limbs))
