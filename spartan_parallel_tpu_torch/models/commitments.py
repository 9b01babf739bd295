"""Pedersen multi-commitments (reference: src/commitments.rs).

Generators are derived exactly as the reference does (shake256 of
label || compressed basepoint, read in 64-byte chunks through the ristretto
one-way map, commitments.rs:15-33), so commitments are bit-compatible with
the JAX package's.

Host/device split as in the JAX package: small commits run on the host
(native C Straus); bulk row commits of device-resident Montgomery rows run
through the batched MSM kernel (ops/msm.py, K2) when their total work
exceeds the threshold below. Under an active prover mesh of several ranks
(parallel/context.py) the threshold is 8192 on any device, and bulk
commits split their points over the ranks (parallel/msm_sharded.py).
Results are exact either way, so the proof bytes do not depend on the
threshold or the split.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..core.consts import L as L_MOD
from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import curve, fq, msm, ristretto_dev
from ..ops import limbs as lb
from ..parallel.context import current_mesh

_MESH_MSM_MAX = 8192


def host_msm_max(device: torch.device) -> int:
    """Total work (rows x (points + 1)) up to which a row commit stays on
    the host: on the card 8192, the JAX package's accelerator threshold;
    on the CPU the host path takes everything."""
    return 8192 if device.type == "cuda" else 1 << 62


def _mesh_active() -> bool:
    mesh = current_mesh()
    return mesh is not None and mesh.size > 1


def _bulk_msm(points_dev: torch.Tensor, limbs: torch.Tensor) -> list:
    """Device MSM of a bulk commit; under an active mesh of several ranks
    its points split over them (parallel/msm_sharded.py), as the JAX
    package's _bulk_msm does."""
    mesh = current_mesh()
    if mesh is not None and mesh.size > 1 and \
            points_dev.shape[0] >= 2 * mesh.size:
        from ..parallel.msm_sharded import msm_sharded

        return msm_sharded(mesh, points_dev, limbs)
    return msm.msm(points_dev, limbs)


class MultiCommitGens:
    __slots__ = ("n", "G", "h", "_dev")

    def __init__(self, n: int, label: bytes, _raw=None):
        if _raw is not None:
            self.n, self.G, self.h = _raw
        else:
            shake = hashlib.shake_256()
            shake.update(label)
            shake.update(RistrettoPoint.basepoint().compress())
            stream = shake.digest(64 * (n + 1))
            gens = [
                RistrettoPoint.from_uniform_bytes(stream[64 * i: 64 * i + 64])
                for i in range(n + 1)
            ]
            self.n = n
            self.G = gens[:n]
            self.h = gens[n]
        self._dev = {}

    def split_at(self, mid: int):
        return (
            MultiCommitGens(0, b"", _raw=(mid, self.G[:mid], self.h)),
            MultiCommitGens(0, b"", _raw=(self.n - mid, self.G[mid:], self.h)),
        )

    def scale(self, s: Scalar) -> "MultiCommitGens":
        return MultiCommitGens(
            0, b"", _raw=(self.n, [g * s for g in self.G], self.h)
        )

    def device_points(self, device) -> torch.Tensor:
        """(n+1, 4, 16) tensor on `device`: G ++ [h]."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = lb.to_device(
                curve.encode_points(self.G + [self.h]), device)
        return self._dev[key]

    def comb_tables(self, device) -> torch.Tensor:
        """The fixed-base comb tables of G ++ [h] (ops/ristretto_dev.py),
        (n+1, 64, 16, 4, 16), built once and kept on `device`."""
        key = ("comb", str(device))
        if key not in self._dev:
            self._dev[key] = lb.to_device(
                ristretto_dev.make_comb_tables(self.G + [self.h]), device)
        return self._dev[key]


def _to_int_rows(values) -> np.ndarray:
    """list[Scalar]/ints or (B, n) object array -> (B, n) object ints."""
    if isinstance(values, np.ndarray) and values.dtype == object:
        return values if values.ndim == 2 else values[None]
    row = np.array([int(v) for v in values], dtype=object)
    return row[None]


def commit(values, blind, gens: MultiCommitGens) -> RistrettoPoint:
    """<values, G[..len]> + blind*h (commitments.rs:70-91)."""
    return commit_rows(_to_int_rows(values), [blind], gens)[0]


def commit_scalar(x, blind, gens: MultiCommitGens) -> RistrettoPoint:
    assert gens.n >= 1
    return gens.G[0] * int(x) + gens.h * int(blind)


def commit_rows(rows, blinds, gens: MultiCommitGens):
    """Commit of B rows of host scalars sharing generators. On one rank
    every host-scalar commit stays on the host (the paths' are a few
    thousand points at most, below the device threshold); under an active
    mesh of several ranks a commit of more than 8192 points of work goes
    to the sharded MSM on the mesh's devices."""
    rows = _to_int_rows(rows)
    b, n = rows.shape
    assert gens.n >= n
    pts = gens.G[:n] + [gens.h]
    if not _mesh_active() or b * (n + 1) <= _MESH_MSM_MAX:
        return [multiscalar_mul(list(r) + [int(x)], pts)
                for r, x in zip(rows, blinds)]
    dev = current_mesh().device
    scal = [int(v) % L_MOD for r, x in zip(rows, blinds)
            for v in list(r) + [int(x)]]
    limbs = lb.to_device(lb.ints_to_limbs(scal), dev).reshape(b, n + 1, 16)
    idx = torch.cat([torch.arange(n), torch.tensor([gens.n])]).to(dev)
    return _bulk_msm(gens.device_points(dev)[idx], limbs)


def commit_rows_device(rows_mont: torch.Tensor, blinds,
                       gens: MultiCommitGens):
    """Batched commit of device-resident Montgomery rows (B, n, 16)."""
    b, n, _ = rows_mont.shape
    assert gens.n >= n
    limit = _MESH_MSM_MAX if _mesh_active() else \
        host_msm_max(rows_mont.device)
    if b * (n + 1) <= limit:
        vals = fq.decode(rows_mont.reshape(-1, 16))
        pts = gens.G[:n] + [gens.h]
        return [multiscalar_mul(vals[i * n:(i + 1) * n] + [int(blinds[i])],
                                pts) for i in range(b)]
    dev = rows_mont.device
    canon = fq.to_canonical(rows_mont)
    pts_dev = gens.device_points(dev)
    if all(int(x) == 0 for x in blinds):
        # zero blinds (the fork passes None for every witness poly):
        # 0*h = identity, so the h column is dropped
        return _bulk_msm(pts_dev[:n], canon)
    blind_limbs = curve.scalar_limbs(blinds, dev).reshape(b, 1, 16)
    scal = torch.cat([canon, blind_limbs], dim=1)
    idx = torch.cat([torch.arange(n), torch.tensor([gens.n])]).to(dev)
    return _bulk_msm(pts_dev[idx], scal)
