"""Ranks, process groups and the sharded phase-1 round.

Counterpart of the JAX package's parallel/mesh.py. A `Mesh` is the group
of ranks a prove is split over (torch.distributed must be initialized in
every rank first, e.g. by _dryrun_stages.py `launch`): the process group,
one subgroup per axis for a two-axis mesh, the world size, this rank, the
axis names and this rank's device.

The backend follows what the ranks see (`pick_backend`): NCCL when every
rank has a card of its own, gloo when ranks share a card or run on the
CPU. Under gloo the collectives of tensors on the card go through host
memory; under NCCL they stay on the card's stream, with no host sync.

Cross-rank sums of field elements and points are exact group sums
(`sum_partials`: one all_gather, then K1's sum_reduce; the sharded MSM's
points: one all_gather, then K12), so the transcript cannot depend on the
number of ranks.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core import device as _device
from ..core.consts import L
from ..ops import fq
from ..ops import sumcheck as sck
from .context import split_low


def pick_backend(world_size: int, device) -> str:
    """NCCL when each of the world_size ranks can have a card of its own,
    else gloo (ranks that share a card, or CPU ranks)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dist.is_nccl_available() and \
            world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device) -> torch.device:
    """The device of a rank: card rank mod the card count, or the CPU."""
    dev = _device.resolve(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class Mesh:
    """The ranks of a prove: axis names and sizes (row-major, the last axis
    fastest, so a rank's flat shard index is its rank), the process group
    of each axis that holds this rank, this rank's device, a count of the
    collectives it ran with their host-clock seconds, and the number of
    rounds each sumcheck ran on split tables (`split_rounds`, one entry a
    sumcheck, models/sumcheck.py)."""

    def __init__(self, axis_names, shape, groups, device):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)
        self.size = math.prod(self.shape)
        self.rank = dist.get_rank()
        if dist.get_world_size() != self.size:
            raise ValueError(f"a mesh of {self.size} ranks in a world of "
                             f"{dist.get_world_size()}")
        self.groups = dict(zip(self.axis_names, groups))
        self.device = rank_device(self.rank, device)
        self.backend = dist.get_backend()
        self.collectives = 0
        self.collective_s = 0.0
        self.split_rounds = []

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, ordered by rank. One
        all_gather per axis, the fastest axis first."""
        out = t.contiguous()
        for ax, n in reversed(list(zip(self.axis_names, self.shape))):
            out = self._gather1(out, self.groups[ax], n)
        return out.reshape((-1,) + tuple(t.shape))

    def _gather1(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and t.device.type == "cuda"
        src = t.cpu() if staged else t
        bufs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(bufs, src, group=group)
        out = torch.stack(bufs)
        if staged:
            out = out.to(t.device)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0
        return out


def make_mesh(n_devices: int | None = None, axis: str = "q",
              device=None) -> Mesh:
    """A one-axis mesh of every rank of the initialized world."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a world of {world} "
                         "ranks")
    return Mesh((axis,), (world,), (dist.group.WORLD,), device)


def make_mesh2(n_hosts: int, n_chips: int, axes: tuple = ("host", "chip"),
               device=None) -> Mesh:
    """A two-axis (host, chip) mesh: rank = host * n_chips + chip (chips
    fastest, as the JAX package flattens its device grid). Each rank keeps
    the group of its host's chips and the group of its chip across hosts;
    every rank creates every group, in one order."""
    if dist.get_world_size() != n_hosts * n_chips:
        raise ValueError(f"need {n_hosts * n_chips} ranks, have "
                         f"{dist.get_world_size()}")
    rank = dist.get_rank()
    chip_groups = [dist.new_group([h * n_chips + c for c in range(n_chips)])
                   for h in range(n_hosts)]
    host_groups = [dist.new_group([h * n_chips + c for h in range(n_hosts)])
                   for c in range(n_chips)]
    return Mesh(axes, (n_hosts, n_chips),
                (host_groups[rank % n_chips], chip_groups[rank // n_chips]),
                device)


def shard_q(mesh: Mesh, arr: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """This rank's share of arr along its q axis (the layout of
    context.shard_big), on the rank's device."""
    if arr.shape[axis] % mesh.size:
        raise ValueError(f"q axis of {arr.shape[axis]} over {mesh.size} "
                         "ranks")
    return split_low(arr.to(mesh.device), axis, mesh.size, mesh.rank)


def replicate(mesh: Mesh, arr: torch.Tensor) -> torch.Tensor:
    """The whole of arr on every rank's device."""
    return arr.to(mesh.device)


def sum_partials(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The exact field sum over the ranks of (..., 16) Montgomery partials:
    an all_gather, then K1's sum_reduce over the rank axis."""
    return fq.sum_reduce(mesh.all_gather(t), 0)


def gather_axis(mesh: Mesh, items) -> list:
    """Entry 0 along `axis` of each (tensor, axis) of this rank, gathered
    from every rank into an axis of length mesh.size (rank k's entry at
    index k), with one collective for all the items."""
    pieces = [t.narrow(axis, 0, 1).contiguous() for t, axis in items]
    flat = torch.cat([p.reshape(-1) for p in pieces])
    g = mesh.all_gather(flat)
    out, off = [], 0
    for p, (_, axis) in zip(pieces, items):
        part = g[:, off:off + p.numel()].reshape((-1,) + tuple(p.shape))
        out.append(part.movedim(0, axis).squeeze(axis + 1).contiguous())
        off += p.numel()
    return out


def sharded_p1_round(tp, tq, tx, B, C, D, r, n_half, mode: int,
                     mesh: Mesh):
    """One phase-1 sumcheck round, evaluations then bind, with tq and
    B/C/D this rank's share along q (`shard_q`): K4 (ops/sumcheck.py
    p1_evals) on the share, the exact sum of the ranks' (3, 16)
    evaluations (`sum_partials`), then the bind on the share (K1). A
    q-mode round halves the rank's own n_half: the fold of a high bit
    stays on the rank. Returns (evals, this rank's bound tables)."""
    n_half = int(n_half)
    if mode == sck.MODE_Q:
        if n_half % mesh.size:
            raise ValueError(f"a q round of n_half {n_half} over "
                             f"{mesh.size} ranks")
        n_half //= mesh.size
    evals = sum_partials(mesh, sck.p1_evals(tp, tq, tx, B, C, D, n_half,
                                            mode))
    bound = sck.p1_bind(tp, tq, tx, B, C, D, r, n_half, mode)
    return evals, bound


def rand_tab(rng, *shape) -> torch.Tensor:
    """Random field elements (40 random bytes mod l each, as the JAX
    package's dryrun draws them) as a (*shape, 16) Montgomery tensor."""
    n = int(np.prod(shape)) if shape else 1
    vals = [int.from_bytes(rng.bytes(40), "little") % L for _ in range(n)]
    return torch.from_numpy(fq.encode(vals)).reshape(*shape, 16)


def dryrun_tables(P_i=2, Q=8, X=8, seed=0) -> dict:
    """The JAX package's dryrun tables tp, tq, tx, B, C, D (P_i, Q, X) and
    r, drawn in its order from numpy's default_rng(seed), on the CPU."""
    rng = np.random.default_rng(seed)
    t = {"tp": rand_tab(rng, P_i), "tq": rand_tab(rng, Q),
         "tx": rand_tab(rng, X)}
    for k in ("B", "C", "D"):
        t[k] = rand_tab(rng, P_i, Q, X)
    t["r"] = rand_tab(rng)
    return t


def dryrun_step(mesh: Mesh, P_i=2, Q=8, X=8):
    """One sharded round on the seed-0 dryrun tables, q split over the
    mesh. Returns (evals, this rank's bound tables)."""
    t = dryrun_tables(P_i, Q, X)
    B, C, D = (shard_q(mesh, t[k]) for k in ("B", "C", "D"))
    return sharded_p1_round(replicate(mesh, t["tp"]),
                            shard_q(mesh, t["tq"], axis=0),
                            replicate(mesh, t["tx"]), B, C, D,
                            replicate(mesh, t["r"]), X // 2, sck.MODE_X,
                            mesh)
