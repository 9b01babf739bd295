"""Prover sharding context: split a prove over the ranks of a Mesh.

Counterpart of the JAX package's parallel/context.py. There, `shard_big`
places a tensor with a NamedSharding and XLA inserts the collectives. Here
every rank is a process (torch.distributed) that runs the whole prover on
the same inputs, and `shard_big` returns this rank's share of a big
tensor. The sumcheck drivers (models/sumcheck.py) and the bulk commits
(models/commitments.py) see the active mesh and add the ranks' partial
results exactly, so a sharded prove is byte-identical to a single-rank
one. A tensor is always split over every rank of the mesh (for a two-axis
mesh, ranks flattened with chips fastest).

Layout: a tensor is split by the low bits of its index along the axis
(rank k of n holds entries k, k + n, k + 2n, ...), not in contiguous
blocks. The sumcheck folds bind the top bit of an axis first (ops/
sumcheck.py `_lohi`: entry i with entry i + n_half), so every fold whose
half length is at least n pairs two entries of one rank.

Usage, in each rank of a group (see _dryrun_stages.py `launch`):

    with prover_mesh(make_mesh()):
        proof = NIZK.prove(...)

With no active mesh `shard_big` is the identity.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def current_mesh():
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def prover_mesh(mesh):
    """Split the proves inside the block over every rank of `mesh`."""
    prev = current_mesh()
    _STATE.mesh = mesh
    try:
        yield
    finally:
        _STATE.mesh = prev


def split_low(x, axis: int, n: int, idx: int):
    """Entries idx, idx + n, idx + 2n, ... of x along dim `axis` (whose
    length n divides)."""
    axis = axis % x.dim()
    return x.unflatten(axis, (-1, n)).select(axis + 1, idx).contiguous()


def shard_big(x, axis: int):
    """This rank's share of `x` along dim `axis` (`split_low` by its rank;
    the tensor itself when no mesh is active or the axis does not
    divide)."""
    mesh = current_mesh()
    if mesh is None or x.shape[axis] % mesh.size:
        return x
    return split_low(x, axis, mesh.size, mesh.rank)
