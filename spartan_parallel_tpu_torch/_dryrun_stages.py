"""Multi-device dryrun stages, and the launcher that runs them on D ranks.

Counterpart of the JAX package's _dryrun_stages.py. There one process
holds a virtual D-device CPU platform; here D processes (ranks) join one
torch.distributed group and each runs the whole prover with its share of
the big tensors (parallel/).

    python -m spartan_parallel_tpu_torch._dryrun_stages <stage> <D>
        [--device cpu] [--timeout SECONDS]

runs one stage on D new ranks (the card unless --device cpu), checks that
every rank made the same proof, and prints one JSON line: the stage, the
backend, and per rank its prove seconds, its kernel launches and its
collectives. Any rank that fails makes the command exit non-zero.

Stages (the JAX package's, at the same shapes unless given others):
  1_sharded_round  one phase-1 round on q-sharded seed-0 tables
  2_nizk           the NIZK, n = max(64, 8 D); a two-axis (host, chip)
                   mesh when D >= 4 and D is even
  3_snark          the 9-stage SNARK of the counter program
  4_dp_r1cs        the data-parallel R1CSProof, 32 constraints, executed
                   [4, 2, 1] times (the q-size-classed prover)
Each stage function takes (mesh, device, ...) and runs on one rank
without a mesh too, which gives the single-rank result it is held
against.

`launch` starts the ranks with the spawn start method (CUDA cannot be
forked), meets them at a TCP rendezvous on 127.0.0.1, builds the kernels
once before it starts them (so the ranks never race nvcc), and bounds
both the group's set-up and the run by `timeout`: a rank that raises, or
dies, ends the launch with an error at once, and the other ranks are
killed.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import queue
import socket
import sys
import time
import traceback


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------
def _meshes(world: int):
    """The mesh shape of a proof stage: (2, D / 2) when D >= 4 and even,
    else (D,)."""
    return (2, world // 2) if world >= 4 and world % 2 == 0 else (world,)


def common_seed(mesh, seed: bytes | None) -> bytes:
    """The random tape's seed, the same on every rank: `seed`, or 32 fresh
    bytes drawn by rank 0 and sent to the others."""
    if seed is not None or mesh is None:
        return seed if seed is not None else os.urandom(32)
    import torch.distributed as dist

    box = [os.urandom(32) if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _prove(mesh, prove, device):
    """prove() under prover_mesh(mesh) (with no mesh, on one rank): its
    result, its seconds, and the number of split rounds of each sumcheck
    it ran (parallel/mesh.py Mesh.split_rounds; [] on one rank)."""
    import contextlib

    import torch

    from .parallel.context import prover_mesh

    n0 = 0 if mesh is None else len(mesh.split_rounds)
    with contextlib.nullcontext() if mesh is None else prover_mesh(mesh):
        t0 = time.perf_counter()
        out = prove()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return out, seconds, [] if mesh is None else mesh.split_rounds[n0:]


def warm_comb_tables(sat_gens, device) -> None:
    """Build the comb tables of the SAT proofs' sumcheck generators on the
    card before a timed prove (set-up, as the generators themselves)."""
    import torch

    if torch.device(device).type == "cuda":
        for g in sat_gens:
            g.gens_sc.gens_4.comb_tables(device)
            g.gens_sc.gens_1.comb_tables(device)


def sharded_round(mesh, device, tables: dict, n_half: int,
                  mode: int) -> dict:
    """One phase-1 round (parallel/mesh.py sharded_p1_round) on tables
    split along q from the whole numpy `tables`; without a mesh, the
    unsharded round. Returns the evaluations and this rank's bound tables
    (numpy)."""
    import torch

    from .ops import sumcheck as sck
    from .parallel.mesh import sharded_p1_round, shard_q

    t = {k: torch.from_numpy(v).to(device) for k, v in tables.items()}
    if mesh is not None:
        for k in ("B", "C", "D"):
            t[k] = shard_q(mesh, t[k])
        t["tq"] = shard_q(mesh, t["tq"], 0)
    args = [t[k] for k in ("tp", "tq", "tx", "B", "C", "D")]
    if mesh is None:
        evals = sck.p1_evals(*args, n_half, mode)
        bound = sck.p1_bind(*args, t["r"], n_half, mode)
    else:
        evals, bound = sharded_p1_round(*args, t["r"], n_half, mode, mesh)
    return {"evals": evals.cpu().numpy(),
            "bound": [b.cpu().numpy() for b in bound]}


def stage_1_sharded_round(mesh, device, P_i=2, Q=None, X=8) -> dict:
    """parallel/mesh.py dryrun_step (JAX: Q = max(8, 2 D)); without a mesh
    the unsharded round on the same tables."""
    from .ops import sumcheck as sck
    from .parallel.mesh import dryrun_step, dryrun_tables

    world = 1 if mesh is None else mesh.size
    Q = max(8, 2 * world) if Q is None else Q
    if mesh is None:
        tables = {k: v.numpy() for k, v in dryrun_tables(P_i, Q, X).items()}
        return sharded_round(None, device, tables, X // 2, sck.MODE_X)
    evals, bound = dryrun_step(mesh, P_i, Q, X)
    return {"evals": evals.cpu().numpy(),
            "bound": [b.cpu().numpy() for b in bound]}


def stage_2_nizk(mesh, device, n=None, num_inputs=4, seed=2,
                 tape_seed=None, label=b"dryrun") -> dict:
    """The NIZK of the synthetic n x n instance with num_inputs inputs:
    prove under the mesh (every rank), verify; the proof's bytes."""
    from . import serialization as ser
    from .models.nizk import NIZK, NIZKGens
    from .models.r1csinstance import produce_synthetic_r1cs
    from .utils.random_tape import RandomTape
    from .utils.transcript import Transcript

    world = 1 if mesh is None else mesh.size
    n = max(64, 8 * world) if n is None else n
    inst, vars_mat, inputs_mat = produce_synthetic_r1cs(
        1, [1], n, n, num_inputs, seed=seed, device=device)
    gens = NIZKGens(n, n, device=device)
    warm_comb_tables([gens.gens_r1cs_sat], device)
    tape = RandomTape(b"proof", seed=common_seed(mesh, tape_seed))

    def prove():
        return NIZK.prove(inst, vars_mat[0][0], inputs_mat[0][0], gens,
                          Transcript(label), tape, device=device)

    proof, prove_s, split = _prove(mesh, prove, device)
    proof.verify(inst, inputs_mat[0][0], gens, Transcript(label),
                 device=device)
    return {"bytes": ser.serialize(proof, "NIZK"), "prove_s": prove_s,
            "split_rounds": split}


def stage_3_snark(mesh, device, tape_seed=None,
                  label=b"snark_example") -> dict:
    """The 9-stage SNARK of the counter program: set-up, prove under the
    mesh, verify; the proof's bytes."""
    from . import examples as ex
    from . import serialization as ser

    args, pa = ex.build_counter_program()
    ctx = ex.setup_program_instances(args, pa, device=device)
    warm_comb_tables([ctx[k].gens_r1cs_sat for k in (
        "block_gens", "pairwise_gens", "perm_root_gens")], device)
    seed = common_seed(mesh, tape_seed)

    def prove():
        return ex.prove_program(pa, ctx, label=label, tape_seed=seed,
                                device=device)

    proof, prove_s, split = _prove(mesh, prove, device)
    ex.verify_program(proof, pa, ctx, label=label, device=device)
    return {"bytes": ser.serialize(proof, "SNARK"), "prove_s": prove_s,
            "split_rounds": split}


def stage_4_dp_r1cs(mesh, device, num_proofs=(4, 2, 1), ncons=32,
                    num_inputs=4, seed=3, tape_seed=None,
                    label=b"dryrun_dp") -> dict:
    """The data-parallel R1CSProof: P = len(num_proofs) synthetic blocks
    of ncons constraints, block p executed num_proofs[p] times (skewed
    counts take the q-size-classed prover), two witness sections (vars,
    io). Commits the witness and proves under the mesh, then verifies;
    the proof's bytes."""
    from . import serialization as ser
    from .models import r1csproof as rp
    from .models.r1csinstance import produce_synthetic_r1cs
    from .utils.random_tape import RandomTape
    from .utils.transcript import Transcript

    num_proofs = list(num_proofs)
    P, qmax = len(num_proofs), max(num_proofs)
    inst, vars_mat, inputs_mat = produce_synthetic_r1cs(
        P, num_proofs, ncons, ncons, num_inputs, seed=seed, device=device)
    nv = inst.get_num_vars() // 2
    io_mat = [[[1] + list(io) + [0] * (nv - 1 - len(io))
               for io in inputs_mat[p]] for p in range(P)]
    secs = [rp.ProverWitnessSecInfo.from_scalars([nv] * P, m, device)
            for m in (vars_mat, io_mat)]
    gens = rp.R1CSGens(b"gens_r1cs_sat", ncons, qmax * nv)
    warm_comb_tables([gens], device)
    tape = RandomTape(b"proof", seed=common_seed(mesh, tape_seed))

    def prove():
        comms = [[s.poly_w[p].commit(gens.gens_pc, None)[0]
                  for p in range(P)] for s in secs]
        return comms, rp.R1CSProof.prove(
            P, qmax, num_proofs, nv, [nv] * P, secs, inst, gens,
            Transcript(label), tape, device)

    (comms, (proof, r)), prove_s, split = _prove(mesh, prove, device)
    views = [rp.VerifierWitnessSecInfo(num_proofs, [nv] * P, c)
             for c in comms]
    _, bound = inst.multi_evaluate_bound_rp(r[0], r[2], r[3], device=device)
    if proof.verify(P, qmax, num_proofs, nv, views, nv, gens, bound,
                    Transcript(label), device) != r:
        raise AssertionError("the verifier returned another point")
    return {"bytes": ser.serialize(proof, "R1CSProof"), "prove_s": prove_s,
            "split_rounds": split}


STAGES = {
    "1_sharded_round": stage_1_sharded_round,
    "2_nizk": stage_2_nizk,
    "3_snark": stage_3_snark,
    "4_dp_r1cs": stage_4_dp_r1cs,
}


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, init_method, backend, device, shape, timeout,
               fn, args, results):
    """One rank: join the group, build the mesh, run fn(mesh, device,
    *args) with the launch counts set to 0 just before, and put (rank,
    ok, report) on `results`."""
    try:
        import torch
        import torch.distributed as dist

        from .ops import kernels
        from .parallel import mesh as pm

        dev = pm.rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = pm.make_mesh2(*shape, device=dev) if len(shape) == 2 \
                else pm.make_mesh(device=dev)
            kernels.reset_counts()
            t0 = time.perf_counter()
            out = fn(mesh, dev, *args)
            report = {"result": out, "seconds": time.perf_counter() - t0,
                      "launches": {k: v for k, v in kernels.launches.items()
                                   if v},
                      "collectives": mesh.collectives,
                      "collective_s": mesh.collective_s,
                      "backend": mesh.backend, "device": str(dev)}
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, report))
    except BaseException:  # the launcher reports it and fails the launch
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world: int, args=(), device=None, shape=None,
           timeout: float = 600.0) -> list:
    """fn(mesh, device, *args) on `world` new ranks: one process each,
    spawned, joined in one torch.distributed group (`pick_backend`), with a
    mesh of `shape` (default (world,); (H, C) for a two-axis mesh). fn and
    its arguments must pickle (a module-level function). Returns each
    rank's report, rank 0 first: fn's result, its seconds, its kernel
    launches, its collectives and their seconds, the backend. Raises when
    a rank fails or the whole launch outlasts `timeout` seconds."""
    import multiprocessing

    from .core import device as _device
    from .ops import kernels
    from .parallel.mesh import pick_backend

    dev = _device.resolve(device)
    if dev.type == "cuda":
        kernels.build()
    shape = tuple(shape or (world,))
    backend = pick_backend(world, dev)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, init, backend, dev.type, shape, timeout, fn, args,
        results)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got = {}
    try:
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} died (exit code "
                                       f"{procs[dead[0]].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
    return [got[r] for r in range(world)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("stage", choices=sorted(STAGES))
    ap.add_argument("world", type=int, help="the number of ranks, D")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--timeout", type=float, default=900.0)
    a = ap.parse_args(argv)
    shape = (a.world,) if a.stage == "1_sharded_round" else \
        _meshes(a.world)
    reports = launch(STAGES[a.stage], a.world, device=a.device, shape=shape,
                     timeout=a.timeout)
    digests = []
    for rep in reports:
        res = rep.pop("result")
        raw = res["bytes"] if "bytes" in res else res["evals"].tobytes()
        digests.append(hashlib.sha256(raw).hexdigest())
        rep["prove_s"] = res.get("prove_s")
        rep["split_rounds"] = res.get("split_rounds")
    same = len(set(digests)) == 1
    print(json.dumps({"stage": a.stage, "world": a.world, "mesh": shape,
                      "backend": reports[0]["backend"],
                      "ranks_agree": same, "sha256": digests[0],
                      "ranks": reports}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
