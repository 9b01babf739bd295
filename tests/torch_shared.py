"""A result that the pytest-xdist workers of one run share.

The suite runs with `--dist load`, which hands a file's tests to several
workers in chunks, and each worker sets up a module-scoped fixture again.
A fixture that proves with the JAX package (minutes of XLA compiles on a
cold cache) computes its plain result once per run through
`shared_result`; the other workers wait for it and read it back.
`in_fresh_process` runs a computation in a new interpreter, so that the
XLA executables it compiles do not stay in a worker; `case_rng` seeds a
case's inputs from its key, so that such a process and every worker
draw the same. `msm_edge_scalars`
lists the scalars at the edges of K2's signed digit recoding. `device_rounds`
gives CPU tables the port's device-resident sumcheck rounds. `rank_jobs`
is what each rank of a multi-rank launch runs
(spartan_parallel_tpu_torch._dryrun_stages.launch).
"""

import contextlib
import os
import pickle
import zlib

from filelock import FileLock


def shared_result(tmp_path_factory, name: str, compute):
    """compute() once per test run; its result must pickle. Without xdist
    this is a plain call."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / (name + ".pkl")
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            return pickle.loads(path.read_bytes())
        out = compute()
        path.write_bytes(pickle.dumps(out))
        return out


def case_rng(*key):
    """The numpy generator of one test case's inputs, seeded from the
    case's key alone: the same in every worker and in the fresh process
    that computes the case's JAX values."""
    import numpy as np

    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def in_fresh_process(fn, *args, timeout=None):
    """fn(*args) in a new interpreter (multiprocessing's spawn context),
    so that what it compiles and allocates leaves with the process; fn,
    its arguments and its result must pickle. With `timeout` (seconds) a
    child that has not answered by then is killed and TimeoutError
    raised."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    ex = ProcessPoolExecutor(max_workers=1, mp_context=ctx)
    try:
        return ex.submit(fn, *args).result(timeout=timeout)
    except TimeoutError:
        for p in list(ex._processes.values()):
            p.kill()
        raise
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


@contextlib.contextmanager
def device_rounds():
    """Inside the block the port's ZK sumchecks run their device-resident
    rounds on CPU tables too (the plain round tail of ops/zk_round.py),
    where the tables' device would pick the host loop."""
    import pytest

    from spartan_parallel_tpu_torch.models import sumcheck

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sumcheck, "_device_rounds_on", lambda device: True)
        yield


def msm_edge_scalars() -> list:
    """Canonical scalars at the edges of K2's signed 8-bit recoding
    (csrc/msm.cuh signed_digits: a byte plus the carry in, from 128 up,
    becomes itself - 256 and a carry out): 0, 1, l - 1; byte w alone at
    0x7F, 0x80 and 0xFF for every window w below the top; bytes 0-30 all
    at 0x7F, 0x80 or 0xFF under a top byte of 0x0F; a carry from a 0x80
    byte that ripples through seventeen 0xFF bytes."""
    from spartan_parallel_tpu_torch.core.consts import L

    out = [0, 1, L - 1]
    out += [v << (8 * w) for w in range(31) for v in (0x7F, 0x80, 0xFF)]
    out += [int.from_bytes(bytes([v] * 31 + [0x0F]), "little")
            for v in (0x7F, 0x80, 0xFF)]
    out.append(int.from_bytes(bytes([0] * 3 + [0x80] + [0xFF] * 17
                                    + [0] * 10 + [0x0F]), "little"))
    assert all(0 <= s < L for s in out)
    return out


def rank_jobs(mesh, device, jobs):
    """One rank's part of a launch: each job (name, args) in turn, the
    results as a list. A name is a stage function of
    spartan_parallel_tpu_torch._dryrun_stages; "msm_sharded" commits the
    numpy points and scalar limbs of args through the sharded MSM and
    gives the compressed points; "device_rounds" runs the job args[0]
    with the device-resident round form forced on CPU tables; "fail"
    raises on rank args[0] while the other ranks wait in a barrier."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds

    out = []
    for name, args in jobs:
        if name == "msm_sharded":
            import torch

            from spartan_parallel_tpu_torch.ops import curve
            from spartan_parallel_tpu_torch.parallel.msm_sharded import (
                msm_sharded,
            )

            pts, limbs = (torch.from_numpy(a).to(device) for a in args)
            out.append([p.compress() for p in msm_sharded(mesh, pts,
                                                          limbs)])
        elif name == "device_rounds":
            from spartan_parallel_tpu_torch.models import sumcheck

            pick = sumcheck._device_rounds_on
            sumcheck._device_rounds_on = lambda device: True
            try:
                out += rank_jobs(mesh, device, [args])
            finally:
                sumcheck._device_rounds_on = pick
        elif name == "fail":
            import torch.distributed as dist

            if mesh.rank == args[0]:
                raise ValueError(f"rank {mesh.rank} fails on purpose")
            dist.barrier()
        else:
            out.append(getattr(ds, name)(mesh, device, *args))
    return out
