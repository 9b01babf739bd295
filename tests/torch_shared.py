"""A result that the pytest-xdist workers of one run share.

The suite runs with `--dist load`, which hands a file's tests to several
workers in chunks, and each worker sets up a module-scoped fixture again.
A fixture that proves with the JAX package (minutes of XLA compiles on a
cold cache) computes its plain result once per run through
`shared_result`; the other workers wait for it and read it back.
`in_fresh_process` runs a computation in a new interpreter, so that the
XLA executables it compiles do not stay in a worker. `device_rounds`
gives CPU tables the port's device-resident sumcheck rounds.
"""

import contextlib
import os
import pickle

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


def in_fresh_process(fn, *args):
    """fn(*args) in a new interpreter (multiprocessing's spawn context),
    so that what it compiles and allocates leaves with the process; fn,
    its arguments and its result must pickle."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as ex:
        return ex.submit(fn, *args).result()


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
