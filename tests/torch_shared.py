"""A result that the pytest-xdist workers of one run share.

The suite runs with `--dist load`, which hands a file's tests to several
workers in chunks, and each worker sets up a module-scoped fixture again.
A fixture that proves with the JAX package (minutes of XLA compiles on a
cold cache) computes its plain result once per run through
`shared_result`; the other workers wait for it and read it back.
"""

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
