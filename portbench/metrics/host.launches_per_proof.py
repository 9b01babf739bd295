"""host.launches_per_proof: calls of the port's kernel launch
(ops/kernels.py `launch`) during a prove, averaged over the window's
proves. (A composite counter of kernels.launches, such as eq_fold's,
counts one launch twice; the calls of `launch` do not.)"""

from portbench import tracedata

WRAPS = {"spartan_parallel_tpu_torch.ops.kernels:launch": None}


def read(ctx):
    v = tracedata.counted(ctx, __file__, "prove")
    return sum(v) / len(v) if v and sum(v) else None
