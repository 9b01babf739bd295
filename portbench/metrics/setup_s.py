"""setup_s: seconds from the process's start to the first timed request:
imports, the kernels' build or load, the instance with its digest, the
generators, the SPARK encode, the inputs and one warm-up request."""


def read(ctx):
    return ctx["setup_s"]
