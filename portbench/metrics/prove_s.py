"""prove_s: the mean wall time of the proves started and finished in the
window (host clock, from the call to the proof object in host memory)."""


def read(ctx):
    t = ctx["times"].get("prove")
    return sum(t) / len(t) if t else None
