"""verify_s: the mean wall time of the verifies started and finished in
the window (host clock)."""


def read(ctx):
    t = ctx["times"].get("verify")
    return sum(t) / len(t) if t else None
