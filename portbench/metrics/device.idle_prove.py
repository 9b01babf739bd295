"""device.idle_prove: per cent of the window's prove spans in which no
kernel, copy or fill ran on the card (torch.profiler's device trace)."""

from portbench.tracer import idle_share


def read(ctx):
    if not ctx["trace"]["device"]:
        return None
    return idle_share(ctx["trace"]["device"], ctx["spans"].get("prove", []))
