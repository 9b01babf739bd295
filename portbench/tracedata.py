"""From a traced run's record to what the per-layer metrics read: each
wrapped call's shapes and device seconds, the calls counted, the device
intervals in each step's spans, and the breakdown of the result line; and
the helpers the metrics' readers share."""

from __future__ import annotations

import bisect
import os
import sys

from . import tracer as tr
from . import work


def _rate(device) -> float:
    """The int32 multiply rate of the card, computed from its SM count and
    maximum SM clock (printed on standard error as computed)."""
    import torch

    if device.type != "cuda":
        return work.int32_rate(1, 1e9)
    props = torch.cuda.get_device_properties(device)
    clock = work.max_sm_clock_hz(device.index or 0)
    src = "nvidia-smi clocks.max.sm"
    if clock is None:
        khz = getattr(props, "clock_rate", None)
        clock, src = (khz * 1e3, "device properties") if khz else \
            (1.98e9, "assumed 1980 MHz")
    rate = work.int32_rate(props.multi_processor_count, clock)
    print(f"int32 multiply rate (computed, not published): "
          f"{props.multi_processor_count} SMs x {work.INT32_LANES_PER_SM} "
          f"lanes x {clock / 1e6:.0f} MHz ({src}) = {rate:.4e}/s",
          file=sys.stderr)
    return rate


def prepare(ctx: dict) -> None:
    """Adds to ctx: `int32_rate`; `calls`, each wrapped call of each metric
    with its shapes, step, request and device seconds; `counts`, each
    metric's counted calls by (step, request); `spans`, each step's spans
    of the counted requests; `busy_window` and `breakdown`."""
    import torch

    tracer, parsed, device = ctx["tracer"], ctx["trace"], ctx["device"]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx["int32_rate"] = _rate(device)
    ctx["calls"], ctx["device_time_source"] = {}, {}
    for metric, calls in tracer.calls.items():
        secs = tr.call_device_seconds(parsed, metric, len(calls))
        source = "profiler"
        if secs is None:
            secs, source = tr.event_seconds(calls), "cuda_events"
        ctx["device_time_source"][metric] = source
        ctx["calls"][metric] = [dict(c, device_s=t)
                                for c, t in zip(calls, secs)]
    ctx["counts"] = tracer.counts

    spans = {}
    for s, e, name in parsed["ranges"]:
        if name.startswith("s:"):
            step, idx = name[2:].rsplit("#", 1)
            spans.setdefault(step, {})[int(idx)] = (s, e)
    ctx["spans"] = {step: [spans.get(step, {})[i] for i in got
                           if i in spans.get(step, {})]
                    for step, got in ctx["ids"].items()}
    merged = parsed["device"]
    ctx["busy_by_step"] = {step: [tr.covered(merged, s, e) for s, e in sp]
                           for step, sp in ctx["spans"].items()}
    every = [se for by in spans.values() for se in by.values()]
    if every:
        w0 = min(s for s, _ in every)
        w1 = max(e for _, e in every)
        ctx["busy_window"] = (tr.covered(merged, w0, w1), w1 - w0)
    else:
        ctx["busy_window"] = (0.0, 0.0)

    ops = sorted(parsed["ops"].items(), key=lambda kv: -kv[1])[:10]
    ctx["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                        "idle_gaps": idle_gaps(parsed, every)[:10]}


def metric_name(path: str) -> str:
    """A metric's name from its reader's file path."""
    return os.path.basename(path)[:-len(".py")]


def counted_calls(ctx: dict, path: str, step: str) -> list:
    """The wrapped calls of the metric read by the file at `path` that ran
    in `step` of the window's counted requests."""
    got = set(ctx["ids"].get(step, ()))
    return [c for c in ctx["calls"].get(metric_name(path), ())
            if c["step"] == step and c["req"] in got]


def counted(ctx: dict, path: str, step: str) -> list:
    """The metric's call counts in `step`, one a counted request."""
    by = ctx["counts"].get(metric_name(path), {})
    return [by.get((step, i), 0) for i in ctx["ids"].get(step, ())]


def roofline(calls: list, least_of, rate: float):
    """Per cent of the calls' least seconds in their device seconds;
    least_of(call) gives a call's (bytes, multiplies). None where there
    is nothing to read."""
    least = sum(work.least_seconds(*least_of(c), rate) for c in calls)
    dev = sum(c["device_s"] for c in calls)
    return 100.0 * least / dev if dev > 0 and least > 0 else None


def idle_gaps(parsed: dict, spans) -> list:
    """Idle device time inside the spans, summed by the innermost stage
    (a Timer span, `t:<label>`) running on the host at each gap's middle,
    largest first."""
    merged = parsed["device"]
    stages = sorted((s, e, n[2:]) for s, e, n in parsed["ranges"]
                    if n.startswith("t:"))
    starts = [st[0] for st in stages]
    m_starts = [m[0] for m in merged]
    by = {}
    for s, e in spans:
        cur = s
        i = max(bisect.bisect_right(m_starts, s) - 1, 0)
        pieces = []
        while i < len(merged) and merged[i][0] < e:
            if merged[i][1] > s:
                pieces.append(merged[i])
            i += 1
        for a, b in pieces + [[e, e]]:
            if a > cur:
                mid = (cur + a) / 2
                name = "(no stage)"
                j = bisect.bisect_right(starts, mid) - 1
                stop = max(j - 512, -1)
                while j > stop:
                    if stages[j][1] >= mid:
                        name = stages[j][2]
                        break
                    j -= 1
                by[name] = by.get(name, 0.0) + (a - cur)
            cur = max(cur, b)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])
