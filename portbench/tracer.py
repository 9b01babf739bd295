"""The traced run: spans, the wrapped entry points and the device trace.

Only a `--trace 1` run installs any of this. It wraps, from outside the
port, the entry points that the cell's per-layer metrics name in their
`WRAPS` (portbench/metrics/<name>.py: "module:attribute" to a function of
the call's arguments that returns its shapes, or None to count calls
only), and the port's stage Timer (utils/timer.py, so that each stage is a
span of the trace), and runs torch.profiler over the window. A wrapped
call with shapes is a record_function range named `c:<metric>#<index>`;
its shapes, step and request are kept here. After the window the
profiler's Chrome trace is read back: kernels are tied to the range that
launched them through the launch's correlation id; where the trace holds
no kernels, CUDA events recorded around each wrapped call give its device
time instead.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os


def _union(intervals):
    """Sorted, merged copy of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, s: float, e: float) -> float:
    """Length of [s, e] covered by merged intervals."""
    tot = 0.0
    i = bisect.bisect_right([m[0] for m in merged], s) - 1
    i = max(i, 0)
    while i < len(merged) and merged[i][0] < e:
        a, b = merged[i]
        lo, hi = max(a, s), min(b, e)
        if hi > lo:
            tot += hi - lo
        i += 1
    return tot


def idle_share(merged, spans) -> float | None:
    """Per cent of the spans' total length in which no device interval
    ran; None without spans."""
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    busy = sum(covered(merged, s, e) for s, e in spans)
    return 100.0 * (1.0 - busy / total)


class Tracer:
    """Wraps the port's entry points for the window of a traced run."""

    def __init__(self, trace_path: str):
        self.path = trace_path
        self.calls = {}  # metric -> [shapes, step, request, events]
        self.counts = {}  # metric -> {(step, request): calls}
        self.step = self.req = None
        self._undo = []
        self._depth = {}
        self._prof = None
        self._timers = {}

    def at(self, step, req) -> None:
        """The step and request that the calls from now on belong to."""
        self.step, self.req = step, req

    # -- spans --------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str):
        import torch

        with torch.profiler.record_function(name):
            yield

    # -- wrapping -----------------------------------------------------
    def _patch(self, owner, attr, fn):
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, fn)

    def _count(self, metric: str, orig):
        counts = self.counts.setdefault(metric, {})

        def wrapped(*a, **kw):
            key = (self.step, self.req)
            counts[key] = counts.get(key, 0) + 1
            return orig(*a, **kw)

        return wrapped

    def _wrap_call(self, metric: str, orig, shape_of):
        import torch

        calls = self.calls.setdefault(metric, [])
        self._depth[metric] = 0

        def wrapped(*a, **kw):
            if self._depth[metric]:
                return orig(*a, **kw)
            info = shape_of(*a, **kw)
            cuda = info.pop("_cuda", False)
            idx = len(calls)
            ev = None
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            self._depth[metric] += 1
            try:
                with torch.profiler.record_function(f"c:{metric}#{idx}"):
                    out = orig(*a, **kw)
            finally:
                self._depth[metric] -= 1
            if ev is not None:
                ev[1].record()
            info.update(events=ev, step=self.step, req=self.req)
            calls.append(info)
            return out

        return wrapped

    def install(self, metrics: dict) -> None:
        """metrics: name -> metric module; wraps what each names."""
        import torch

        from spartan_parallel_tpu_torch.utils import timer

        for name, mod in metrics.items():
            for target, shape_of in getattr(mod, "WRAPS", {}).items():
                modname, attr = target.split(":")
                owner = importlib.import_module(modname)
                orig = getattr(owner, attr)
                self._patch(owner, attr, self._count(name, orig)
                            if shape_of is None else
                            self._wrap_call(name, orig, shape_of))

        T = timer.Timer
        orig_init, orig_stop = T.__init__, T.stop
        opened = self._timers

        def t_init(tm, label):
            orig_init(tm, label)
            rf = torch.profiler.record_function(f"t:{label}")
            rf.__enter__()
            opened[id(tm)] = rf

        def t_stop(tm, sync=None):
            dt = orig_stop(tm, sync)
            rf = opened.pop(id(tm), None)
            if rf is not None:
                rf.__exit__(None, None, None)
            return dt

        self._patch(T, "__init__", t_init)
        self._patch(T, "stop", t_stop)

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    # -- profiler -----------------------------------------------------
    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> dict:
        """Closes the profiler and reads its trace back: device intervals,
        kernel totals by name, named host ranges and launch links."""
        self._prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        with open(self.path, encoding="utf-8") as fh:
            events = json.load(fh).get("traceEvents", [])
        os.remove(self.path)
        return parse(events)


def parse(events) -> dict:
    """The pieces of a Chrome trace the metrics read (times in seconds)."""
    dev, kernels_by_corr, launch_ts = [], {}, {}
    ranges, ops = [], {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts = float(ev.get("ts", 0.0)) * 1e-6
        dur = float(ev.get("dur", 0.0)) * 1e-6
        args = ev.get("args") or {}
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((ts, ts + dur))
            name = ev.get("name", "?")
            ops[name] = ops.get(name, 0.0) + dur
            if cat == "kernel" and "correlation" in args:
                kernels_by_corr.setdefault(args["correlation"], []).append(
                    dur)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launch_ts[args["correlation"]] = ts
        elif cat == "user_annotation":
            ranges.append((ts, ts + dur, ev.get("name", "")))
    return {"device": _union(dev), "ops": ops, "ranges": ranges,
            "kernels_by_corr": kernels_by_corr, "launch_ts": launch_ts}


def call_device_seconds(parsed: dict, kind: str, count: int) -> list | None:
    """Device seconds of each of `count` wrapped calls of `kind` (a
    metric's name) from the trace's kernels, tied to their `c:<kind>#i`
    range by the launch's correlation id; None where the trace ties no
    kernel to any call."""
    rng = sorted((s, e, int(n.rsplit("#", 1)[1])) for s, e, n in
                 parsed["ranges"] if n.startswith(f"c:{kind}#"))
    if not rng:
        return None
    starts = [r[0] for r in rng]
    out = [0.0] * count
    hit = False
    for corr, durs in parsed["kernels_by_corr"].items():
        ts = parsed["launch_ts"].get(corr)
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and rng[i][0] <= ts <= rng[i][1] and rng[i][2] < count:
            out[rng[i][2]] += sum(durs)
            hit = True
    return out if hit else None


def event_seconds(calls: list) -> list:
    """Device seconds of each call from the CUDA events around it (the
    card synchronised first)."""
    return [c["events"][0].elapsed_time(c["events"][1]) * 1e-3
            if c.get("events") else 0.0 for c in calls]
