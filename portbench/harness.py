"""One run of one cell: set-up, the measured window, the reference's
judgement, and the result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name: BENCHMARK.json's cell names a configuration (its `file`
under portbench/configs/) and a traffic mix (portbench/traffic/<mix>.json,
which names the steps of a request: methods of the system); the
configuration names its `system` (portbench/systems/<system>.py); every
metric, end-to-end or per layer, is read by portbench/metrics/<name>.py,
which in a traced run also names the entry points it wraps (`WRAPS`).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import pickle
import random
import sys
import time

from . import workload

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "spartan_parallel_tpu")


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than its cell asks for."""


def process_age() -> float | None:
    """Seconds since this process started (from /proc), or None."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime", encoding="ascii") as fh:
            up = float(fh.read().split()[0])
        return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


# --------------------------------------------------------------------------
# Finding a cell's files by name
# --------------------------------------------------------------------------
def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def cell_files(spec: dict, name: str, root: str = ROOT):
    """(cell, configuration, traffic mix) of the cell `name`."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"]), encoding="utf-8") as fh:
        cfg = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json"),
              encoding="utf-8") as fh:
        traffic = json.load(fh)
    return cell, cfg, traffic


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: with trace the per-layer ones,
    else the end-to-end ones, each where its `workloads` (if any) name the
    cell and, per layer, where the end-to-end metric it moves is
    reported."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if m["moves"] in names and
            ("workloads" not in m or cell in m["workloads"])]


def metric_module(name: str):
    """portbench/metrics/<name>.py: `read(ctx)`, and optionally `WRAPS`,
    the port's entry points it reads in a traced run."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def system_module(cfg: dict):
    return importlib.import_module("portbench.systems." + cfg["system"])


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------
class _Pauses:
    """Garbage collections that run inside a timed step."""

    def __init__(self):
        self.n, self.total, self.longest = 0, 0.0, 0.0
        self.in_step, self._t = False, None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter() if self.in_step else None
        elif self._t is not None:
            dt = time.perf_counter() - self._t
            self.n, self.total = self.n + 1, self.total + dt
            self.longest = max(self.longest, dt)


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, device, cfg: dict | None = None,
             t0: float | None = None, require_card: bool = True,
             trace_path: str | None = None, traffic: dict | None = None):
    """Runs the cell once. Returns (result dict, stderr lines). cfg and
    traffic default to the cell's files; device is a torch.device."""
    import torch

    if t0 is None:
        t0 = time.perf_counter()
    age0 = process_age()
    clock0 = time.perf_counter()

    def since_start() -> float:
        if age0 is not None:
            return age0 + (time.perf_counter() - clock0)
        return time.perf_counter() - t0

    cell, cfg_file, traffic_file = cell_files(spec, cell_name)
    cfg = cfg_file if cfg is None else cfg
    traffic = traffic_file if traffic is None else traffic
    if require_card:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"cell {cell_name} needs {cell['chips']} CUDA "
                         f"card(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cuda = device.type == "cuda"
    metric_specs = cell_metrics(spec, cell_name, trace)
    mods = {m["name"]: metric_module(m["name"]) for m in metric_specs}

    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.utils import timer

    marks = [("imports", since_start())]
    if cuda:
        kernels.build()
    marks.append(("kernels built or loaded", since_start()))
    sysmod = system_module(cfg)
    system = sysmod.System(cfg, seed, device)
    marks += [(k, marks[-1][1] + v)
              for k, v in getattr(system, "setup_parts", {}).items()]
    marks.append(("system", since_start()))
    steps = list(traffic["steps"])
    stream = workload.requests(traffic, seed, system.pool)

    # the mix's prepare steps, one a pool input; then one warm-up request
    # of the mix's shapes; all outside the window
    base = {}
    for req in workload.prepared(seed, system.pool):
        rec = None
        for step in traffic.get("prepare", []):
            rec = getattr(system, step)(req, rec)
        base[req["input"]] = rec
    marks.append(("prepare", since_start()))
    warm = dict(next(workload.requests(traffic, seed + 1, system.pool)),
                index=-1)
    rec = base[warm["input"]]
    for step in steps:
        rec = getattr(system, step)(warm, rec)
    del rec, warm
    if cuda:
        torch.cuda.synchronize(device)
    # what set-up built stays for the run: full collections in the window
    # leave it out
    gc.collect()
    gc.freeze()
    setup_s = since_start()
    marks.append(("warm-up request", setup_s))

    tracer = None
    if trace:
        from .tracer import Tracer

        tracer = Tracer(trace_path or os.path.join(
            ROOT, "build", "portbench", "trace.json"))
        tracer.install(mods)
        tracer.start()

    def span(name):
        return tracer.span(name) if tracer else contextlib.nullcontext()

    pauses = _Pauses()
    gc.callbacks.append(pauses)
    times = {s: [] for s in steps}
    cpu = {s: [] for s in steps}
    stages = {s: [] for s in steps}
    ids = {s: [] for s in steps}
    failures = {s: 0 for s in steps}
    # every proof made is judged; kept as bytes, which no collection walks
    records = [pickle.dumps(sysmod.System.plain(r)) for r in base.values()
               if r is not None]
    attempted = failed = 0
    between_s = 0.0
    w_start = time.perf_counter()
    w_end = w_start + seconds
    while time.perf_counter() < w_end:
        req = next(stream)
        attempted += 1
        rec = base[req["input"]]
        for step in steps:
            timer.totals.clear()
            if tracer:
                tracer.at(step, req["index"])
            pauses.in_step = True
            u = os.times()
            a = time.perf_counter()
            try:
                with span(f"s:{step}#{req['index']}"):
                    rec = getattr(system, step)(req, rec)
            except Exception as exc:  # a step that raises fails its request
                pauses.in_step = False
                print(f"{step} {req['index']} failed: {exc!r}",
                      file=sys.stderr)
                failures[step] += 1
                failed += 1
                break
            b = time.perf_counter()
            v = os.times()
            pauses.in_step = False
            if b <= w_end:
                times[step].append(b - a)
                cpu[step].append(v.user + v.system - u.user - u.system)
                ids[step].append(req["index"])
                stages[step].append(dict(timer.totals))
        if tracer:
            tracer.at(None, None)
        # the reference judges every proof made here, accepted or not
        if rec is not None and rec is not base[req["input"]]:
            records.append(pickle.dumps(sysmod.System.plain(rec)))
        del rec
        c = time.perf_counter()
        gc.collect()
        between_s += time.perf_counter() - c
    if cuda:
        torch.cuda.synchronize(device)
    gc.callbacks.remove(pauses)

    parsed = None
    if tracer:
        tracer.uninstall()
        parsed = tracer.stop()

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if cuda else
                "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_reserved(
                    device)) if cuda else 0}

    ctx = {"setup_s": setup_s, "times": times, "stages": stages,
           "ids": ids, "trace": parsed, "tracer": tracer, "device": device}
    if tracer:
        from . import tracedata

        tracedata.prepare(ctx)
        busy = ctx["busy_window"]
        dev_info["busy_s"] = busy[0]
        dev_info["window_s"] = busy[1]

    metrics = {}
    for m in metric_specs:
        v = mods[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state goes before the reference runs
    del base
    system.free()
    if cuda:
        torch.cuda.empty_cache()
    gc.unfreeze()
    gc.collect()

    k = cfg.get("check_sample")
    pick = random.Random(workload.sub_seed(seed, "sample"))
    sample = records if k is None or k >= len(records) else \
        pick.sample(records, k)
    sample = [pickle.loads(r) for r in sample]
    checks = {f"failed.{s}": (n, 0) for s, n in failures.items()}
    checks["unchecked"] = (int(not sample), 0)
    t_ref = time.perf_counter()
    for name, v in system.check(sample, seed).items():
        checks[name] = (v, 0)
    ref_s = time.perf_counter() - t_ref
    correct = all(v <= lim for v, lim in checks.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if tracer:
        result["breakdown"] = ctx["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}
    lines = ["set-up, seconds from the process's start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in marks)]
    lines.append("window: " + "; ".join(
        f"{s} s " + " ".join(f"{t:.4f}" for t in times[s]) for s in steps) +
        f"; {pauses.n} garbage collections inside steps, "
        f"{pauses.total:.4f} s, the longest {pauses.longest:.4f}; "
        f"collections between requests {between_s:.4f} s")
    lines.append("this process's CPU s in each counted step: " + "; ".join(
        f"{s} " + " ".join(f"{t:.2f}" for t in cpu[s]) for s in steps))
    if tracer:
        lines.append("device time of the wrapped calls from: " + ", ".join(
            f"{k} {v}" for k, v in ctx["device_time_source"].items()))
        lines.append("device busy s in each counted step: " + "; ".join(
            f"{s} " + " ".join(f"{b:.4f}" for b in ctx["busy_by_step"][s])
            for s in steps))
    lines.append(f"reference: {len(sample)} of {len(records)} finished "
                 f"proofs checked in {ref_s:.3f} s")
    lines += [f"check {n}: {v} (limit {lim})"
              for n, (v, lim) in checks.items()]
    return result, lines
