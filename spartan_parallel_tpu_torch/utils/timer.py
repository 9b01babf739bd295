"""Hierarchical wall-clock profiler (reference: src/timer.rs:14-67).

Same nested start/stop semantics and indented output, enabled via the
SPARTAN_PROFILE env var or Timer.enable(). Device work is made observable by
passing the device (or a tensor on it) to stop(): a CUDA device is
synchronized before the clock is read."""

from __future__ import annotations

import os
import time

_ENABLED = bool(os.environ.get("SPARTAN_PROFILE"))
_DEPTH = 0

# last elapsed seconds per label, regardless of _ENABLED — lets bench.py
# report per-stage metrics (roofline %) without parsing profiler output;
# totals sums them per label (a label that recurs within one prove, as
# R1CSProof::prove does in the 9-stage SNARK) until the caller clears it
records: dict = {}
totals: dict = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


class Timer:
    __slots__ = ("label", "t0")

    def __init__(self, label: str):
        global _DEPTH
        self.label = label
        self.t0 = time.perf_counter()
        if _ENABLED:
            print("  " * _DEPTH + f"* {label}")
            _DEPTH += 1

    def stop(self, sync=None) -> float:
        global _DEPTH
        if sync is not None:
            import torch

            dev = sync.device if isinstance(sync, torch.Tensor) else \
                torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        records[self.label] = dt
        totals[self.label] = totals.get(self.label, 0.0) + dt
        if _ENABLED:
            _DEPTH -= 1
            print("  " * _DEPTH + f"* {self.label} {dt * 1e3:.3f}ms")
        return dt

    @staticmethod
    def print_line(msg: str) -> None:
        if _ENABLED:
            print("  " * _DEPTH + f"* {msg}")
