"""Tracing and profiling utilities.

Port of quadraturefields_tpu/utils/profiling.py: a device trace of a
block (torch.profiler in place of jax.profiler), a stage timer with
aggregate totals, and a step-rate meter.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed block with torch.profiler (the host's
    operators, and the card's kernels where there is one) and write a
    Chrome trace (trace.json, viewable in Perfetto or TensorBoard) into
    log_dir. Yields the profiler, whose key_averages() the caller may
    read after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Named wall-clock sections with aggregate totals."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t:.3f}s total / {n} calls "
                         f"({1e3 * t / max(n, 1):.2f} ms avg)")
        return "\n".join(lines)


class Throughput:
    """Rolling items/sec meter (rays, samples, steps)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.items = 0

    def add(self, n: int):
        self.items += n

    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.items / dt if dt > 0 else 0.0

    def reset(self):
        self.t0 = time.perf_counter()
        self.items = 0
