"""The traced slice: torch.profiler's events reduced to the figures the
per-layer readers take.

Device operations are the profiler's events on the card (kernels,
copies, fills), without the user annotations it mirrors there. Kernel
classes follow `chip_smoke.py`'s `PROFILE_CLASSES` (copied, with each
hand-written kernel a class of its own). Optimizer kernels are the ones
launched inside `Optimizer.step`'s annotation, matched through the
launch's correlation id, so that they are found whatever their names.
An idle gap of the device is named by the innermost host operator that
was running at its midpoint.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

PROFILE_CLASSES = (
    ("pair segment sum (K1's stream interface, K8)", ("pairs_kernel",)),
    ("cell row stream (K5's stream entry)", ("cell_row_grad_kernel",)),
    ("cell table gradient (K5-K7 fused)", ("cell_grad_x_kernel",)),
    ("cell table gradient (K5-K7 streams)", ("cell_",)),
    ("encode backward, stochastic (K1's stochastic form)",
     ("encode_bwd_stochastic",)),
    ("encode backward (K1 fused)", ("encode_bwd_kernel",)),
    ("encode forward (K2)", ("encode_tet_kernel", "encode_cube_kernel")),
    ("occupancy bits (K4)", ("occ_bits",)),
    ("segment sum (K3)", ("segment_sum",)),
    ("MLP GEMMs (fwd + bwd)", ("gemm", "xmma", "cutlass", "sm90", "Kernel2")),
    ("Adam (multi-tensor)", ("multi_tensor", "foreach", "adam")),
    ("compaction (nonzero / cub)", ("nonzero", "cub::", "select", "flag")),
    ("copies and dtype casts", ("copy", "memcpy")),
    ("gathers / scatters / index_add_", ("index", "gather", "scatter")),
    ("reductions", ("reduce",)),
    ("elementwise (scans, composite, activations)",
     ("elementwise", "cat", "fill", "where", "pow", "clamp", "memset")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, pats in PROFILE_CLASSES:
        if any(p.lower() in low for p in pats):
            return cls
    return "other"


@dataclasses.dataclass
class Slice:
    """A traced slice of `units` steps or views."""

    units: int
    wall_s: float
    device: list           # (name, start_s, end_s, is_kernel)
    optimizer: list        # indices into `device` launched by Optimizer.step
    host: list             # (name, start_s, end_s) host operators
    calls: dict = dataclasses.field(default_factory=dict)

    @property
    def kernels(self):
        return [d for d in self.device if d[3]]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        spans = sorted((s, e) for _, s, e, _ in self.device)
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def time_of(self, patterns) -> float:
        low = [p.lower() for p in patterns]
        return sum(e - s for name, s, e, k in self.device
                   if k and any(p in name.lower() for p in low))

    def optimizer_s(self) -> float:
        return sum(self.device[i][2] - self.device[i][1]
                   for i in self.optimizer)

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for name, s, e, _ in self.device:
            by[name] += e - s
        return sorted(([n[:160], v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:k]

    def classes(self):
        by = defaultdict(float)
        for name, s, e, _ in self.device:
            by[kernel_class(name)] += e - s
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))

    def idle_gaps(self, k: int = 10):
        """Idle time of the device summed by the host operator running
        at each gap's midpoint; the k largest."""
        spans = sorted((s, e) for _, s, e, _ in self.device)
        gaps, end = [], 0.0
        for s, e in spans:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.wall_s > end:
            gaps.append((end, self.wall_s))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            name = "host Python between operators"
            for j in range(i - 1, max(i - 400, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name[:160]] += b - a
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:k]


ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def _kind(evt, cuda) -> str:
    """The event's activity, from its device and its name: torch's own
    annotations (`Optimizer.step`, which the profiler mirrors on the
    device too), device copies and fills, kernels, CUDA runtime calls
    (they carry the correlation id of their launch) and host
    operators."""
    name = evt.name()
    annotation = name.startswith(ANNOTATIONS)
    if evt.device_type() == cuda:
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    if name.startswith("cu") and evt.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


def trace(run_units, sync, n_units: int) -> Slice:
    """Profile `run_units()` (which runs n_units steps or views) between
    two synchronisations, and reduce the events."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0_ns = time.perf_counter_ns()
        mark0 = time.time_ns()
        run_units()
        sync()
        wall_s = (time.perf_counter_ns() - t0_ns) / 1e9
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    device, host, launches, annotations = [], [], {}, []
    rows = [(evt, _kind(evt, cuda), evt.start_ns(), evt.duration_ns())
            for evt in events]
    starts = [s for _, kind, s, _ in rows
              if kind in ("cpu_op", "user_annotation")]
    base = min(starts) if starts else mark0
    for evt, kind, start, dur in rows:
        s = (start - base) / 1e9
        e = s + dur / 1e9
        if kind == "gpu_user_annotation":
            continue
        if evt.device_type() == cuda:
            device.append((evt.name(), s, e, kind == "kernel",
                           evt.correlation_id()))
        elif kind == "cpu_op":
            host.append((evt.name(), s, e))
        elif kind == "user_annotation":
            if evt.name().startswith("Optimizer.step"):
                annotations.append((s, e))
        elif kind == "cuda_runtime":
            launches[evt.correlation_id()] = s
    optimizer = [i for i, d in enumerate(device)
                 if d[4] in launches
                 and any(a <= launches[d[4]] <= b for a, b in annotations)]
    return Slice(units=n_units, wall_s=wall_s,
                 device=[d[:4] for d in device], optimizer=optimizer,
                 host=host)
