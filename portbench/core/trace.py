"""The traced run's records, from ``torch.profiler``.

The profiler runs over the whole window (``--trace 1``); the window itself
is the benchmark's ``portbench.window`` range. ``reduce`` turns the
profiler's events into plain tuples that the per-layer metric readers
take:

  * ``device``: every operation on the device (kernels, copies, sets) as
    ``(name, start_ns, end_ns, correlation)``, user annotations left out;
  * ``launches``: each launch's host event, ``correlation → start_ns``
    (the runtime call that enqueued the device operation);
  * ``ranges``: the benchmark's own ``record_function`` ranges on the host,
    ``(name, start_ns, end_ns)``;
  * ``host``: the torch operations on the host, ``(name, start_ns,
    end_ns)``, to say what the host was doing in an idle gap.

Timestamps are the profiler's (nanoseconds on its clock).
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]
    device: List[Tuple[str, int, int, int]]
    launches: Dict[int, int]
    ranges: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def in_window(self) -> List[Tuple[str, int, int, int]]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi), c) for n, s, e, c in self.device
                if e > lo and s < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the
        device (the union of their intervals)."""
        return sum(e - s for s, e in _union(
            [(s, e) for _, s, e, _ in self.in_window()])) * 1e-9

    def kernels(self, pattern: str) -> List[Tuple[str, int, int, int]]:
        """The window's device operations whose name matches ``pattern``
        (``re.search``)."""
        rx = re.compile(pattern)
        return [d for d in self.in_window() if rx.search(d[0])]

    def range_of_launch(self, names) -> Dict[int, str]:
        """For each device operation launched inside one of the ranges
        ``names``, its correlation → the range's name."""
        spans = sorted((s, e, n) for n, s, e in self.ranges if n in names)
        starts = [s for s, _, _ in spans]
        out = {}
        for corr, t in self.launches.items():
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and spans[k][0] <= t <= spans[k][1]:
                out[corr] = spans[k][2]
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing (the innermost torch operation or
        benchmark range running on the host halfway through the gap;
        seconds summed by that name)."""
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e, _ in self.in_window():
            ops[short(n)] += (e - s) * 1e-9
        busy = _union([(s, e) for _, s, e, _ in self.in_window()])
        lo, hi = self.window
        gaps = []
        edge = lo
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if hi > edge:
            gaps.append((edge, hi))
        host = sorted(self.host + [(n, s, e) for n, s, e in self.ranges],
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            idle[_doing(host, starts, (s + e) // 2)] += (e - s) * 1e-9
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def _doing(host, starts, t) -> str:
    """The innermost host event that spans time ``t`` (the one that started
    last among those still running)."""
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - 4096, -1), -1):
        name, s, e = host[j]
        if s <= t <= e:
            return name
    return "(no host event)"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short(name: str) -> str:
    """A kernel's name without its template arguments and signature."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name.strip()[:96]


def profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def reduce(prof: torch.profiler.profile) -> Optional[Trace]:
    """The records of a finished profile, or None without a
    ``portbench.window`` range."""
    device, launches, ranges, host = [], {}, [], []
    window = None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        on_cpu = ev.device_type() == torch.autograd.DeviceType.CPU
        if ev.is_user_annotation():
            if on_cpu and name.startswith(PREFIX):
                if name == PREFIX + "window":
                    window = (s, e)
                else:
                    ranges.append((name, s, e))
            continue
        if not on_cpu:
            device.append((name, s, e, ev.correlation_id()))
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                              "cudaMemset")):
            launches[ev.correlation_id()] = s
        elif name.startswith("aten::"):
            host.append((name, s, e))
    if window is None:
        return None
    return Trace(window, device, launches, ranges, host)
