"""Metric smoothing + console metric logging.

Counterpart of ``transformer_mm_explainability_tpu/core/meter.py``:
mmf/common/meter.py (Meter/SmoothedValue) and DETR's
util/misc.MetricLogger.log_every (windowed medians/averages, ETA, it/s).
Counts and totals are summed over the ranks of an initialised
``torch.distributed`` process group (DETR's ``all_reduce`` of the same
pair); without one, nothing is synchronised.
"""

from __future__ import annotations

import collections
import datetime
import time
from typing import Dict, Iterable, Iterator, Optional

import numpy as np


class SmoothedValue:
    """Track a series; expose windowed median/avg and global avg."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self) -> None:
        """Sum count and total over the ranks of the initialised process
        group (no-op without one, or with one rank)."""
        import torch
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        device = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=device)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


class Meter:
    """Named collection of SmoothedValues (MMF Meter)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            if hasattr(v, "item"):
                v = v.item()
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items())


class MetricLogger(Meter):
    """DETR-style progress logging over an iterable."""

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None,
                  printer=print) -> Iterator:
        i = 0
        total = total if total is not None else len(iterable)  # type: ignore
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            t0 = time.time()
            yield obj
            iter_time.update(time.time() - t0)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * (total - i)
                printer(
                    f"{header} [{i}/{total}] eta: "
                    f"{datetime.timedelta(seconds=int(eta))} {self} "
                    f"time: {iter_time}")
            i += 1
        elapsed = time.time() - start
        printer(f"{header} Total time: "
                f"{datetime.timedelta(seconds=int(elapsed))} "
                f"({elapsed / max(total, 1):.4f} s / it)")
