"""The closed loop of every cell: one batch submitted ahead.

The host submits batch i + 1 before it waits for batch i's outputs on the
host, as the port's ``harness/pert_runner.run_loop`` keeps one batch in
flight. Submission stops when ``seconds`` have passed; the window closes
when the last batch submitted is on the host, so every unit counted is
complete. A batch's time runs from its submission to its outputs on the
host: with the device busy, the wait for the batch ahead of it and its own
run.

A driver gives ``submit(i) -> handle``, ``settle(handle) -> record`` (which
returns once the batch's outputs are on the host) and ``batch_units``. A
driver's ``submit`` enqueues the copy of the batch's outputs to the host
right behind the batch's kernels (``Posted``), so that ``settle`` waits for
that batch alone and the next batch's kernels are already queued behind it.
``keep`` of the records, drawn from the seed over every batch settled
(reservoir sampling), are what the reference judges after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Any, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Window:
    seconds: float          # from the first submission to the last settle
    batches: int
    units: int
    batch_s: List[float]    # per batch, submission to outputs on the host
    kept: List[Tuple[int, Any]]


class Posted:
    """Outputs on their way to the host: each tensor's copy into pinned host
    memory (non-blocking) and an event, enqueued on the current stream right
    behind the kernels that made them. ``get()`` waits on that event alone
    and returns the host arrays. Tensors on the CPU are copied as they
    are."""

    def __init__(self, *tensors: torch.Tensor):
        self.event = None
        self.host = []
        for t in tensors:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach().clone()
            self.host.append(h)
        if any(t.is_cuda for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


def run(driver, seconds: float, keep: int, rng: np.random.Generator,
        mark=None) -> Window:
    """The loop for ``seconds``. ``mark(name)`` (optional) returns a context
    manager wrapped around each submit and settle (the trace's ranges)."""
    def span(name):
        return mark(name) if mark is not None else contextlib.nullcontext()

    kept: List[Tuple[int, Any]] = []
    batch_s: List[float] = []
    pending = None
    i = 0
    t0 = time.perf_counter()
    while True:
        if time.perf_counter() - t0 >= seconds:
            break
        t_sub = time.perf_counter()
        with span("portbench.submit"):
            handle = driver.submit(i)
        if pending is not None:
            _settle(driver, pending, batch_s, kept, keep, rng, span)
        pending = (i, t_sub, handle)
        i += 1
    if pending is not None:
        _settle(driver, pending, batch_s, kept, keep, rng, span)
    t1 = time.perf_counter()
    return Window(t1 - t0, i, i * driver.batch_units, batch_s, kept)


def _settle(driver, pending, batch_s, kept, keep, rng, span) -> None:
    i, t_sub, handle = pending
    with span("portbench.settle"):
        record = driver.settle(handle)
    batch_s.append(time.perf_counter() - t_sub)
    if len(kept) < keep:
        kept.append((i, record))
    else:
        j = int(rng.integers(0, i + 1))
        if j < keep:
            kept[j] = (i, record)


def p95(values: List[float]) -> float:
    """The 95th percentile (``statistics.quantiles``, inclusive) of every
    value."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]
