"""Timing, tracing and sanitiser hooks of the port: its one timing definition.

Counterpart of ``transformer_mm_explainability_tpu/utils/profiling.py``:

  * ``sustained_seconds_per_call`` — the benchmark methodology of
    ``bench.py`` and ``tools/bench_families.py``: one warm call outside the
    timer, then pipelined calls whose every output is copied to the host;
  * ``rate`` — items per second of one call, the median of 3 trials between
    two ``torch.cuda.synchronize()``; ``cuda_ms`` — the mean device time of
    back-to-back calls from CUDA events. ``chip_smoke.py`` imports both;
  * ``peak_memory`` — the allocator's peak around one call (the JAX
    package's ``hlo_memory_analysis`` reads XLA's buffer assignment, which
    PyTorch has not);
  * ``trace`` — a ``torch.profiler`` Chrome trace of a block;
  * ``Timer`` / ``profile_section`` — debug-level wall-time prints;
  * ``enable_nan_debugging`` — ``torch.autograd.set_detect_anomaly``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

logger = logging.getLogger("tmmx")


def _host(out: Any) -> Any:
    """Every tensor of ``out`` (tensors, dicts, lists, tuples) copied to the
    host as numpy, which waits for the device."""
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: _host(v) for k, v in out.items()}
    if isinstance(out, tuple) and hasattr(out, "_fields"):
        return type(out)(*(_host(v) for v in out))
    if isinstance(out, (list, tuple)):
        return type(out)(_host(v) for v in out)
    return out


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sustained_seconds_per_call(fn: Callable, args: tuple, iters: int = 16,
                               depth: int = 3) -> float:
    """Seconds per call of ``fn(*args)``, end to end: one warm call outside
    the timer (kernel builds, allocator growth), then ``iters`` calls with
    at most ``depth`` whose outputs are not yet on the host; every output is
    copied to the host, so the number includes the copies."""
    _host(fn(*args))
    inflight = []
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        inflight.append(fn(*args))
        if len(inflight) >= depth:
            _host(inflight.pop(0))
    for out in inflight:
        _host(out)
    _synchronize()
    return (time.perf_counter() - t0) / iters


def rate(call: Callable[[], Any], size: float, trials: int = 3) -> float:
    """Items per second of ``call()``: the median of ``trials`` timed
    trials, each between two ``torch.cuda.synchronize()``."""
    out = []
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append(size / (time.perf_counter() - t0))
    return statistics.median(out)


def cuda_ms(fn: Callable[[], Any], iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peak_memory(fn: Callable, *args, device="cuda"
                ) -> Optional[Dict[str, int]]:
    """Run ``fn(*args)`` once with the allocator's peak reset before it:
    ``{bytes_in_use, peak_bytes_in_use, bytes_limit}`` of ``device`` after
    it (``torch.cuda.memory_stats``, ``torch.cuda.mem_get_info``), or None
    when ``device`` is not a CUDA device (the call still runs)."""
    device = torch.device(device)
    if device.type != "cuda":
        fn(*args)
        return None
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn(*args)
    torch.cuda.synchronize(device)
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "bytes_limit": int(total)}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (the CPU, and CUDA where there is
    a device), written as a Chrome trace ``log_dir/trace.json`` (open it
    in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock timer with reset semantics (mmf/utils/timer.py)."""

    def __init__(self) -> None:
        self.start = time.time()

    def reset(self) -> None:
        self.start = time.time()

    def elapsed(self) -> float:
        return time.time() - self.start


@contextlib.contextmanager
def profile_section(name: str, level: int = logging.DEBUG) -> Iterator[None]:
    """Timer print at debug level (TrainerProfilingMixin.profile)."""
    t0 = time.time()
    try:
        yield
    finally:
        logger.log(level, "%s: %.3fs", name, time.time() - t0)


def enable_nan_debugging(enabled: bool = True) -> None:
    """``torch.autograd.set_detect_anomaly``: a backward that makes a NaN
    raises where it was made (MMF's training.detect_anomaly)."""
    torch.autograd.set_detect_anomaly(enabled)
