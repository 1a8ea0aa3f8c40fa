"""One run of one cell: set-up, warm-up, the window, the per-layer
readings of a traced run, then the comparison with the reference.

The order matters: the device's memory peak is read when the window
closes, the program's state is freed, and only then does the reference
run (in blocks), so that it never sets the peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import Any, Dict, Optional

import torch

from portbench.core import judge, loop, seeds, spec, trace
from portbench.reference import common

JAX_NAMES = ("jax", "jaxlib", "flax", "transformer_mm_explainability_tpu")


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader gets."""

    config: Dict[str, Any]
    mix: Dict[str, Any]
    driver: Any
    window: loop.Window
    trace: Optional[trace.Trace]


def jax_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``JAX_NAMES``, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in JAX_NAMES)


def warm(driver, batches: int) -> None:
    """The window's pattern (one batch ahead) over ``batches`` batches."""
    pending = None
    for i in range(batches):
        handle = driver.submit(i)
        if pending is not None:
            driver.settle(pending)
        pending = handle
    driver.settle(pending)


def run(c: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> Dict[str, Any]:
    """The result line's object (``compared`` last), or raises."""
    common.tf32_off()
    mix, cfg = c.mix, c.config
    on_cuda = torch.device(device).type == "cuda"
    task = spec.task(cfg, mix)
    driver = task(cfg, mix, seed, device, control)
    warm(driver, mix["warm_batches"])
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sync()
    setup_s = time.perf_counter() - t_start
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    prof, mark = None, None
    if traced:
        mark = torch.profiler.record_function
        driver.mark = mark
        prof = trace.profiler()
        prof.__enter__()
    rng = seeds.rng(seed, "judge")
    with (mark("portbench.window") if traced
          else contextlib.nullcontext()):
        window = loop.run(driver, seconds, mix["judge_batches"], rng, mark)
        sync()
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    tr = None
    if traced:
        prof.__exit__(None, None, None)
        tr = trace.reduce(prof)
        del prof
    values = {f"{task.unit}_per_s": window.units / window.seconds,
              "batch_ms_p95": 1e3 * loop.p95(window.batch_s),
              "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    got = Run(cfg, mix, driver, window, tr)
    metrics = {}
    if traced:
        for m in c.per_layer:
            v = spec.metric_reader(m["name"])(got)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in c.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if on_cuda
                            else "cpu"),
                   "count": c.chips if on_cuda else 0,
                   "memory_peak_bytes": int(peak)}
    out = {"attempted": window.units, "failed": 0, "metrics": metrics,
           "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    driver.release()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    numbers = driver.judge(window.kept)
    entries = judge.compared(numbers, cfg["limits"][mix["task"]])
    result = {"correct": judge.correct(entries)}
    result.update(out)
    result["compared"] = entries
    return result
