"""``portbench/run.py``'s command line."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench.core import spec

# Caches of the program, inside the checkout at fixed paths: the port
# builds its kernels into build/kernels/ itself (``ops/_build.py``).
CACHES = {"TRITON_CACHE_DIR": "build/portbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once; print one JSON "
                    "result line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="the reference in TF32 in the program's place (the "
                         "control of correct; never in a benchmark run)")
    return ap


def main(argv, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parser().parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(spec.ROOT / rel)
    c = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"portbench: {args.workload} needs {c.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    from portbench.core import cell
    result = cell.run(c, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start, control=args.control)
    return emit(result)


def emit(result) -> int:
    """Prints the compared numbers last on standard error and the result
    line last on standard output; refuses (exit 3, no result) where a JAX
    module is loaded."""
    from portbench.core import cell
    found = cell.jax_modules()
    if found:
        print(f"portbench: JAX modules loaded in the run's process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for e in result["compared"]:
        print(f"compared {e['name']} = {e['value']!r} (limit "
              f"{e['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
