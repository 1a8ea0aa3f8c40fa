"""The readings that the limits of ``correct`` are set from, many seeds in
one process (the benchmark's own runs never run this).

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 1,2,3 [--control-seeds 4,5,6] [--mix batch=256,pool_batches=2]

runs the cell once per seed as ``run.py`` does, the program on ``--seeds``
and the control (the reference in TF32 in the program's place) on
``--control-seeds``, and prints one JSON line per run with the numbers the
judge compared. ``PERF.md`` gives the readings and the limits set from
them: each limit lies above every sound run's reading and below every
control's. ``--mix`` sets keys of the cell's traffic mix for these runs
(whole numbers), as the sweep of a batch size that sets a mix's ``batch``
does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import cell, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--mix", default="",
                    help="key=value,... set in the cell's traffic mix")
    args = ap.parse_args(argv)
    c = spec.cell(args.workload)
    for item in filter(None, args.mix.split(",")):
        key, value = item.split("=")
        c.mix[key] = int(value)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = cell.run(c, seed, args.seconds, False, "cuda", t0, control)
        print(json.dumps({
            "workload": c.name, "mix": c.mix, "seed": seed, "control": control,
            "correct": r["correct"], "attempted": r["attempted"],
            "compared": {e["name"]: e["value"] for e in r["compared"]},
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
