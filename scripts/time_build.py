"""Time the build of the port's CUDA libraries in two layouts of the
libraries that ``ops/_build.PARTS`` builds from more than one source.

    # on the card's machine, from the root of a checkout:
    python scripts/time_build.py [--trials split,one,one,split]

``split``: as ``ops/_build.build_all`` builds them: each source of such a
library compiled to an object (``-c``), all at once, then linked.
``one``: the same sources as one translation unit (a file that includes
them), compiled by one ``nvcc``.

Each trial builds every library of ``csrc/`` from nothing, one ``nvcc`` per
compile started together as ``build_all`` starts them, into a fresh
directory under ``build/time_build/``. It prints the wall time of the
whole build, and of each process, from its start to its end. A trial that
runs past ``--limit`` seconds is stopped and printed as such.
"""

from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from transformer_mm_explainability_tpu_torch.ops import _build  # noqa: E402


def _libraries() -> list:
    parts = {s for v in _build.PARTS.values() for s in v}
    return sorted(p.stem for p in _build.CSRC.glob("*.cu")
                  if p.stem not in parts)


def _run(cmds: dict, out: pathlib.Path, limit: float) -> dict:
    """Start every command at once, each with its output in a file of
    ``out`` (ptxas's report of a large source fills a pipe); seconds each
    took, by key, None for one stopped at ``limit`` (raises if one
    fails)."""
    start = time.monotonic()
    logs = {k: open(out / f"{k}.log".replace(" ", "_"), "w") for k in cmds}
    procs = {k: subprocess.Popen(c, stdout=logs[k], stderr=subprocess.STDOUT)
             for k, c in cmds.items()}
    took = {}
    try:
        while len(took) < len(procs):
            late = time.monotonic() - start > limit
            for k, p in procs.items():
                if k in took:
                    continue
                if p.poll() is not None:
                    took[k] = time.monotonic() - start
                    if p.returncode != 0:
                        raise RuntimeError(f"{k} failed (exit "
                                           f"{p.returncode}), see {out}")
                elif late:
                    p.kill()
                    p.wait()
                    took[k] = None
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    return took


def trial(layout: str, out: pathlib.Path, limit: float) -> tuple:
    """(whole build seconds, {process: seconds or None}) of one build in
    ``layout``, stopped at ``limit`` seconds."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc, flags = _build.nvcc(), list(_build.NVCC_FLAGS)
    compile_flags = [f for f in flags if f != "-shared"]
    cmds, links = {}, {}
    for lib in _libraries():
        srcs = _build.sources(lib)
        so = str(out / f"lib{lib}.so")
        if len(srcs) == 1:
            cmds[lib] = [nvcc, *flags, "-o", so,
                         str(_build.CSRC / f"{lib}.cu")]
        elif layout == "one":
            unit = out / f"{lib}_one.cu"
            unit.write_text("".join(f'#include "{_build.CSRC / s}.cu"\n'
                                    for s in srcs))
            cmds[lib] = [nvcc, *flags, "-o", so, str(unit)]
        else:
            objs = [str(out / f"{s}.o") for s in srcs]
            for s, o in zip(srcs, objs):
                cmds[s] = [nvcc, *compile_flags, "-c", "-o", o,
                           str(_build.CSRC / f"{s}.cu")]
            links[f"{lib} link"] = [nvcc, "-shared", "-o", so, *objs]
    start = time.monotonic()
    took = _run(cmds, out, limit)
    if links and None not in took.values():
        t0 = time.monotonic() - start
        took.update({k: None if t is None else t0 + t
                     for k, t in _run(links, out, limit - t0).items()})
    return time.monotonic() - start, took


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", default="split,one,one,split")
    ap.add_argument("--limit", type=float, default=600.0,
                    help="seconds after which a trial is stopped")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}; nvcc {_build.nvcc()}; libraries {_libraries()}; "
          f"parts {_build.PARTS}", flush=True)
    for i, layout in enumerate(args.trials.split(",")):
        total, took = trial(layout, ROOT / "build" / "time_build" / str(i),
                            args.limit)
        stopped = None in took.values()
        print(f"trial {i} {layout}: whole build {total:.1f} s"
              + (f" (stopped at the {args.limit:g} s limit)" if stopped
                 else "") + "; "
              + ", ".join(f"{k} " + ("stopped" if t is None else f"{t:.1f} s")
                          for k, t in sorted(took.items(), key=lambda kv:
                                             -(kv[1] or float("inf")))),
              flush=True)
    shutil.rmtree(ROOT / "build" / "time_build", ignore_errors=True)


if __name__ == "__main__":
    main()
