"""Time the bf16-product GEMM of several checkouts of the port on one card.

    python scripts/gemm_bf16_ab.py ROOT [ROOT ...] [--json OUT]

Each ROOT is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` beside this one); give them in turns (parent, change,
change, parent) to see the spread. First every checkout's bf16 library
(``csrc/attn_block_bf16.cu``) is built, all at once; then, one checkout at a
time in a process of its own, its ``ops/attn_block._gemm_bf16`` runs each
product of the four block kernels (g1-g9 of ``chip_smoke.py``) at ViT-B/16
widths (S=197, D=768, I=3072) for B=1, 8 and 32 images (M = B·S) on bf16
operands drawn from a fixed seed, fp32 output and no epilogue (the same
call in every checkout since the bf16 mode was added):

  * ``kernel_ms``: the kernels' device time per call: 20 calls captured
    in a CUDA graph, its replays timed with CUDA events (median of 5), so
    that the host's launch time is not between them;
  * ``fp32_b_ms``: the same with b stored in fp32 (the weights of an fp32
    model), all of the call's kernels;
  * ``path_ms``: the same product with the output dtype and epilogue that
    the bf16-tensor path gives it (``PATH``: bias, GELU, GELU'(aux) or the
    residual; bf16 or fp32 C);
  * ``tile_ms`` (checkouts whose library can force the tile width): the
    kernel at each tile width, and ``tile``, the width the table picks;
  * ``event_ms``: CUDA events around 50 back-to-back calls, per call (the
    host time where the wrapper takes longer than its kernel);
  * ``cublas_ms``: the same for ``torch.matmul`` on the same bf16
    operands (bf16 output), the library yardstick;
  * ``host_us``: the host time of one call at B=8 (the enqueue of 200 calls
    without a synchronise, per call), on g2;
  * ``err``: max|C - C64| / max|C64| against the float64 product of the
    same bf16 values.

Prints one JSON object per checkout and shape and a table; ``--json``
writes them all. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import pathlib
import subprocess
import sys

S, D, I = 197, 768, 3072
SHAPES = {  # name: (N, K, trans_b), M = B·S
    "g1": (3 * D, D, False), "g2": (D, D, False), "g3": (I, D, False),
    "g4": (D, I, False), "g5": (I, D, False), "g6": (I, D, True),
    "g7": (D, I, True), "g8": (D, D, True), "g9": (D, 3 * D, True)}
BATCHES = (1, 8, 32)
# the bf16-tensor path's output dtype and epilogue of each product
PATH = {"g1": ("bf16", "bias"), "g2": ("bf16", "bias res"),
        "g3": ("bf16", "bias gelu"), "g4": ("bf16", "bias res"),
        "g5": ("fp32", "bias"), "g6": ("bf16", "gelu'(aux)"),
        "g7": ("fp32", ""), "g8": ("bf16", ""), "g9": ("fp32", "")}


def _device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn()``: ``iters`` calls captured in a CUDA
    graph, its replays timed with CUDA events (median of ``replays``), so
    that no host launch time is between the kernels."""
    import statistics

    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # relaxed: a launcher may set a kernel attribute while it is captured
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _event_ms(fn, iters: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_one(root: str) -> list:
    """Time this process's checkout (``root`` first on sys.path)."""
    import time

    import torch

    sys.path.insert(0, root)
    from transformer_mm_explainability_tpu_torch.ops import attn_block as ab

    dev = torch.device("cuda")
    lib = ab.library(fast_dots=True)
    # the current stream at each call: a CUDA graph captures on its own
    st = lambda: torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(19)
    rows = []
    for batch in BATCHES:
        M = batch * S
        for name, (N, K, trans_b) in SHAPES.items():
            a = torch.randn((M, K), generator=gen).to(dev, torch.bfloat16)
            b = (torch.randn((N, K) if trans_b else (K, N), generator=gen)
                 / math.sqrt(K)).to(dev, torch.bfloat16)
            run = lambda: ab._gemm_bf16(lib, a, b, st(), trans_b=trans_b)
            got = run()
            want = ab.gemm_plain(a.double(), b.double(), trans_b)
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max()
                        / want.abs().max())
            op_b = b.transpose(-1, -2) if trans_b else b
            b32 = b.float()
            row = dict(root=root, B=batch, gemm=name, M=M, N=N, K=K,
                       trans_b=trans_b, err=err, kernel_ms=_device_ms(run),
                       event_ms=_event_ms(run),
                       cublas_ms=_device_ms(lambda: torch.matmul(a, op_b)),
                       fp32_b_ms=_device_ms(lambda: ab._gemm_bf16(
                           lib, a, b32, st(), trans_b=trans_b)),
                       flops=2 * M * N * K)
            out, epi = PATH[name]
            kw = {"out_dtype": torch.bfloat16 if out == "bf16"
                  else torch.float32}
            if "bias" in epi:
                kw["bias"] = torch.randn(N, generator=gen).to(
                    dev, torch.bfloat16)
            if "res" in epi:
                kw["res"] = torch.randn((M, N), generator=gen).to(
                    dev, torch.bfloat16)
            if epi.endswith("gelu"):
                kw["act"] = ab._ACT_GELU
            if "aux" in epi:
                kw["act"] = ab._ACT_MUL_GELU_GRAD
                kw["aux"] = torch.randn((M, N), generator=gen).to(dev)
            row["path_ms"] = _device_ms(lambda: ab._gemm_bf16(
                lib, a, b, st(), trans_b=trans_b, **kw))
            if hasattr(ab, "gemm_bf16_copies"):   # the tile table's library
                lib.tmx_gemm_bf16_force_tile.argtypes = [ctypes.c_int]
                row["tile"] = lib.tmx_gemm_bf16_tile(M, N, 1)
                row["tile_ms"] = {}
                for width in (64, 128):
                    lib.tmx_gemm_bf16_force_tile(width)
                    row["tile_ms"][width] = _device_ms(run)
                lib.tmx_gemm_bf16_force_tile(0)
            if batch == 8 and name == "g2":
                for _ in range(20):
                    run()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    run()
                row["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--json", default=None)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        run_one(os.path.abspath(args.roots[0]))
        return 0
    roots = [os.path.abspath(r) for r in args.roots]
    # build every checkout's library at once (each caches by content)
    builds = [subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); "
         "from transformer_mm_explainability_tpu_torch.ops import _build; "
         "_build.build('attn_block_bf16')", root])
        for root in dict.fromkeys(roots)]
    if any(p.wait() for p in builds):
        print("build failed", file=sys.stderr)
        return 1
    rows = []
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--one", root],
                             capture_output=True, text=True)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            print(f"{root}: exit {out.returncode}", file=sys.stderr)
            return 1
        rows += [json.loads(line) for line in out.stdout.splitlines()
                 if line.startswith("{")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    names = {root: f"[{i}] {pathlib.Path(root).name}"
             for i, root in enumerate(dict.fromkeys(roots))}
    for row in rows:
        tf = row["flops"] / row["kernel_ms"] / 1e9
        print(f"{names[row['root']]} B={row['B']} {row['gemm']} "
              f"{row['M']}x{row['K']}x{row['N']} "
              f"{'[N,K]' if row['trans_b'] else '[K,N]'}: kernel "
              f"{row['kernel_ms']:.4f} ms ({tf:.1f} TFLOP/s), events "
              f"{row['event_ms']:.4f} ms, cuBLAS {row['cublas_ms']:.4f} ms "
              f"({row['flops'] / row['cublas_ms'] / 1e9:.1f} TFLOP/s), "
              f"max|Δ|/max|C64| {row['err']:.2e}; fp32 b "
              f"{row['fp32_b_ms']:.4f} ms; path epilogue "
              f"{row['path_ms']:.4f} ms"
              + (f"; tile 128x{row['tile']} (64: {row['tile_ms']['64']:.4f}"
                 f", 128: {row['tile_ms']['128']:.4f} ms)"
                 if "tile" in row else "")
              + (f"; host {row['host_us']:.1f} us/call"
                 if "host_us" in row else ""))
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(
            {"card": card.strip(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
