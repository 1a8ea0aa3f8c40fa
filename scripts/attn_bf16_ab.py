"""Time the bf16 attention (forward and backward) of several checkouts of the port on one card.

    python scripts/attn_bf16_ab.py ROOT [ROOT ...] [--profile] [--json OUT]

Each ROOT is the root of a checkout (e.g. the parent commit unpacked with
``git archive`` beside this one); give them in turns (parent, change,
change, parent) to see the spread. First every checkout's bf16 library
(``csrc/attn_block_bf16.cu``) is built, all at once; then, one checkout at a
time in a process of its own, the bf16 attention of
``ops/flash_attention`` with ``fast_dots=True`` runs on a merged bf16 qkv
[B, S, 3D] and cotangent [B, S, D] drawn from a fixed seed, at ViT-B/16
widths (S=197, H=12, dh=64) for B = 1, 8 and 32, and at S = 2,000 and
4,000 (B=1, H=2).

The backward, ``flash_bwd_ehat_qkv`` (rows #6 and #8 of the kernel table
in the bf16 mode; #4's attention part is the same launch):

  * ``kernel_ms``: the call's device time: 20 calls captured in a CUDA
    graph, its replays timed with CUDA events (median of 5), so that the
    host's launch time is not between them;
  * ``launches``: kernel launches per call and ``profiled_ms`` their device
    time, from torch.profiler over 20 calls; ``split``: that time by
    kernel (names shortened);
  * ``fp32_ms``: ``kernel_ms`` on the same values stored in float32 (the
    ``fast_dots`` mode of an fp32 model; the backward rounds them first);
  * ``event_ms``: CUDA events around 50 back-to-back calls, per call (the
    host's time where the wrapper takes longer than its kernels);
  * ``keys_ms`` (checkouts whose library can force the key width): the call
    at 64 and 128 keys a block, and ``keys``, the width the table picks;
  * ``sdpa_ms``: context only, never a yardstick of the same function:
    ``torch.autograd.grad`` through ``scaled_dot_product_attention`` on the
    same bf16 q, k, v and dout (dq, dk, dv, no ``e_row``), device time from
    torch.profiler;
  * ``err``: the worst max|Δ| / max|plain| over dq, dk, dv and e_row
    against the plain version with ``fast_dots`` (bf16 rounding level);
  * ``host_us``: the host time of one call at B=8 (the enqueue of 200 calls
    without a synchronise, per call).

The forward (rows #5 and #7; #1's attention is the same launch as #7's),
under ``fwd``: the same measures of ``flash_fwd_qkv`` (``kernel_ms``,
``fp32_ms``, ``event_ms``, ``launches``, ``profiled_ms``, ``split``,
``err`` against ``flash_fwd_qkv_plain`` with ``fast_dots``), ``views_ms``:
the device time of ``flash_fwd`` on the split-head views of the same qkv,
``sdpa_ms``: ``scaled_dot_product_attention`` on those views, the same
function (the library time of #5 and #7), by the same CUDA-graph device
time; ``bound_ms``: the bytes of the
bf16 q, k, v and out over 3.35 TB/s or its two S×S×dh products over 989
TFLOP/s, the larger.

``--profile`` also profiles ``vit.relevancy_fused_block2`` on a bf16 copy
of a seeded ViT-B/16 with bf16 images and ``fast_dots=True`` at B=8 and
B=32: the call's wall time (median of 3), device busy, and the device time
of the attention forward, the attention backward, the GEMM and the
LayerNorm rows (forward and VJP), each apart. The backward's ``bound_ms``:
the larger of the bytes of the bf16 q, k, v, dout, dq, dk, dv (r and e_row
fp32) over 3.35 TB/s and the function's five S×S×dh products over 989
TFLOP/s. Prints one JSON object per checkout and shape and a table;
``--json`` writes them all. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

SHAPES = [(1, 12, 197, 64), (8, 12, 197, 64), (32, 12, 197, 64),
          (1, 2, 2000, 64), (1, 2, 4000, 64)]
BF16_FLOPS, HBM_BYTES_S = 989e12, 3.35e12   # H100 SXM, dense bf16; HBM3


def bound_ms(B: int, H: int, S: int, dh: int) -> float:
    """The least time of the function on the card: its five S×S×dh products
    at the dense bf16 rate, or its bytes (bf16 q, k, v, dout in, dq, dk, dv
    out; r in and e_row out fp32) at the memory rate, the larger."""
    flops = 5 * 2 * B * H * S * S * dh
    nbytes = 2 * 7 * B * H * S * dh + 4 * 2 * B * S
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S) * 1e3


def fwd_bound_ms(B: int, H: int, S: int, dh: int) -> float:
    """The least time of the forward on the card: its two S×S×dh products
    at the dense bf16 rate, or its bytes (bf16 q, k, v in, out out) at the
    memory rate, the larger."""
    flops = 2 * 2 * B * H * S * S * dh
    nbytes = 2 * 4 * B * H * S * dh
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_S) * 1e3


def _device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn()`` from CUDA-graph replays (see the
    module note)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
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


def _profiled(fn, iters: int = 20, pattern: str = "", split=None):
    """(device ms, launches) per call of ``fn()``'s kernels whose name
    contains ``pattern``, and the same for all kernels, from torch.profiler;
    ``split``, a dict, receives the device ms per call of each kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = n = ms_all = n_all = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        ms_all += us / 1e3 / iters
        n_all += ev.count / iters
        if split is not None:
            name = re.sub(r"[<(].*", "", re.sub(
                r"^void |\(anonymous namespace\)::", "", ev.key))
            split[name] = split.get(name, 0.0) + us / 1e3 / iters
        if pattern in ev.key:
            ms += us / 1e3 / iters
            n += ev.count / iters
    return ms, n, ms_all, n_all


def run_one(root: str, with_profile: bool) -> list:
    """Time this process's checkout (``root`` first on sys.path)."""
    import torch

    sys.path.insert(0, root)
    from transformer_mm_explainability_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    lib = fa.library(fast_dots=True)
    gen = torch.Generator().manual_seed(20)
    rows = []
    for B, H, S, dh in SHAPES:
        D = H * dh
        qkv = (torch.randn((B, S, 3 * D), generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        dm = (torch.randn((B, S, D), generator=gen) * 0.5).to(
            dev, torch.bfloat16)
        r = torch.rand((B, S), generator=gen).to(dev)
        run = lambda t=qkv, c=dm: fa.flash_bwd_ehat_qkv(t, c, r, H,
                                                         fast_dots=True)
        got = run()
        want = fa.flash_bwd_ehat_qkv_plain(qkv, dm, r, H, fast_dots=True)
        got = (*fa.qkv_heads(got[0], H), got[1])
        want = (*fa.qkv_heads(want[0], H), want[1])
        torch.cuda.synchronize()
        err = max(float((g.float() - w.float()).abs().max()
                        / w.float().abs().max()) for g, w in zip(got, want))
        q32, d32 = qkv.float(), dm.float()
        split = {}
        profiled_ms, launches = _profiled(run, split=split)[2:4]
        row = dict(root=root, B=B, H=H, S=S, dh=dh, err=err,
                   kernel_ms=_device_ms(run), event_ms=_event_ms(run),
                   fp32_ms=_device_ms(lambda: run(q32, d32)),
                   launches=launches, profiled_ms=profiled_ms, split=split,
                   bound_ms=bound_ms(B, H, S, dh))
        if hasattr(lib, "tmx_attn_bwd_bf16_force_keys"):
            row["keys"] = lib.tmx_attn_bwd_bf16_keys(S, dh, B * H)
            row["keys_ms"] = {}
            for keys in (64, 128):
                lib.tmx_attn_bwd_bf16_force_keys(keys)
                row["keys_ms"][keys] = _device_ms(run)
            lib.tmx_attn_bwd_bf16_force_keys(0)
        q, k, v = (x.detach().contiguous().requires_grad_()
                   for x in fa.qkv_heads(qkv, H))
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v)
        dout = fa.heads(dm, H).contiguous()
        row["sdpa_ms"] = _profiled(lambda: torch.autograd.grad(
            out, (q, k, v), dout, retain_graph=True))[2]
        del q, k, v, out
        if B == 8 and S == 197:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                run()
            row["host_us"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        row["fwd"] = forward(fa, qkv, H)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if with_profile:
        rows += profile_path(root)
    return rows


def forward(fa, qkv, H: int) -> dict:
    """The forward's measures on one merged bf16 qkv (module note)."""
    import torch

    B, S, D3 = qkv.shape
    dh = D3 // (3 * H)
    run = lambda t=qkv: fa.flash_fwd_qkv(t, H, fast_dots=True)
    got = run()
    want = fa.flash_fwd_qkv_plain(qkv, H, fast_dots=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    q32 = qkv.float()
    views = fa.qkv_heads(qkv, H)
    split = {}
    profiled_ms, launches = _profiled(run, split=split)[2:4]
    return dict(err=err, kernel_ms=_device_ms(run), event_ms=_event_ms(run),
                fp32_ms=_device_ms(lambda: run(q32)),
                views_ms=_device_ms(lambda: fa.flash_fwd(*views,
                                                         fast_dots=True)),
                launches=launches, profiled_ms=profiled_ms, split=split,
                bound_ms=fwd_bound_ms(B, H, S, dh),
                sdpa_ms=_device_ms(lambda: torch.nn.functional.
                                   scaled_dot_product_attention(*views)))


def _sum_of(split: dict, *patterns) -> float:
    return sum(v for k, v in split.items()
               if any(p in k for p in patterns))


def profile_path(root: str) -> list:
    """The bf16 ``relevancy_fused_block2`` call at B=8 and 32 (module note)."""
    import copy

    import torch

    from transformer_mm_explainability_tpu_torch.models import vit

    dev = torch.device("cuda")
    model = copy.deepcopy(vit.init_params(0, vit.VIT_B_16, dev)).to(
        torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    rows = []
    for B in (8, 32):
        images = torch.randn((B, 224, 224, 3), generator=gen).to(
            dev, torch.bfloat16)
        targets = torch.randint(0, 1000, (B,), generator=gen).to(dev)
        call = lambda: vit.relevancy_fused_block2(model, images, targets,
                                                  fast_dots=True)
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        split = {}
        bwd_ms, bwd_n, busy, n = _profiled(call, iters=3, pattern="attn_bwd",
                                           split=split)
        fwd_n = _profiled(call, iters=3, pattern="attn_fwd")[1]
        row = dict(root=root, path="relevancy_fused_block2 bf16", B=B,
                   wall_ms=wall, maps_per_sec=B / wall * 1e3, busy_ms=busy,
                   launches=n, attn_bwd_ms=bwd_ms, attn_bwd_launches=bwd_n,
                   attn_fwd_ms=_sum_of(split, "attn_fwd"),
                   attn_fwd_launches=fwd_n,
                   gemm_ms=_sum_of(split, "gemm_bf16"),
                   layernorm_ms=_sum_of(split, "ln_fwd_bf16", "ln_vjp_any"),
                   split=split)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--json", default=None)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        run_one(os.path.abspath(args.roots[0]), args.profile)
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
        out = subprocess.run([sys.executable, __file__, "--one", root]
                             + ["--profile"] * args.profile,
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
        if "path" in row:
            print(f"{names[row['root']]} {row['path']} B={row['B']}: "
                  f"{row['maps_per_sec']:.1f} maps/s ({row['wall_ms']:.2f} ms "
                  f"a call), device busy {row['busy_ms']:.3f} ms in "
                  f"{row['launches']:.0f} launches; attention backward "
                  f"{row['attn_bwd_ms']:.3f} ms in "
                  f"{row['attn_bwd_launches']:.0f}, attention forward "
                  f"{row['attn_fwd_ms']:.3f} ms in "
                  f"{row['attn_fwd_launches']:.0f}, GEMM "
                  f"{row['gemm_ms']:.3f} ms, LayerNorm rows "
                  f"{row['layernorm_ms']:.3f} ms")
            continue
        print(f"{names[row['root']]} B={row['B']} H={row['H']} S={row['S']} "
              f"dh={row['dh']}: kernels {row['kernel_ms']:.4f} ms "
              f"(graph; profiler {row['profiled_ms']:.4f} ms in "
              f"{row['launches']:.0f} launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["split"].items())
              + "), events "
              f"{row['event_ms']:.4f} ms, fp32 tensors {row['fp32_ms']:.4f} "
              f"ms, bound {row['bound_ms']:.4f} ms, SDPA bwd (context) "
              f"{row['sdpa_ms']:.4f} ms, max|Δ|/max|plain| {row['err']:.2e}"
              + (f"; keys {row['keys']} (64: {row['keys_ms']['64']:.4f}, "
                 f"128: {row['keys_ms']['128']:.4f} ms)"
                 if "keys" in row else "")
              + (f"; host {row['host_us']:.1f} us/call"
                 if "host_us" in row else ""))
        f = row["fwd"]
        print(f"{names[row['root']]} B={row['B']} H={row['H']} S={row['S']} "
              f"dh={row['dh']} forward: qkv {f['kernel_ms']:.4f} ms (graph; "
              f"profiler {f['profiled_ms']:.4f} ms in {f['launches']:.0f} "
              "launches: "
              + ", ".join(f"{k} {v:.4f}" for k, v in f["split"].items())
              + f"), views {f['views_ms']:.4f} ms, events "
              f"{f['event_ms']:.4f} ms, fp32 tensors {f['fp32_ms']:.4f} ms, "
              f"bound {f['bound_ms']:.4f} ms, SDPA fwd {f['sdpa_ms']:.4f} ms, "
              f"max|Δ|/max|plain| {f['err']:.2e}")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(
            {"card": card.strip(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
