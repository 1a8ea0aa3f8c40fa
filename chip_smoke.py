#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (``nvidia-smi``);
2. builds ``csrc/attn_block.cu``, ``csrc/relevancy_chain.cu`` and
   ``csrc/roi_pool.cu`` with ``nvcc`` for ``sm_90a`` (one compiler process
   each, started together) and prints the build time and ptxas's register /
   spill report, one line per kernel (the GEMM and the attention backward
   must not spill);
3. GEMM phase: each product of the block kernels (g1-g9) and the chain's
   product unpadded (gc, on no path since the chain pads its rows) at the
   shapes of the main path (B=8), through
   ``ops/attn_block._gemm``, the tensor-core GEMM of ``csrc/common.cuh``:
   one line each with the tile it takes, its time (median of 5 event
   means, with their spread) and TFLOP/s, one PyTorch call's
   (``torch.addmm`` / ``torch.matmul`` / ``torch.baddbmm`` in fp32, TF32
   off), the fp32 and 3xTF32 bounds, and max|Δ| from float64 over
   max|C64| beside the fp32 library's own; a shape past 1e-5 raises; gc
   also gives the kernel's and ``torch.baddbmm``'s device time alone
   (torch.profiler), without the host's launch path;
4. kernel phase, each wrapper on the card held to its plain PyTorch version
   on the same inputs, with its time and the plain version's time (CUDA
   events, mean of 50 back-to-back calls after 3 warm-up calls; for the
   rows that run the GEMM or the attention kernels, the median of 5 such
   means, with their spread), the least time the card could take
   (``bound_ms``, fp32 on the CUDA cores; for the rows whose products run
   on the tensor cores, also ``bound_tc_ms`` at the 3xTF32 rate, and
   ``unit`` says where each row's work runs) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``; the
   backward rows also print the time of ``torch.autograd.grad`` through
   SDPA, which is not the same function: no ``e_row``):
   - at ViT-B/16 widths (B=8, S=197, D=768, H=12, dh=64, I=3072; fp32,
     TF32 off, within rtol 5e-4 / atol 1e-4): the four block wrappers of
     ``ops/attn_block``; the four of ``ops/flash_attention`` (per-head on
     contiguous [8, 12, 197, 64] tensors, qkv on a [8, 197, 2304] qkv, then
     the per-head wrappers on split-head views of that qkv, which must give
     the qkv wrappers' bits); ``ops/relevancy_pallas``'s chain on
     attention-scale [8, 12, 12, 197, 197] captures, batch-first views of
     [12, 8, ...] stacks as ``vit.capture`` gives them (no copy),
     start_layer 0 and 1, the row also within 1e-5 · max|R64| of the chain
     in float64, a bar that R = I and a chain of single-pass TF32 products
     must both miss, with its device time split between the reduction (one
     launch) and the 12 products, and one product's device time beside
     ``torch.baddbmm`` on the padded shapes (gc padded). ``flash_fwd`` and
     ``flash_fwd_qkv`` are
     also held within 1e-5 of their plain versions run in float64 (which a
     single TF32 product would miss), ``flash_bwd_ehat`` and
     ``flash_bwd_ehat_qkv`` each of dq, dk, dv and e_row within 1e-5 ·
     max|ref| of float64 at B=8 and at S = 2,000; ``flash_fwd`` runs at
     S = 4,000 and ``flash_bwd_ehat`` at S = 2,000 and 4,000 against their
     plain versions;
   - ``ops/roi_pool_pallas`` at the protocol shape (a [50, 76, 1024] map,
     1,000 boxes over an 800×1216 image with a tiny, a clipped and a
     degenerate one, P=14, scale 1/16), EXACTLY equal to its plain version,
     with the L2 reads of the earlier schedule (every bin's window) and of
     the box pixels, the kernel's own device time
     beside the wrapper's, and what ``roi_bin_bounds``'s torch operations
     (the earlier kernel's bins, now the plain version's) take on the
     device;
5. ViT path phase, full-width ViT-B/16 (12 layers, seeded random weights,
   B=8): ``relevancy_fused_block2`` (slice 1), ``relevancy_fused`` and
   ``relevancy_fused_block``. For each, every launch counter is set to 0
   before the call and must read exactly the path's kernels 12 times after
   it (and 0 for every other wrapper); the [8, 196] maps must lie within
   max|Δ| < 1e-4 of ``relevancy``, ``relevancy_streamed_row`` and
   ``relevancy_streamed`` (plain PyTorch on the card), whose largest entry
   must be at least 10 times that bar. Then the chain path,
   ``capture`` + ``self_attention_relevancy_auto``, launches the chain
   kernel once and its R[:, 0, 1:] matches ``relevancy``. Maps/s is the
   median of 3 timed trials per path at B=8 and B=32, the forward probes
   split each path's time into forward and backward, and torch.profiler
   splits the device time of ``relevancy_fused_block2``,
   ``relevancy_fused`` and the chain by kernel and gives the device's idle
   share;
6. cli phase: ``cli explain-vit --device cuda`` on a generated PNG, again
   through the kernels;
7. FRCNN path phase, full-width ``FRCNN_VG`` (ResNet-101 C4, 6000 → 1000
   RPN proposals, P=14, 1600 classes, 400 attributes, 36 detections;
   seeded random weights): two generated 600×912 RGB images through
   ``frcnn.preprocess`` (→ 800×1216) and ``frcnn.forward``, every counter
   at 0 before, ``roi_pool_pallas`` exactly 1 per image after and every
   other wrapper 0; the same images with ``roi_pool_impl="xla"`` give the
   same outputs (bit for bit, or the differences are printed and held to
   1e-5 of each output's scale, the pooled maps exactly); images/s (median
   of 3), a per-stage split from CUDA events (median of 3 forwards; the
   ``roi_pool`` stage on a line of its own) and a torch.profiler split
   with the device's idle share;
8. LXMERT path phase, full-width ``LXMERT_VQA`` (9/5/5 layers, D=768, 12
   heads, 3129 answers; seeded random weights), B=8 questions of St=20
   (several true lengths, padded) on the two images' 36 detections:
   ``LxmertPerturbationRunner(..., "ours_no_lrp").explain_batched`` on the
   card within max|Δ| < 1e-4 of the same call on the CPU; explanations/s
   at B=8 and B=32 and perturbation samples/s (9 steps, image and text) at
   B=8, medians of 3;
9. LXMERT cli phase: ``cli perturbation --model lxmert --device cuda`` (the
   synthetic run) and the port's LXMERT example on a generated PNG, which
   must write its two files through the RoIPool kernel (1 launch);
10. VisualBERT path phase, full-width ``VISUAL_BERT_VQA2`` (BERT-base, 12
   layers, D=768, 12 heads, 2048-d boxes, 3129 answers; seeded random
   weights), B=8 questions of S_t=128 (8-20 real tokens) on N_v=100 boxes
   (10-100 real): ``relevancy_row`` within max|Δ| < 1e-4 of ``capture`` +
   ``generate_ours`` on the card and of the CPU on two samples, scores
   within rtol 1e-4 / atol 1e-5; explanations/s at B=8 and 32, image and text
   perturbation samples/s at N=8 (explain + 9 steps), medians of 3, peak
   memory and torch.profiler splits of an explain and of a perturbation
   batch; every kernel counter 0 across the phase;
11. VisualBERT cli phase: ``cli perturbation --device cuda`` (default model)
   on synthetic samples, then on files written to ``build/smoke/vqa`` (a
   100-box 2048-d object TSV of two images, 8 questions, the answer
   vocabulary, a small WordPiece vocabulary) at full width, which must
   print nine step accuracies;
12. CLIP path phase, full-width CLIP ViT-B/32 (224 px, width 768, 12
   layers; text 77 tokens, width 512, 8 heads, 12 layers; seeded random
   weights): ``interpret`` on one generated image through
   ``clip_preprocess`` and 4 texts through ``bpe.tokenize``, R_txt and
   R_img within 1e-4 of the CPU, logits within rtol 1e-4 / atol 1e-5;
   interpret calls/s (median of 3) and a profile; RN50 (stages (3, 4, 6,
   3), width 64, embed 1024) ``encode_image`` within rtol 1e-4 of the CPU
   (atol 1e-5 of the features' scale); every
   kernel counter 0;
13. CLIP cli phase: ``cli explain-clip IMG TEXT... --device cuda`` writes
   one PNG per text.

Each phase prints its seconds.

It then prints one JSON line describing every kernel and, as its last line,
the device line. Any failure raises, so the exit code is non-zero; without
a CUDA device it exits with 2 before doing anything.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
B, S, D, H, I = 8, 197, 768, 12, 3072
DH = D // H
EPS = 1e-6
TOL = dict(rtol=5e-4, atol=1e-4)   # fp32 reduction order, kernel vs plain
MAP_BAR = 1e-4                     # the repo's relevancy parity target
SCORE_TOL = dict(rtol=1e-4, atol=1e-5)   # answer scores / logits vs the CPU
# H100 SXM published peaks: fp32 outside the tensor cores, HBM3
FP32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12
TF32_FLOPS = 495e12   # dense TF32 on the tensor cores; 3xTF32 takes 3 each
F64_BAR = 1e-5        # attention kernels vs the plain version in float64
GEMM_BAR = 1e-5       # GEMM: max|Δ| from float64 over max|C64|
CSRC = "transformer_mm_explainability_tpu_torch/csrc"
JAX_OPS = "transformer_mm_explainability_tpu/ops"
KERNELS = {  # name: (CUDA source, the TPU kernel it replaces)
    "attn_block_fwd": ("attn_block.cu", "attn_block_pallas.py:318"),
    "mlp_block_fwd": ("attn_block.cu", "attn_block_pallas.py:200"),
    "mlp_block_bwd": ("attn_block.cu", "attn_block_pallas.py:265"),
    "attn_block_bwd": ("attn_block.cu", "attn_block_pallas.py:345"),
    "flash_fwd": ("attn_block.cu", "flash_attention.py:124"),
    "flash_bwd_ehat": ("attn_block.cu", "flash_attention.py:144"),
    "flash_fwd_qkv": ("attn_block.cu", "flash_attention.py:257"),
    "flash_bwd_ehat_qkv": ("attn_block.cu", "flash_attention.py:279"),
    "self_attention_relevancy_pallas": ("relevancy_chain.cu",
                                        "relevancy_pallas.py:86"),
    "roi_pool_pallas": ("roi_pool.cu", "roi_pool_pallas.py:95"),
}
LIBRARIES = ("attn_block", "relevancy_chain", "roi_pool")
_GEMMS = "tensor cores, 3xTF32 (GEMMs"
BLOCK_UNITS = {   # where the work of each row built on the GEMM runs
    "attn_block_fwd": f"{_GEMMS} and attention); LayerNorm on the CUDA "
                      "cores, fp32",
    "mlp_block_fwd": f"{_GEMMS}); LayerNorm on the CUDA cores, fp32",
    "mlp_block_bwd": f"{_GEMMS}); LayerNorm and its VJP on the CUDA cores, "
                     "fp32",
    "attn_block_bwd": f"{_GEMMS} and attention backward); e_row head sum "
                      "and LayerNorm on the CUDA cores, fp32",
    "self_attention_relevancy_pallas": "tensor cores, 3xTF32 (GEMM); Ê "
                                       "reduction on the CUDA cores, fp32",
}
# rows #6 and #8: the function's 5 products run as 9 on the tensor cores
FLASH_BWD_UNIT = ("tensor cores, 3xTF32 (attention backward, 9 products for "
                  "the function's 5); e_row head sum on the CUDA cores, fp32")
# the products of one relevancy_fused_block2 call at B=8 (M = B·S) and the
# chain's product unpadded (gc; the chain runs it on rows padded to SP
# floats, timed in the chain phase): name: (M, N, K, trans_b, epilogue,
# batch, launches per call)
SP = -(-S // 4) * 4
GEMMS = {
    "g1 LN1·W_qkv": (B * S, 3 * D, D, False, "bias", 1, 24),
    "g2 merged·W_out": (B * S, D, D, False, "bias+res", 1, 12),
    "g3 LN2·W1": (B * S, I, D, False, "bias+gelu", 1, 12),
    "g4 GELU·W2": (B * S, D, I, False, "bias+res", 1, 12),
    "g5 LN2·W1": (B * S, I, D, False, "bias", 1, 12),
    "g6 cot·W2ᵀ": (B * S, I, D, True, "gelu'(aux), aux is C", 1, 12),
    "g7 da·W1ᵀ": (B * S, D, I, True, "none", 1, 12),
    "g8 cot·W_outᵀ": (B * S, D, D, True, "none", 1, 12),
    "g9 dqkv·W_qkvᵀ": (B * S, D, 3 * D, True, "none", 1, 12),
    "gc E·R + R": (S, S, S, False, "res", B, 0),
}
# the RoIPool protocol shape: res4 map of an 800×1216 image, 1000 RPN boxes
ROI_H, ROI_W, ROI_C, ROI_K, ROI_P = 50, 76, 1024, 1000, 14


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) per entry
    of a ``-Xptxas -v`` log; kernel names shortened to name<args>."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            # _ZN <len><anonymous namespace> <len><kernel> I<args>E ...
            m = re.match(r"_ZN(\d+)_GLOBAL__N_", name)
            if m:
                rest = name[m.end(1) + int(m.group(1)):]
                n = re.match(r"\d+", rest)
                if n:
                    ident = rest[n.end():n.end() + int(n.group())]
                    args = re.findall(r"L[ib](\d+)E", rest[n.end():])
                    name = ident + (f"<{','.join(args)}>" if args else "")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name = None
    return rows


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
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


def work(name: str, layers: int = 12, bin_pixels: int = 0) -> tuple:
    """(flops, bytes) that the function must do and move at the smoke
    shape: the FLOPs of its products (and of the chain's head reduction);
    each input read once, each output written once (fp32). ``layers``: the
    chain's layers from its start_layer on. ``bin_pixels``: RoIPool's
    Σ over bins of the bin's area for this run's boxes; its operations are
    one comparison per channel and pixel of a bin."""
    M, attn = B * S, 2 * B * H * S * S * DH   # one S×S×dh product
    f32 = 4
    if name == "roi_pool_pallas":   # map and boxes in, [K, P, P, C] out
        flops = bin_pixels * ROI_C
        nbytes = f32 * (ROI_H * ROI_W * ROI_C + 4 * ROI_K
                        + ROI_K * ROI_P * ROI_P * ROI_C)
    elif name == "attn_block_fwd":
        flops = 2 * M * D * 3 * D + 2 * attn + 2 * M * D * D
        nbytes = f32 * (2 * M * D + 4 * D * D + 7 * D)
    elif name == "mlp_block_fwd":
        flops = 2 * 2 * M * D * I
        nbytes = f32 * (2 * M * D + 2 * D * I + I + 3 * D)
    elif name == "mlp_block_bwd":
        flops = 3 * 2 * M * D * I
        nbytes = f32 * (3 * M * D + 2 * D * I + I + 2 * D)
    elif name == "attn_block_bwd":  # qkv, cot·W_outᵀ, 5 attention, ·W_qkvᵀ
        flops = 4 * M * D * 3 * D + 2 * M * D * D + 5 * attn
        nbytes = f32 * (3 * M * D + 2 * B * S + 4 * D * D + 5 * D)
    elif name in ("flash_fwd", "flash_fwd_qkv"):   # q·kᵀ, A·v
        flops = 2 * attn
        nbytes = f32 * 4 * M * D                    # q, k, v in; out
    elif name in ("flash_bwd_ehat", "flash_bwd_ehat_qkv"):
        flops = 5 * attn                # q·kᵀ, dout·vᵀ, ds·k, dsᵀ·q, Aᵀ·dout
        nbytes = f32 * (7 * M * D + 2 * B * S)      # q,k,v,dout,r; dq,dk,dv,e
    else:  # the chain: per layer Ê = mean_h relu(A∘G), then Ê·R
        flops = layers * B * (2 * S ** 3 + 3 * H * S * S)
        nbytes = f32 * (2 * B * layers * H * S * S + B * S * S)
    return flops, nbytes


def timed(fn, repeats: int) -> tuple:
    """(median, min, max) of ``repeats`` runs of ``cuda_ms(fn)``."""
    runs = [cuda_ms(fn) for _ in range(repeats)]
    return statistics.median(runs), min(runs), max(runs)


def device_ms(fn, iters: int = 20) -> dict:
    """(device ms, launches) per call of ``fn()``, by kernel name, from
    torch.profiler over ``iters`` calls after one warm-up call: the
    kernels' own time, without the host's launch path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        ms, n = out.get(ev.key, (0.0, 0.0))
        out[ev.key] = (ms + us / 1e3 / iters, n + ev.count / iters)
    return out


def ms_of(times: dict, pattern: str = "") -> float:
    """Device ms per call of the ``device_ms`` kernels whose name matches."""
    return sum(t for k, (t, _) in times.items() if re.search(pattern, k))


def launches_of(times: dict, pattern: str = "") -> float:
    """Launches per call of the ``device_ms`` kernels whose name matches."""
    return sum(n for k, (_, n) in times.items() if re.search(pattern, k))


def measure(name: str, kernel, plain, library=None, layers: int = 12,
            extra_err: float = 0.0, exact: bool = False,
            bin_pixels: int = 0, repeats: int = 1,
            tensor_cores: bool = False, unit: str = "") -> dict:
    """Hold ``kernel()`` to ``plain()`` (same inputs; equal to the bit when
    ``exact``) and time both, and ``library()`` where given, each as the
    median of ``repeats`` means; one row of the kernels line.
    ``tensor_cores``: the kernel's products run as 3xTF32 on the tensor
    cores, which adds their bound (``bound_tc_ms``). ``unit``: where the
    kernel's work runs, where the default words do not say it."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = extra_err
    for g, w in zip(got, want):
        assert torch.isfinite(g).all(), f"{name}: non-finite output"
        err = max(err, float((g - w).abs().max()))
        if exact:
            assert torch.equal(g, w), f"{name}: differs from plain by {err}"
        else:
            torch.testing.assert_close(g, w, **TOL)
    flops, nbytes = work(name, layers, bin_pixels)
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    ms, *ms_range = timed(kernel, repeats)
    plain_ms, *plain_range = timed(plain, repeats)
    library_ms = lib_range = None
    if library is not None:
        library_ms, *lib_range = timed(library, repeats)
    bound = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    src, replaces = KERNELS[name]

    def fmt(t, spread) -> str:
        return f"{t:.4f} ms" + ("" if repeats == 1 else
                                f" ({spread[0]:.4f}-{spread[1]:.4f})")

    lib_txt = ("" if library_ms is None
               else f", library {fmt(library_ms, lib_range)}")
    timing = "" if repeats == 1 else f"; median of {repeats} means (spread)"
    bar = "exact" if exact else "rtol 5e-4, atol 1e-4"
    row = {"name": name, "route": "cuda", "source": f"{CSRC}/{src}",
           "replaces": f"{JAX_OPS}/{replaces}", "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": bound_by, "library_ms": library_ms,
           "unit": unit or ("tensor cores, 3xTF32" if tensor_cores
                            else "CUDA cores, fp32")}
    tc_txt = ""
    if tensor_cores:
        row["bound_tc_ms"] = max(3 * flops / TF32_FLOPS * 1e3, t_bytes)
        tc_txt = f", 3xTF32 tensor-core bound {row['bound_tc_ms']:.4f} ms"
    print(f"kernel {name}: max|Δ| {err:.3e} ({bar}), "
          f"kernel {fmt(ms, ms_range)}, plain {fmt(plain_ms, plain_range)}"
          f"{lib_txt}, fp32 bound {bound:.4f} ms ({bound_by}, "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB){tc_txt}{timing}",
          flush=True)
    return row


def gemm_phase(ab, gen) -> None:
    """Each product of the block kernels (g1-g9) and the chain (gc) through
    ``ops/attn_block._gemm`` at the shapes of the main path: the tile it
    takes, its time (median of 5 event means) beside one PyTorch call's and
    both bounds, and its distance from float64, held to GEMM_BAR ·
    max|C64|."""
    dev = torch.device("cuda")
    lib = ab.library()
    st = torch.cuda.current_stream().cuda_stream
    total = total_lib = 0.0
    for name, (M, N, K, trans_b, epi, batch, per_call) in GEMMS.items():
        lead = (batch,) if batch > 1 else ()
        rnd = lambda *s_: torch.randn(s_, generator=gen).to(dev)
        a = rnd(*lead, M, K)
        b = rnd(*lead, *((N, K) if trans_b else (K, N))) / math.sqrt(K)
        bias, res, aux = rnd(N) * 0.1, rnd(*lead, M, N), rnd(*lead, M, N)
        kw = {"bias": bias if "bias" in epi else None,
              "res": res if "res" in epi else None,
              "aux": aux if "gelu'" in epi else None,
              "act": (ab._ACT_MUL_GELU_GRAD if "gelu'" in epi else
                      ab._ACT_GELU if "gelu" in epi else ab._ACT_NONE)}
        f64 = {k: v.double() if torch.is_tensor(v) else v
               for k, v in kw.items()}
        want = ab.gemm_plain(a.double(), b.double(), trans_b, **f64)
        own = ab.gemm_plain(a, b, trans_b, **kw)
        if "gelu'" in epi:   # the product written over aux, as in the path
            buf = aux.clone()
            kw.update(aux=buf, out=buf)
        run = lambda: ab._gemm(lib, a, b, st, trans_b=trans_b, **kw)
        got = run()
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), f"gemm {name}: non-finite output"
        scale = float(want.abs().max())
        err = float((got.double() - want).abs().max()) / scale
        own_err = float((own.double() - want).abs().max()) / scale
        op_b = b.transpose(-1, -2) if trans_b else b
        if "bias" in epi:     # one call: the product and the bias
            library = lambda: torch.addmm(bias, a, op_b)
        elif batch > 1:       # the chain's whole function
            library = lambda: torch.baddbmm(res, a, op_b)
        else:
            library = lambda: torch.matmul(a, op_b)
        ms, lo, hi = timed(run, 5)
        lib_ms = timed(library, 5)[0]
        flops = 2 * M * N * K * batch
        nbytes = 4 * batch * (M * K + K * N + M * N
                              * (1 + ("res" in epi) + ("gelu'" in epi)))
        nbytes += 4 * N * ("bias" in epi)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        b32 = max(flops / FP32_FLOPS * 1e3, t_bytes)
        btc = max(3 * flops / TF32_FLOPS * 1e3, t_bytes)
        if batch == 1:   # g1-g9: the products of the main path
            total += per_call * ms
            total_lib += per_call * lib_ms
        warps = lib.tmx_gemm_warps(M, N, batch)
        tile = f"64x64 ({warps} warps of 32x{128 // warps})"
        shape = f"{batch} x " if batch > 1 else ""
        dev_txt = ""
        if batch > 1:    # the chain's: device time alone, no host path
            own, lib_dev = device_ms(run), device_ms(library)
            dev_txt = (f"; device time kernel "
                       f"{ms_of(own, 'gemm_tc_kernel'):.4f} ms, library "
                       f"{ms_of(lib_dev):.4f} ms (torch.profiler, 20 calls)")
        print(f"gemm {name}: {shape}{M}x{K}x{N} (MxKxN), B "
              f"{'[N,K]' if trans_b else '[K,N]'}, epilogue {epi}, copies "
              f"{ab.gemm_copy_width(a, b)} B, tile {tile}: kernel "
              f"{ms:.4f} ms ({lo:.4f}-{hi:.4f}) {flops / ms / 1e9:.1f} "
              f"TFLOP/s; library {lib_ms:.4f} ms {flops / lib_ms / 1e9:.1f} "
              f"TFLOP/s; bounds fp32 {b32:.4f} ms, 3xTF32 {btc:.4f} ms; "
              f"max|Δ|/max|C64| {err:.2e} (bar {GEMM_BAR:g}; fp32 library "
              f"{own_err:.2e}); {per_call} launches per call{dev_txt}",
              flush=True)
        assert err <= GEMM_BAR, f"gemm {name}: {err} of max|C64| from float64"
    print(f"gemm per relevancy_fused_block2 call (B={B}, g1-g9): kernel "
          f"{total:.3f} ms, library {total_lib:.3f} ms (sum of launches x "
          f"median event means)", flush=True)


def block_kernel_phase(ab, gen) -> dict:
    dev = torch.device("cuda")
    rnd = lambda *s, scale=0.3: (torch.randn(s, generator=gen) * scale).to(dev)
    wt = lambda *s: (torch.randn(s, generator=gen) / math.sqrt(D)).to(dev)
    x, cot = rnd(B, S, D), rnd(B, S, D)
    r = torch.rand((B, S), generator=gen).to(dev)
    attn_w = (wt(D, 3 * D), rnd(3 * D, scale=0.03), wt(D, D),
              rnd(D, scale=0.03), 1.0 + rnd(D, scale=0.03), rnd(D, scale=0.03))
    w1, b1 = wt(D, I), rnd(I, scale=0.03)
    w2, b2 = wt(I, D), rnd(D, scale=0.03)
    g2, bb2 = 1.0 + rnd(D, scale=0.03), rnd(D, scale=0.03)
    wqkv, bqkv, wout, bout, g1, bl1 = attn_w
    calls = {
        "attn_block_fwd": (
            lambda: ab.attn_block_fwd(x, wqkv, bqkv, wout, bout, g1, bl1, H,
                                      EPS),
            lambda: ab.attn_block_fwd_plain(x, wqkv, bqkv, wout, bout, g1, bl1,
                                            H, EPS)),
        "mlp_block_fwd": (
            lambda: ab.mlp_block_fwd(x, w1, b1, w2, b2, g2, bb2, EPS),
            lambda: ab.mlp_block_fwd_plain(x, w1, b1, w2, b2, g2, bb2, EPS)),
        "mlp_block_bwd": (
            lambda: ab.mlp_block_bwd(x, cot, w1, b1, w2, g2, bb2, EPS),
            lambda: ab.mlp_block_bwd_plain(x, cot, w1, b1, w2, g2, bb2, EPS)),
        "attn_block_bwd": (
            lambda: ab.attn_block_bwd(x, cot, r, wqkv, bqkv, wout, g1, bl1, H,
                                      EPS),
            lambda: ab.attn_block_bwd_plain(x, cot, r, wqkv, bqkv, wout, g1,
                                            bl1, H, EPS)),
    }
    # no single PyTorch call computes a fused block: library_ms is null;
    # their products run on the tensor cores, each row timed as a median
    # of 5
    return {name: measure(name, kernel, plain, repeats=5, tensor_cores=True,
                          unit=BLOCK_UNITS[name])
            for name, (kernel, plain) in calls.items()}


def flash_kernel_phase(fa, gen) -> dict:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    dev = torch.device("cuda")
    rnd = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(dev)
    qkv, dmerged = rnd(B, S, 3 * D), rnd(B, S, D)
    r = torch.rand((B, S), generator=gen).to(dev)
    views, dview = fa.qkv_heads(qkv, H), fa.heads(dmerged, H)
    q, k, v = (t.contiguous() for t in views)
    dout = dview.contiguous()
    fwd = dict(repeats=5, tensor_cores=True)
    bwd = dict(repeats=5, tensor_cores=True, unit=FLASH_BWD_UNIT)
    rows = {
        "flash_fwd": measure(
            "flash_fwd", lambda: fa.flash_fwd(q, k, v),
            lambda: fa.flash_fwd_plain(q, k, v), lambda: sdpa(q, k, v),
            **fwd),
        "flash_bwd_ehat": measure(
            "flash_bwd_ehat", lambda: fa.flash_bwd_ehat(q, k, v, dout, r),
            lambda: fa.flash_bwd_ehat_plain(q, k, v, dout, r), **bwd),
        # SDPA on the split-head views of the same qkv: the same attention,
        # its output left per head
        "flash_fwd_qkv": measure(
            "flash_fwd_qkv", lambda: fa.flash_fwd_qkv(qkv, H),
            lambda: fa.flash_fwd_qkv_plain(qkv, H), lambda: sdpa(*views),
            **fwd),
        "flash_bwd_ehat_qkv": measure(
            "flash_bwd_ehat_qkv",
            lambda: fa.flash_bwd_ehat_qkv(qkv, dmerged, r, H),
            lambda: fa.flash_bwd_ehat_qkv_plain(qkv, dmerged, r, H), **bwd),
    }
    # a yardstick only: PyTorch's own attention backward computes dq, dk,
    # dv without the e_row fold, so it stays out of library_ms
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = sdpa(qg, kg, vg)
    ms, lo, hi = timed(lambda: torch.autograd.grad(out, (qg, kg, vg), dout,
                                                   retain_graph=True), 5)
    print(f"library torch.autograd.grad through SDPA fp32 for (dq, dk, dv) "
          f"at {tuple(q.shape)}: {ms:.4f} ms ({lo:.4f}-{hi:.4f}); not the "
          f"same function (no e_row)", flush=True)
    del qg, kg, vg, out
    # the per-head kernels on split-head views of qkv == the qkv kernels
    out = fa.flash_fwd(*views)
    assert torch.equal(out, fa.heads(fa.flash_fwd_qkv(qkv, H), H))
    *grads, e_row = fa.flash_bwd_ehat(*views, dview, r)
    dqkv, e_qkv = fa.flash_bwd_ehat_qkv(qkv, dmerged, r, H)
    assert all(torch.equal(g, w) for g, w in zip(grads, fa.qkv_heads(dqkv, H)))
    assert torch.equal(e_row, e_qkv)
    assert torch.equal(fa.flash_fwd(*views), out)
    print("kernel flash_fwd / flash_bwd_ehat on split-head views of qkv: "
          "the same bits as flash_fwd_qkv / flash_bwd_ehat_qkv; a second "
          "call repeats them", flush=True)

    # fp32 accuracy of the 3xTF32 products: against float64
    for name, got, want in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v),
             lambda t: fa.flash_fwd_plain(*(x.to(t) for x in (q, k, v)))),
            ("flash_fwd_qkv", lambda: fa.flash_fwd_qkv(qkv, H),
             lambda t: fa.flash_fwd_qkv_plain(qkv.to(t), H))):
        want64 = want(torch.float64)
        err = float((got().double() - want64).abs().max())
        own = float((want(torch.float32).double() - want64).abs().max())
        rows[name]["max_abs_err_f64"] = err
        print(f"kernel {name} vs its plain version in float64: max|Δ| "
              f"{err:.3e} (bar {F64_BAR:g}); the fp32 plain version's own "
              f"distance from float64 {own:.3e}", flush=True)
        assert err <= F64_BAR, f"{name}: {err} from float64"

    # the backward's fp32 accuracy, output by output: at B=8, then S=2000
    for name, err in bwd_f64_gate(fa, "B=8 S=197", qkv, dmerged, r, H).items():
        rows[name]["max_rel_err_f64"] = err
    lqkv, ldm = rnd(1, 2000, 6 * DH), rnd(1, 2000, 2 * DH)
    lr = torch.rand((1, 2000), generator=gen).to(dev)
    for name, err in bwd_f64_gate(fa, "B=1 H=2 S=2000", lqkv, ldm, lr,
                                  2).items():
        rows[name]["max_rel_err_f64"] = max(rows[name]["max_rel_err_f64"],
                                            err)

    # lengths whose score rows the old kernels could not hold
    lq, lk, lv = (rnd(1, 2, 4000, DH) for _ in range(3))
    got = fa.flash_fwd(lq, lk, lv)
    want = fa.flash_fwd_plain(lq, lk, lv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    print(f"kernel flash_fwd at S=4000 (B=1, H=2, dh={DH}): max|Δ| "
          f"{float((got - want).abs().max()):.3e} (rtol 5e-4, atol 1e-4), "
          f"kernel {cuda_ms(lambda: fa.flash_fwd(lq, lk, lv), 10):.4f} ms, "
          f"plain {cuda_ms(lambda: fa.flash_fwd_plain(lq, lk, lv), 10):.4f} "
          f"ms", flush=True)
    lib = fa.library()
    for L in (2000, 4000):
        assert lib.tmx_attn_smem(L, DH, 1) == lib.tmx_attn_smem(S, DH, 1)
        args = (*(rnd(1, 2, L, DH) for _ in range(4)),
                torch.rand((1, L), generator=gen).to(dev))
        got = fa.flash_bwd_ehat(*args)
        want = fa.flash_bwd_ehat_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"kernel flash_bwd_ehat at S={L} (B=1, H=2, dh={DH}; shared "
              f"memory {lib.tmx_attn_smem(L, DH, 1)} bytes a block, as at "
              f"S={S}): max|Δ| {err:.3e} (rtol 5e-4, atol 1e-4), kernel "
              f"{cuda_ms(lambda: fa.flash_bwd_ehat(*args), 10):.4f} ms, plain "
              f"{cuda_ms(lambda: fa.flash_bwd_ehat_plain(*args), 10):.4f} ms",
              flush=True)
    return rows


def bwd_f64_gate(fa, label: str, qkv, dmerged, r, nheads: int) -> dict:
    """``flash_bwd_ehat`` on per-head copies of a merged qkv and cotangent,
    and ``flash_bwd_ehat_qkv`` on the merged tensors: each of dq, dk, dv
    and e_row within F64_BAR · max|ref| of the plain version in float64
    (the fp32 plain version's own distance printed beside it); returns the
    worst max|Δ| / max|ref| per wrapper."""
    q, k, v = (t.contiguous() for t in fa.qkv_heads(qkv, nheads))
    per_head = (q, k, v, fa.heads(dmerged, nheads).contiguous(), r)

    def split(dqkv, e_row):
        return (*fa.qkv_heads(dqkv, nheads), e_row)

    runs = {
        "flash_bwd_ehat": (
            lambda: fa.flash_bwd_ehat(*per_head),
            lambda t: fa.flash_bwd_ehat_plain(*(x.to(t) for x in per_head))),
        "flash_bwd_ehat_qkv": (
            lambda: split(*fa.flash_bwd_ehat_qkv(qkv, dmerged, r, nheads)),
            lambda t: split(*fa.flash_bwd_ehat_qkv_plain(
                qkv.to(t), dmerged.to(t), r.to(t), nheads)))}
    worst = {}
    for name, (kernel, plain) in runs.items():
        got, want64, own = kernel(), plain(torch.float64), plain(torch.float32)
        rel = [[float((x.double() - w).abs().max() / w.abs().max())
                for x, w in zip(out, want64)] for out in (got, own)]
        print(f"kernel {name} {label} vs its plain version in float64, "
              f"max|Δ|/max|ref| of dq, dk, dv, e_row: "
              f"{', '.join(f'{e:.2e}' for e in rel[0])} (bar {F64_BAR:g}); "
              f"the fp32 plain version's own: "
              f"{', '.join(f'{e:.2e}' for e in rel[1])}", flush=True)
        assert max(rel[0]) <= F64_BAR, f"{name} {label}: {rel[0]}"
        worst[name] = max(rel[0])
    return worst


def chain_captures() -> tuple:
    """Attention-scale captures [B, 12, H, S, S] as batch-first views of
    [12, B, H, S, S] stacks, as ``vit.capture`` gives them: rows of |randn|
    summing to one, randn gradients. The products then move R well away
    from I, where random ViT-B/16 captures leave it within about 1e-2."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = (12, B, H, S, S)
    cams = torch.randn(shape, generator=gen, device="cuda").abs_()
    cams /= cams.sum(-1, keepdim=True)
    grads = torch.randn(shape, generator=gen, device="cuda")
    return cams.movedim(1, 0), grads.movedim(1, 0)


def chain_f64(cams, grads) -> torch.Tensor:
    """The rule-6 chain in float64 (the plain chain takes its Ê in fp32
    whatever the captures' dtype)."""
    e = torch.clamp(cams.double() * grads.double(), min=0).mean(dim=2)
    R = torch.eye(S, dtype=torch.float64, device=e.device).expand(B, S, S)
    for i in range(e.shape[1]):
        R = R + e[:, i] @ R
    return R


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 stored significand bits), as one TF32 pass of
    the tensor cores reads it."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def chain_kernel_phase(rp) -> dict:
    """The chain on attention-scale captures: at start_layer 1, then the
    row (start_layer 0, all 12 layers) within F64_BAR · max|R64| of the
    chain in float64, where a chain with no products (R = I) and one whose
    products are a single TF32 pass both miss that bar; then the call's
    device time split between the reduction and the products."""
    cams, grads = chain_captures()
    got = rp.self_attention_relevancy_pallas(cams, grads, 1)
    want = rp.self_attention_relevancy_pallas_plain(cams, grads, 1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **TOL)
    print(f"kernel self_attention_relevancy_pallas start_layer=1: max|Δ| "
          f"{err:.3e} on captures {tuple(cams.shape)}, strides "
          f"{cams.stride()}", flush=True)
    call = lambda: rp.self_attention_relevancy_pallas(cams, grads)
    got = call()
    assert got.is_contiguous() and got.shape == (B, S, S)
    want64 = chain_f64(cams, grads)
    scale = float(want64.abs().max())
    off = lambda R: float((R.double() - want64).abs().max()) / scale
    rel = off(got)
    moved = off(torch.eye(S, device=got.device).expand(B, S, S))
    e = torch.clamp(cams * grads, min=0).mean(dim=2)
    one_pass = torch.eye(S, device=got.device).expand(B, S, S)
    for i in range(e.shape[1]):
        one_pass = one_pass + tf32(e[:, i].contiguous()) @ tf32(
            one_pass.contiguous())
    rel_tf32 = off(one_pass)
    del want64, e, one_pass
    print(f"kernel self_attention_relevancy_pallas vs float64: max|Δ| / "
          f"max|R64| {rel:.2e} (bar {F64_BAR:g}); max|R64| {scale:.4f}, "
          f"max|R64 - I| / max|R64| {moved:.2e} (R = I misses the bar by "
          f"that), one TF32 pass per product {rel_tf32:.2e}", flush=True)
    assert rel <= F64_BAR, f"chain: {rel} of max|R64| from float64"
    assert moved > 100 * F64_BAR and rel_tf32 > F64_BAR, \
        f"chain: the float64 bar cannot fail a wrong chain ({moved}, " \
        f"{rel_tf32})"
    t = device_ms(call)
    red, prod = ms_of(t, "ehat_kernel"), ms_of(t, "gemm_tc_kernel")
    n_prod = launches_of(t, "gemm_tc_kernel")
    # gc padded: one layer's product as the chain runs it (E and R padded
    # to SP columns with zeros, 16-byte copies) beside torch.baddbmm on
    # the same operands
    gen = torch.Generator().manual_seed(5)
    e = torch.zeros((B, S, SP))
    e[..., :S] = torch.rand((B, S, S), generator=gen) / S
    r = torch.zeros((B, SP, SP))
    r[:, :S, :S] = torch.randn((B, S, S), generator=gen)
    e, r = e.to(cams.device), r.to(cams.device)
    lib_t = device_ms(lambda: torch.baddbmm(r[:, :S], e, r))
    print(f"split self_attention_relevancy_pallas {tuple(cams.shape)}: "
          f"reduction {red:.4f} ms in {launches_of(t, 'ehat_kernel'):g} "
          f"launch(es), products {prod:.4f} ms in {n_prod:g} launches "
          f"({prod / max(n_prod, 1) * 1e3:.2f} us each), other "
          f"{ms_of(t) - red - prod:.4f} ms; device time per call "
          f"(torch.profiler, 20 calls)", flush=True)
    print(f"gemm gc padded E·R + R: {B} x {S}x{SP}x{SP} (MxKxN), 16-byte "
          f"copies: kernel {prod / max(n_prod, 1):.4f} ms per launch in the "
          f"chain; torch.baddbmm {ms_of(lib_t):.4f} ms in "
          f"{launches_of(lib_t):g} launch(es) on the same shapes; device "
          f"time (torch.profiler)", flush=True)
    name = "self_attention_relevancy_pallas"
    return {name: measure(
        name, call,
        lambda: rp.self_attention_relevancy_pallas_plain(cams, grads),
        layers=cams.shape[1], extra_err=err, repeats=5, tensor_cores=True,
        unit=BLOCK_UNITS[name])}


def roi_kernel_phase(rpool, gen) -> dict:
    """RoIPool at the protocol shape: a [50, 76, 1024] map and 1000 boxes
    over the 800×1216 image, a tiny, a clipped and a degenerate one
    first; the kernel must equal its plain version to the bit."""
    dev = torch.device("cuda")
    feats = torch.randn((ROI_H, ROI_W, ROI_C), generator=gen).to(dev)
    img_h, img_w = ROI_H * 16.0, ROI_W * 16.0
    u = torch.rand((ROI_K, 4), generator=gen)
    x0, y0 = u[:, 0] * img_w * 0.9, u[:, 1] * img_h * 0.9
    boxes = torch.stack([x0, y0, x0 + u[:, 2] * img_w * 0.6,
                         y0 + u[:, 3] * img_h * 0.6], 1)
    boxes[:3] = torch.tensor([[0.0, 0.0, 2.0, 2.0],
                              [img_w - 3, img_h - 3, img_w + 50, img_h + 50],
                              [5.0, 5.0, 5.0, 5.0]])
    boxes = boxes.to(dev)
    bounds = lambda: rpool.roi_bin_bounds(boxes, ROI_P, 1 / 16, ROI_H, ROI_W)
    hs, he, ws, we = bounds()
    bin_pixels = int(((he - hs)[:, :, None] * (we - ws)[:, None, :]).sum())
    # the rows and columns some bin covers are one interval each
    span = lambda lo, hi: (hi - lo).clamp(min=0)
    box_pixels = int((span(hs[:, 0], he[:, -1])
                      * span(ws[:, 0], we[:, -1])).sum())
    name = "roi_pool_pallas"
    call = lambda: rpool.roi_pool_pallas(feats, boxes, ROI_P, 1 / 16)
    # no single PyTorch call computes RoIPool (torchvision is not there)
    row = measure(name, call,
                  lambda: rpool.roi_pool_plain(feats, boxes, ROI_P, 1 / 16),
                  exact=True, bin_pixels=bin_pixels)
    t, tb = device_ms(call), device_ms(bounds)
    gb = lambda pixels: pixels * ROI_C * 4 / 1e9
    print(f"roi_pool reads at the protocol shape: {gb(bin_pixels):.3f} GB "
          f"bin by bin (the earlier schedule: every bin's window), "
          f"{gb(box_pixels):.3f} GB of box pixels; output "
          f"{ROI_K * ROI_P ** 2 * ROI_C * 4 / 1e9:.3f} GB", flush=True)
    print(f"roi_pool device time: kernel {ms_of(t, 'roi_pool_kernel'):.4f} "
          f"ms in {launches_of(t, 'roi_pool_kernel'):g} launch, all "
          f"kernels of the call {ms_of(t):.4f} ms, wrapper (events) "
          f"{row['ms']:.4f} ms; roi_bin_bounds in torch (the earlier "
          f"kernel's bins, now the plain version's) {ms_of(tb):.4f} ms in "
          f"{launches_of(tb):g} launches, {cuda_ms(bounds):.4f} ms by events "
          f"(torch.profiler, 20 calls)", flush=True)
    return {name: row}


def reset_counts(mods) -> None:
    for m in mods:
        m.reset_launch_counts()


def counts(mods) -> dict:
    return {name: n for m in mods for name, n in m.launch_counts().items()}


def path_phase(mods, vit, rp, model, images, targets, cams, grads,
               card: str) -> dict:
    """The three kernel paths and the chain path, each driven with every
    counter at 0; returns the launch count of each kernel from the run of
    the path it belongs to."""
    depth = vit.VIT_B_16.depth
    paths = {
        "relevancy_fused_block2": ("attn_block_fwd", "mlp_block_fwd",
                                   "mlp_block_bwd", "attn_block_bwd"),
        "relevancy_fused": ("flash_fwd_qkv", "flash_bwd_ehat_qkv"),
        "relevancy_fused_block": ("attn_block_fwd", "attn_block_bwd"),
    }
    refs = {name: getattr(vit, name)(model, images, targets)
            for name in ("relevancy", "relevancy_streamed_row",
                         "relevancy_streamed")}
    torch.cuda.synchronize()
    launches = {}
    for path, kernels in paths.items():
        torch.cuda.reset_peak_memory_stats()
        reset_counts(mods)
        maps = getattr(vit, path)(model, images, targets)
        torch.cuda.synchronize()
        got = counts(mods)
        print(f"path {path} launches: {got}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        want = {name: depth if name in kernels else 0 for name in got}
        assert got == want, f"{path}: launches {got}, expected {want}"
        for name in kernels:
            launches.setdefault(name, got[name])
        check_maps(path, maps, refs)

    reset_counts(mods)
    R = rp.self_attention_relevancy_auto(cams, grads)
    torch.cuda.synchronize()
    got = counts(mods)
    print(f"path capture + self_attention_relevancy_auto launches: {got}",
          flush=True)
    chain = "self_attention_relevancy_pallas"
    assert got == {name: int(name == chain) for name in got}, got
    launches[chain] = got[chain]
    check_maps("self_attention_relevancy_auto", R[:, 0, 1:], refs)
    # on no model path (the JAX package calls them only from its tests)
    launches.setdefault("flash_fwd", 0)
    launches.setdefault("flash_bwd_ehat", 0)

    def rate(fn, batch_images, batch_targets) -> float:
        trials = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(model, batch_images, batch_targets)
            torch.cuda.synchronize()
            trials.append(batch_images.shape[0] / (time.perf_counter() - t0))
        return statistics.median(trials)

    def fwd_ms(probe) -> float:
        trials = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            probe(model, images)
            torch.cuda.synchronize()
            trials.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(trials)

    rates = {path: rate(getattr(vit, path), images, targets) for path in paths}
    plain = rate(vit.relevancy, images, targets)
    print(f"maps/s ViT-B/16 fp32 B={B}: "
          + ", ".join(f"{p} {v:.1f}" for p, v in rates.items())
          + f", relevancy (plain torch) {plain:.1f}; median of 3 on {card}",
          flush=True)
    for path in paths:
        total = B / rates[path] * 1e3
        fwd = fwd_ms(getattr(vit, f"{path}_forward_probe"))
        print(f"split {path} B={B}: forward {fwd:.2f} ms, backward "
              f"{total - fwd:.2f} ms of {total:.2f} ms (forward probe, median "
              f"of 3)", flush=True)
    for path in ("relevancy_fused_block2", "relevancy_fused"):
        profile(f"{path} B={B}",
                lambda: getattr(vit, path)(model, images, targets),
                B / rates[path] * 1e3)
    chain_ms = cuda_ms(lambda: rp.self_attention_relevancy_auto(cams, grads))
    profile(f"self_attention_relevancy_auto {tuple(cams.shape)}",
            lambda: rp.self_attention_relevancy_auto(cams, grads), chain_ms)
    gen = torch.Generator().manual_seed(1)
    big = torch.randn((32, 224, 224, 3), generator=gen).to(images.device)
    big_t = torch.randint(0, 1000, (32,), generator=gen).to(images.device)
    for path in paths:
        getattr(vit, path)(model, big, big_t)
        print(f"maps/s ViT-B/16 fp32 B=32: {path} "
              f"{rate(getattr(vit, path), big, big_t):.1f}; median of 3 on "
              f"{card}", flush=True)
    return launches


def check_maps(path: str, maps, refs: dict) -> None:
    """maps within MAP_BAR of each reference, whose largest entry is at
    least 10 · MAP_BAR (maps of zeros miss the bar)."""
    assert maps.shape == (B, S - 1), maps.shape
    assert torch.isfinite(maps).all(), f"{path}: non-finite maps"
    for name, other in refs.items():
        err = float((maps - other).abs().max())
        top = float(other.abs().max())
        print(f"path {path} maps vs {name}: max|Δ| {err:.3e} (bar "
              f"{MAP_BAR:g}; max|map| {top:.3e})", flush=True)
        assert err < MAP_BAR, f"{path}: maps differ from {name} by {err}"
        assert top >= 10 * MAP_BAR, f"{path}: {name}'s maps are {top}"


# kernel-name patterns (mangled or demangled): the port's kernels first,
# then cuDNN's convolutions and cuBLAS / cuDNN products
KERNEL_GROUPS = (("roi_pool", "roi_pool_kernel"),
                 ("GEMM 64x64 (tensor cores)", "gemm_tc_kernel"),
                 ("attn fwd", "attn_fwd_kernel"),
                 ("attn bwd q pass", "attn_bwd_q_kernel"),
                 ("attn bwd kv pass", "attn_bwd_kv_kernel"),
                 ("layernorm fwd", "ln_fwd_kernel"),
                 ("layernorm vjp", "ln_vjp_kernel"),
                 ("e_row", "e_row_kernel"),
                 ("relevancy Ê", "ehat_kernel"),
                 ("convolution (cuDNN)",
                  r"(?i)conv|fprop|implicit|winograd|cudnn"),
                 ("matrix products (cuBLAS, xmma)",
                  r"(?i)gemm|cutlass|cublas|xmma"))


def profile(label: str, call, call_ms: float, show_other: int = 0) -> None:
    """Device time of one ``call()`` by kernel, from torch.profiler; the
    idle share is against the unprofiled call time. ``show_other``: how many
    of the largest kernels of the "other (torch)" group to name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (torch)"] = 0.0
    other = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        name = next((g for g, pat in KERNEL_GROUPS if re.search(pat, ev.key)),
                    "other (torch)")
        groups[name] += us / 1e3
        if name == "other (torch)":
            other.append((us / 1e3, ev.count, ev.key))
    busy = sum(groups.values())
    if busy == 0.0:
        print("profile: device time not measured (the profiler recorded no "
              "CUDA kernels)", flush=True)
        return
    print(f"profile {label}: device busy "
          f"{busy:.2f} ms of {call_ms:.2f} ms per call (idle share "
          f"{max(0.0, 1 - busy / call_ms):.3f})", flush=True)
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        if ms > 0.0:
            print(f"  {name}: {ms:.3f} ms ({ms / busy:.1%})", flush=True)
    for ms, n, key in sorted(other, reverse=True)[:show_other]:
        print(f"    other: {ms:.3f} ms in {n} launches of {key[:90]}",
              flush=True)


def cli_phase(ab, cli) -> None:
    import numpy as np
    from PIL import Image

    work_dir = ROOT / "build" / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    arr = (np.random.RandomState(0).rand(240, 320, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(work_dir / "input.png")
    ab.reset_launch_counts()
    rc = cli.main(["explain-vit", str(work_dir / "input.png"), "--output",
                   str(work_dir / "relevancy.png"), "--device", "cuda"])
    torch.cuda.synchronize()
    assert rc == 0
    got = ab.launch_counts()
    assert all(n == 12 for n in got.values()), got
    fig = np.asarray(Image.open(work_dir / "relevancy.png"))
    assert fig.shape == (224, 224, 3), fig.shape
    print(f"cli explain-vit --device cuda: ok, launches {got}", flush=True)


def frcnn_phase(mods, frcnn, rpool, card: str):
    """Full-width FRCNN_VG on two generated 600×912 images; returns the
    RoIPool launches of the path's run and the two detections."""
    import dataclasses

    dev = torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32
    cfg = frcnn.FRCNN_VG
    assert cfg.roi_pool_impl == "pallas"
    params = frcnn.init_params(0, cfg, dev)
    gen = torch.Generator().manual_seed(2)
    rgb = [torch.randint(0, 256, (600, 912, 3), generator=gen,
                         dtype=torch.uint8) for _ in range(2)]
    pre = [frcnn.preprocess(im, device=dev) for im in rgb]
    assert all(tuple(p.shape) == (800, 1216, 3) for p in pre)

    torch.cuda.reset_peak_memory_stats()
    reset_counts(mods)
    with torch.no_grad():
        outs = [frcnn.forward(params, p, cfg) for p in pre]
    torch.cuda.synchronize()
    got = counts(mods)
    print(f"path frcnn.forward FRCNN_VG x2 images launches: {got}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    want = {name: len(pre) * (name == "roi_pool_pallas") for name in got}
    assert got == want, f"frcnn: launches {got}, expected {want}"
    for o in outs:
        assert o["roi_features"].shape == (cfg.max_detections, 2048)
        assert o["rois"].shape == (cfg.post_nms_topk, 4)
        assert all(torch.isfinite(v.float()).all() for v in o.values())
    print(f"path frcnn detections valid: "
          f"{[int(o['valid'].sum()) for o in outs]} of {cfg.max_detections}, "
          f"rois valid: {[int(o['roi_valid'].sum()) for o in outs]} of "
          f"{cfg.post_nms_topk}, max|roi feature| "
          f"{max(float(o['roi_features'].abs().max()) for o in outs):.3e}",
          flush=True)

    # the same images through the plain RoIPool; the pooled maps of the
    # path's own features and rois held to the bit
    xcfg = dataclasses.replace(cfg, roi_pool_impl="xla")
    with torch.no_grad():
        xouts = [frcnn.forward(params, p, xcfg) for p in pre]
        feats = frcnn._res4_features(params, pre[0][None], cfg)[0]
        pool_args = (feats, outs[0]["rois"], cfg.pooler_resolution,
                     1.0 / cfg.feat_stride)
        assert torch.equal(rpool.roi_pool_pallas(*pool_args),
                           rpool.roi_pool_plain(*pool_args))
    diffs = {}
    for o, x in zip(outs, xouts):
        for k in o:
            if not torch.equal(o[k], x[k]):
                scale = max(1.0, float(x[k].float().abs().max()))
                diffs[k] = max(diffs.get(k, 0.0), float(
                    (o[k].float() - x[k].float()).abs().max()) / scale)
    if diffs:
        print(f"path frcnn roi_pool_impl pallas vs xla: pooled maps equal, "
              f"outputs NOT bit-identical, max|Δ| / scale {diffs}",
              flush=True)
        assert all(v <= 1e-5 for v in diffs.values()), diffs
    else:
        print("path frcnn roi_pool_impl pallas vs xla: all outputs "
              "bit-identical (pooled maps equal)", flush=True)

    def run_all():
        with torch.no_grad():
            for p in pre:
                frcnn.forward(params, p, cfg)

    trials = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_all()
        torch.cuda.synchronize()
        trials.append(len(pre) / (time.perf_counter() - t0))
    rate = statistics.median(trials)
    print(f"images/s FRCNN_VG 800x1216 fp32: {rate:.2f} (median of 3, "
          f"{len(pre)} images each) on {card}", flush=True)

    stages = []
    for _ in range(3):
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        start = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        with torch.no_grad():
            frcnn.forward(params, pre[0], cfg, on_stage=mark)
        torch.cuda.synchronize()
        prev, split = start, {}
        for name, ev in marks:
            split[name] = prev.elapsed_time(ev)
            prev = ev
        split["total"] = start.elapsed_time(prev)
        stages.append(split)
    print(f"split frcnn.forward (CUDA events between stage ends, median of "
          f"3 forwards): " + ", ".join(
              f"{k} {statistics.median(st[k] for st in stages):.2f} ms"
              for k in stages[0]), flush=True)
    roi = [st["roi_pool"] for st in stages]
    print(f"frcnn roi_pool stage ({cfg.post_nms_topk} rois, P "
          f"{cfg.pooler_resolution}): "
          f"{statistics.median(roi):.3f} ms ({min(roi):.3f}-{max(roi):.3f}), "
          f"CUDA events between the rpn+nms and roi_pool marks", flush=True)
    with torch.no_grad():
        profile("frcnn.forward FRCNN_VG 800x1216",
                lambda: frcnn.forward(params, pre[0], cfg), 1e3 / rate,
                show_other=6)
    return got["roi_pool_pallas"], outs


def _rate(call, size) -> float:
    """Items per second of ``call()``: the median of 3 timed trials, each
    between two ``torch.cuda.synchronize()``."""
    trials = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        trials.append(size / (time.perf_counter() - t0))
    return statistics.median(trials)


def lxmert_phase(lx, pert_runner, dets, card: str) -> None:
    """Full-width LXMERT_VQA ours_no_lrp on the card against the CPU, and
    its rates."""
    import numpy as np

    cfg = lx.LXMERT_VQA
    params = lx.init_params(0, cfg, "cuda")
    gen = torch.Generator().manual_seed(3)
    n, St = 8, 20
    lengths = torch.tensor([20, 14, 9, 17, 6, 20, 12, 8])
    ar = torch.arange(St)[None].expand(n, St)
    mask = (ar < lengths[:, None]).int()
    ids = torch.randint(1000, cfg.vocab_size, (n, St), generator=gen)
    ids[:, 0] = 101                                     # [CLS]
    ids[ar == (lengths - 1)[:, None]] = 102             # [SEP]
    det = [dets[b % len(dets)] for b in range(n)]
    batch = {
        "input_ids": ids * mask, "attention_mask": mask,
        "visual_feats": torch.stack([d["roi_features"] for d in det]).cpu(),
        "visual_pos": torch.stack([d["normalized_boxes"] for d in det]).cpu(),
        "visual_mask": torch.stack([d["valid"] for d in det]).int().cpu(),
    }
    batch["num_boxes"] = batch["visual_mask"].sum(1)
    runner = pert_runner.LxmertPerturbationRunner(params, cfg, "ours_no_lrp",
                                                  device="cuda")
    scores, cam_text, cam_image = runner.explain_batched(batch)
    ref = pert_runner.LxmertPerturbationRunner(params, cfg, "ours_no_lrp",
                                               device="cpu")
    r_scores, r_text, r_image = ref.explain_batched(batch)
    assert (scores.argmax(-1) == r_scores.argmax(-1)).all(), "answers differ"
    err = max(float(abs(cam_text - r_text).max()),
              float(abs(cam_image - r_image).max()))
    assert np.isfinite(cam_text).all() and np.isfinite(cam_image).all()
    print(f"path lxmert ours_no_lrp B={n} St={St} Sv=36: cam_text / "
          f"cam_image vs the CPU max|Δ| {err:.3e} (bar {MAP_BAR:g}; "
          f"max|cam| {float(abs(r_text).max()):.3e} / "
          f"{float(abs(r_image).max()):.3e}), qa_scores max|Δ| "
          f"{float(abs(scores - r_scores).max()):.3e}", flush=True)
    assert err < MAP_BAR, f"lxmert: cams differ from the CPU by {err}"
    del ref

    big = {k: torch.cat([v] * 4) for k, v in batch.items()}
    print(f"explanations/s LXMERT_VQA ours_no_lrp fp32: B={n} "
          f"{_rate(lambda: runner.explain_batched(batch), n):.1f}, B=32 "
          f"{_rate(lambda: runner.explain_batched(big), 32):.1f} (median "
          f"of 3) on {card}", flush=True)
    soft = torch.rand((n, cfg.num_qa_labels), generator=gen).numpy()
    for text in (False, True):
        pr = pert_runner.LxmertPerturbationRunner(
            params, cfg, "ours_no_lrp", text_pert=text, device="cuda")
        accs = pr.run_samples_batched(batch, soft)
        assert accs.shape == (n, len(pr.steps))
        print(f"perturbation samples/s LXMERT_VQA ours_no_lrp "
              f"{'text' if text else 'image'} (9 steps, B={n}): "
              f"{_rate(lambda: pr.run_samples_batched(batch, soft), n):.1f} "
              f"(median of 3) on {card}", flush=True)


def lxmert_cli_phase(cli, example, rpool) -> None:
    import numpy as np
    from PIL import Image

    rc = cli.main(["perturbation", "--model", "lxmert", "--device", "cuda",
                   "--num-samples", "8"])
    assert rc == 0
    work_dir = ROOT / "build" / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    arr = (np.random.RandomState(1).rand(240, 320, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(work_dir / "lxmert_input.png")
    prefix = work_dir / "lxmert"
    rpool.reset_launch_counts()
    rc = example.main([str(work_dir / "lxmert_input.png"),
                       "what is in the picture?", "--device", "cuda",
                       "--output-prefix", str(prefix)])
    torch.cuda.synchronize()
    assert rc == 0
    assert rpool.launch_counts() == {"roi_pool_pallas": 1}
    fig = np.asarray(Image.open(f"{prefix}_image.png"))
    assert fig.shape == (240, 320, 3), fig.shape
    assert "<span" in pathlib.Path(f"{prefix}_text.html").read_text()
    print("cli perturbation --model lxmert --device cuda: ok; example "
          "lxmert_explainability --device cuda: ok, roi_pool_pallas "
          "launches 1", flush=True)


def _feature_tsv(path: pathlib.Path, n_images: int, n_boxes: int) -> None:
    """A bottom-up-attention object TSV of ``n_images`` images with
    ``n_boxes`` 2048-d boxes each, from a seed."""
    import base64

    import numpy as np

    enc = lambda a: base64.b64encode(a.tobytes()).decode()
    rows = []
    for i in range(n_images):
        rng = np.random.RandomState(i)
        n = n_boxes
        rows.append("\t".join([
            f"img{i}", "480", "640", enc(np.arange(n, dtype=np.int64)),
            enc(rng.rand(n).astype(np.float32)),
            enc(np.arange(n, dtype=np.int64)),
            enc(rng.rand(n).astype(np.float32)), str(n),
            enc((rng.rand(n, 4) * 400).astype(np.float32)),
            enc(rng.rand(n, 2048).astype(np.float32))]))
    path.write_text("\n".join(rows) + "\n")


def _cli_json(cli, argv) -> dict:
    """``cli.main(argv)`` with its output captured; returns the JSON of its
    last line (printed too)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    lines = buf.getvalue().strip().splitlines()
    print(f"  {' '.join(argv[:3])} ...: rc {rc}; {lines[-1]}", flush=True)
    assert rc == 0, (argv, rc)
    return json.loads(lines[-1])


def visual_bert_phase(mods, vb, evb, pert_runner, card: str) -> None:
    """Full-width VISUAL_BERT_VQA2 (BERT-base, 2048-d boxes, 3129 answers;
    seeded random weights), B=8 questions of S_t=128 (8-20 real tokens) on
    N_v=100 boxes (10-100 real): ``relevancy_row`` against ``capture`` +
    ``generate_ours`` on the card and against the CPU, rates, a profile,
    and the perturbation CLI on synthetic samples and on data files. No
    kernel of the port lies on this path: every counter must read 0."""
    import numpy as np

    from transformer_mm_explainability_tpu_torch._device import params_to

    reset_counts(mods)
    cfg = vb.VISUAL_BERT_VQA2
    params = vb.init_params(0, cfg, "cuda")
    gen = torch.Generator().manual_seed(5)
    n, St, Nv = 8, 128, 100
    lengths = torch.tensor([20, 14, 9, 17, 8, 20, 12, 11])
    num_boxes = torch.tensor([100, 36, 10, 57, 80, 23, 64, 100])
    ar = torch.arange(St)[None].expand(n, St)
    mask = (ar < lengths[:, None]).int()
    ids = torch.randint(1000, cfg.bert.vocab_size, (n, St), generator=gen)
    ids[:, 0] = 101                                     # [CLS]
    ids[ar == (lengths - 2)[:, None]] = 1029            # ?
    ids[ar == (lengths - 1)[:, None]] = 102             # [SEP]
    batch = {
        "input_ids": ids * mask, "input_mask": mask,
        "visual_embeddings": torch.rand((n, Nv, 2048), generator=gen),
        "visual_mask": (torch.arange(Nv)[None] < num_boxes[:, None]).int(),
        "num_boxes": num_boxes,
    }
    dev = {k: v.cuda() for k, v in batch.items()}
    scores, row = vb.relevancy_row(params, dev, None, cfg)
    c_scores, attn, grads = vb.capture(params, dev, None, cfg)
    want = evb.generate_ours(attn, grads, vb.cls_index(dev["input_mask"]))
    del attn, grads
    err = float((row - want).abs().max())
    s_err = float((scores - c_scores).abs().max())
    print(f"path visual_bert relevancy_row B={n} S={St}+{Nv}: vs capture + "
          f"generate_ours on the card max|Δ| {err:.3e} (bar {MAP_BAR:g}; "
          f"max|row| {float(want.abs().max()):.3e}), scores max|Δ| "
          f"{s_err:.3e}", flush=True)
    assert torch.isfinite(row).all() and err < MAP_BAR, err
    assert torch.allclose(scores, c_scores, **SCORE_TOL)
    cpu = params_to(params, "cpu")
    two = {k: v[:2] for k, v in batch.items()}
    r_scores, r_row = vb.relevancy_row(cpu, two, None, cfg)
    del cpu
    err = float((row[:2].cpu() - r_row).abs().max())
    print(f"path visual_bert relevancy_row samples 0-1 vs the CPU max|Δ| "
          f"{err:.3e} (bar {MAP_BAR:g}), scores max|Δ| "
          f"{float((scores[:2].cpu() - r_scores).abs().max()):.3e}",
          flush=True)
    assert err < MAP_BAR, f"visual_bert: rows differ from the CPU by {err}"
    assert torch.allclose(scores[:2].cpu(), r_scores, **SCORE_TOL)

    runner = pert_runner.VisualBertPerturbationRunner(
        params, cfg, "ours_no_lrp", device="cuda")
    big = {k: torch.cat([v] * 4) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    runner.explain_batched(batch)
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    runner.explain_batched(big)
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    rate8 = _rate(lambda: runner.explain_batched(batch), n)
    rate32 = _rate(lambda: runner.explain_batched(big), 4 * n)
    print(f"explanations/s VISUAL_BERT_VQA2 ours_no_lrp (relevancy_row) "
          f"fp32: B={n} {rate8:.1f}, B={4 * n} {rate32:.1f} (median of 3); "
          f"peak device memory {peak8:.2f} / {peak32:.2f} GiB; on {card}",
          flush=True)
    profile(f"visual_bert explain B={n}",
            lambda: runner.explain_batched(batch), 1e3 * n / rate8,
            show_other=6)
    soft = torch.rand((n, cfg.num_labels), generator=gen).numpy()
    for text in (False, True):
        pr = pert_runner.VisualBertPerturbationRunner(
            params, cfg, "ours_no_lrp", text_pert=text, device="cuda")
        accs = pr.run_samples_batched(batch, soft)
        assert accs.shape == (n, len(pr.steps)) and np.isfinite(accs).all()
        rate = _rate(lambda: pr.run_samples_batched(batch, soft), n)
        kind = "text" if text else "image"
        print(f"perturbation samples/s VISUAL_BERT_VQA2 ours_no_lrp {kind} "
              f"(explain + 9 steps, N={n}): {rate:.1f} (median of 3) on "
              f"{card}", flush=True)
        if not text:
            profile(f"visual_bert image perturbation N={n}",
                    lambda: pr.run_samples_batched(batch, soft),
                    1e3 * n / rate, show_other=4)
    got = counts(mods)
    assert all(v == 0 for v in got.values()), f"visual_bert: launches {got}"
    print(f"path visual_bert launches: {got}", flush=True)


def visual_bert_cli_phase(mods, cli) -> None:
    """``cli perturbation --device cuda`` with the default model: synthetic
    samples, then the data-file path at full width (a 100-box TSV of two
    images, 8 questions, an answer vocabulary, a WordPiece vocabulary)."""
    reset_counts(mods)
    summary = _cli_json(cli, ["perturbation", "--device", "cuda",
                              "--num-samples", "8"])
    assert summary["num_samples"] == 4 and len(summary["steps"]) == 9
    work = ROOT / "build" / "smoke" / "vqa"
    work.mkdir(parents=True, exist_ok=True)
    _feature_tsv(work / "feats.tsv", 2, 100)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "on", "the",
             "table", "?", "how", "many", "cups", "are", "there", "color",
             "of", "cup", "a", "in", "picture"]
    (work / "vocab.txt").write_text("\n".join(words) + "\n")
    answers = ["yes", "no", "2", "red", "cup"]
    (work / "a2l.json").write_text(json.dumps(
        {a: i for i, a in enumerate(answers)}))
    (work / "l2a.json").write_text(json.dumps(answers))
    sents = ["what is on the table?", "how many cups are there?",
             "what color is the cup?", "is there a cup in the picture?"]
    (work / "q.json").write_text(json.dumps(
        [{"question_id": i, "img_id": f"img{i % 2}", "sent": sents[i % 4],
          "label": {answers[i % 5]: 1.0}} for i in range(8)]))
    summary = _cli_json(cli, [
        "perturbation", "--device", "cuda", "--num-samples", "8",
        "--questions", str(work / "q.json"), "--features",
        str(work / "feats.tsv"), "--ans2label", str(work / "a2l.json"),
        "--label2ans", str(work / "l2a.json"), "--bert-vocab",
        str(work / "vocab.txt")])
    torch.cuda.synchronize()
    assert summary["num_samples"] == 8
    assert len(summary["step_accuracies"]) == 9
    got = counts(mods)
    assert all(v == 0 for v in got.values()), got
    print(f"cli perturbation --device cuda (visual_bert): synthetic and "
          f"data files ok, nine step accuracies; launches {got}", flush=True)


def clip_phase(mods, clip, eclip, bpe, img_ops, card: str) -> None:
    """Full-width CLIP ViT-B/32 ``interpret`` on one generated image and 4
    texts against the CPU, its rate, and RN50's ``encode_image`` against
    the CPU; seeded random weights. No kernel of the port lies on this
    path: every counter must read 0."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch._device import params_to

    reset_counts(mods)
    cfg = clip.CLIP_VIT_B_32
    params = clip.init_params(0, cfg, "cuda")
    gen = torch.Generator().manual_seed(6)
    raw = torch.randint(0, 256, (300, 400, 3), generator=gen,
                        dtype=torch.uint8)
    image = img_ops.clip_preprocess(raw.cuda(), cfg.image_resolution)
    texts = ["a photo of a dog", "a photo of a cat", "a red car on a road",
             "two people playing chess in a park"]
    tokens = torch.as_tensor(bpe.tokenize(texts, cfg.context_length)).cuda()
    R_txt, R_img, logits = eclip.interpret(params, image, tokens, cfg)
    cpu = params_to(params, "cpu")
    c_txt, c_img, c_logits = eclip.interpret(cpu, image.cpu(), tokens.cpu(),
                                             cfg)
    err = max(float((R_txt.cpu() - c_txt).abs().max()),
              float((R_img.cpu() - c_img).abs().max()))
    print(f"path clip ViT-B/32 interpret 4 texts: R_txt / R_img vs the CPU "
          f"max|Δ| {err:.3e} (bar {MAP_BAR:g}; max|R_img| "
          f"{float(c_img.abs().max()):.3e}), logits max|Δ| "
          f"{float((logits.cpu() - c_logits).abs().max()):.3e}", flush=True)
    assert R_img.shape == (4, 49) and R_txt.shape == (4, 77, 77)
    assert torch.isfinite(R_img).all() and torch.isfinite(R_txt).all()
    assert err < MAP_BAR, f"clip: maps differ from the CPU by {err}"
    assert torch.allclose(logits.cpu(), c_logits, **SCORE_TOL)
    rate = _rate(lambda: eclip.interpret(params, image, tokens, cfg), 1)
    print(f"interpret calls/s CLIP ViT-B/32 (1 image, 4 texts) fp32: "
          f"{rate:.1f} (median of 3) on {card}", flush=True)
    profile("clip interpret ViT-B/32 4 texts",
            lambda: eclip.interpret(params, image, tokens, cfg), 1e3 / rate,
            show_other=4)
    del params, cpu

    rn = dataclasses.replace(cfg, embed_dim=1024, vision_layers=(3, 4, 6, 3),
                             vision_width=64)
    rparams = clip.init_params(1, rn, "cuda")
    images = torch.stack([image, image.flip(1)])
    with torch.no_grad():
        feats, _ = clip.encode_image(rparams, images, rn)
        c_feats, _ = clip.encode_image(params_to(rparams, "cpu"),
                                       images.cpu(), rn)
    scale = float(c_feats.abs().max())
    rel = float(((feats.cpu() - c_feats).abs()
                 / c_feats.abs().clamp(min=1e-30)).max())
    print(f"path clip RN50 encode_image 2 images: features [2, 1024] vs the "
          f"CPU max rel|Δ| {rel:.3e}, max|Δ| "
          f"{float((feats.cpu() - c_feats).abs().max()):.3e} (scale "
          f"{scale:.3e})", flush=True)
    assert feats.shape == (2, 1024) and torch.isfinite(feats).all()
    # the random tower's features span ~1e3; its entries near 0 take an
    # absolute floor of 1e-5 of that scale
    assert torch.allclose(feats.cpu(), c_feats, rtol=1e-4,
                          atol=1e-5 * scale), rel
    got = counts(mods)
    assert all(v == 0 for v in got.values()), f"clip: launches {got}"
    print(f"path clip launches: {got}", flush=True)


def clip_cli_phase(mods, cli) -> None:
    import numpy as np
    from PIL import Image

    reset_counts(mods)
    work = ROOT / "build" / "smoke"
    arr = (np.random.RandomState(2).rand(240, 320, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(work / "clip_input.png")
    prefix = work / "clip"
    out = _cli_json(cli, ["explain-clip", str(work / "clip_input.png"),
                          "a dog", "a cat", "a car", "--device", "cuda",
                          "--output-prefix", str(prefix)])
    torch.cuda.synchronize()
    assert len(out["probs"]) == 3
    for path in out["outputs"]:
        assert np.asarray(Image.open(path)).shape == (224, 224, 3)
    got = counts(mods)
    assert all(v == 0 for v in got.values()), got
    print(f"cli explain-clip --device cuda: ok, {len(out['outputs'])} PNGs; "
          f"launches {got}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from transformer_mm_explainability_tpu_torch import cli
    from transformer_mm_explainability_tpu_torch.data import bpe
    from transformer_mm_explainability_tpu_torch.examples import (
        lxmert_explainability as example)
    from transformer_mm_explainability_tpu_torch.explain import clip as eclip
    from transformer_mm_explainability_tpu_torch.explain import (
        visual_bert as evb)
    from transformer_mm_explainability_tpu_torch.harness import pert_runner
    from transformer_mm_explainability_tpu_torch.models import clip
    from transformer_mm_explainability_tpu_torch.models import frcnn
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.models import vit
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)
    from transformer_mm_explainability_tpu_torch.ops import image as img_ops
    from transformer_mm_explainability_tpu_torch.ops import _build
    from transformer_mm_explainability_tpu_torch.ops import attn_block as ab
    from transformer_mm_explainability_tpu_torch.ops import flash_attention as fa
    from transformer_mm_explainability_tpu_torch.ops import relevancy_pallas as rp
    from transformer_mm_explainability_tpu_torch.ops import roi_pool_pallas as rpool

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _build.build_all(LIBRARIES)
    print(f"build: {', '.join(f'csrc/{n}.cu' for n in LIBRARIES)} with nvcc "
          f"(sm_90a, in parallel) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for lib, path in built.items():
        for kernel, regs, st, ld in ptxas_report(
                path.with_suffix(".log").read_text()):
            print(f"  ptxas {lib}: {kernel}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
            assert not kernel.startswith(("gemm_tc_kernel", "attn_bwd_")) \
                or st + ld == 0, f"{kernel} spills"
    mods = (ab, fa, rp, rpool)
    for mod in mods:
        mod.library()

    phase_s = {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s", flush=True)
        return out

    gen = torch.Generator().manual_seed(0)
    timed_phase("gemm", gemm_phase, ab, torch.Generator().manual_seed(4))

    def kernel_rows():
        rows = block_kernel_phase(ab, gen)
        rows.update(flash_kernel_phase(fa, gen))
        return rows

    rows = timed_phase("kernels (block, flash)", kernel_rows)

    dev = torch.device("cuda")
    model = vit.init_params(0, vit.VIT_B_16, dev)
    images = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    targets = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    _, attn, grads = vit.capture(model, images, targets)
    # [L, B, H, S, S] → batch first, as views
    cams, grads = attn.movedim(1, 0), grads.movedim(1, 0)
    rows.update(timed_phase("kernels (chain)", chain_kernel_phase, rp))
    rows.update(timed_phase("kernels (roi_pool)", roi_kernel_phase, rpool,
                            gen))

    launches = timed_phase("vit paths", path_phase, mods, vit, rp, model,
                           images, targets, cams, grads, card)
    del attn, grads, cams, model
    timed_phase("cli explain-vit", cli_phase, ab, cli)
    torch.cuda.empty_cache()
    launches["roi_pool_pallas"], dets = timed_phase(
        "frcnn", frcnn_phase, mods, frcnn, rpool, card)
    torch.cuda.empty_cache()
    timed_phase("lxmert", lxmert_phase, lx, pert_runner, dets, card)
    timed_phase("lxmert cli + example", lxmert_cli_phase, cli, example,
                rpool)
    torch.cuda.empty_cache()
    timed_phase("visual_bert", visual_bert_phase, mods, vb, evb,
                pert_runner, card)
    timed_phase("visual_bert cli", visual_bert_cli_phase, mods, cli)
    torch.cuda.empty_cache()
    timed_phase("clip", clip_phase, mods, clip, eclip, bpe, img_ops, card)
    timed_phase("clip cli", clip_cli_phase, mods, cli)
    print(f"phases: {sum(phase_s.values()):.1f} s in all", flush=True)
    for name, n in launches.items():
        rows[name]["launches"] = n

    assert set(rows) == set(KERNELS) and all("launches" in r
                                             for r in rows.values())
    print(json.dumps({"kernels": [rows[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
