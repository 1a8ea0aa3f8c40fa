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
14. DETR path phase, full-width ``DETR_R50`` (ResNet-50, d_model 256, 8
   heads, 6 + 6 layers, FFN 2048, 100 queries, 91 + 1 classes; seeded
   random weights) on a generated 800×1066 image through
   ``detr_eval.prepare_image`` (→ 800×1088, S = 25×34 = 850): random
   weights keep no query above 0.5, so it explains the top queries by
   score. The K = 4 rows of ``ours_no_lrp``, ``attn_gradcam`` and
   ``rollout`` through ``explain/detr.generate`` on the card within 1e-4
   of the CPU's rows from its ``capture_multi`` (a family whose max|row|
   is under 1e-3, where that bar says nothing, is held on a float64
   capture made on both sides: the card's rows within 1e-4 · max|row| of
   the CPU's, with the fp32 distance printed); ``ablation_no_aggregation``,
   whose float64 rows lie below fp32's range (exactly 0 in fp32 on both
   sides), held on that capture with its gradients scaled by a power of
   two, the CPU's rows within 1e-4 of max|row| of float64 and the card's
   within 1e-4 of max|row| of the CPU's; logits and boxes within rtol
   1e-4 / atol 1e-5 of the CPU (the layers' biases drawn too: zero biases
   make the no-aggregation rows 0 at any scale); the card's
   ``capture_multi`` gradients equal to K ``capture`` calls of the image,
   one query each (within 1e-4 of each family's max|g|, the probabilities
   to the bit); K = 8
   rows in one pass equal to two passes of 4; the masks the card makes
   from the CPU's rows equal to the CPU's; finite rows, and exactly 0 in
   the columns of padded tokens when a pad mask covers the last two
   feature columns; a batching-rule fallback of ``is_grads_batched`` is an
   error; every kernel counter 0. Then ``explain_image`` images/s and
   explained queries/s at K = 8 and 32 (one pass each) and 64 (two passes
   of 32), medians of 3; at K = 32 a split by CUDA events between calls
   of the functions ``explain_image`` makes (detection forward,
   ``keep_detections``, ``capture_multi``, ``rows_from_capture``, the
   masks and their bits) and the host clock, with ``capture_multi``'s
   tapped forward timed alone, a profile with the device's idle share,
   and peak memory;
15. DETR cli phase: ``cli detr-eval --device cuda --shortest 800`` on a
   generated two-image mini-COCO under ``build/smoke/coco``, which must
   exit 0 and print the 12 COCO segm stats: with random weights, then
   with a release-format checkpoint of the seeded weights
   (``utils/convert.detr_to_state_dict``) whose class-1 bias is raised so
   that about 8 queries of the first image clear 0.5, for ``ours_no_lrp``
   and the three LRP methods, each of which must make masks;
16. the LRP phases, one per family, each after its family's phase (the
   relprop of ``models/{bert,lxmert,detr}_lrp``, plain PyTorch): LXMERT_VQA
   (B=8, St=20, on FRCNN detections made in the phase: RoIPool 1 launch
   per image, every other counter 0) with its four LRP methods,
   VISUAL_BERT_VQA2 (the batch of 10) with its three, through the runners;
   DETR_R50 (the image of 14) with its three through
   ``explain/detr.generate`` at K = 8. Each method's rows are held within
   ``LRP_BAR`` (1e-4) of max|row|, per row, of the same call run in
   float64 on the card, of each example run alone (B=1; K=1), and the
   card's of the CPU's at two layers of each stack (``LRP_BARS`` states
   each other bar and why); explanations/s at B=8, ``explain_image``
   images/s and queries/s at K = 8 and 32, peak memory, a split of the
   DETR call at K = 32 (the tapped forward, the batched relprop, the rows)
   and a profile. The cli phases also run an LRP method: ``cli
   perturbation`` (both models) and the LXMERT example.
17. parity phase: ``cli verify-parity --family all --device cuda`` (the
   port against the maps the original PyTorch reference computed, the
   five fixtures of ``data/assets/parity``: ViT-B/16, CLIP ViT-B/32,
   VisualBERT, LXMERT and the DETR-R50 transformer at full width) must
   exit 0, and every map must lie within the relative bar
   ``tools/verify_parity.REL_TOL`` (1e-3 of max|ref|; exactly 0 where the
   reference is 0) besides the tool's own rule, one line per map; then the
   ViT fixture through ``relevancy_fused_block2`` (kernels #1-4, with #7
   and #8 inside #1 and #4; 12 launches each) and, on its captured A and
   ∇A, through ``self_attention_relevancy_pallas`` (kernel #9, 1 launch),
   both maps within both bars of the reference's;
18. semantic phase: ``tools/semantic_validation.run_family`` for
   VisualBERT and LXMERT at the tool's defaults (trained from the JAX
   tool's initial weights on the causal task, 256 samples, six methods
   and the random control); the hard checks must hold and the held-out
   accuracy reach 0.9; the training steps and seconds, the sweep seconds
   and every check's AUCs are printed beside ``SEMANTIC_r05.json`` (the
   JAX tool on a CPU), the record written to
   ``build/smoke/semantic_torch.json``;
19. entry-points phase: the port's four new examples (ViT, CLIP and DETR
   explainability, LXMERT perturbation) in their checkpoint-free mode and
   ``tools/extract_features`` on two generated images (FRCNN_VG, 800 px)
   with ``--device cuda``: each exits 0 and writes its files, the ViT
   example launches the four block kernels 12 times each,
   ``extract_features`` RoIPool once per image (its TSV read back), the
   others no kernel.
20. the training phases (after the sp and sharded-example phases, every
   kernel counter at 0 before them and 0 after: training runs the plain
   forwards): ``cli lxmert-finetune --device cuda`` on generated files at
   full width (LXMERT_VQA 9/5/5, 3129 answers, B = 32, St = 20, Sv = 36,
   BertAdam; 2 epochs of 4 batches, validated), with updates/s (median
   of the steady updates), peak memory and a profile of one update, and
   the same 3 updates at B = 4 on the card and the CPU (losses and
   parameters within ``TRAIN_BAR``); DETR_R50 ``train_batch`` at B = 2,
   800×1066, 5 targets an image (finite losses with the JAX step's keys,
   valid assignments, updates/s, peak memory, a profile) and a reduced
   DETR on the card and the CPU (the same assignments, losses within rtol
   1e-4); the ViT-B/16 train step at B = 32 (images/s, peak memory, a
   profile), the dp×tp step on one NCCL rank bit-equal to it and on two
   gloo ranks on cuda:0 (tp = 2) within the JAX test's bars.
21. the mmf phases (the MMF core and data; every kernel counter at 0 before
   them and 0 after), on files written to ``build/smoke/mmf`` from a seed
   (a 30,522-entry BERT vocabulary, a VQA2 imdb of 256 questions, 64
   100×2048 feature ``.npy`` files, 3,129 answers): ``cli predict --device
   cuda`` at full width (VISUAL_BERT_VQA2, B = 32, St = 128, Nv = 100)
   through the ``vqa2`` builder, ``bert_tokenizer``, ``collate``,
   ``prediction.argmax`` and ``TestReporter`` (256 rows with the imdb's
   question ids), predictions/s (median of 3, host included), peak memory,
   the host's share of a batch and a profile, the first 8 scores within
   ``SCORE_TOL`` of the CPU and the report's answers equal to the CPU's
   argmax where its top-two gap exceeds 1e-4; every registered loss on
   cuda within ``LOSS_REL`` of the CPU (B = 32 × 3,129; captions at
   [32, 20, 30,522]) and the tensor metrics equal to the CPU's, on cuda;
   VisualBERT pretraining on a collated ``masked_vqa2`` batch (B = 4),
   three AdamW updates at 12 layers on the card and at 2 layers card
   against CPU (``PRETRAIN_REL``), ``forward_nlvr2`` and
   ``forward_bypass`` at 12 layers against the CPU at ``SCORE_TOL``; two
   updates of ``train/lxmert_pretrain_loop`` over ``LXMERTPretrainData``
   and ``AnswerTable`` at 9/5/5 layers on the card and at 2/2/2 layers
   card against CPU.

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

# the port's one timing definition: mean device ms of back-to-back calls by
# CUDA events, and items/s as the median of 3 synchronised trials
from transformer_mm_explainability_tpu_torch.utils.profiling import (
    cuda_ms, rate as _rate)

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
    # a user annotation (``Optimizer.step#...``) spans kernels counted on
    # their own: leave it out
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    for ev in kernels:
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
                  r"(?i)conv|fprop|implicit|winograd|cudnn|wgrad|dgrad"),
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
    # a user annotation (``Optimizer.step#...``) spans kernels counted on
    # their own: leave it out
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not ev.is_user_annotation]
    for ev in kernels:
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        name = next((g for g, pat in KERNEL_GROUPS if re.search(pat, ev.key)),
                    "other (torch)")
        groups[name] += us / 1e3
        if name == "other (torch)":
            other.append((us / 1e3, ev.count, ev.key))
    busy = sum(groups.values())
    launches = sum(ev.count for ev in kernels)
    if busy == 0.0:
        print("profile: device time not measured (the profiler recorded no "
              "CUDA kernels)", flush=True)
        return
    print(f"profile {label}: device busy "
          f"{busy:.2f} ms of {call_ms:.2f} ms per call in {launches} kernel "
          f"launches (idle share {max(0.0, 1 - busy / call_ms):.3f})",
          flush=True)
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
    RoIPool launches of the path's run, the two detections, and a function
    that detects on the two images again (one RoIPool launch each)."""
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

    def detect():
        with torch.no_grad():
            return [frcnn.forward(params, p, cfg) for p in pre]

    return got["roi_pool_pallas"], outs, detect


def _lx_batch(cfg, dets, gen: torch.Generator) -> dict:
    """B=8 questions of St=20 (true lengths 6-20) on the FRCNN
    detections ``dets`` (36 boxes each, alternating images), on the
    host."""
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
    return batch


def lxmert_phase(lx, pert_runner, dets, card: str) -> None:
    """Full-width LXMERT_VQA ours_no_lrp on the card against the CPU, and
    its rates."""
    import numpy as np

    cfg = lx.LXMERT_VQA
    params = lx.init_params(0, cfg, "cuda")
    gen = torch.Generator().manual_seed(3)
    batch = _lx_batch(cfg, dets, gen)
    n, St = batch["input_ids"].shape
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

    for method in ("ours_no_lrp", "ours_with_lrp"):
        rc = cli.main(["perturbation", "--model", "lxmert", "--device",
                       "cuda", "--num-samples", "8", "--method", method])
        assert rc == 0, method
    work_dir = ROOT / "build" / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    arr = (np.random.RandomState(1).rand(240, 320, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(work_dir / "lxmert_input.png")
    prefix = work_dir / "lxmert"
    for method in ("ours_no_lrp", "ours_with_lrp"):
        rpool.reset_launch_counts()
        rc = example.main([str(work_dir / "lxmert_input.png"),
                           "what is in the picture?", "--device", "cuda",
                           "--output-prefix", str(prefix), "--method",
                           method])
        torch.cuda.synchronize()
        assert rc == 0
        assert rpool.launch_counts() == {"roi_pool_pallas": 1}
        fig = np.asarray(Image.open(f"{prefix}_image.png"))
        assert fig.shape == (240, 320, 3), fig.shape
        assert "<span" in pathlib.Path(f"{prefix}_text.html").read_text()
    print("cli perturbation --model lxmert --device cuda (ours_no_lrp, "
          "ours_with_lrp): ok; example lxmert_explainability --device cuda "
          "(the same two methods): ok, roi_pool_pallas launches 1 each",
          flush=True)


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


def _vb_batch(cfg, gen: torch.Generator) -> dict:
    """B=8 VQA questions of S_t=128 (8-20 real tokens, the ``?`` at
    ``len - 2``) on N_v=100 2048-d boxes (10-100 real), on the host."""
    n, St, Nv = 8, 128, 100
    lengths = torch.tensor([20, 14, 9, 17, 8, 20, 12, 11])
    num_boxes = torch.tensor([100, 36, 10, 57, 80, 23, 64, 100])
    ar = torch.arange(St)[None].expand(n, St)
    mask = (ar < lengths[:, None]).int()
    ids = torch.randint(1000, cfg.bert.vocab_size, (n, St), generator=gen)
    ids[:, 0] = 101                                     # [CLS]
    ids[ar == (lengths - 2)[:, None]] = 1029            # ?
    ids[ar == (lengths - 1)[:, None]] = 102             # [SEP]
    return {
        "input_ids": ids * mask, "input_mask": mask,
        "visual_embeddings": torch.rand((n, Nv, 2048), generator=gen),
        "visual_mask": (torch.arange(Nv)[None] < num_boxes[:, None]).int(),
        "num_boxes": num_boxes,
    }


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
    batch = _vb_batch(cfg, gen)
    n, St = batch["input_ids"].shape
    Nv = batch["visual_mask"].shape[1]
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
    for method in ("ours_no_lrp", "transformer_attribution"):
        summary = _cli_json(cli, ["perturbation", "--device", "cuda",
                                  "--num-samples", "8", "--method", method])
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


def _held(name: str, got: torch.Tensor, want: torch.Tensor,
          rows64) -> None:
    """DETR rows on the card against the CPU's, both through
    ``explain/detr.generate``. A family whose rows reach 10 · MAP_BAR is
    held within MAP_BAR in fp32. Below that the absolute bar says nothing,
    and fp32 rounding is not small against max|row| (GradCAM's head
    weights are means over Q·S = 85,000 gradients of both signs, which
    cancel), so the family is held twice: in fp32 within 1e-3 · max|row|
    (a wrong row is off by the order of max|row|), and through ``generate``
    on float64 weights and image (``rows64(device)``), the card's rows
    within 1e-4 · max|row| of the CPU's."""
    got = got.cpu()
    err = float((got - want).abs().max())
    top = float(want.abs().max())
    assert torch.isfinite(got).all(), f"detr {name}: non-finite rows"
    if top >= 10 * MAP_BAR:
        print(f"path detr {name} K=4: vs the CPU max|Δ| {err:.3e} (bar "
              f"{MAP_BAR:g}; max|row| {top:.3e})", flush=True)
        assert err <= MAP_BAR, f"detr {name}: rows differ from the CPU by {err}"
        return
    t0 = time.perf_counter()
    want64, got64 = rows64("cpu"), rows64("cuda").cpu()
    err64 = float((got64 - want64).abs().max())
    top64 = float(want64.abs().max())
    print(f"path detr {name} K=4: max|row| {top:.3e} < 10 · {MAP_BAR:g}: "
          f"fp32 card vs CPU max|Δ| {err:.3e} = {err / top:.3e} of max|row| "
          f"(bar 1e-3); generate in float64 on the CPU and the card "
          f"({time.perf_counter() - t0:.1f} s): card vs CPU max|Δ| "
          f"{err64:.3e} (bar 1e-4 · max|row| = {1e-4 * top64:.3e}; max|row| "
          f"{top64:.3e})", flush=True)
    assert err <= 1e-3 * top, (
        f"detr {name}: fp32 rows differ from the CPU by {err}")
    assert top64 > 0.0 and torch.isfinite(got64).all(), name
    assert err64 <= 1e-4 * top64, (
        f"detr {name}: float64 rows differ from the CPU by {err64}")


def _random_biases(tree, gen: torch.Generator) -> None:
    """Draw every bias of a DETR layer tree (attention, FFN, LayerNorm)
    from 0.1·N(0, 1), in place. ``init_params`` zeroes them, as the JAX
    package does; then the first decoder layer's values are 0 (tgt starts
    at 0), its Ê is 0 and every no-aggregation row is exactly 0 at any
    scale. With the biases drawn those rows are not 0, but at full width
    they still lie below fp32's range (see ``_no_aggregation``)."""
    items = tree._asdict().items() if hasattr(tree, "_fields") \
        else tree.items()
    for name, leaf in items:
        if isinstance(leaf, dict) or hasattr(leaf, "_fields"):
            _random_biases(leaf, gen)
        elif name.startswith("b"):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=gen).to(
                leaf.device))


def _no_aggregation(detr, edetr, cfg, attn, grads, tq, tv, got, want,
                    rows64):
    """The ``ablation_no_aggregation`` family on the card. Its rows are a
    product of every layer's Ê with no identity (6 encoder, 6 decoder
    self-attention and the last cross-attention: 13 factors of
    ~1e-4-1e-2 row sums), whose float64 value on the CPU's capture lies
    below fp32's least subnormal 2^-149: the fp32 rows are exactly 0 on
    both sides and say nothing. So the family is held on the CPU's capture
    with every gradient scaled by 2^p, which scales each Ê by 2^p and the
    rows by 2^(13p) exactly (powers of two, all terms ≥ 0): the CPU's fp32
    rows there within 1e-4 · max of the float64 rows times 2^(13p), and
    the card's within 1e-4 · max of the CPU's. ``got``: the card's rows of
    the family through ``generate``; ``want``: the CPU's; ``rows64``: as
    ``_held``'s."""
    import math

    n = cfg.num_encoder_layers + cfg.num_decoder_layers + 1
    wide = lambda taps: detr.DETRTaps(*(x.double() for x in taps))
    f64 = edetr.rows_from_capture("ablation_no_aggregation", wide(attn),
                                  wide(grads), tq, tv)
    m64 = float(f64.abs().max())
    assert m64 > 0.0, "detr no-aggregation: float64 rows are 0"
    if m64 < 2.0 ** -149:
        assert float(got.abs().max()) == 0.0 == float(want.abs().max())
        print(f"path detr ablation_no_aggregation K=4: not held at its own "
              f"scale: float64 max|row| {m64:.3e} < 2^-149, so the fp32 "
              f"rows are 0 on the card and the CPU", flush=True)
    else:
        _held("ablation_no_aggregation", got, want, rows64)
    p = math.floor(-math.log2(m64) / n)
    scaled = detr.DETRTaps(*(g * 2.0 ** p for g in grads))
    ref = edetr.rows_from_capture("ablation_no_aggregation", attn, scaled,
                                  tq, tv)
    top = float(ref.abs().max())
    err64 = float((ref.double() - f64 * 2.0 ** (n * p)).abs().max())
    on_card = edetr.rows_from_capture(
        "ablation_no_aggregation", detr.DETRTaps(*(x.cuda() for x in attn)),
        detr.DETRTaps(*(x.cuda() for x in scaled)), tq.cuda(),
        None if tv is None else tv.cuda()).cpu()
    err = float((on_card - ref).abs().max())
    print(f"path detr ablation_no_aggregation K=4, gradients × 2^{p} (rows "
          f"× 2^{n * p}): CPU fp32 vs float64 max|Δ| {err64:.3e}, card vs "
          f"CPU max|Δ| {err:.3e} (bar 1e-4 · max|row| = {1e-4 * top:.3e}; "
          f"max|row| {top:.3e})", flush=True)
    assert top > 0.0 and torch.isfinite(on_card).all()
    assert err64 <= 1e-4 * top, "detr no-aggregation: fp32 vs float64"
    assert err <= 1e-4 * top, "detr no-aggregation: card vs CPU"


def detr_phase(mods, detr, edetr, dsegm, deval, card: str) -> None:
    """Full-width DETR_R50 explanation segmentation on one generated
    800×1066 image (S = 850): gates against the CPU and against the
    replicated capture, rates at K = 8, 32 and 64, a stage split, a
    profile and peak memory at K = 32. No kernel of the port lies on this
    path: every counter must read 0."""
    import dataclasses
    import warnings

    import numpy as np

    from transformer_mm_explainability_tpu_torch._device import params_to

    warnings.filterwarnings("error", message=".*batching rule.*")
    reset_counts(mods)
    cfg, params, image, valid, q, c = _detr_setup(detr, deval, dsegm)
    S = 25 * 34
    with torch.no_grad():
        out = detr.forward(params, image[None], valid[None], cfg)
    tq, tc = q[:4], c[:4]

    # the CPU: one capture of the K = 4 targets, every family from it
    cpu = params_to(params, "cpu")
    t0 = time.perf_counter()
    c_tq = torch.as_tensor(tq, dtype=torch.long)
    c_out, c_attn, c_grads = detr.capture_multi(
        cpu, image.cpu(), edetr._one_hots(c_tq, torch.as_tensor(
            tc, dtype=torch.long), cfg), valid.cpu(), cfg)
    c_tv = edetr._token_valid(image.cpu(), valid.cpu(), cfg)
    c_rows = {m: edetr.rows_from_capture(m, c_attn, c_grads, c_tq, c_tv)
              for m in ("ours_no_lrp", "ablation_no_aggregation",
                        "attn_gradcam", "rollout")}
    print(f"path detr DETR_R50 800x1088 (S={S}) CPU capture K=4 and rows: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # float64 weights and image, on the CPU and on the card, for the
    # families whose rows are too small for the absolute bar (_held)
    wide = {dev: (params_to(params_to(params, dev), torch.float64),
                  image.to(dev, torch.float64), valid.to(dev))
            for dev in ("cpu", "cuda")}
    del cpu
    for name, want in (("pred_logits", c_out["pred_logits"]),
                       ("pred_boxes", c_out["pred_boxes"])):
        err = float((out[name].cpu() - want).abs().max())
        print(f"path detr {name}: vs the CPU max|Δ| {err:.3e} (rtol 1e-4, "
              f"atol 1e-5)", flush=True)
        assert torch.allclose(out[name].cpu(), want, **SCORE_TOL), name
    for m, want in c_rows.items():
        got = edetr.generate(m, params, image, tq, tc, cfg, valid)

        def rows64(dev, m=m):
            p64, i64, v64 = wide[dev]
            return edetr.generate(m, p64, i64, tq, tc, cfg, v64)

        if m == "ablation_no_aggregation":
            _no_aggregation(detr, edetr, cfg, c_attn, c_grads, c_tq, c_tv,
                            got, want, rows64)
        else:
            _held(m, got, want, rows64)
    del c_attn, c_grads, wide

    # capture_multi: one forward + one batched backward == K forwards, one
    # per query. Each at B=1: a batch of 4 copies takes other cuDNN
    # algorithms, and the encoder's gradients (small fp32 sums that
    # cancel) then move by up to 8e-3 of max|g|, as far as the CPU's are
    # from the card's; at B=1 the forwards are the same bits and only the
    # batching of the backward differs
    oh = edetr._one_hots(torch.as_tensor(tq, device="cuda").long(),
                         torch.as_tensor(tc, device="cuda").long(), cfg)
    _, attn, grads = detr.capture_multi(params, image, oh, valid, cfg)
    rel = dict.fromkeys(detr.DETRTaps._fields, 0.0)
    for k in range(4):
        _, r_attn, r_grads = detr.capture(params, image[None], oh[k:k + 1],
                                          valid[None], cfg)
        for fam in rel:
            g, r = getattr(grads, fam)[:, k], getattr(r_grads, fam)[:, 0]
            rel[fam] = max(rel[fam], float((g - r).abs().max()
                                           / r.abs().max()))
            assert torch.equal(getattr(attn, fam)[:, k],
                               getattr(r_attn, fam)[:, 0]), fam
    print(f"path detr capture_multi K=4 vs 4 captures of one query each: "
          f"probabilities equal, grads max|Δ| / max|g| {rel} (bar 1e-4)",
          flush=True)
    assert all(v <= 1e-4 for v in rel.values()), rel
    del attn, grads, r_attn, r_grads

    # chunking is batching: 8 rows in one pass == two passes of 4
    one = edetr.generate("ours_no_lrp", params, image, q[:8], c[:8], cfg,
                         valid)
    two = torch.cat([edetr.generate("ours_no_lrp", params, image, q[i:i + 4],
                                    c[i:i + 4], cfg, valid)
                     for i in (0, 4)])
    err = float((one - two).abs().max())
    print(f"path detr K=8 one pass vs two passes of 4: max|Δ| {err:.3e} "
          f"(bar {MAP_BAR:g}; max|row| {float(one.abs().max()):.3e})",
          flush=True)
    assert err < MAP_BAR and torch.isfinite(one).all()

    # masks of the same rows: the card's Otsu + upsample == the CPU's
    rows = c_rows["ours_no_lrp"]
    m_cpu = dsegm.masks_from_relevancy(rows, (25, 34), (800, 1088))
    m_gpu = dsegm.masks_from_relevancy(rows.cuda(), (25, 34), (800, 1088))
    assert torch.equal(m_gpu.cpu(), m_cpu), "detr: masks differ"
    print(f"path detr masks of the CPU's rows on the card: equal, "
          f"{int(m_cpu.sum())} of {m_cpu.numel()} pixels set", flush=True)

    # padded tokens: a pad mask over the last two feature columns
    cut = valid.clone()
    cut[:, 1000:] = 0
    padded = edetr.generate("ours_no_lrp", params, image, tq, tc, cfg, cut)
    cols = padded.reshape(4, 25, 34)[:, :, 32:]
    assert torch.isfinite(padded).all() and float(cols.abs().max()) == 0.0
    print(f"path detr padded tokens (feature columns 32-33): rows finite, "
          f"their columns 0; max|row| {float(padded.abs().max()):.3e}",
          flush=True)

    rates = {}
    for K in (8, 32, 64):
        scfg = dsegm.SegmConfig(confidence_threshold=0.0, max_detections=K)
        call = lambda: dsegm.explain_image(params, image, cfg, scfg,
                                           pad_valid=valid, pack_masks=True)
        res = call()
        assert res["masks_packed"].shape == (K, 800, 136), K
        if K == 32:
            torch.cuda.reset_peak_memory_stats()
            call()
            peak = torch.cuda.max_memory_allocated() / 2**30
        rates[K] = _rate(call, 1)
        print(f"explain_image DETR_R50 800x1088 K={K} "
              f"({-(-K // 32)} pass{'es' if K > 32 else ''}): "
              f"{rates[K]:.2f} images/s, {K * rates[K]:.1f} queries/s "
              f"(median of 3) on {card}", flush=True)
    print(f"peak device memory DETR_R50 explain_image K=32: {peak:.2f} GiB",
          flush=True)

    # the K = 32 stage split: CUDA events between calls of the functions
    # explain_image makes, in its order, and the host clock around all;
    # what the events do not cover is host time (medians of 3). The
    # tapped forward alone (detr.forward with detr.zero_taps, as
    # capture_multi calls it) is timed apart: capture_multi less it is
    # the batched backward
    scfg = dsegm.SegmConfig(confidence_threshold=0.0, max_detections=32)
    names = ("detection forward", "logits to the host, keep_detections",
             "capture_multi", "chain (rows_from_capture)",
             "masks, bits to the host")
    stages = {k: [] for k in names + ("host, the rest",
                                      "capture_multi's tapped forward")}
    tv = edetr._token_valid(image, valid, cfg)
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        with torch.no_grad():
            o = detr.forward(params, image[None], valid[None], cfg)
        ev[1].record()
        qk, ck, _ = dsegm.keep_detections(o["pred_logits"][0].cpu().numpy(),
                                          0.0, 32)
        tq32 = torch.as_tensor(qk, device="cuda").long()
        oh = edetr._one_hots(tq32, torch.as_tensor(ck, device="cuda").long(),
                             cfg)
        ev[2].record()
        _, a, g = detr.capture_multi(params, image, oh, valid, cfg)
        ev[3].record()
        r = edetr.rows_from_capture("ours_no_lrp", a, g, tq32, tv)
        del a, g
        ev[4].record()
        dsegm.pack_mask_bits(dsegm.masks_from_relevancy(
            r, (25, 34), (800, 1088))).cpu()
        ev[5].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        for i, k in enumerate(names):
            stages[k].append(ev[i].elapsed_time(ev[i + 1]))
        stages["host, the rest"].append(wall - ev[0].elapsed_time(ev[5]))
        ev[6].record()
        with torch.enable_grad():
            detr.forward(params, image[None], valid[None], cfg,
                         detr.zero_taps(cfg, 1, S, device="cuda",
                                        requires_grad=True))
        ev[7].record()
        torch.cuda.synchronize()
        stages["capture_multi's tapped forward"].append(
            ev[6].elapsed_time(ev[7]))
    med = {k: statistics.median(v) for k, v in stages.items()}
    fwd = med.pop("capture_multi's tapped forward")
    call_ms = 1e3 / rates[32]
    print(f"detr stage split K=32 (CUDA events, medians of 3; "
          f"{sum(med.values()):.1f} ms in all; one explain_image call "
          f"{call_ms:.1f} ms): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in med.items())
          + f"; of capture_multi, the tapped forward alone {fwd:.2f} ms, "
          f"so the batched backward {med['capture_multi'] - fwd:.2f} ms",
          flush=True)
    profile("detr explain_image DETR_R50 K=32",
            lambda: dsegm.explain_image(params, image, cfg, scfg,
                                        pad_valid=valid, pack_masks=True),
            call_ms, show_other=6)
    got = counts(mods)
    assert all(v == 0 for v in got.values()), f"detr: launches {got}"
    print(f"path detr launches: {got}", flush=True)


def _detr_checkpoint(detr, deval, dsegm, path: pathlib.Path, raw,
                     n_kept: int = 8, shortest: int = 800,
                     longest: int = 1333) -> float:
    """A release-format DETR_R50 checkpoint (``utils/convert.
    detr_to_state_dict``) of ``_detr_setup``'s seeded weights whose
    class-1 bias is raised midway between the raises that let ``n_kept``
    and ``n_kept + 1`` queries of ``raw`` (an RGB image prepared at
    ``shortest`` / ``longest`` as the caller's entry point prepares it)
    clear the 0.5 threshold; returns the raise. The random model's queries
    have near-equal logits, so the entry point's own forward may keep a
    few more or fewer."""
    from transformer_mm_explainability_tpu_torch.utils import convert

    cfg, params, *_ = _detr_setup(detr, deval, dsegm)
    image, valid = deval.prepare_image(raw, shortest, longest,
                                       device="cuda")
    with torch.no_grad():
        z = detr.forward(params, image[None], valid[None],
                         cfg)["pred_logits"][0].double()
    # class 1 clears 0.5 once its logit + δ exceeds logsumexp of the others
    others = torch.cat([z[:, :1], z[:, 2:]], dim=1).logsumexp(-1)
    need = (others - z[:, 1]).sort().values
    delta = float(need[n_kept - 1] + need[n_kept]) / 2
    sd = convert.detr_to_state_dict(params)
    sd["class_embed.bias"][1] += delta
    torch.save({"model": sd}, path)
    return delta


def detr_cli_phase(mods, cli, detr, deval, dsegm) -> None:
    """``cli detr-eval --device cuda --shortest 800`` on a generated
    two-image mini-COCO (480×640 images, one polygon each): with random
    weights (no query kept), then with a checkpoint whose raised class
    bias keeps queries of the first image, for ``ours_no_lrp`` and the
    three LRP methods. With the checkpoint every call must make masks."""
    import numpy as np
    from PIL import Image

    reset_counts(mods)
    work = ROOT / "build" / "smoke" / "coco"
    work.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(3)
    images, anns, raws = [], [], []
    for i in range(2):
        arr = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(work / f"img{i}.jpg")
        raws.append(np.asarray(Image.open(work / f"img{i}.jpg")))
        images.append({"id": i, "height": 480, "width": 640,
                       "file_name": f"img{i}.jpg"})
        anns.append({"id": 10 + i, "image_id": i, "category_id": 1 + i,
                     "iscrowd": 0, "bbox": [100, 80, 200, 150],
                     "segmentation": [[100, 80, 300, 80, 300, 230, 100,
                                       230]]})
    (work / "instances.json").write_text(json.dumps(
        {"images": images, "annotations": anns,
         "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    argv = ["detr-eval", "--device", "cuda", "--shortest", "800",
            "--coco-path", str(work), "--annotations",
            str(work / "instances.json")]
    stats = _cli_json(cli, argv)
    torch.cuda.synchronize()
    assert len(stats) == 12 and all(-1.0 <= v <= 1.0 for v in stats.values())

    ckpt = work / "detr_raised.pth"
    delta = _detr_checkpoint(detr, deval, dsegm, ckpt, raws[0])
    made = []
    explain_image = dsegm.explain_image

    def counted(*args, **kw):
        out = explain_image(*args, **kw)
        made.append((out["masks_packed"].shape[0],
                     int(np.unpackbits(out["masks_packed"]).sum())))
        return out

    dsegm.explain_image = counted
    try:
        for method in ("ours_no_lrp",) + DETR_LRP:
            made.clear()
            stats = _cli_json(cli, argv + ["--checkpoint", str(ckpt),
                                           "--method", method])
            torch.cuda.synchronize()
            assert len(stats) == 12
            print(f"  detr-eval --method {method} --checkpoint (class-1 "
                  f"bias + {delta:.3f}): masks (kept queries, pixels set) "
                  f"per image {made}", flush=True)
            assert len(made) == 2 and made[0][0] > 0, made
            assert all(px > 0 for k, px in made if k), made
    finally:
        dsegm.explain_image = explain_image
    got = counts(mods)
    assert all(v == 0 for v in got.values()), got
    print(f"cli detr-eval --device cuda: ok, 12 stats; with the checkpoint "
          f"every method made masks; launches {got}", flush=True)


# ---------------------------------------------------------------------------
# the LRP methods (relprop: models/{bert,lxmert,detr}_lrp, ops/lrp): plain
# PyTorch, no kernel of the port; every counter but RoIPool's reads 0
# ---------------------------------------------------------------------------

VB_LRP = ("transformer_attribution", "partial_lrp", "ours_with_lrp")
LX_LRP = ("ours_with_lrp", "ours_with_lrp_no_normalization",
          "transformer_att", "partial_lrp")
DETR_LRP = ("ours_with_lrp", "transformer_att", "partial_lrp")
# Each LRP method's rows are held, per row (max|Δ_row| / max|row| of the
# reference), against: the same call in float64 on the card; each example
# alone (B=1; DETR: each query alone, K=1), in float64; and the CPU at two
# layers of each stack, in float64 and in fp32. LRP_BAR holds where fp32
# rounding allows it; LRP_BARS states each other bar and why.
LRP_BAR = 1e-4
_DEPTH = ("fp32 LRP cams sit 1e-2 to 4e-1 of their max from float64 at full "
          "width, more in the layers walked back last (the rules divide by "
          "near-cancelling sums: q·kᵀ of small random weights, residual "
          "adds), and these rows read every layer's cam")
_NORM = ("its normalised chain divides by row sums of R − I, which cancel "
         "in fp32 for LRP Ê of 1e-6")
LRP_BARS = {  # (family, method, check): (bar, why)
    ("visual_bert", "transformer_attribution", "fp32 vs float64"):
        (0.5, _DEPTH),
    ("visual_bert", "ours_with_lrp", "fp32 vs float64"): (0.5, _DEPTH),
    ("visual_bert", "partial_lrp", "fp32 vs float64"):
        (1e-2, "the last layer's cam after the head's α-β"),
    ("visual_bert", "transformer_attribution", "fp32 card vs CPU"):
        (0.1, _DEPTH),
    ("visual_bert", "ours_with_lrp", "fp32 card vs CPU"): (0.1, _DEPTH),
    ("visual_bert", "partial_lrp", "fp32 card vs CPU"):
        (1e-2, "the last layer's cam after the head's α-β"),
    ("lxmert", "ours_with_lrp", "fp32 vs float64"): (0.5, _DEPTH),
    ("lxmert", "ours_with_lrp_no_normalization", "fp32 vs float64"):
        (0.5, _DEPTH),
    ("lxmert", "transformer_att", "fp32 vs float64"): (0.5, _DEPTH),
    ("lxmert", "partial_lrp", "fp32 vs float64"):
        (1e-2, "the last x-layer's cams after the head's α-β"),
    ("lxmert", "ours_with_lrp", "fp32 card vs CPU"): (1e-2, _DEPTH),
    ("lxmert", "ours_with_lrp_no_normalization", "fp32 card vs CPU"):
        (1e-3, _DEPTH),
    ("lxmert", "transformer_att", "fp32 card vs CPU"): (1e-3, _DEPTH),
    ("detr", "ours_with_lrp", "fp32 vs float64"): (0.5, _NORM),
    ("detr", "ours_with_lrp", "fp32 card vs CPU"): (0.5, _NORM),
    ("detr", "ours_with_lrp", "float64 card vs CPU"):
        (1e-2, _NORM + ", and at 2 + 2 layers in float64 too"),
}


def _row_dist(got, want) -> float:
    """max over the rows b of max|got_b − want_b| / max|want_b|."""
    import numpy as np

    host = lambda x: np.asarray(x.cpu() if torch.is_tensor(x) else x,
                                np.float64)
    g, w = host(got), host(want)
    g, w = g.reshape(len(g), -1), w.reshape(len(w), -1)
    top = np.abs(w).max(axis=1)
    assert np.isfinite(g).all() and np.isfinite(w).all(), "non-finite rows"
    assert (top > 0).all(), "a row of the reference is 0"
    return float((np.abs(g - w).max(axis=1) / top).max())


def _gate(family: str, method: str, check: str, dist: float) -> None:
    bar, why = LRP_BARS.get((family, method, check), (LRP_BAR, ""))
    print(f"  {family} {method}: rows {check} max|Δ_row|/max|row| "
          f"{dist:.3e} (bar {bar:g}{': ' + why if why else ''})",
          flush=True)
    assert dist <= bar, f"{family} {method} {check}: {dist} > {bar}"


def _cast(batch: dict, dtype: torch.dtype) -> dict:
    """``batch`` with its floating leaves in ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def _peak_gib(call):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2**30


def _split(label: str, stages) -> None:
    """CUDA events between ``stages`` (``(name, fn)`` run in order, each
    taking the previous one's result), medians of 3."""
    times = {name: [] for name, _ in stages}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(stages) + 1)]
        ev[0].record()
        out = None
        for i, (name, fn) in enumerate(stages):
            out = fn(out)
            ev[i + 1].record()
        torch.cuda.synchronize()
        for i, name in enumerate(times):
            times[name].append(ev[i].elapsed_time(ev[i + 1]))
        del out
    print(f"split {label} (CUDA events, medians of 3): " + ", ".join(
        f"{k} {statistics.median(v):.2f} ms" for k, v in times.items()),
        flush=True)


def _lrp_models(init, cfg, small):
    """``{"card": (cfg, fp32, float64), "small": ..., "small_cpu": ...}``:
    the full-width model on the card and the two-layer one on the card and
    the CPU, each in fp32 and float64."""
    from transformer_mm_explainability_tpu_torch._device import params_to

    both = lambda p: (p, params_to(p, torch.float64))
    ps = init(small, "cuda")
    return {"card": (cfg,) + both(init(cfg, "cuda")),
            "small": (small,) + both(ps),
            "small_cpu": (small,) + both(params_to(ps, "cpu"))}


def _hold_lrp(family: str, method: str, run, n: int, models,
              n_cpu: int = 0) -> None:
    """The gates of one LRP method. ``run(cfg, params, sel, device)``
    returns the rows of examples ``sel`` (a slice of the ``n``), computed
    in the dtype of ``params``; the CPU takes the first ``n_cpu`` (all by
    default)."""
    cfg, p, p64 = models["card"]
    every = slice(0, n)
    alone = lambda q: [run(cfg, q, slice(i, i + 1), "cuda")
                       for i in range(n)]
    cat = lambda rows: torch.cat([torch.as_tensor(r) for r in rows])
    rows, rows64 = run(cfg, p, every, "cuda"), run(cfg, p64, every, "cuda")
    one, one64 = cat(alone(p)), cat(alone(p64))
    scfg, ps, ps64 = models["small"]
    _, pc, pc64 = models["small_cpu"]
    _gate(family, method, "fp32 vs float64", _row_dist(rows, rows64))
    _gate(family, method, f"float64 B={n} vs B=1", _row_dist(rows64, one64))
    print(f"  {family} {method}: rows fp32 B={n} vs B=1 max|Δ_row|/max|row| "
          f"{_row_dist(rows, one):.3e} (fp32 rounding of other product "
          f"shapes; the float64 line above is the batch gate)", flush=True)
    few = slice(0, n_cpu or n)
    _gate(family, method, "float64 card vs CPU",
          _row_dist(run(scfg, ps64, few, "cuda"),
                    run(scfg, pc64, few, "cpu")))
    _gate(family, method, "fp32 card vs CPU",
          _row_dist(run(scfg, ps, few, "cuda"), run(scfg, pc, few, "cpu")))


def visual_bert_lrp_phase(mods, vb, evb, pert_runner, card: str) -> None:
    """Full-width VISUAL_BERT_VQA2 (B=8, S_t=128, N_v=100; the batch of
    ``visual_bert_phase``): the three LRP methods through the runner, held
    by ``_hold_lrp`` (the CPU at 2 layers); explanations/s and peak memory.
    Every counter reads 0."""
    import dataclasses

    import numpy as np

    reset_counts(mods)
    cfg = vb.VISUAL_BERT_VQA2
    batch = _vb_batch(cfg, torch.Generator().manual_seed(5))
    n = batch["input_ids"].shape[0]
    models = _lrp_models(lambda c, dev: vb.init_params(0, c, dev), cfg,
                         dataclasses.replace(cfg, bert=dataclasses.replace(
                             cfg.bert, num_hidden_layers=2)))
    for m in VB_LRP:
        def run(c, p, sel, dev, m=m):
            b = _cast({k: v[sel] for k, v in batch.items()},
                      p["pooler"]["w"].dtype)
            return pert_runner.VisualBertPerturbationRunner(
                p, c, m, device=dev).explain_batched(b)[1]

        r = pert_runner.VisualBertPerturbationRunner(models["card"][1], cfg,
                                                     m, device="cuda")
        (_, cam), peak = _peak_gib(lambda: r.explain_batched(batch))
        rate = _rate(lambda: r.explain_batched(batch), n)
        print(f"explanations/s VISUAL_BERT_VQA2 {m} fp32: B={n} {rate:.1f} "
              f"(median of 3); peak device memory {peak:.2f} GiB; "
              f"max|row| {float(np.abs(cam).max()):.3e}; on {card}",
              flush=True)
        _hold_lrp("visual_bert", m, run, n, models)
    p, dev = models["card"][1], {k: v.cuda() for k, v in batch.items()}
    ci = vb.cls_index(dev["input_mask"])
    _split(f"visual_bert transformer_attribution B={n}", (
        ("capture with the tape",
         lambda _: vb.capture(p, dev, None, cfg, return_tape=True)),
        ("relprop", lambda c: (c, vb.relprop(p, c[3], torch.nn.functional.
                                               one_hot(c[0].argmax(-1),
                                                       cfg.num_labels),
                                               cfg)[1])),
        ("rows", lambda c: evb.generate_transformer_att(c[1], c[0][2],
                                                        ci))))
    # where fp32 loses the accuracy: each layer's cam against float64 for
    # the same answers, in the relprop's order (the last layer first)
    p64 = models["card"][2]
    scores, _, _, tape = vb.capture(p, dev, None, cfg, return_tape=True)
    one_hot = torch.nn.functional.one_hot(scores.argmax(-1), cfg.num_labels)
    _, c32 = vb.relprop(p, tape, one_hot, cfg)
    _, _, _, tape = vb.capture(p64, _cast(dev, torch.float64), None, cfg,
                               return_tape=True)
    _, c64 = vb.relprop(p64, tape, one_hot, cfg)
    print("visual_bert relprop cams fp32 vs float64, max|Δ|/max|cam| per "
          "layer, last first: " + ", ".join(
              f"{_row_dist(c32[i][None], c64[i][None]):.1e}"
              for i in reversed(range(len(c64)))), flush=True)
    got = counts(mods)
    assert all(v == 0 for v in got.values()), f"visual_bert lrp: {got}"
    print(f"path visual_bert lrp launches: {got}", flush=True)


def lxmert_lrp_phase(mods, lx, pert_runner, detect, card: str) -> None:
    """Full-width LXMERT_VQA (B=8, St=20) on FRCNN detections made in this
    phase (one RoIPool launch per image): the four LRP methods through the
    runner, held by ``_hold_lrp`` (the CPU at 2 + 2 + 2 layers; a row is
    the text row then the image row); explanations/s and peak memory.
    RoIPool reads one launch per image, every other counter 0."""
    import dataclasses

    import numpy as np

    from transformer_mm_explainability_tpu_torch.explain import lxmert as elx
    from transformer_mm_explainability_tpu_torch.models import lxmert_lrp

    reset_counts(mods)
    dets = detect()
    cfg = lx.LXMERT_VQA
    batch = _lx_batch(cfg, dets, torch.Generator().manual_seed(3))
    n = batch["input_ids"].shape[0]
    models = _lrp_models(lambda c, dev: lx.init_params(0, c, dev), cfg,
                         dataclasses.replace(cfg, l_layers=2, x_layers=2,
                                             r_layers=2))
    both = lambda out: np.concatenate([out[1], out[2]], axis=1)
    for m in LX_LRP:
        def run(c, p, sel, dev, m=m):
            b = _cast({k: v[sel] for k, v in batch.items()},
                      p["pooler"]["w"].dtype)
            return both(pert_runner.LxmertPerturbationRunner(
                p, c, m, device=dev).explain_batched(b))

        r = pert_runner.LxmertPerturbationRunner(models["card"][1], cfg, m,
                                                 device="cuda")
        out, peak = _peak_gib(lambda: r.explain_batched(batch))
        rate = _rate(lambda: r.explain_batched(batch), n)
        print(f"explanations/s LXMERT_VQA {m} fp32: B={n} {rate:.1f} "
              f"(median of 3); peak device memory {peak:.2f} GiB; "
              f"max|row| {float(np.abs(both(out)).max()):.3e}; on {card}",
              flush=True)
        _hold_lrp("lxmert", m, run, n, models)
    p, dev = models["card"][1], {k: v.cuda() for k, v in batch.items()}
    _split(f"lxmert ours_with_lrp B={n}", (
        ("capture with the tape",
         lambda _: lx.capture(p, dev, None, cfg, return_tape=True)),
        ("relprop", lambda c: (c, lxmert_lrp.relprop(
            p, c[3], torch.nn.functional.one_hot(c[0].argmax(-1),
                                                 cfg.num_qa_labels),
            c[3]["lang_mask"], c[3]["visn_mask"], cfg)[2])),
        ("rows", lambda c: elx.generate_ours_lrp(
            c[1], c[0][2], text_valid=dev["attention_mask"],
            visual_valid=dev["visual_mask"]))))
    torch.cuda.synchronize()
    got = counts(mods)
    want = {name: len(dets) * (name == "roi_pool_pallas") for name in got}
    assert got == want, f"lxmert lrp: launches {got}, expected {want}"
    print(f"path lxmert lrp launches (detections of {len(dets)} images "
          f"included): {got}", flush=True)


def _detr_setup(detr, deval, dsegm):
    """DETR_R50 with seeded random weights (and drawn transformer biases)
    on a generated 800×1066 image (→ 800×1088, S = 850): ``(cfg, params,
    image, valid, queries and classes by descending score)``."""
    cfg = detr.DETR_R50
    params = detr.init_params(0, cfg, "cuda")
    gen = torch.Generator().manual_seed(7)
    _random_biases(params["encoder"], gen)
    _random_biases(params["decoder"], gen)
    raw = torch.randint(0, 256, (800, 1066, 3), generator=gen,
                        dtype=torch.uint8).numpy()
    image, valid = deval.prepare_image(raw, 800, device="cuda")
    assert tuple(image.shape) == (800, 1088, 3)
    with torch.no_grad():
        out = detr.forward(params, image[None], valid[None], cfg)
    assert out["feat_hw"] == (25, 34)
    q, c, _ = dsegm.keep_detections(out["pred_logits"][0].cpu().numpy(),
                                    0.0, 64)
    return cfg, params, image, valid, q, c


def detr_lrp_phase(mods, detr, edetr, dsegm, deval, card: str) -> None:
    """Full-width DETR_R50 (the image of ``detr_phase``, S = 850): the
    three LRP methods through ``explain/detr.generate`` at K = 8, held by
    ``_hold_lrp`` (each query alone is K = 1; the CPU at 2 + 2 layers and
    K = 4); ``explain_image`` images/s and queries/s at K = 8 and 32 with
    peak memory, a split of the call at K = 32 by CUDA events, and a
    profile. Every counter reads 0."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch._device import params_to

    reset_counts(mods)
    cfg, params, image, valid, q, c = _detr_setup(detr, deval, dsegm)
    n = 8
    small = dataclasses.replace(cfg, num_encoder_layers=2,
                                num_decoder_layers=2)
    models = _lrp_models(lambda c_, dev: params_to(dict(
        params, encoder=detr._layer(params["encoder"],
                                    slice(0, c_.num_encoder_layers)),
        decoder=detr._layer(params["decoder"],
                            slice(0, c_.num_decoder_layers))), dev),
        cfg, small)
    for m in DETR_LRP:
        def run(c_, p, sel, dev, m=m):
            dt = p["input_proj"]["w"].dtype
            return edetr.generate(m, p, image.to(dev, dt), q[:n][sel],
                                  c[:n][sel], c_, valid.to(dev))

        print(f"path detr {m} K={n}: max|row| "
              f"{float(run(cfg, params, slice(0, n), 'cuda').abs().max()):.3e}",
              flush=True)
        _hold_lrp("detr", m, run, n, models, n_cpu=4)
    del models

    for m in DETR_LRP:
        for K in (8, 32):
            scfg = dsegm.SegmConfig(confidence_threshold=0.0,
                                    max_detections=K, method=m)
            call = lambda: dsegm.explain_image(params, image, cfg, scfg,
                                               pad_valid=valid,
                                               pack_masks=True)
            res, peak = _peak_gib(call)
            assert res["masks_packed"].shape == (K, 800, 136), (m, K)
            rate = _rate(call, 1)
            print(f"explain_image DETR_R50 800x1088 {m} K={K}: {rate:.2f} "
                  f"images/s, {K * rate:.1f} queries/s (median of 3); peak "
                  f"device memory {peak:.2f} GiB; on {card}", flush=True)

    # the K = 32 split of the two LRP shapes: the tapped forward (with the
    # batched backward for ours_with_lrp; without gradients for
    # partial_lrp), the K-batched relprop, the rows
    tq32 = torch.as_tensor(q[:32], device="cuda").long()
    oh = edetr._one_hots(tq32, torch.as_tensor(c[:32], device="cuda").long(),
                         cfg)
    tv = edetr._token_valid(image, valid, cfg)
    for m in ("ours_with_lrp", "partial_lrp"):
        full = m == "ours_with_lrp"

        def forward(_, full=full):
            if full:
                return detr.capture_multi(params, image, oh, valid, cfg,
                                          return_tape=True)
            with torch.no_grad():
                return detr.forward(params, image[None], valid[None], cfg,
                                    return_tape=True), None, None

        def relprop(o, full=full):
            with torch.no_grad():
                return o, edetr._relprop_cams(params, o[0]["tape"], oh, cfg,
                                              last_cross_only=not full)

        def rows(c, full=full):
            with torch.no_grad():
                if full:
                    return edetr._rows(edetr.relevancy_from_capture(
                        c[1], c[0][2], token_valid=tv), tq32)
                return edetr.generate_partial_lrp(c[1], tq32)

        _split(f"detr {m} K=32", (("forward", forward), ("relprop", relprop),
                                  ("rows", rows)))
    scfg = dsegm.SegmConfig(confidence_threshold=0.0, max_detections=32,
                            method="ours_with_lrp")
    call = lambda: dsegm.explain_image(params, image, cfg, scfg,
                                       pad_valid=valid, pack_masks=True)
    profile("detr explain_image DETR_R50 ours_with_lrp K=32", call,
            1e3 / _rate(call, 1), show_other=6)
    got = counts(mods)
    assert all(v == 0 for v in got.values()), f"detr lrp: launches {got}"
    print(f"path detr lrp launches: {got}", flush=True)


# --- the original reference's maps, semantic validation, the entry points --

BLOCKS = ("attn_block_fwd", "mlp_block_fwd", "mlp_block_bwd",
          "attn_block_bwd")


def parity_phase(mods, cli, vp, vit, rp, card: str) -> None:
    """``cli verify-parity --family all --device cuda``: the port against
    the maps the original reference computed (the five fixtures); exit 0
    and every map within the tool's rule and within ``vp.REL_TOL`` of its
    max|ref| (exactly 0 where the reference is 0), one line per map. Then
    the ViT fixture's weights and image through ``relevancy_fused_block2``
    (the four block kernels, 12 launches each; kernels #7 and #8 run inside
    #1 and #4) and, on ``vit.capture``'s A and ∇A, through
    ``self_attention_relevancy_pallas`` (1 launch): both maps within both
    bars of the reference's."""
    out = ROOT / "build" / "smoke" / "parity.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    reset_counts(mods)
    t0 = time.perf_counter()
    rc = cli.main(["verify-parity", "--family", "all", "--device", "cuda",
                   "--out", str(out)])
    torch.cuda.synchronize()
    print(f"cli verify-parity --family all --device cuda: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s; launches {counts(mods)}",
          flush=True)
    assert rc == 0
    reports = json.loads(out.read_text())
    assert set(reports) == set(vp.FAMILIES), set(reports)
    print(f"parity against the reference's maps on {card}, fp32 (rel = "
          f"max|Δ|/max|ref|, bar {vp.REL_TOL:g}; the tool's rule max|Δ|/"
          f"max(1, max|ref|) < {vp.TOL:g}, absolute for scores):",
          flush=True)
    for fam, rep in reports.items():
        assert rep.pop("ok") is True, fam
        for name, r in rep.items():
            print(f"  parity {fam} {name}: max|Δ| {r['max_abs']:.3e}, "
                  f"max|ref| {r['max_ref']:.3e}, rel {r['rel']:.3e}"
                  + (" (uninformative: max|ref| < the tool's bar)"
                     if r["uninformative"] else ""), flush=True)
            assert r["ok"] and r["rel"] <= vp.REL_TOL, (fam, name, r)

    sd, ref = vp.fixture_state_dict("vit")
    model, images, targets = vp.vit_model(sd, "cuda")
    reset_counts(mods)
    fused = vit.relevancy_fused_block2(model, images, targets)
    torch.cuda.synchronize()
    got = counts(mods)
    assert got == {k: 12 * (k in BLOCKS) for k in got}, got
    _, attn, grads = vit.capture(model, images, targets)
    reset_counts(mods)
    R = rp.self_attention_relevancy_pallas(attn.movedim(1, 0),
                                           grads.movedim(1, 0))
    torch.cuda.synchronize()
    got_chain = counts(mods)
    chain = "self_attention_relevancy_pallas"
    assert got_chain == {k: int(k == chain) for k in got_chain}, got_chain
    for label, maps, launched in (
            ("relevancy_fused_block2 (kernels #1-4; #7, #8 inside #1, #4)",
             fused, {k: got[k] for k in BLOCKS}),
            ("capture + self_attention_relevancy_pallas (kernel #9)",
             R[:, 0, 1:], {chain: 1})):
        r = vp.map_report(maps.cpu().numpy(), ref["relevancy"], "relevancy")
        print(f"parity vit relevancy through {label} on {card}: max|Δ| "
              f"{r['max_abs']:.3e}, max|ref| {r['max_ref']:.3e}, rel "
              f"{r['rel']:.3e} (bars: the tool's {vp.TOL:g}, rel "
              f"{vp.REL_TOL:g}); launches {launched}", flush=True)
        assert r["ok"] and r["rel"] <= vp.REL_TOL, (label, r)


def semantic_phase(sv, card: str) -> None:
    """``tools/semantic_validation.run_family`` for VisualBERT and LXMERT
    at the tool's defaults (the JAX tool's initial weights, 256 samples,
    six methods each and the random control) on the card: the hard checks
    must hold (``semantics["ok"]``) and the held-out accuracy reach 0.9.
    Prints the training steps and seconds, the eval accuracy, the sweep
    seconds and every check's AUCs beside ``SEMANTIC_r05.json`` (the JAX
    tool on a CPU) and writes ``build/smoke/semantic_torch.json``."""
    jax_run = json.loads((ROOT / "SEMANTIC_r05.json").read_text())
    results = {"artifact": "semantic_validation", "backend": "cuda",
               "devices": [torch.cuda.get_device_name(0)], "card": card}
    keys = ("neg_auc", "pos_auc", "gap", "control_auc", "ours", "baseline")
    for model in ("visual_bert", "lxmert"):
        fam = sv.run_family(model, device="cuda", printer=lambda *a: None)
        results[model] = fam
        tr, jtr = fam["train"], jax_run[model]["train"]
        print(f"semantic {model} on {card}: {tr['train_steps']} training "
              f"steps in {tr['train_wall_s']} s, eval accuracy "
              f"{tr['eval_acc']}, sweeps {fam['sweep_wall_s']} s (JAX on a "
              f"CPU, SEMANTIC_r05.json: {jtr['train_steps']} steps in "
              f"{jtr['train_wall_s']} s, eval {jtr['eval_acc']}, sweeps "
              f"{jax_run[model]['sweep_wall_s']} s)", flush=True)
        for c, jc in zip(fam["semantics"]["checks"],
                         jax_run[model]["semantics"]["checks"]):
            assert c["check"] == jc["check"], (c, jc)
            show = lambda d: ", ".join(f"{k} {d[k]}" for k in keys if k in d)
            print(f"  {model} {'hard' if c['hard'] else 'soft'} "
                  f"{c['check']}: {show(c)}, ok {c['ok']} (JAX: {show(jc)}, "
                  f"ok {jc['ok']})", flush=True)
        assert fam["semantics"]["ok"], f"semantic {model}: a hard check"
        assert tr["eval_acc"] >= 0.9, f"semantic {model}: eval {tr}"
    results["ok"] = True
    out = ROOT / "build" / "smoke" / "semantic_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1) + "\n")


def entry_points_phase(mods, card: str) -> None:
    """The four examples (``examples/{vit,clip,detr}_explainability``,
    ``examples/lxmert_perturbation``) in their checkpoint-free mode,
    the DETR example again on a full-width DETR_R50 checkpoint whose
    raised class bias keeps queries of the image, and
    ``tools/extract_features`` (full-width FRCNN_VG at 800 px on a folder
    of two generated images) with ``--device cuda``, each with every
    counter at 0 before it: the ViT example launches the four block
    kernels 12 times each, ``extract_features`` RoIPool once per image,
    the others none. Each must exit 0 and write what it advertises; the
    DETR example at full width must keep a detection and make a non-empty
    mask of each; the TSV reads back through ``data/vqa.load_obj_tsv``."""
    import numpy as np
    from PIL import Image

    from transformer_mm_explainability_tpu_torch.data import vqa
    from transformer_mm_explainability_tpu_torch.examples import (
        clip_explainability, detr_explainability, lxmert_perturbation,
        vit_explainability)
    from transformer_mm_explainability_tpu_torch.harness import (
        detr_eval, detr_segm)
    from transformer_mm_explainability_tpu_torch.models import detr
    from transformer_mm_explainability_tpu_torch.tools import extract_features

    work = ROOT / "build" / "smoke" / "entry_points"
    (work / "images").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(5)
    image = str(work / "input.png")
    Image.fromarray((rng.rand(240, 320, 3) * 255).astype(np.uint8)).save(
        image)
    shapes = ((480, 640), (600, 800))
    for i, hw in enumerate(shapes):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
            work / "images" / f"img{i}.png")
    tsv = work / "features.tsv"
    tsv.unlink(missing_ok=True)

    def run(label, main, argv, launched):
        reset_counts(mods)
        t0 = time.perf_counter()
        rc = main([*map(str, argv), "--device", "cuda"])
        torch.cuda.synchronize()
        got = counts(mods)
        print(f"{label} --device cuda: rc {rc} in "
              f"{time.perf_counter() - t0:.1f} s; launches {got}", flush=True)
        assert rc == 0, label
        assert got == {k: launched.get(k, 0) for k in got}, (label, got)

    run("example vit_explainability", vit_explainability.main,
        [image, "--output", work / "vit.png"], {k: 12 for k in BLOCKS})
    assert np.asarray(Image.open(work / "vit.png")).shape == (224, 224, 3)
    run("example clip_explainability", clip_explainability.main,
        [image, "a photo of a dog", "a photo of a cat", "--output-prefix",
         work / "clip"], {})
    assert (work / "clip_1.png").exists()
    assert "<span" in (work / "clip_text.html").read_text()
    run("example detr_explainability", detr_explainability.main,
        [image, "--output-prefix", work / "detr"], {})
    assert np.asarray(Image.open(work / "detr_masks.png")).ndim == 3
    # at full width: the example prepares the image at 512 / 800 px
    ckpt = work / "detr_raised.pth"
    delta = _detr_checkpoint(detr, detr_eval, detr_segm, ckpt,
                             np.asarray(Image.open(image).convert("RGB")),
                             n_kept=4, shortest=512, longest=800)
    made = []
    explain_image = detr_segm.explain_image

    def counted(*args, **kw):
        out = explain_image(*args, **kw)
        made.append([int(m.sum()) for m in out["masks"]])
        return out

    detr_segm.explain_image = counted
    try:
        run("example detr_explainability --checkpoint (DETR_R50)",
            detr_explainability.main,
            [image, "--checkpoint", ckpt, "--output-prefix",
             work / "detr_r50"], {})
    finally:
        detr_segm.explain_image = explain_image
    ckpt.unlink()
    print(f"  DETR_R50 class-1 bias + {delta:.3f}: {len(made[0])} "
          f"detections kept, pixels set per mask {made[0]}", flush=True)
    assert len(made) == 1 and len(made[0]) > 0, made
    assert all(px > 0 for px in made[0]), made
    assert np.asarray(Image.open(work / "detr_r50_masks.png")).ndim == 3
    run("example lxmert_perturbation", lxmert_perturbation.main,
        ["--num-samples", "3"], {})
    run("tools/extract_features (FRCNN_VG, 800 px)", extract_features.main,
        ["--img-root", work / "images", "--out", tsv],
        {"roi_pool_pallas": len(shapes)})
    rows = vqa.load_obj_tsv(str(tsv))
    assert [r["img_id"] for r in rows] == ["img0", "img1"], rows
    for row, (h, w) in zip(rows, shapes):
        n = row["num_boxes"]
        assert (row["img_h"], row["img_w"]) == (h, w)
        assert 0 < n <= 36 and row["features"].shape == (n, 2048)
        assert np.isfinite(row["features"]).all()
        assert float(row["boxes"][:, 2].max()) <= w + 1
    print(f"extract_features TSV: {[r['num_boxes'] for r in rows]} boxes "
          f"of 2048-d features, read back by data/vqa.load_obj_tsv; on "
          f"{card}", flush=True)


def bench_phase(mods, cli, card: str) -> dict:
    """``cli bench --device cuda``: one JSON line with maps/s > 0 at B = 32,
    the four block kernels 12 times per call of ``relevancy_fused_block2``
    (``bench.TRIALS`` trials of one warm call and ``bench.ITERS`` timed
    ones), every other counter 0. Returns the block kernels' counts."""
    import contextlib
    import io

    from transformer_mm_explainability_tpu_torch import bench

    reset_counts(mods)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["bench", "--device", "cuda"])
    torch.cuda.synchronize()
    got = counts(mods)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    calls = bench.TRIALS * (bench.ITERS + 1)
    print(f"cli bench --device cuda: {lines[-1]}; launches {got} ({calls} "
          f"calls); on {card}", flush=True)
    assert rc == 0 and len(lines) == 1, lines
    rec = json.loads(lines[0])
    assert rec["value"] > 0 and rec["batch"] == 32, rec
    assert got == {k: 12 * calls if k in BLOCKS else 0 for k in got}, got
    return {k: got[k] for k in BLOCKS}


def bench_families_phase(mods, card: str) -> int:
    """``tools/bench_families`` for the five families at their full shapes,
    2 timed calls (and one warm call) each, every counter at 0 before each:
    one JSON line per family; RoIPool launches once per FRCNN image, every
    other counter 0. Returns the FRCNN family's RoIPool launches."""
    from transformer_mm_explainability_tpu_torch.tools import (
        bench_families as bf)

    iters, roi = 2, 0
    for fam in bf.ALL_FAMILIES:
        reset_counts(mods)
        (rec,) = bf.run([fam], tiny=False, iters=iters, device="cuda")
        torch.cuda.synchronize()
        got = counts(mods)
        n = iters + 1 if fam == "frcnn" else 0
        print(f"  bench_families {fam}: {rec['ms_per_unit']} ms per "
              f"{rec['unit']}; launches {got}; on {card}", flush=True)
        assert rec["ms_per_call"] > 0, rec
        assert got == {k: n if k == "roi_pool_pallas" else 0 for k in got}
        roi += n
    return roi


class _Cut(Exception):
    """Stops the LXMERT rehearsal loop after a sample, as a time limit
    would."""


def rehearsal_phase(mods, cli, card: str) -> int:
    """``cli protocol-rehearsal --device cuda`` at full width with reduced
    counts, one protocol per invocation into one ``--out`` artifact (each
    merged into the earlier ones): VisualBERT 64 samples × 4 sweeps at
    B = 16, LXMERT 2 samples (FRCNN re-run in each of the 9 steps: RoIPool
    exactly 20 launches, every other counter 0), DETR 2 images. Every curve
    has 9 steps in [0, 1] and a finite AUC; every protocol's memory record
    is measured. Then the LXMERT loop, cut after its first sample with a
    sidecar written every sample, resumes from the sidecar in a second
    invocation: the resumed sample must be the uninterrupted run's second
    one (the same drawn image, question and answer, the same 9
    accuracies), and the curve the CLI's. (With random weights and 3,129
    answers the accuracies are 0, so the drawn inputs are what tells a
    replay from another stream.) Returns RoIPool's launches in the LXMERT
    protocol."""
    import contextlib
    import io

    from transformer_mm_explainability_tpu_torch.models import frcnn
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.tools import (
        protocol_rehearsal as pr)

    work = ROOT / "build" / "smoke" / "rehearsal"
    work.mkdir(parents=True, exist_ok=True)
    out = work / "protocol.json"
    out.unlink(missing_ok=True)
    # each LXMERT sample's inputs and accuracies; a _Cut after `stop`
    real, seen, stop = pr.lxmert_sample, [], [None]

    def recorded(*args, **kw):
        if len(seen) == stop[0]:
            raise _Cut
        accs = real(*args, **kw)
        image, ids, soft = args[4], args[5], args[7]
        seen.append((float(image.double().sum()), ids.tolist(),
                     int(soft.argmax()), accs.tolist()))
        return accs

    pr.lxmert_sample = recorded
    try:
        roi = {}
        for proto, extra in (("visualbert", ["--vb-samples", "64"]),
                             ("lxmert", ["--lx-samples", "2"]),
                             ("detr", ["--detr-images", "2"])):
            reset_counts(mods)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["protocol-rehearsal", "--protocol", proto,
                               *extra, "--out", str(out), "--device",
                               "cuda"])
            torch.cuda.synchronize()
            got = counts(mods)
            n = 20 if proto == "lxmert" else 0
            print(f"cli protocol-rehearsal --protocol {proto} "
                  f"{' '.join(extra)}: rc {rc} in "
                  f"{time.perf_counter() - t0:.1f} s; launches {got}",
                  flush=True)
            assert rc == 0, proto
            assert got == {k: n if k == "roi_pool_pallas" else 0
                           for k in got}
            roi[proto] = got["roi_pool_pallas"]
        uninterrupted, seen[:] = list(seen), []
        art = json.loads(out.read_text())
        vb, lxr, dr = art["visualbert"], art["lxmert"], art["detr"]
        curves = [(f"visualbert positive={s['positive']} "
                   f"text={s['text_pert']}", s) for s in vb["sweeps"]]
        curves.append(("lxmert", lxr))
        assert len(curves) == 5 and len(uninterrupted) == 2
        for name, rec in curves:
            acc = rec["step_accuracies"]
            print(f"  rehearsal {name}: {rec['num_samples']} samples, "
                  f"{rec['ms_per_sample_steady']} ms/sample steady, AUC "
                  f"{rec['auc']}, steps {acc}", flush=True)
            assert len(acc) == 9 and all(0.0 <= a <= 1.0 for a in acc), acc
            assert math.isfinite(rec["auc"]), rec
        for proto in ("visualbert", "lxmert", "detr"):
            mem = art[proto]["memory"]
            print(f"  rehearsal {proto} memory: {mem}", flush=True)
            assert mem is not None and mem["peak_bytes_in_use"] > 0, proto
        print(f"  rehearsal detr: {dr['num_images']} images, "
              f"{dr['ms_per_image_first']} ms the first; stats "
              f"{dr['stats']}; on {card}", flush=True)
        assert all(math.isfinite(v) for v in dr["stats"].values())

        dev = torch.device("cuda")
        fcfg, lcfg = frcnn.FRCNN_VG, lx.LXMERT_VQA
        fparams = frcnn.init_params(1, fcfg, dev)
        lparams = lx.init_params(2, lcfg, dev)
        side = work / "resume.json"
        side.unlink(missing_ok=True)
        loop = lambda: pr.lxmert_loop(fparams, lparams, fcfg, lcfg, 2,
                                      resume_path=str(side), save_every=1,
                                      printer=lambda *a: None, device=dev)
        stop[0] = 1
        with contextlib.suppress(_Cut):
            loop()
        assert seen == uninterrupted[:1], (seen, uninterrupted)
        assert json.loads(side.read_text())["i"] == 1
        stop[0], seen[:] = None, []
        resumed = loop()
    finally:
        pr.lxmert_sample = real
    print(f"  rehearsal lxmert resumed at sample {resumed['resumed_at']}: "
          f"sample 2 drawn again (image sum {seen[0][0]:.6e}, answer "
          f"{seen[0][2]}), steps {resumed['step_accuracies']} "
          f"(uninterrupted {lxr['step_accuracies']})", flush=True)
    assert resumed["resumed_at"] == 1 and not side.exists()
    assert seen == uninterrupted[1:], (seen, uninterrupted)
    assert resumed["step_accuracies"] == lxr["step_accuracies"]
    return roi["lxmert"]


SP_K = 8       # DETR queries explained in the sp phase


def _sp_rows(mesh) -> dict:
    """DETR_R50 of ``_detr_setup`` (S = 850), its top ``SP_K`` queries
    captured on this rank's card, then ``parallel/sp.sp_detr_relevancy``
    (the ``ours_no_lrp`` rows) and ``sp_self_attention_relevancy`` of the
    first query's encoder taps over ``mesh``'s tp axis."""
    from transformer_mm_explainability_tpu_torch.explain import detr as edetr
    from transformer_mm_explainability_tpu_torch.harness import (
        detr_eval, detr_segm)
    from transformer_mm_explainability_tpu_torch.models import detr
    from transformer_mm_explainability_tpu_torch.parallel import sp

    cfg, params, image, valid, q, c = _detr_setup(detr, detr_eval, detr_segm)
    tq = torch.as_tensor(q[:SP_K], device=image.device).long()
    oh = edetr._one_hots(tq, torch.as_tensor(c[:SP_K], device=image.device)
                         .long(), cfg)
    _, attn, grads = detr.capture_multi(params, image, oh, valid, cfg)
    k_first = [t.movedim(1, 0) for fam in ("enc_self", "dec_self",
                                           "dec_cross")
               for t in (getattr(attn, fam), getattr(grads, fam))]
    R_qi = sp.sp_detr_relevancy(
        *k_first, mesh, token_valid=edetr._token_valid(image, valid, cfg))
    R = sp.sp_self_attention_relevancy(attn.enc_self[:, 0],
                                       grads.enc_self[:, 0], mesh)
    return {"rows": R_qi[torch.arange(SP_K, device=tq.device), tq], "R": R}


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    top = float(want.abs().max())
    assert top > 0, "the reference is zero"
    return float((got.to(want) - want).abs().max()) / top


def sp_phase(mesh, card: str) -> None:
    """Sequence-parallel relevancy on the card. One rank over NCCL
    (``mesh``, made by ``main``): ``explain/detr.generate`` with ``mesh``
    for ``ours_no_lrp`` and ``ours_with_lrp`` on DETR_R50 at S = 850,
    K = 8, equal to the call without it within 1e-4 of max|row| in fp32 and
    1e-10 in float64. Then two spawned ranks of a gloo group on this one
    card (gloo stages the CUDA tensors through the host; NCCL refuses two
    ranks on one device): ``sp_detr_relevancy`` and
    ``sp_self_attention_relevancy`` at that size, each rank's result
    within 1e-5 of max of the one-rank result."""
    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.explain import detr as edetr
    from transformer_mm_explainability_tpu_torch.harness import (
        detr_eval, detr_segm)
    from transformer_mm_explainability_tpu_torch.models import detr
    from transformer_mm_explainability_tpu_torch.parallel.launch import (
        MeshArg, RankPool)

    cfg, params, image, valid, q, c = _detr_setup(detr, detr_eval, detr_segm)
    tq, tc = q[:SP_K], c[:SP_K]
    wide = (params_to(params, torch.float64), image.double(), valid)
    for method in ("ours_no_lrp", "ours_with_lrp"):
        for label, (p, im, v), bar in (("fp32", (params, image, valid), 1e-4),
                                       ("float64", wide, 1e-10)):
            want = edetr.generate(method, p, im, tq, tc, cfg, v)
            t0 = time.perf_counter()
            got = edetr.generate(method, p, im, tq, tc, cfg, v, mesh=mesh)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            print(f"sp detr {method} {label} K={SP_K} S=850, 1 NCCL rank: "
                  f"max|Δ| / max|row| {rel:.3e} (bar {bar:g}; max|row| "
                  f"{float(want.abs().max()):.3e}) in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
            assert rel <= bar, (method, label, rel)
    del wide
    one = _sp_rows(mesh)
    t0 = time.perf_counter()
    with RankPool(2, "gloo", "cuda", timeout_s=300) as pool:
        two = pool.run(_sp_rows, MeshArg(dp=1, tp=2))
        t1 = time.perf_counter()
        pool.run(_sp_rows, MeshArg(dp=1, tp=2))
        t2 = time.perf_counter()
    print(f"sp 2 gloo ranks on cuda:0: spawn, group and the first call "
          f"(DETR_R50 drawn, capture, both chains) {t1 - t0:.1f} s, a "
          f"second call {t2 - t1:.1f} s; on {card}", flush=True)
    for rank, out in enumerate(two):
        for key in ("rows", "R"):
            rel = _rel(out[key], one[key])
            print(f"  rank {rank} {key} {tuple(out[key].shape)} vs 1 NCCL "
                  f"rank: max|Δ| / max {rel:.3e} (bar 1e-5)", flush=True)
            assert rel <= 1e-5, (rank, key, rel)


def sharded_example_phase(mods, vit, mesh, card: str) -> dict:
    """``examples/sharded_relevancy``: ``sharded_maps(..., "relevancy_fused")``
    on ``mesh`` (one NCCL rank) with every counter at 0 before it launches
    the attention kernels #7 and #8 12 times each and no other, and gives
    the maps of ``relevancy_fused`` unsharded, bit for bit; then the
    example's ``main(["--fused"])`` (one spawned rank per card over NCCL)
    exits 0. Returns #7's and #8's counts."""
    import contextlib
    import io

    from transformer_mm_explainability_tpu_torch.examples import (
        sharded_relevancy as sr)

    dev = torch.device("cuda")
    model = vit.init_params(0, vit.VIT_B_16, dev)
    gen = torch.Generator().manual_seed(11)
    images = torch.randn((B, 224, 224, 3), generator=gen).to(dev)
    targets = torch.randint(0, 1000, (B,), generator=gen).to(dev)
    want = vit.relevancy_fused(model, images, targets)
    reset_counts(mods)
    got = sr.sharded_maps(model, images, targets, mesh, "relevancy_fused")
    torch.cuda.synchronize()
    launched = counts(mods)
    attn = ("flash_fwd_qkv", "flash_bwd_ehat_qkv")
    print(f"sharded example relevancy_fused on 1 NCCL rank: launches "
          f"{launched}; max|Δ| from unsharded "
          f"{float((got - want).abs().max()):.3e}", flush=True)
    assert launched == {k: 12 if k in attn else 0 for k in launched}
    assert torch.equal(got, want)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sr.main(["--fused", "--batch", str(B)])
    print(f"example sharded_relevancy --fused: rc {rc} in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{' | '.join(buf.getvalue().splitlines())}; on {card}", flush=True)
    assert rc == 0 and buf.getvalue().strip().endswith("OK")
    return {k: launched[k] for k in attn}


# ---------------------------------------------------------------------------
# The training path (train/): plain PyTorch, no kernel of the port
# ---------------------------------------------------------------------------

TRAIN_BAR = 1e-5    # card vs CPU: each loss (relative), the parameters
                    # (max|Δ| over the tree's max|p|)
DETR_LOSS_KEYS = {"loss_ce", "loss_bbox", "loss_giou", "cardinality_error",
                  "loss"}


def _tree_rel(got, want) -> float:
    """max|Δ| over the leaves of two parameter trees (or modules) over the
    largest |p| of ``want``."""
    from transformer_mm_explainability_tpu_torch.train import steps

    g, w = steps.tree_leaves(got), steps.tree_leaves(want)
    top = max(float(t.detach().abs().max()) for t in w)
    return max(float((a.detach().to(b.device) - b.detach()).abs().max())
               for a, b in zip(g, w)) / top


def _lxmert_files(root: pathlib.Path, n_train: int, n_valid: int) -> dict:
    """The ``run/vqa_finetune.bash`` inputs at the VQA widths, from a seed:
    questions over 8 images of a 36-box 2048-d TSV, a 3129-answer
    ``ans2label`` / ``label2ans``, a WordPiece vocabulary."""
    import numpy as np

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(14)
    words = ["what", "color", "is", "the", "dog", "how", "many", "cats",
             "are", "there", "on", "table", "?"]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    answers = [f"answer{k}" for k in range(3129)]
    (root / "ans2label.json").write_text(json.dumps(
        {a: k for k, a in enumerate(answers)}))
    (root / "label2ans.json").write_text(json.dumps(answers))

    def questions(n, offset):
        out = []
        for i in range(n):
            sent = " ".join(rng.choice(words[:-1], rng.randint(3, 12)))
            picks = rng.choice(3129, 2, replace=False)
            out.append({"question_id": offset + i, "img_id": f"img{i % 8}",
                        "sent": sent + " ?",
                        "label": {answers[picks[0]]: 1.0,
                                  answers[picks[1]]: 0.3}})
        return out

    (root / "train.json").write_text(json.dumps(questions(n_train, 0)))
    (root / "valid.json").write_text(json.dumps(questions(n_valid, n_train)))
    _feature_tsv(root / "feats.tsv", 8, 36)
    return {name: str(root / f) for name, f in (
        ("train", "train.json"), ("valid", "valid.json"),
        ("features", "feats.tsv"), ("ans2label", "ans2label.json"),
        ("label2ans", "label2ans.json"), ("vocab", "vocab.txt"))}


def _lx_train_batches(cfg, n: int, B: int, gen: torch.Generator) -> list:
    """``n`` batches of B questions of St = 20 (lengths 6-20, padded) on
    36 boxes (28-36 real) with soft targets over the 3129 answers."""
    out = []
    for _ in range(n):
        lengths = torch.randint(6, 21, (B,), generator=gen)
        ar = torch.arange(20)[None]
        mask = (ar < lengths[:, None]).int()
        ids = torch.randint(1000, cfg.vocab_size, (B, 20), generator=gen)
        nv = torch.randint(28, 37, (B,), generator=gen)
        target = torch.zeros(B, cfg.num_qa_labels)
        target[torch.arange(B), torch.randint(0, cfg.num_qa_labels, (B,),
                                              generator=gen)] = 1.0
        out.append({"input_ids": ids * mask, "attention_mask": mask,
                    "visual_feats": torch.rand((B, 36, 2048), generator=gen),
                    "visual_pos": torch.rand((B, 36, 4), generator=gen),
                    "visual_mask": (torch.arange(36)[None]
                                    < nv[:, None]).int(),
                    "target": target})
    return out


def lxmert_train_phase(cli, card: str) -> None:
    """LXMERT_VQA finetune, the slice's main path: ``cli lxmert-finetune
    --device cuda`` on generated files (9/5/5, D = 768, 3129 answers,
    B = 32, St = 20, Sv = 36, BertAdam; 2 epochs of 4 batches, validated
    on 2), one finite loss per epoch; updates/s (median of the steady
    updates, each timed between synchronisations) and peak memory. Then
    the same 3 updates (B = 4, seeded weights, BertAdam over 3 steps) on
    the card and on the CPU: each loss within ``TRAIN_BAR`` (relative),
    the parameters within ``TRAIN_BAR`` of the tree's max|p|."""
    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.train import lxmert_tasks

    B = 32
    files = _lxmert_files(ROOT / "build" / "smoke" / "lxmert_train", 4 * B,
                          2 * B)
    real = lxmert_tasks._TaskTrainer.train_step
    times = []

    last = {}

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        last.update(trainer=self, batch=batch)
        return out

    lxmert_tasks._TaskTrainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        got = _cli_json(cli, [
            "lxmert-finetune", "--train-questions", files["train"],
            "--valid-questions", files["valid"],
            "--features", files["features"], "--ans2label",
            files["ans2label"], "--label2ans", files["label2ans"],
            "--bert-vocab", files["vocab"], "--batch-size", str(B),
            "--epochs", "2", "--device", "cuda"])
    finally:
        lxmert_tasks._TaskTrainer.train_step = real
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert len(got["loss"]) == 2 and all(math.isfinite(x)
                                         for x in got["loss"]), got
    assert len(times) == 8, len(times)
    steady = statistics.median(times[1:])
    print(f"train lxmert cli lxmert-finetune LXMERT_VQA B={B} St=20 Sv=36 "
          f"BertAdam: 8 updates + 2 validations in {wall:.1f} s; first "
          f"update {times[0] * 1e3:.1f} ms, steady {steady * 1e3:.2f} ms "
          f"(median of 7; {min(times[1:]) * 1e3:.2f}-"
          f"{max(times[1:]) * 1e3:.2f}) = {1 / steady:.2f} updates/s, "
          f"{B / steady:.1f} samples/s; peak {peak:.2f} GiB; losses "
          f"{got['loss']}; on {card}", flush=True)
    profile("train lxmert update B=32 (one more, after the cli)",
            lambda: last["trainer"].train_step(last["batch"]),
            steady * 1e3, show_other=6)
    del last

    cfg = lx.LXMERT_VQA
    params = lx.init_params(5, cfg, "cpu")
    batches = _lx_train_batches(cfg, 3, 4, torch.Generator().manual_seed(6))
    runs = {}
    for dev in ("cuda", "cpu"):
        p = params_to(params, dev) if dev == "cuda" else params
        tr = lxmert_tasks.LxmertTaskTrainer(
            cfg.num_qa_labels, lxmert_tasks.FinetuneConfig(batch_size=4,
                                                           epochs=1),
            model_cfg=cfg, batches_per_epoch=3, params=p, device=dev)
        t0 = time.perf_counter()
        losses = [tr.train_step({k: v.to(dev) for k, v in b.items()})[0]
                  for b in batches]
        runs[dev] = (losses, tr.state.params, time.perf_counter() - t0)
    (gl, gp, gs), (cl, cp, cs) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    p_rel = _tree_rel(gp, cp)
    print(f"train lxmert card vs CPU, LXMERT_VQA B=4, 3 BertAdam updates: "
          f"losses {gl} vs {cl}, max relative {loss_rel:.3e}; parameters "
          f"max|Δ| / max|p| {p_rel:.3e} (bar {TRAIN_BAR:g}); card "
          f"{gs:.1f} s, CPU {cs:.1f} s", flush=True)
    assert loss_rel <= TRAIN_BAR and p_rel <= TRAIN_BAR, (loss_rel, p_rel)


def _detr_targets(B: int, M: int, num_classes: int, gen: torch.Generator):
    labels = torch.randint(1, num_classes, (B, M), generator=gen)
    cxcy = 0.2 + 0.6 * torch.rand((B, M, 2), generator=gen)
    wh = 0.05 + 0.25 * torch.rand((B, M, 2), generator=gen)
    return labels, torch.cat([cxcy, wh], dim=-1)


def _detr_updates(dtrain, matcher, steps, cfg, params, images, labels,
                  boxes, n: int):
    """``n`` updates of ``train_batch`` (AdamW 1e-4, decay 1e-4, clip
    0.1): ([(losses as floats, the assignment the update made, seconds)],
    a call that makes one more update). The assignment is ``predict`` +
    ``matcher.match`` before the update, untimed (the step matches the
    same outputs of its own forward)."""
    tx = steps.make_adamw(1e-4, weight_decay=1e-4, grad_clip=0.1)
    state = steps.init_state(params, tx)
    predict, step = dtrain.make_detr_train_step(cfg, tx)
    n_valid = [labels.shape[1]] * labels.shape[0]
    out = []
    for _ in range(n):
        assignment = matcher.match(*predict(state.params, images), labels,
                                   boxes, n_valid)
        if images.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, losses = dtrain.train_batch(state, images, labels, boxes,
                                           n_valid, predict, step)
        losses = {k: float(v) for k, v in losses.items()}
        out.append((losses, assignment, time.perf_counter() - t0))
    return out, lambda: dtrain.train_batch(state, images, labels, boxes,
                                           n_valid, predict, step)


def detr_train_phase(card: str) -> None:
    """DETR_R50 training: B = 2 at 800×1066 (the reference's
    ``--batch_size 2``), 5 targets an image, 3 updates of ``train_batch``:
    finite losses with the JAX step's keys, valid assignments (5 distinct
    queries an image), updates/s (median of the last two) and peak memory.
    Then a reduced DETR (2 + 2 layers, 320×320) from the same seeded weights
    on the card and on the CPU, 2 updates: the same assignment and each
    loss within rtol 1e-4."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.models import detr, matcher
    from transformer_mm_explainability_tpu_torch.train import detr_train
    from transformer_mm_explainability_tpu_torch.train import steps

    dev = torch.device("cuda")
    cfg = detr.DETR_R50
    gen = torch.Generator().manual_seed(21)
    images = torch.randn((2, 800, 1066, 3), generator=gen).to(dev)
    labels, boxes = _detr_targets(2, 5, cfg.num_classes, gen)
    params = detr.init_params(0, cfg, dev)
    torch.cuda.reset_peak_memory_stats()
    runs, again = _detr_updates(detr_train, matcher, steps, cfg, params,
                                images, labels.to(dev), boxes.to(dev), 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for losses, assignment, _ in runs:
        assert set(losses) == DETR_LOSS_KEYS, losses
        assert all(math.isfinite(v) for v in losses.values()), losses
        for row in assignment:
            assert len(set(row.tolist())) == 5 and row.min() >= 0 \
                and row.max() < cfg.num_queries, assignment
    steady = statistics.median(t for *_, t in runs[1:])
    print(f"train detr DETR_R50 B=2 800x1066, 5 targets an image, AdamW: "
          f"updates {[round(t * 1e3, 1) for *_, t in runs]} ms, steady "
          f"{steady * 1e3:.1f} ms = {1 / steady:.2f} updates/s, "
          f"{2 / steady:.2f} images/s; peak {peak:.2f} GiB; losses "
          f"{[round(r[0]['loss'], 5) for r in runs]}; on {card}", flush=True)
    profile("train detr update B=2 800x1066", again, steady * 1e3,
            show_other=6)
    del params, images, again

    small = dataclasses.replace(cfg, num_encoder_layers=2,
                                num_decoder_layers=2)
    params = detr.init_params(3, small, "cpu")
    images = torch.randn((2, 320, 320, 3), generator=gen)
    labels, boxes = _detr_targets(2, 5, small.num_classes, gen)
    card_runs, _ = _detr_updates(detr_train, matcher, steps, small,
                              params_to(params, dev), images.to(dev),
                              labels.to(dev), boxes.to(dev), 2)
    cpu_runs, _ = _detr_updates(detr_train, matcher, steps, small, params,
                                images, labels, boxes, 2)
    for k, ((gl, ga, _), (cl, ca, _)) in enumerate(zip(card_runs,
                                                       cpu_runs)):
        rel = max(abs(gl[n] - cl[n]) / max(abs(cl[n]), 1e-30)
                  for n in ("loss_ce", "loss_bbox", "loss_giou", "loss"))
        print(f"train detr card vs CPU, 2 + 2 layers 320x320, update {k}: "
              f"assignments equal {bool((ga == ca).all())}, losses max "
              f"relative {rel:.3e} (bar 1e-4)", flush=True)
        assert (ga == ca).all() and rel <= 1e-4, (ga, ca, rel)


def _vit_loss(model, batch):
    from transformer_mm_explainability_tpu_torch.models import vit
    from transformer_mm_explainability_tpu_torch.train import steps

    logits, _ = vit.forward(model, batch["images"])
    return steps.softmax_xent(logits, batch["labels"])


def _vit_sharded_update(model, images, labels, mesh):
    """One dp×tp update (``parallel/mesh.make_train_step``, AdamW 1e-3) of
    this rank's shard of ``model``: (loss, the whole model's w_qkv of every
    block, gathered back)."""
    from transformer_mm_explainability_tpu_torch.parallel import mesh as pm
    from transformer_mm_explainability_tpu_torch.train import steps

    tx = steps.make_adamw(1e-3)
    state = steps.init_state(pm.shard_params(model, mesh), tx)
    step = pm.make_train_step(_vit_loss, tx, mesh)
    state, loss = step(state, pm.shard_batch(
        {"images": images, "labels": labels}, mesh))
    whole = pm.unshard_params(state.params, mesh)
    return loss, torch.stack([blk.w_qkv.detach() for blk in whole.blocks])


def vit_train_phase(mesh, card: str) -> None:
    """ViT-B/16 train step, B = 32, AdamW 1e-3: images/s (median of 4
    steady updates) and peak memory of the unsharded step; one update of
    the dp×tp step on one NCCL rank (``mesh``, dp = tp = 1) equal to the
    unsharded update bit for bit (loss and every parameter); one on two
    gloo ranks sharing cuda:0 (tp = 2) within loss rtol 1e-5 and ``w_qkv``
    atol 1e-5 (``tests/test_parallel.py``'s bars) wherever |g| ≥ 1e-6
    (100 times AdamW's eps), and within 2 lr where it is not."""
    import copy

    from transformer_mm_explainability_tpu_torch.models import vit
    from transformer_mm_explainability_tpu_torch.parallel import mesh as pm
    from transformer_mm_explainability_tpu_torch.parallel.launch import (
        MeshArg, RankPool)
    from transformer_mm_explainability_tpu_torch.train import steps

    dev = torch.device("cuda")
    model = vit.init_params(0, vit.VIT_B_16, dev)
    gen = torch.Generator().manual_seed(31)
    images = torch.randn((32, 224, 224, 3), generator=gen).to(dev)
    labels = torch.randint(0, 1000, (32,), generator=gen).to(dev)
    batch = {"images": images, "labels": labels}

    tx = steps.make_adamw(1e-3)
    state = steps.init_state(copy.deepcopy(model), tx)
    step = steps.make_train_step(_vit_loss, tx)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        float(loss)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(times[1:])
    print(f"train vit ViT-B/16 B=32 AdamW: first update "
          f"{times[0] * 1e3:.1f} ms, steady {steady * 1e3:.2f} ms (median of "
          f"4; {min(times[1:]) * 1e3:.2f}-{max(times[1:]) * 1e3:.2f}) = "
          f"{32 / steady:.1f} images/s; peak {peak:.2f} GiB; on {card}",
          flush=True)
    profile("train vit update B=32", lambda: step(state, batch),
            steady * 1e3, show_other=6)
    del state

    ref = steps.init_state(copy.deepcopy(model), tx)
    ref, ref_loss = step(ref, batch)
    one = steps.init_state(pm.shard_params(model, mesh), tx)
    one, one_loss = pm.make_train_step(_vit_loss, tx, mesh)(
        one, pm.shard_batch(batch, mesh))
    same = torch.equal(one_loss, ref_loss) and all(
        torch.equal(a, b) for a, b in zip(one.params.parameters(),
                                          ref.params.parameters()))
    print(f"train vit dp x tp step on 1 NCCL rank (dp = tp = 1): loss "
          f"{float(one_loss):.6f}, bit-equal to the unsharded update: "
          f"{same}", flush=True)
    assert same

    # AdamW's first step is lr · g / (|g| + eps), eps = 1e-8: it does not
    # move with g's rounding only where |g| >> eps. Below 100 eps (the key
    # bias's structural zeros, cancelling sums) the two layouts' summation
    # orders move the step by up to 2 lr
    _, grads = steps.value_and_grad(_vit_loss, copy.deepcopy(model), batch)
    names = [n for n, _ in model.named_parameters()]
    g_qkv = torch.stack([g for n, g in zip(names, grads)
                         if n.endswith(".w_qkv")]).abs().cpu()
    noise = g_qkv < 1e-6
    del grads
    t0 = time.perf_counter()
    with RankPool(2, "gloo", "cuda", timeout_s=300) as pool:
        outs = pool.run(_vit_sharded_update, copy.deepcopy(model).cpu(),
                        images.cpu(), labels.cpu(), MeshArg(dp=1, tp=2))
    want_w = torch.stack([b.w_qkv.detach() for b in ref.params.blocks]).cpu()
    for rank, (loss, w_qkv) in enumerate(outs):
        loss_rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        diff = (w_qkv - want_w).abs()
        w_err = float(diff[~noise].max())
        w_noise = float(diff[noise].max()) if noise.any() else 0.0
        print(f"train vit dp x tp step on 2 gloo ranks on cuda:0 (tp = 2), "
              f"rank {rank}: loss relative {loss_rel:.3e} (bar 1e-5), w_qkv "
              f"max|Δ| {w_err:.3e} (bar 1e-5) over the {int((~noise).sum())} "
              f"elements whose gradient is at least 1e-6 (max|g| "
              f"{float(g_qkv.max()):.3e}); the other {int(noise.sum())}: "
              f"max|Δ| {w_noise:.3e} (bar 2 lr = 2e-3); spawn, group and "
              f"the update "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        assert loss_rel <= 1e-5 and w_err <= 1e-5 and w_noise <= 2e-3, (
            rank, loss_rel, w_err, w_noise)


def train_phases(mods, cli, mesh, card: str, timed_phase) -> None:
    """The training phases with every kernel counter at 0 before them;
    they must read 0 after: training runs the plain forwards (the kernels
    compute relevancy cotangents and no weight gradient)."""
    reset_counts(mods)
    timed_phase("train lxmert", lxmert_train_phase, cli, card)
    torch.cuda.empty_cache()
    timed_phase("train detr", detr_train_phase, card)
    torch.cuda.empty_cache()
    timed_phase("train vit", vit_train_phase, mesh, card)
    torch.cuda.empty_cache()
    launched = counts(mods)
    print(f"train phases: kernel launches {launched}", flush=True)
    assert not any(launched.values()), launched


# ---------------------------------------------------------------------------
# the MMF core and data (ROADMAP A5b): cli predict, losses and metrics,
# VisualBERT and LXMERT pretraining on the card
# ---------------------------------------------------------------------------

MMF_WORDS = ["what", "color", "is", "the", "dog", "cat", "how", "many",
             "are", "there", "on", "table", "a", "man", "sky", "red",
             "blue", "sitting", "two", "of", "in", "picture", "?"]
LOSS_REL = 1e-6       # losses, card vs CPU (relative)
PRETRAIN_REL = 1e-5   # pretraining losses after the updates, card vs CPU


def _rel_f(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _mmf_files(root: pathlib.Path, n_q: int, n_img: int) -> dict:
    """From a seed: a BERT ``vocab.txt`` of 30,522 entries (the
    bert-base-uncased special ids, the question words, made-up tokens), a
    VQA2 imdb of ``n_q`` questions (``question_tokens``/``question_str``,
    6-20 words) over ``n_img`` images, one 100×2048 feature ``.npy`` per
    image, and a 3,129-answer vocabulary."""
    import numpy as np

    root.mkdir(parents=True, exist_ok=True)
    (root / "feats").mkdir(exist_ok=True)
    vocab = [f"[unused{i}]" for i in range(30522)]
    vocab[0], vocab[100], vocab[101], vocab[102], vocab[103] = (
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    for i, w in enumerate(MMF_WORDS):
        vocab[1000 + i] = w
    for i in range(1000 + len(MMF_WORDS), 30522):
        vocab[i] = f"tok{i}"
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (root / "answers.txt").write_text("\n".join(
        f"answer{k}" for k in range(3129)) + "\n")
    rng = np.random.RandomState(15)
    rows = [{"dataset_name": "vqa2"}]
    for i in range(n_q):
        toks = list(rng.choice(MMF_WORDS[:-1], rng.randint(5, 20))) + ["?"]
        answers = [f"answer{k}" for k in rng.randint(0, 3129, 10)]
        rows.append({"image_id": i % n_img, "question_id": 90000 + i,
                     "question_tokens": toks, "question_str": " ".join(toks),
                     "answers": answers, "all_answers": answers,
                     "feature_path": f"{i % n_img}.npy"})
    np.save(root / "imdb.npy", np.array(rows, dtype=object))
    for k in range(n_img):
        np.save(root / "feats" / f"{k}.npy",
                rng.rand(100, 2048).astype(np.float32))
    return {name: str(root / f) for name, f in (
        ("imdb", "imdb.npy"), ("feats", "feats"), ("vocab", "vocab.txt"),
        ("answers", "answers.txt"))}


def mmf_predict_phase(cli, files: dict, card: str) -> None:
    """``cli predict --device cuda`` at full width (VISUAL_BERT_VQA2, random
    weights from ``--seed``; B = 32, St = 128, Nv = 100, 256 questions)
    through the registered ``vqa2`` builder, ``bert_tokenizer``, ``collate``,
    the forward, ``prediction.argmax`` and ``TestReporter``: the report has
    256 rows with the imdb's question ids. Then ``predict_visual_bert`` on
    the same weights: predictions/s (median of 3, host included), peak
    memory, the host's share of one batch and a profile; the first 8
    samples' scores on the card within ``SCORE_TOL`` of the CPU's, and the
    report's answers equal to the CPU's argmax wherever the CPU's top-two
    gap exceeds 1e-4."""
    import numpy as np

    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.core.registry import registry
    from transformer_mm_explainability_tpu_torch.harness import predict
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)

    out = ROOT / "build" / "smoke" / "mmf" / "reports"
    argv = ["predict", "--annotations", files["imdb"], "--features",
            files["feats"], "--bert-vocab", files["vocab"],
            "--label2ans", files["answers"], "--report-folder", str(out),
            "--batch-size", "32", "--max-seq-length", "128",
            "--max-features", "100", "--seed", "15", "--device", "cuda"]
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    paths = buf.getvalue().split()
    assert rc == 0 and len(paths) == 1, (rc, paths)
    rows = json.loads(pathlib.Path(paths[0]).read_text())
    want_ids = [90000 + i for i in range(256)]
    assert [r["question_id"] for r in rows] == want_ids, rows[:3]
    print(f"mmf cli predict --device cuda VISUAL_BERT_VQA2 B=32 St=128 "
          f"Nv=100: rc 0, {len(rows)} rows with the imdb's question ids in "
          f"{wall:.1f} s (weights drawn, data read), "
          f"{pathlib.Path(paths[0]).name}", flush=True)

    cfg = vb.VISUAL_BERT_VQA2
    dev = torch.device("cuda")
    params = vb.init_params(15, cfg, dev)   # the cli's weights (--seed 15)
    dataset = registry.get("builder", "vqa2")().load({
        "annotations": files["imdb"], "features": files["feats"],
        "max_features": 100, "processors": {"text_processor": {
            "type": "bert_tokenizer", "params": {
                "tokenizer_config": {"vocab_path": files["vocab"]},
                "max_seq_length": 128}}}}, "test")
    report = str(out / "timed")
    run = lambda: predict.predict_visual_bert(params, cfg, dataset, report,
                                              batch_size=32)
    run()
    torch.cuda.reset_peak_memory_stats()
    per_s = _rate(run, len(dataset))
    peak = torch.cuda.max_memory_allocated() / 2**30
    host, total = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        samples = [dataset[i] for i in range(32)]
        t1 = time.perf_counter()
        predict.batch_scores(params, cfg, samples, dev).cpu()
        t2 = time.perf_counter()
        host.append(t1 - t0)
        total.append(t2 - t0)
    h, t = statistics.median(host), statistics.median(total)
    print(f"mmf predict_visual_bert (cuda, 256 questions, B=32): "
          f"{per_s:.1f} predictions/s (median of 3, host included); peak "
          f"{peak:.2f} GiB; one batch {t * 1e3:.1f} ms, of which reading and "
          f"processing 32 samples on the host {h * 1e3:.1f} ms (host share "
          f"{h / t:.3f}; median of 3); on {card}", flush=True)
    samples = [dataset[i] for i in range(32)]
    fwd_ms = cuda_ms(lambda: predict.batch_scores(params, cfg, samples, dev),
                     iters=5, warmup=1)
    profile("mmf predict batch_scores B=32 (collate, to_device, forward)",
            lambda: predict.batch_scores(params, cfg, samples, dev), fwd_ms,
            show_other=4)

    got = predict.batch_scores(params, cfg, samples[:8], dev).cpu()
    want = predict.batch_scores(params_to(params, "cpu"), cfg, samples[:8],
                                "cpu")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **SCORE_TOL)
    card_rows = json.loads(pathlib.Path(paths[0]).read_text())[:8]
    answers = [ln for ln in pathlib.Path(files["answers"]).read_text()
               .splitlines()]
    top2 = torch.topk(want, 2, dim=1).values
    gap = (top2[:, 0] - top2[:, 1]).numpy()
    cpu_ans = want.argmax(1).numpy()
    held = [i for i in range(8) if gap[i] > 1e-4]
    for i in held:
        assert card_rows[i]["answer"] == answers[int(cpu_ans[i])], (
            i, card_rows[i], cpu_ans[i])
    print(f"mmf predict card vs CPU, first 8 samples: scores max|Δ| "
          f"{err:.3e} (rtol {SCORE_TOL['rtol']:g} / atol "
          f"{SCORE_TOL['atol']:g}); report answers equal to the CPU's "
          f"argmax on {len(held)} of 8 (top-two gap > 1e-4; gaps "
          f"{np.round(gap, 6).tolist()})", flush=True)


def _loss_inputs(gen: torch.Generator) -> dict:
    """name → (sample_list, model_output, params) at B = 32 × 3,129 answers
    (``caption_cross_entropy`` at [32, 20, 30,522]), on the CPU."""
    B, A = 32, 3129
    r = lambda *s: torch.randn(s, generator=gen) * 2.0
    soft = (torch.rand((B, A), generator=gen)
            * (torch.rand((B, A), generator=gen) > 0.995))
    scores = r(B, A)
    probs = torch.sigmoid(r(B, A))
    ce_t = torch.randint(0, A, (B,), generator=gen)
    ce_t[3] = -100
    T, V = 20, 30522
    attn = torch.sigmoid(r(B, 12, 36))
    sup = (torch.rand((B, 12, 36), generator=gen) > 0.5).long()
    m4c_t = (torch.rand((B, 12, 64), generator=gen) > 0.9).float()
    return {
        "logit_bce": ({"targets": soft}, {"scores": scores}, {}),
        "triple_logit_bce": ({"targets": soft}, {"scores": r(B, 3, A)}, {}),
        "bce": ({"targets": soft}, {"scores": probs}, {}),
        "nll_loss": ({"targets": soft},
                     {"scores": torch.log_softmax(scores, 1)}, {}),
        "weighted_softmax": ({"targets": soft}, {"scores": scores}, {}),
        "softmax_kldiv": ({"targets": soft}, {"scores": scores}, {}),
        "wrong": ({"targets": soft}, {"scores": scores}, {}),
        "bce_kl_combined": ({"targets": soft}, {"scores": scores},
                            {"weight_softmax": 0.3}),
        "cross_entropy": ({"targets": ce_t}, {"scores": scores},
                          {"label_smoothing": 0.1}),
        "caption_cross_entropy": (
            {"targets": torch.randint(0, V, (B, T), generator=gen),
             "caption_len": torch.randint(5, T + 1, (B,), generator=gen)},
            {"scores": r(B, T, V)}, {}),
        "attention_supervision": ({"info": {"attention_supervision": sup}},
                                  {"attentions": [attn]}, {}),
        "m4c_decoding_bce_with_mask": (
            {"targets": m4c_t,
             "train_loss_mask": (torch.rand((B, 12), generator=gen)
                                 > 0.3).float()},
            {"scores": r(B, 12, 64)}, {}),
    }


def mmf_losses_phase(card: str) -> None:
    """Every registered loss on cuda tensors (B = 32 × 3,129 answers;
    ``caption_cross_entropy`` at [32, 20, 30,522]) within ``LOSS_REL``
    (relative) of the same call on the CPU, each result on cuda; the tensor
    metrics (``accuracy``, ``vqa_accuracy``, ``top_k_accuracy``,
    ``r@1/5/10``, ``mean_r``, ``mean_rr``) on cuda: the answers they pick
    and the ranks they read equal to the CPU's, every value equal but
    ``vqa_accuracy`` and ``mean_rr``, sums of 32 fp32 terms that the card
    adds in another order (within ``LOSS_REL``). The sklearn and nltk
    metrics run on host numpy and are not run here."""
    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.core import metrics
    from transformer_mm_explainability_tpu_torch.core.registry import registry

    gen = torch.Generator().manual_seed(21)
    inputs = _loss_inputs(gen)
    assert set(inputs) == set(registry.list("loss")), registry.list("loss")
    worst = ("", 0.0)
    for name, (sl, mo, kw) in inputs.items():
        fn = registry.get("loss", name)
        got = fn(params_to(sl, "cuda"), params_to(mo, "cuda"), **kw)
        want = fn(sl, mo, **kw)
        assert got.device.type == "cuda" and torch.isfinite(got), name
        rel = _rel_f(float(got), float(want))
        worst = max(worst, (name, rel), key=lambda x: x[1])
        assert rel <= LOSS_REL, (name, float(got), float(want), rel)
    print(f"mmf losses: {len(inputs)} registered losses on cuda within "
          f"{LOSS_REL:g} of the CPU (worst {worst[0]} {worst[1]:.2e})",
          flush=True)

    B, A = 32, 3129
    scores = torch.randn((B, A), generator=gen)
    # half the rows labelled with their top answer (or one of their top
    # 5), so that no metric reads 0 by construction
    labels = torch.randint(0, A, (B,), generator=gen)
    top5 = torch.topk(scores, 5, dim=1).indices
    labels[:16] = top5[torch.arange(16), torch.arange(16) % 5]
    soft = torch.rand((B, A), generator=gen) * (
        torch.rand((B, A), generator=gen) > 0.99)
    soft[torch.arange(16), top5[:16, 0]] = 0.6
    cand = torch.round(torch.randn((B, 100), generator=gen) * 4) / 4
    gt = torch.randint(0, 100, (B,), generator=gen)
    gt[:16] = torch.topk(cand[:16], 8, dim=1).indices[torch.arange(16),
                                                     torch.arange(16) % 8]
    onehot = torch.nn.functional.one_hot(gt, 100).float()
    cases = [("accuracy", labels, scores, {}),
             ("vqa_accuracy", soft, scores, {}),
             ("top_k_accuracy", labels, scores, {"k": 5}),
             ("r@1", onehot, cand, {}), ("r@5", onehot, cand, {}),
             ("r@10", onehot, cand, {}), ("mean_r", onehot, cand, {}),
             ("mean_rr", onehot, cand, {})]
    vals = []
    for name, t, sc, kw in cases:
        fn = registry.get("metric", name)
        got = fn({"targets": t.cuda()}, {"scores": sc.cuda()}, **kw)
        want = fn({"targets": t}, {"scores": sc}, **kw)
        assert got.device.type == "cuda", name
        if name in ("vqa_accuracy", "mean_rr"):
            rel = _rel_f(float(got), float(want))
            assert rel <= LOSS_REL, (name, float(got), float(want))
        else:
            assert float(got) == float(want), (name, float(got),
                                               float(want))
        vals.append(f"{name} {float(got):.6f} (CPU {float(want):.6f})")
    picks = metrics._masked_unk_softmax(scores.cuda(), 0).argmax(1)
    assert torch.equal(picks.cpu(),
                       metrics._masked_unk_softmax(scores, 0).argmax(1))
    ranks = metrics._ranks(cand.cuda(), onehot.cuda())
    assert torch.equal(ranks.cpu(), metrics._ranks(cand, onehot))
    print(f"mmf tensor metrics on cuda, the picked answers and the ranks "
          f"equal to the CPU's: {', '.join(vals)}; on {card}", flush=True)


def _pretrain_updates(vb, steps_lib, cfg, params, head, batch, dev,
                      n: int = 3) -> list:
    """``n`` AdamW updates (``train/steps.make_adamw``, lr 1e-4) of the
    VisualBERT model and its pretraining head on ``batch``: the losses."""
    tree = steps_lib.tree_map(lambda x: x.detach().clone().to(dev),
                              {"p": params, "h": head})
    b = {k: v.to(dev) for k, v in batch.items()}
    tx = steps_lib.make_adamw(1e-4)
    state = steps_lib.init_state(tree, tx)
    step = steps_lib.make_train_step(
        lambda t, kw: vb.pretrain_forward(t["p"], t["h"], **kw,
                                          cfg=cfg)["loss"], tx)
    return [float(step(state, b)[1]) for _ in range(n)]


def mmf_pretrain_phase(files: dict, card: str) -> None:
    """VisualBERT pretraining on ``masked_vqa2`` samples of the generated
    files (masked_token over the 30,522 vocabulary, St = 128, seeded mask
    RNG; 100 boxes), collated at B = 4: three AdamW updates of
    ``pretrain_forward`` at full width (12 layers) on the card, then the
    same three updates at 2 layers of the same widths on the card and on
    the CPU, each loss within ``PRETRAIN_REL`` (12 layers on the CPU take
    minutes); ``forward_nlvr2`` (2 pairs) and ``forward_bypass`` (B = 2)
    at 12 layers, card against the CPU at ``SCORE_TOL``."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch._device import params_to
    from transformer_mm_explainability_tpu_torch.core.registry import registry
    from transformer_mm_explainability_tpu_torch.core.sample import collate
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)
    from transformer_mm_explainability_tpu_torch.train import (
        steps as steps_lib)

    tok = {"tokenizer_config": {"vocab_path": files["vocab"]},
           "max_seq_length": 128}
    ds = registry.get("builder", "masked_vqa2")().load({
        "annotations": files["imdb"], "features": files["feats"],
        "max_features": 100, "processors": {
            "masked_token_processor": {"type": "masked_token", "params": {
                **tok, "mask_probability": 0.15, "seed": 3}},
            "text_processor": {"type": "bert_tokenizer", "params": tok}}},
        "train")
    sl = collate([ds[i] for i in range(4)]).to_device("cpu")
    batch = {"input_ids": sl["input_ids"], "input_mask": sl["input_mask"],
             "token_type_ids": sl["segment_ids"],
             "masked_lm_labels": sl["lm_label_ids"],
             "visual_embeddings": sl["image_feature_0"]}
    n_masked = int((sl["lm_label_ids"] >= 0).sum())
    cfg = vb.VISUAL_BERT_VQA2
    params = vb.init_params(16, cfg, "cpu")
    head = vb.init_pretrain_params(17, cfg, "cpu")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    full = _pretrain_updates(vb, steps_lib, cfg, params, head, batch, "cuda")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(math.isfinite(x) for x in full), full
    cfg2 = dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, num_hidden_layers=2))
    p2 = dict(params, encoder=steps_lib.tree_map(lambda x: x[:2],
                                                 params["encoder"]))
    runs = {dev: _pretrain_updates(vb, steps_lib, cfg2, p2, head, batch, dev)
            for dev in ("cuda", "cpu")}
    rel = max(_rel_f(a, b) for a, b in zip(runs["cuda"], runs["cpu"]))
    print(f"mmf visual_bert pretraining, masked_vqa2 B=4 St=128 Nv=100 "
          f"({n_masked} masked tokens), 3 AdamW updates: 12 layers on the "
          f"card losses {full} in {full_s:.1f} s, peak {peak:.2f} GiB; 2 "
          f"layers card {runs['cuda']} vs CPU {runs['cpu']}, max relative "
          f"{rel:.2e} (bar {PRETRAIN_REL:g}); on {card}", flush=True)
    assert rel <= PRETRAIN_REL, runs

    dev = torch.device("cuda")
    pc = params_to(params, dev)
    nlvr2 = vb.init_nlvr2_head(18, cfg, device="cpu")
    bypass = vb.init_bypass_layer(19, cfg, "cpu")
    pair = {k: batch[k] for k in ("input_ids", "input_mask",
                                  "visual_embeddings")}
    errs = []
    for name, fn, h, key in (("nlvr2", vb.forward_nlvr2, nlvr2, "scores"),
                             ("bypass", vb.forward_bypass, bypass,
                              "pooled_output")):
        with torch.no_grad():
            got = fn(pc, params_to(h, dev), **{k: v.to(dev)
                                               for k, v in pair.items()},
                     cfg=cfg)[key].cpu()
            want = fn(params, h, **pair, cfg=cfg)[key]
        torch.testing.assert_close(got, want, **SCORE_TOL)
        errs.append(f"{name} {key} {tuple(got.shape)} max|Δ| "
                    f"{float((got - want).abs().max()):.2e}")
    print(f"mmf visual_bert heads at 12 layers, card vs CPU: "
          f"{'; '.join(errs)} (rtol {SCORE_TOL['rtol']:g} / atol "
          f"{SCORE_TOL['atol']:g})", flush=True)


def mmf_lxmert_pretrain_phase(files: dict, card: str) -> None:
    """LXMERT pretraining over the real data module: ``LXMERTDataset`` and
    ``AnswerTable`` (3,129 answers) over generated JSON, 16 sentences on 8
    images of 36 2048-d boxes, ``LXMERTPretrainData`` with the matched-task
    swap; two updates of ``train/lxmert_pretrain_loop.train`` (B = 8,
    St = 20, BertAdam) at full width (9/5/5 layers) on the card, then the
    same two at 2/2/2 layers on the card and the CPU, each loss's mean
    within ``PRETRAIN_REL``."""
    import dataclasses

    import numpy as np

    from transformer_mm_explainability_tpu_torch.data import (
        lxmert_pretrain_data as lpd)
    from transformer_mm_explainability_tpu_torch.data import qa_answer_table
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx
    from transformer_mm_explainability_tpu_torch.train import (
        lxmert_pretrain_loop as loop)

    root = ROOT / "build" / "smoke" / "mmf" / "lxmert"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(22)
    answers = [f"answer{k}" for k in range(3129)]
    (root / "all_ans.json").write_text(json.dumps(
        [{"ans": a, "dsets": ["vqa", "gqa"]} for a in answers]))
    data = []
    for i in range(8):
        sents = [" ".join(rng.choice(MMF_WORDS[:-1], rng.randint(4, 12)))
                 for _ in range(2)]
        data.append({"img_id": f"img{i}",
                     "sentf": {"mscoco": sents[:1], "vqa": sents[1:]},
                     "labelf": {"vqa": [{answers[rng.randint(3129)]: 1.0,
                                         answers[rng.randint(3129)]: 0.3}]}})
    (root / "train.json").write_text(json.dumps(data))
    table = qa_answer_table.AnswerTable(
        all_ans_path=str(root / "all_ans.json"))
    dataset = lpd.LXMERTDataset("train", data_root=str(root),
                                answer_table=table)
    img_data = [{"img_id": f"img{i}", "img_h": 480, "img_w": 640,
                 "num_boxes": 36,
                 "features": rng.rand(36, 2048).astype(np.float32),
                 "boxes": (rng.rand(36, 4) * [640, 480, 640, 480]).astype(
                     np.float32),
                 "objects_id": rng.randint(0, 1600, 36),
                 "objects_conf": rng.rand(36).astype(np.float32),
                 "attrs_id": rng.randint(0, 400, 36),
                 "attrs_conf": rng.rand(36).astype(np.float32)}
                for i in range(8)]
    tokenizer = BertTokenizer(files["vocab"])
    pt = loop.PretrainConfig(epochs=1, batch_size=8, max_seq_length=20)

    def run(cfg, dev):
        data = lpd.LXMERTPretrainData(dataset, img_data, task_matched=True,
                                      seed=5)
        assert len(data) == 16
        out = loop.train(data, tokenizer, cfg, pt, seed=23,
                         printer=lambda *_: None, device=dev)
        return out["history"][0]

    t0 = time.perf_counter()
    full = run(lx.LXMERT_VQA, "cuda")
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    assert all(math.isfinite(v) for v in full.values()), full
    small = dataclasses.replace(lx.LXMERT_VQA, l_layers=2, x_layers=2,
                                r_layers=2)
    got, want = run(small, "cuda"), run(small, "cpu")
    rel = max(_rel_f(got[k], want[k]) for k in want)
    fmt = lambda d: ", ".join(f"{k} {v:.5f}" for k, v in sorted(d.items()))
    print(f"mmf lxmert pretraining over LXMERTPretrainData + AnswerTable "
          f"(16 sentences, 8 images × 36 boxes, matched-task swap), 2 "
          f"BertAdam updates B=8 St=20: 9/5/5 layers on the card ({fmt(full)}) "
          f"in {full_s:.1f} s; 2/2/2 layers card ({fmt(got)}) vs CPU "
          f"({fmt(want)}), max relative {rel:.2e} (bar {PRETRAIN_REL:g}); on "
          f"{card}", flush=True)
    assert rel <= PRETRAIN_REL, (got, want)


def mmf_phases(mods, cli, card: str, timed_phase) -> None:
    """The MMF phase group, every kernel counter at 0 before it; they must
    read 0 after: VisualBERT and LXMERT run their plain forwards here."""
    reset_counts(mods)
    t0 = time.perf_counter()
    files = _mmf_files(ROOT / "build" / "smoke" / "mmf", 256, 64)
    print(f"mmf files: vocab 30,522, imdb 256 questions, 64 × 100×2048 "
          f"features in {time.perf_counter() - t0:.1f} s", flush=True)
    timed_phase("mmf predict", mmf_predict_phase, cli, files, card)
    torch.cuda.empty_cache()
    timed_phase("mmf losses + metrics", mmf_losses_phase, card)
    timed_phase("mmf visual_bert pretrain", mmf_pretrain_phase, files, card)
    torch.cuda.empty_cache()
    timed_phase("mmf lxmert pretrain", mmf_lxmert_pretrain_phase, files,
                card)
    torch.cuda.empty_cache()
    launched = counts(mods)
    print(f"mmf phases (predict, losses, pretrain): "
          f"{time.perf_counter() - t0:.1f} s; kernel launches {launched}",
          flush=True)
    assert not any(launched.values()), launched


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
    from transformer_mm_explainability_tpu_torch.explain import detr as edetr
    from transformer_mm_explainability_tpu_torch.harness import detr_eval
    from transformer_mm_explainability_tpu_torch.harness import detr_segm
    from transformer_mm_explainability_tpu_torch.models import detr
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
    from transformer_mm_explainability_tpu_torch.tools import (
        semantic_validation as sv)
    from transformer_mm_explainability_tpu_torch.tools import (
        verify_parity as vp)
    import torch.distributed as dist

    from transformer_mm_explainability_tpu_torch.parallel.launch import (
        free_port)
    from transformer_mm_explainability_tpu_torch.parallel.mesh import (
        make_mesh)

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
    launches["roi_pool_pallas"], dets, detect = timed_phase(
        "frcnn", frcnn_phase, mods, frcnn, rpool, card)
    torch.cuda.empty_cache()
    timed_phase("lxmert", lxmert_phase, lx, pert_runner, dets, card)
    timed_phase("lxmert lrp", lxmert_lrp_phase, mods, lx, pert_runner,
                detect, card)
    del detect
    timed_phase("lxmert cli + example", lxmert_cli_phase, cli, example,
                rpool)
    torch.cuda.empty_cache()
    timed_phase("visual_bert", visual_bert_phase, mods, vb, evb,
                pert_runner, card)
    timed_phase("visual_bert lrp", visual_bert_lrp_phase, mods, vb, evb,
                pert_runner, card)
    timed_phase("visual_bert cli", visual_bert_cli_phase, mods, cli)
    torch.cuda.empty_cache()
    timed_phase("clip", clip_phase, mods, clip, eclip, bpe, img_ops, card)
    timed_phase("clip cli", clip_cli_phase, mods, cli)
    torch.cuda.empty_cache()
    timed_phase("detr", detr_phase, mods, detr, edetr, detr_segm, detr_eval,
                card)
    torch.cuda.empty_cache()
    timed_phase("detr lrp", detr_lrp_phase, mods, detr, edetr, detr_segm,
                detr_eval, card)
    timed_phase("detr cli", detr_cli_phase, mods, cli, detr, detr_eval,
                detr_segm)
    torch.cuda.empty_cache()
    timed_phase("parity", parity_phase, mods, cli, vp, vit, rp, card)
    torch.cuda.empty_cache()
    timed_phase("semantic", semantic_phase, sv, card)
    timed_phase("entry points", entry_points_phase, mods, card)
    torch.cuda.empty_cache()
    # launches on the paths outside the main one, by kernel
    other = {name: {} for name in KERNELS}
    for name, n in timed_phase("bench", bench_phase, mods, cli,
                               card).items():
        other[name]["cli bench"] = n
    other["roi_pool_pallas"]["bench_families frcnn"] = timed_phase(
        "bench families", bench_families_phase, mods, card)
    torch.cuda.empty_cache()
    other["roi_pool_pallas"]["protocol-rehearsal lxmert"] = timed_phase(
        "protocol rehearsal", rehearsal_phase, mods, cli, card)
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        timed_phase("sp", sp_phase, mesh, card)
        torch.cuda.empty_cache()
        for name, n in timed_phase("sharded example", sharded_example_phase,
                                   mods, vit, mesh, card).items():
            other[name]["sharded_relevancy --fused"] = n
        train_phases(mods, cli, mesh, card, timed_phase)
        for name in KERNELS:
            other[name]["train (lxmert cli, detr, vit)"] = 0
    finally:
        dist.destroy_process_group()
    mmf_phases(mods, cli, card, timed_phase)
    for name in KERNELS:
        other[name]["mmf (predict, losses, pretrain)"] = 0
    print(f"phases: {sum(phase_s.values()):.1f} s in all", flush=True)
    for name, n in launches.items():
        rows[name]["launches"] = n
        rows[name]["launches_other_paths"] = other[name]

    assert set(rows) == set(KERNELS) and all("launches" in r
                                             for r in rows.values())
    print(json.dumps({"kernels": [rows[name] for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
