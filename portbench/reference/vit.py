"""Plain ViT (timm ``vit_base_patch16_224``'s architecture, Dosovitskiy et
al. 2021) and the ViT notebook's ``generate_relevance``, in PyTorch.

Layouts are the benchmark's, which the port's ``models/vit.py`` shares:
images ``[B, H, W, 3]`` (normalised), weights ``[in, out]``, the patch
embedding a ``[P·P·3, D]`` matrix over patches flattened in (row, column,
channel) order (timm's stride-P convolution with its kernel flattened so),
the fused qkv projection's columns q | k | v, each heads-major. Pre-LN
blocks, exact GELU, LayerNorm ε from the configuration, the class token
first.

The map of image b for class ``targets[b]``: one forward with a zero tap
added to every layer's attention probabilities A, one backward of
Σ_b logits[b, targets[b]] to the taps (∇A), then rule 5 and rule 6
(``common.rule6_row``) and row 0 (the class token) without its own column.
Computed in blocks of ``block`` images.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.core import seeds
from portbench.reference import common


def layout(cfg) -> List[seeds.Leaf]:
    """The weights and how each is drawn: normal (std ``init_std``) for the
    products, the class token and the position table; LayerNorm at
    identity; zero biases."""
    D, I, P = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    S = (cfg["image_size"] // P) ** 2 + 1
    out = [("patch_w", (P * P * 3, D), "normal"), ("patch_b", (D,), "zeros"),
           ("cls", (1, D), "normal"), ("pos", (S, D), "normal")]
    for l in range(cfg["num_hidden_layers"]):
        out += [(f"{l}.ln1_scale", (D,), "ones"),
                (f"{l}.ln1_bias", (D,), "zeros"),
                (f"{l}.w_qkv", (D, 3 * D), "normal"),
                (f"{l}.b_qkv", (3 * D,), "zeros"),
                (f"{l}.w_out", (D, D), "normal"),
                (f"{l}.b_out", (D,), "zeros"),
                (f"{l}.ln2_scale", (D,), "ones"),
                (f"{l}.ln2_bias", (D,), "zeros"),
                (f"{l}.w1", (D, I), "normal"), (f"{l}.b1", (I,), "zeros"),
                (f"{l}.w2", (I, D), "normal"), (f"{l}.b2", (D,), "zeros")]
    out += [("norm_scale", (D,), "ones"), ("norm_bias", (D,), "zeros"),
            ("head_w", (D, cfg["num_classes"]), "normal"),
            ("head_b", (cfg["num_classes"],), "zeros")]
    return out


def weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    return seeds.draw_leaves(layout(cfg), seed, device, cfg["init_std"])


def _forward(w, cfg, images, taps, tf32: bool):
    """(logits, A per layer); ``taps`` [L, B, H, S, S] added to A."""
    mm = lambda a, b: common.matmul(a, b, tf32)
    D, H, P = cfg["hidden_size"], cfg["num_attention_heads"], cfg["patch_size"]
    eps = cfg["layer_norm_eps"]
    B, Hi, Wi, C = images.shape
    g = Hi // P
    patches = images.reshape(B, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5)
    x = mm(patches.reshape(B, g * g, P * P * C), w["patch_w"]) + w["patch_b"]
    x = torch.cat([w["cls"].expand(B, 1, D), x], dim=1) + w["pos"]
    S, dh = x.shape[1], D // H
    attn = []
    for l in range(cfg["num_hidden_layers"]):
        p = lambda k: w[f"{l}.{k}"]
        h = common.layer_norm(x, p("ln1_scale"), p("ln1_bias"), eps)
        qkv = mm(h, p("w_qkv")) + p("b_qkv")
        q, k, v = qkv.view(B, S, 3, H, dh).permute(2, 0, 3, 1, 4)
        a = torch.softmax(mm(q, k.transpose(-1, -2)) / math.sqrt(dh), dim=-1)
        o = mm(a + taps[l], v).transpose(1, 2).reshape(B, S, D)
        x = x + mm(o, p("w_out")) + p("b_out")
        h = common.layer_norm(x, p("ln2_scale"), p("ln2_bias"), eps)
        x = x + mm(common.gelu(mm(h, p("w1")) + p("b1")), p("w2")) + p("b2")
        attn.append(a)
    x = common.layer_norm(x, w["norm_scale"], w["norm_bias"], eps)
    return mm(x[:, 0], w["head_w"]) + w["head_b"], torch.stack(attn)


def relevancy(w, cfg, images, targets, tf32: bool = False,
              block: int = 8) -> torch.Tensor:
    """``[B, S - 1]`` maps, ``block`` images at a time."""
    return torch.cat([_relevancy(w, cfg, images[i:i + block],
                                 targets[i:i + block], tf32)
                      for i in range(0, images.shape[0], block)])


def _relevancy(w, cfg, images, targets, tf32):
    B = images.shape[0]
    L, H = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    S = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    taps = torch.zeros((L, B, H, S, S), device=images.device,
                       requires_grad=True)
    with torch.enable_grad():
        logits, attn = _forward(w, cfg, images, taps, tf32)
        score = logits.gather(1, targets.long()[:, None]).sum()
        (grads,) = torch.autograd.grad(score, taps)
    row = torch.zeros(B, dtype=torch.long, device=images.device)
    with torch.no_grad():
        return common.rule6_row(attn.detach(), grads, row, tf32)[:, 1:]
