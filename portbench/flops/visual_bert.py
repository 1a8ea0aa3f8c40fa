"""Work counts of VisualBERT on VQA2 (``configs/visual_bert_vqa2.json``'s
keys). The text is padded to ``max_seq_length`` as MMF's processor pads
it, so every sequence holds that many text tokens and its boxes.
"""

from __future__ import annotations

from typing import Dict, Sequence

from portbench.reference.visual_bert import num_keep


def forward_per_sample(cfg: Dict, boxes: int) -> float:
    """One forward over the padded text and ``boxes`` boxes: the boxes'
    projection, per layer the qkv, attention, output and MLP products, and
    the pooled token's head."""
    D, I, L = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    S = cfg["max_seq_length"] + boxes
    layer = 2 * S * D * 3 * D + 4 * S * S * D + 2 * S * D * D + 4 * S * D * I
    return (2 * boxes * cfg["visual_embedding_dim"] * D + L * layer
            + 2 * D * D + 2 * D * cfg["num_labels"])


def explain_per_map(cfg: Dict) -> float:
    """The forward with every box, then the cotangents the row needs (the
    head's; per layer the MLP's, the output projection's and ∇A; above the
    first layer those of v, q, k and the qkv input too) and the rule-6 row
    fold."""
    D, I, L = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["num_hidden_layers"])
    S = cfg["max_seq_length"] + cfg["max_features"]
    first = 4 * S * D * I + 2 * S * D * D + 2 * S * S * D
    upper = first + 6 * S * S * D + 2 * S * 3 * D * D
    head = 2 * D * cfg["num_labels"] + 2 * D * D
    return (forward_per_sample(cfg, cfg["max_features"]) + head + first
            + (L - 1) * upper + L * 2 * S * S)


def perturb_per_sample(cfg: Dict, steps: Sequence[float]) -> float:
    """One explanation, then one forward a step with only the kept boxes."""
    return explain_per_map(cfg) + sum(
        forward_per_sample(cfg, k)
        for k in num_keep(steps, cfg["max_features"]))
