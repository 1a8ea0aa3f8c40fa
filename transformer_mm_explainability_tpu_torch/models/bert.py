"""BERT encoder (post-LN, HF layout) with attention capture, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/bert.py``: the
layer shape that LXMERT's language and relational stacks reuse. Layers are
stacked along a leading axis, as in the JAX tree (``attn`` an
``AttentionParams`` of ``[L, ...]`` tensors, ``attn_ln``, ``mlp``,
``mlp_ln``), and run in a Python loop; every attention adds its capture
tap to the probabilities (``ops/attention``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams,
    gelu,
    layer_norm,
    multi_head_self_attention,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


BERT_BASE = BertConfig()


def _generator(seed: Union[int, torch.Generator]) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))


def _normal(gen: torch.Generator, device, *shape, s: float = 0.02):
    return (torch.randn(shape, generator=gen) * s).to(device)


def init_encoder_params(seed: Union[int, torch.Generator], cfg: BertConfig,
                        device="cuda") -> Dict[str, Any]:
    """Stacked encoder weights (normal, std 0.02; zero biases; LN at
    identity), drawn on the CPU from ``seed``."""
    gen = _generator(seed)
    D, L, Dm = cfg.hidden_size, cfg.num_hidden_layers, cfg.intermediate_size
    nrm = lambda *shape: _normal(gen, device, *shape)
    zeros = lambda *shape: torch.zeros(shape, device=device)
    ones = lambda *shape: torch.ones(shape, device=device)
    return {
        "attn": AttentionParams(
            w_qkv=nrm(L, D, 3 * D), b_qkv=zeros(L, 3 * D),
            w_out=nrm(L, D, D), b_out=zeros(L, D)),
        "attn_ln": {"scale": ones(L, D), "bias": zeros(L, D)},
        "mlp": {"w1": nrm(L, D, Dm), "b1": zeros(L, Dm),
                "w2": nrm(L, Dm, D), "b2": zeros(L, D)},
        "mlp_ln": {"scale": ones(L, D), "bias": zeros(L, D)},
    }


def init_embedding_params(seed: Union[int, torch.Generator], cfg: BertConfig,
                          device="cuda") -> Dict[str, Any]:
    gen = _generator(seed)
    D = cfg.hidden_size
    nrm = lambda *shape: _normal(gen, device, *shape)
    return {
        "word": nrm(cfg.vocab_size, D),
        "position": nrm(cfg.max_position_embeddings, D),
        "token_type": nrm(cfg.type_vocab_size, D),
        "ln": {"scale": torch.ones(D, device=device),
               "bias": torch.zeros(D, device=device)},
    }


def extended_attention_mask(input_mask: torch.Tensor,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """``[B, S]`` {0,1} mask → additive ``[B, 1, 1, S]`` bias with −10000
    at pads (HF/MMF exactly: −10000, not −inf)."""
    m = input_mask.to(dtype)
    return ((1.0 - m) * -10000.0)[:, None, None, :]


def unstack(params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree (NamedTuples and dicts of ``[L, ...]``
    tensors)."""
    if hasattr(params, "_fields"):
        return type(params)(*(t[i] for t in params))
    if isinstance(params, dict):
        return {k: unstack(v, i) for k, v in params.items()}
    return params[i]


def encoder(params: Dict[str, Any], hidden: torch.Tensor, cfg: BertConfig,
            mask: Optional[torch.Tensor] = None,
            taps: Optional[torch.Tensor] = None, return_tape: bool = False):
    """Post-LN BERT encoder over stacked layers.

    hidden: ``[B, S, D]``; mask: additive ``[B, 1, 1, S]``; taps
    ``[L, B, H, S, S]`` (optional). Returns ``(hidden, attn_probs
    [L, B, H, S, S])``, plus the per-layer input tape ``[L, B, S, D]`` when
    ``return_tape``."""
    probs, tape = [], []
    for i in range(cfg.num_hidden_layers):
        p = unstack({k: params[k] for k in ("attn", "attn_ln", "mlp",
                                           "mlp_ln")}, i)
        tape.append(hidden)
        attn_out, pr = multi_head_self_attention(
            p["attn"], hidden, cfg.num_attention_heads, mask=mask,
            tap=None if taps is None else taps[i])
        x = layer_norm(hidden + attn_out, p["attn_ln"]["scale"],
                       p["attn_ln"]["bias"], cfg.layer_norm_eps)
        h = gelu(x @ p["mlp"]["w1"] + p["mlp"]["b1"])
        h = h @ p["mlp"]["w2"] + p["mlp"]["b2"]
        hidden = layer_norm(x + h, p["mlp_ln"]["scale"], p["mlp_ln"]["bias"],
                            cfg.layer_norm_eps)
        probs.append(pr)
    if return_tape:
        return hidden, torch.stack(probs), torch.stack(tape)
    return hidden, torch.stack(probs)


def text_embeddings(params: Dict[str, Any], input_ids: torch.Tensor,
                    token_type_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """word + position + token-type embeddings (no LN: callers apply it)."""
    S = input_ids.shape[1]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    pos_ids = torch.arange(S, device=input_ids.device)[None, :]
    return (params["word"][input_ids.long()]
            + params["position"][pos_ids]
            + params["token_type"][token_type_ids.long()])
