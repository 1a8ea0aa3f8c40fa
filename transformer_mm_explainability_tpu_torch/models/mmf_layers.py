"""The MMF module library (Pythia / LoRRA / BUTD / BAN / CNN-LSTM /
TopDownBottomUp building blocks), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/mmf_layers.py``
(itself a functional redesign of ``mmf/modules/{layers,attention,
embeddings}.py``). Every block is an ``init_*`` / ``*_fwd`` pair over a
parameter tree of the JAX tree's layout: linears keep torch's ``[out, in]``
weight (``x @ w.T + b``), weight-norm layers keep ``(v, g)`` with a scalar
``g`` for ``dim=None`` and ``g [out]`` for ``dim=0``, convolutions are NCHW
with OIHW kernels. So one generic converter carries a JAX tree across
(``utils/convert.mmf_from_jax_numpy``).

The JAX ``lax.scan`` recurrent nets keep torch's gate order (LSTM i, f,
g, o; GRU r, z, n with ``b_hn`` inside the reset gate), so a whole
sequence runs through torch's own ``nn.LSTM`` / ``nn.GRU`` (cuDNN on the
card) on the tree's four tensors per direction; ``lstm_cell`` keeps one
step for BUTD's decoder. Inits draw on the CPU from a ``torch.Generator``
(or an int seed) and move to ``device``; dropout is omitted (eval
semantics).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]
Seed = Union[int, torch.Generator]


def generator(seed: Seed) -> torch.Generator:
    return seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            device="cuda") -> torch.Tensor:
    return (torch.rand(tuple(shape), generator=gen) * (hi - lo) + lo
            ).to(device)


def normal(gen: torch.Generator, shape, std: float = 1.0,
           device="cuda") -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen) * std).to(device)


def l2_norm(x: torch.Tensor, dim=None, keepdim: bool = False
            ) -> torch.Tensor:
    """√(Σ x²), over all of ``x`` or over ``dim``, as the JAX package's
    ``jnp.linalg.norm`` computes it. (PyTorch's own norm lost 7e-4 of a
    5,000 × 4,096 weight's norm on the CPU in fp32; this sum keeps 1e-7.)"""
    sq = x * x
    return torch.sqrt(sq.sum() if dim is None else sq.sum(dim=dim,
                                                           keepdim=keepdim))


def ln_init(d: int, device="cuda") -> Params:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def bn_init(d: int, device="cuda") -> Params:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device),
            "mean": torch.zeros(d, device=device),
            "var": torch.ones(d, device=device)}


# ---------------------------------------------------------------------------
# linears
# ---------------------------------------------------------------------------

def init_linear(seed: Seed, in_dim: int, out_dim: int,
                device="cuda") -> Params:
    """torch nn.Linear's default init (uniform, bound 1/√in), ``w [out,
    in]``."""
    gen = generator(seed)
    bound = 1.0 / math.sqrt(in_dim)
    return {"w": uniform(gen, (out_dim, in_dim), -bound, bound, device),
            "b": uniform(gen, (out_dim,), -bound, bound, device)}


def linear_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].T + p["b"]


def init_weight_norm_fc(seed: Seed, in_dim: int, out_dim: int,
                        device="cuda") -> Params:
    """weight_norm(nn.Linear, dim=None): ``v [out, in]``, scalar ``g`` =
    ‖v‖_F at init."""
    p = init_linear(seed, in_dim, out_dim, device)
    return {"v": p["w"], "g": l2_norm(p["w"]), "b": p["b"]}


def weight_norm_fc_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ (g·v/‖v‖_F)ᵀ + b."""
    w = p["v"] * (p["g"] / l2_norm(p["v"]))
    return x @ w.T + p["b"]


def init_weight_norm_fc_dim0(seed: Seed, in_dim: int, out_dim: int,
                             device="cuda") -> Params:
    """weight_norm(nn.Linear) with the default dim=0: ``g [out]``."""
    p = init_linear(seed, in_dim, out_dim, device)
    return {"v": p["w"], "g": l2_norm(p["w"], dim=1),
            "b": p["b"]}


def weight_norm_fc_dim0_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["v"] * (p["g"] / l2_norm(p["v"], dim=1))[:, None]
    return x @ w.T + p["b"]


def init_relu_weight_norm_fc(seed: Seed, in_dim: int, out_dim: int,
                             device="cuda") -> Params:
    """ReLUWithWeightNormFC (layers.py:86-97)."""
    return init_weight_norm_fc(seed, in_dim, out_dim, device)


def relu_weight_norm_fc_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.relu(weight_norm_fc_fwd(p, x))


def init_gated_tanh(seed: Seed, in_dim: int, out_dim: int,
                    device="cuda") -> Params:
    """GatedTanh (layers.py:59-84): tanh(Wx+b) · sigmoid(W'x+b')."""
    gen = generator(seed)
    return {"fc": init_linear(gen, in_dim, out_dim, device),
            "gate": init_linear(gen, in_dim, out_dim, device)}


def gated_tanh_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(linear_fwd(p["fc"], x)) * torch.sigmoid(
        linear_fwd(p["gate"], x))


# ---------------------------------------------------------------------------
# recurrent cores (torch's nn.LSTM / nn.GRU on the tree's tensors)
# ---------------------------------------------------------------------------

def _init_rnn(seed: Seed, gates: int, input_size: int, hidden_size: int,
              device) -> Params:
    gen = generator(seed)
    bound = 1.0 / math.sqrt(hidden_size)
    u = lambda *shape: uniform(gen, shape, -bound, bound, device)
    return {"w_ih": u(gates * hidden_size, input_size),
            "w_hh": u(gates * hidden_size, hidden_size),
            "b_ih": u(gates * hidden_size),
            "b_hh": u(gates * hidden_size)}


def init_lstm(seed: Seed, input_size: int, hidden_size: int,
              device="cuda") -> Params:
    """One torch nn.LSTM layer (gates i, f, g, o; two bias vectors)."""
    return _init_rnn(seed, 4, input_size, hidden_size, device)


def lstm_cell(p: Params, x_proj: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step on the projected input ``x @ W_ihᵀ + b_ih``."""
    gates = x_proj + h @ p["w_hh"].T + p["b_hh"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def lstm_cell_fwd(p: Params, x: torch.Tensor, h: torch.Tensor,
                  c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """nn.LSTMCell on an unprojected input."""
    return lstm_cell(p, x @ p["w_ih"].T + p["b_ih"], h, c)


_RNN_MODULES = {"lstm": torch.nn.LSTM, "gru": torch.nn.GRU}


@functools.lru_cache(maxsize=None)
def _rnn_module(kind: str, input_size: int, hidden_size: int,
                bidirectional: bool) -> torch.nn.Module:
    """A weightless (``meta``) ``nn.LSTM`` / ``nn.GRU`` of this shape, one
    per shape; ``rnn_fwd`` runs it on the tree's tensors."""
    return _RNN_MODULES[kind](input_size, hidden_size, batch_first=True,
                              bidirectional=bidirectional, device="meta")


def rnn_fwd(kind: str, dirs: Sequence[Params], x: torch.Tensor
            ) -> torch.Tensor:
    """torch's own ``nn.LSTM`` / ``nn.GRU`` (``kind``) over ``x [B, T, E]``
    from zero states, with one direction's tree (``[B, T, H]``) or the
    forward and backward trees (``[B, T, 2H]``, the backward half in input
    order)."""
    mod = _rnn_module(kind, x.shape[-1], dirs[0]["w_hh"].shape[1],
                      len(dirs) == 2)
    weights = {f"{name}_l0{suffix}": d[key]
               for d, suffix in zip(dirs, ("", "_reverse"))
               for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                 ("bias_ih", "b_ih"), ("bias_hh", "b_hh"))}
    return torch.func.functional_call(mod, weights, (x,))[0]


def _one_direction(kind: str, p: Params, x: torch.Tensor, reverse: bool
                   ) -> torch.Tensor:
    if reverse:
        return rnn_fwd(kind, [p], x.flip(1)).flip(1)
    return rnn_fwd(kind, [p], x)


def lstm_fwd(p: Params, x: torch.Tensor, reverse: bool = False
             ) -> torch.Tensor:
    """One LSTM direction over ``[B, T, E]`` → ``[B, T, H]`` (``reverse``:
    from the last step back, outputs in input order)."""
    return _one_direction("lstm", p, x, reverse)


def init_gru(seed: Seed, input_size: int, hidden_size: int,
             device="cuda") -> Params:
    """One torch nn.GRU layer (gates r, z, n; ``b_hn`` inside r)."""
    return _init_rnn(seed, 3, input_size, hidden_size, device)


def gru_fwd(p: Params, x: torch.Tensor, reverse: bool = False
            ) -> torch.Tensor:
    """``[B, T, E]`` → ``[B, T, H]``, n = tanh(W_in x + b_in + r·(W_hn h +
    b_hn))."""
    return _one_direction("gru", p, x, reverse)


def init_birnn(seed: Seed, init_one, input_size: int, hidden_size: int,
               bidirectional: bool, device="cuda") -> Params:
    gen = generator(seed)
    p = {"fwd": init_one(gen, input_size, hidden_size, device)}
    if bidirectional:
        p["bwd"] = init_one(gen, input_size, hidden_size, device)
    return p


def birnn_fwd(p: Params, kind: str, x: torch.Tensor) -> torch.Tensor:
    """``init_birnn``'s tree through one ``rnn_fwd``: ``[B, T, H]``, or
    ``[B, T, 2H]`` with a backward direction."""
    return rnn_fwd(kind, [p["fwd"]] + ([p["bwd"]] if "bwd" in p else []), x)


# ---------------------------------------------------------------------------
# text embeddings
# ---------------------------------------------------------------------------

def init_attention_text_embedding(seed: Seed, hidden_dim: int,
                                  embedding_dim: int, conv1_out: int,
                                  conv2_out: int, bidirectional: bool = False,
                                  device="cuda") -> Params:
    """AttentionTextEmbedding (embeddings.py:132-190): LSTM → two k=1
    convs (stored as ``[out, in]`` linears) → softmax over T per glimpse →
    glimpse-weighted sums."""
    gen = generator(seed)
    H = hidden_dim // 2 if bidirectional else hidden_dim
    return {
        "lstm": init_birnn(gen, init_lstm, embedding_dim, H, bidirectional,
                           device),
        "conv1": init_linear(gen, hidden_dim, conv1_out, device),
        "conv2": init_linear(gen, conv1_out, conv2_out, device),
    }


def attention_text_embedding_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x [B, T, E]`` word vectors → ``[B, conv2_out · hidden_dim]``."""
    lstm_out = birnn_fwd(p["lstm"], "lstm", x)
    a = torch.relu(torch.einsum("bth,oh->bto", lstm_out, p["conv1"]["w"])
                   + p["conv1"]["b"])
    a = torch.einsum("btc,oc->bto", a, p["conv2"]["w"]) + p["conv2"]["b"]
    att = torch.softmax(a, dim=1)
    feat = torch.einsum("btg,bth->bgh", att, lstm_out)
    return feat.reshape(feat.shape[0], -1)


def init_bilstm_text_embedding(seed: Seed, hidden_dim: int,
                               embedding_dim: int, bidirectional: bool,
                               rnn_type: str = "GRU",
                               device="cuda") -> Params:
    init_one = init_lstm if rnn_type == "LSTM" else init_gru
    return {"rnn": init_birnn(seed, init_one, embedding_dim, hidden_dim,
                              bidirectional, device)}


def bilstm_text_embedding_forward_all(p: Params, x: torch.Tensor,
                                      rnn_type: str = "GRU") -> torch.Tensor:
    """Every timestep's state (``rnn_type`` is config, not a leaf)."""
    return birnn_fwd(p["rnn"], rnn_type.lower(), x)


def bilstm_text_embedding_fwd(p: Params, x: torch.Tensor,
                              rnn_type: str = "GRU",
                              bidirectional: bool = True) -> torch.Tensor:
    """BiLSTMTextEmbedding.forward (embeddings.py:99-107), the documented
    intent as the JAX package implements it: bidirectional → [last forward
    state ‖ first backward state], else the last state."""
    out = bilstm_text_embedding_forward_all(p, x, rnn_type)
    if not bidirectional:
        return out[:, -1]
    H = out.shape[-1] // 2
    return torch.cat([out[:, -1, :H], out[:, 0, H:]], dim=1)


def init_vocab_embedding(seed: Seed, vocab_size: int, embedding_dim: int,
                         vectors=None, device="cuda") -> Params:
    """VocabEmbedding (embeddings.py:59-68), optionally from vectors."""
    if vectors is not None:
        return {"table": torch.as_tensor(np.asarray(vectors, np.float32),
                                         device=device)}
    return {"table": normal(generator(seed), (vocab_size, embedding_dim),
                            device=device)}


def vocab_embedding_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    return p["table"][x.long()]


class PreExtractedEmbedding:
    """PreExtractedEmbedding (embeddings.py:114-129): per-qid ``.npy``
    files read on the host through an LRU cache; a call stacks one batch
    and moves it to ``device``."""

    def __init__(self, out_dim: int, base_path: str, cache_size: int = 5000,
                 device="cuda"):
        self.text_out_dim = out_dim
        self.base_path = base_path
        self.device = device

        @functools.lru_cache(maxsize=cache_size)
        def get_item(qid: int):
            return np.load(os.path.join(base_path, f"{qid}.npy"))

        self.get_item = get_item

    def __call__(self, qids) -> torch.Tensor:
        return torch.as_tensor(
            np.stack([self.get_item(int(q)) for q in qids], axis=0),
            device=self.device)


def init_multi_head_image_feature_embedding(seed: Seed, img_dim: int,
                                            question_dim: int,
                                            num_heads: int,
                                            device="cuda") -> Params:
    """MultiHeadImageFeatureEmbedding (embeddings.py:264-282): torch
    nn.MultiheadAttention(question_dim, kdim=vdim=img_dim), xavier-uniform
    projections, zero biases. ``num_heads`` is passed to the forward."""
    gen = generator(seed)

    def xavier(shape):
        bound = math.sqrt(6.0 / (shape[0] + shape[1]))
        return uniform(gen, shape, -bound, bound, device)

    D, E = question_dim, img_dim
    z = lambda: torch.zeros(D, device=device)
    return {"q": {"w": xavier((D, D)), "b": z()},
            "k": {"w": xavier((D, E)), "b": z()},
            "v": {"w": xavier((D, E)), "b": z()},
            "out": {"w": xavier((D, D)), "b": z()}}


def multi_head_image_feature_embedding_fwd(
        p: Params, image_feat: torch.Tensor, question: torch.Tensor,
        num_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """``question [B, D]`` attends over ``image_feat [B, N, E]`` →
    (context ``[B, D]``, head-averaged weights ``[B, 1, N]``)."""
    H = num_heads
    B, N, _ = image_feat.shape
    D = p["q"]["w"].shape[0]
    dh = D // H
    q = linear_fwd(p["q"], question).reshape(B, 1, H, dh)
    k = linear_fwd(p["k"], image_feat).reshape(B, N, H, dh)
    v = linear_fwd(p["v"], image_feat).reshape(B, N, H, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, 1, D)
    return linear_fwd(p["out"], ctx)[:, 0], probs.mean(dim=1)


# ---------------------------------------------------------------------------
# modal combine layers
# ---------------------------------------------------------------------------

def init_non_linear_element_multiply(seed: Seed, image_feat_dim: int,
                                     ques_emb_dim: int, hidden_dim: int,
                                     context_dim: Optional[int] = None,
                                     device="cuda") -> Params:
    gen = generator(seed)
    p = {"fa_image": init_weight_norm_fc(gen, image_feat_dim, hidden_dim,
                                         device),
         "fa_txt": init_weight_norm_fc(gen, ques_emb_dim, hidden_dim,
                                       device)}
    if context_dim is not None:
        p["fa_context"] = init_weight_norm_fc(gen, context_dim, hidden_dim,
                                              device)
    return p


def non_linear_element_multiply_fwd(
        p: Params, image_feat: torch.Tensor,
        question_embedding: torch.Tensor,
        context_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NonLinearElementMultiply (layers.py:363-396)."""
    image_fa = torch.relu(weight_norm_fc_fwd(p["fa_image"], image_feat))
    question_fa = torch.relu(weight_norm_fc_fwd(p["fa_txt"],
                                                question_embedding))
    if image_feat.dim() == 3 and question_fa.dim() != 3:
        question_fa = question_fa[:, None, :]
    joint = image_fa * question_fa
    if context_embedding is not None:
        context_fa = torch.relu(weight_norm_fc_fwd(p["fa_context"],
                                                   context_embedding))
        joint = torch.cat([joint, context_fa * question_fa], dim=1)
    return joint


def init_two_layer_element_multiply(seed: Seed, image_feat_dim: int,
                                    ques_emb_dim: int, hidden_dim: int,
                                    device="cuda") -> Params:
    gen = generator(seed)
    return {
        "fa_image1": init_weight_norm_fc(gen, image_feat_dim, hidden_dim,
                                         device),
        "fa_image2": init_weight_norm_fc(gen, hidden_dim, hidden_dim,
                                         device),
        "fa_txt1": init_weight_norm_fc(gen, ques_emb_dim, hidden_dim,
                                       device),
        "fa_txt2": init_weight_norm_fc(gen, hidden_dim, hidden_dim, device),
    }


def two_layer_element_multiply_fwd(p: Params, image_feat: torch.Tensor,
                                   question_embedding: torch.Tensor
                                   ) -> torch.Tensor:
    image_fa = relu_weight_norm_fc_fwd(
        p["fa_image2"], relu_weight_norm_fc_fwd(p["fa_image1"], image_feat))
    question_fa = relu_weight_norm_fc_fwd(
        p["fa_txt2"], relu_weight_norm_fc_fwd(p["fa_txt1"],
                                              question_embedding))
    if image_feat.dim() == 3:
        question_fa = question_fa[:, None, :]
    return image_fa * question_fa


def init_mfb_expand(seed: Seed, img_feat_dim: int, txt_emb_dim: int,
                    hidden_dim: int, device="cuda") -> Params:
    gen = generator(seed)
    return {"lc_image": init_linear(gen, img_feat_dim, hidden_dim, device),
            "lc_ques": init_linear(gen, txt_emb_dim, hidden_dim, device)}


def mfb_expand_fwd(p: Params, image_feat: torch.Tensor,
                   question_embed: torch.Tensor) -> torch.Tensor:
    image1 = linear_fwd(p["lc_image"], image_feat)
    ques1 = linear_fwd(p["lc_ques"], question_embed)
    if image_feat.dim() == 3:
        ques1 = ques1[:, None, :]
    return image1 * ques1


def _mfb_squeeze(joint: torch.Tensor, pool_size: int) -> torch.Tensor:
    """MFH.mfb_squeeze (layers.py:322-360): sum-pool, signed square root,
    then an L2 norm over all of a sample's features (F.normalize)."""
    squeezed = joint.dim() == 2
    if squeezed:
        joint = joint[:, None, :]
    B, K, D = joint.shape
    pooled = joint.reshape(B, K, D // pool_size, pool_size).sum(-1)
    sqrt = torch.sqrt(torch.relu(pooled)) - torch.sqrt(torch.relu(-pooled))
    flat = sqrt.reshape(B, -1)
    norm = l2_norm(flat, dim=-1, keepdim=True).clamp(min=1e-12)
    out = (flat / norm).reshape(B, K, D // pool_size)
    return out[:, 0, :] if squeezed else out


def init_mfh(seed: Seed, image_feat_dim: int, ques_emb_dim: int,
             hidden_sizes: Sequence[int], device="cuda") -> Params:
    gen = generator(seed)
    return {"expand": [init_mfb_expand(gen, image_feat_dim, ques_emb_dim, h,
                                       device) for h in hidden_sizes]}


def mfh_fwd(p: Params, image_feat: torch.Tensor,
            question_embedding: torch.Tensor, pool_size: int
            ) -> torch.Tensor:
    """MFH (layers.py:280-321): chained MFB blocks, concatenated."""
    feats, prev = [], None
    for exp_p in p["expand"]:
        z = mfb_expand_fwd(exp_p, image_feat, question_embedding)
        if prev is not None:
            z = prev * z
        prev = z
        feats.append(_mfb_squeeze(z, pool_size))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# top-down attention (the Pythia image-attention core)
# ---------------------------------------------------------------------------

_TDA_EPS = 1.0e-08


def mask_attentions(attention: torch.Tensor,
                    image_locs: torch.Tensor) -> torch.Tensor:
    """TopDownAttention._mask_attentions (attention.py:124-138): zero every
    location at or past the sample's valid count."""
    K = attention.shape[1]
    idx = torch.arange(K, device=attention.device,
                       dtype=attention.dtype)[None, :]
    mask = idx >= image_locs.to(attention.dtype)[:, None]
    return attention.masked_fill(mask[:, :, None], 0.0)


def top_down_attention_fwd(combined: torch.Tensor, transform_p: Params,
                           normalization: str,
                           image_locs: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """TopDownAttention.forward (attention.py:140-163) on the combined
    features ``[B, K, hidden]`` → ``[B, K, n_att]``; the transform is a
    weight-norm (dim=None) linear."""
    raw = weight_norm_fc_fwd(transform_p, combined)
    if normalization.lower() == "softmax":
        att = torch.softmax(raw, dim=1)
        if image_locs is not None:
            att = mask_attentions(att, image_locs)
            s = att.sum(dim=1, keepdim=True)
            s = s + (s == 0).to(att.dtype) + _TDA_EPS
            att = att / s
    elif normalization.lower() == "sigmoid":
        att = torch.sigmoid(raw)
        if image_locs is not None:
            att = mask_attentions(att, image_locs)
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return att


def image_feature_embedding_fwd(attention: torch.Tensor,
                                image_feat: torch.Tensor,
                                order_vectors: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageFeatureEmbedding.forward (embeddings.py:240-261)."""
    if order_vectors is not None:
        image_feat = torch.cat([image_feat, order_vectors], dim=-1)
    emb = torch.einsum("bkg,bkd->bgd", attention, image_feat)
    return emb.reshape(emb.shape[0], -1), attention


# ---------------------------------------------------------------------------
# classifiers
# ---------------------------------------------------------------------------

def init_logit_classifier(seed: Seed, in_dim: int, out_dim: int,
                          text_hidden_dim: int, img_hidden_dim: int,
                          device="cuda") -> Params:
    gen = generator(seed)
    return {
        "f_o_text": init_weight_norm_fc(gen, in_dim, text_hidden_dim,
                                        device),
        "f_o_image": init_weight_norm_fc(gen, in_dim, img_hidden_dim,
                                         device),
        "linear_text": init_linear(gen, text_hidden_dim, out_dim, device),
        "linear_image": init_linear(gen, img_hidden_dim, out_dim, device),
    }


def logit_classifier_fwd(p: Params, joint: torch.Tensor) -> torch.Tensor:
    """LogitClassifier (layers.py:185-214): two-branch sum."""
    return (linear_fwd(p["linear_text"],
                       relu_weight_norm_fc_fwd(p["f_o_text"], joint))
            + linear_fwd(p["linear_image"],
                         relu_weight_norm_fc_fwd(p["f_o_image"], joint)))


def init_weight_norm_classifier(seed: Seed, in_dim: int, out_dim: int,
                                hidden_dim: int, device="cuda") -> Params:
    gen = generator(seed)
    return {"fc1": init_weight_norm_fc(gen, in_dim, hidden_dim, device),
            "fc2": init_weight_norm_fc(gen, hidden_dim, out_dim, device)}


def weight_norm_classifier_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    return weight_norm_fc_fwd(p["fc2"],
                              torch.relu(weight_norm_fc_fwd(p["fc1"], x)))


def init_mlp_classifier(seed: Seed, in_dim: int, out_dim: int,
                        hidden_dim: Optional[int] = None,
                        num_layers: int = 0, device="cuda") -> Params:
    """MLPClassifer (layers.py:148-182), batch norm in eval mode."""
    gen = generator(seed)
    hidden_dim = in_dim if hidden_dim is None else hidden_dim
    hidden, d = [], in_dim
    for _ in range(num_layers):
        hidden.append({"lin": init_linear(gen, d, hidden_dim, device),
                       "bn": bn_init(hidden_dim, device)})
        d = hidden_dim
    return {"hidden": hidden, "out": init_linear(gen, d, out_dim, device)}


def mlp_classifier_fwd(p: Params, x: torch.Tensor,
                       bn_eps: float = 1e-5) -> torch.Tensor:
    for layer in p["hidden"]:
        x = linear_fwd(layer["lin"], x)
        bn = layer["bn"]
        x = (x - bn["mean"]) / torch.sqrt(bn["var"] + bn_eps)
        x = torch.relu(x * bn["scale"] + bn["bias"])
    return linear_fwd(p["out"], x)


# ---------------------------------------------------------------------------
# BAN blocks: FCNet / BCNet / BiAttention
# ---------------------------------------------------------------------------

def init_fc_net(seed: Seed, dims: Sequence[int], act: Optional[str] = None,
                device="cuda") -> Params:
    gen = generator(seed)
    return {"layers": [init_weight_norm_fc(gen, dims[i], dims[i + 1], device)
                       for i in range(len(dims) - 1)]}


_ACTS = {None: lambda y: y, "ReLU": torch.relu,
         "LeakyReLU": lambda y: F.leaky_relu(y, 0.01)}


def fc_net_fwd(p: Params, x: torch.Tensor, act: Optional[str] = None
               ) -> torch.Tensor:
    """FCNet (layers.py:606-638): weight-norm linears, each followed by
    ``act`` (config, passed per call)."""
    fn = _ACTS[act]
    for layer in p["layers"]:
        x = fn(weight_norm_fc_fwd(layer, x))
    return x


def init_bc_net(seed: Seed, v_dim: int, q_dim: int, h_dim: int,
                h_out: Optional[int], act: str = "ReLU", k: int = 3,
                device="cuda") -> Params:
    gen = generator(seed)
    p: Params = {"v_net": init_fc_net(gen, [v_dim, h_dim * k], act, device),
                 "q_net": init_fc_net(gen, [q_dim, h_dim * k], act, device)}
    if h_out is not None and h_out <= 32:
        p["h_mat"] = normal(gen, (1, h_out, 1, h_dim * k), device=device)
        p["h_bias"] = normal(gen, (1, h_out, 1, 1), device=device)
    elif h_out is not None:
        p["h_net"] = init_weight_norm_fc(gen, h_dim * k, h_out, device)
    return p


def bc_net_fwd(p: Params, v: torch.Tensor, q: torch.Tensor,
               h_out: Optional[int], h_mat: Optional[torch.Tensor] = None,
               act: str = "ReLU") -> torch.Tensor:
    """BCNet.forward (layers.py:566-591); the ``h_out <= 32`` branch gives
    ``[B, h_out, K, T]`` glimpse logits. ``h_mat`` overrides the stored one
    (BiAttention weight-norms it outside)."""
    v_ = fc_net_fwd(p["v_net"], v, act)
    q_ = fc_net_fwd(p["q_net"], q, act)
    if h_out is None:
        return torch.einsum("bkd,btd->bktd", v_, q_)
    if h_out <= 32:
        hm = p["h_mat"] if h_mat is None else h_mat
        h_ = v_[:, None, :, :] * hm
        return torch.einsum("bgkd,btd->bgkt", h_, q_) + p["h_bias"]
    d_ = torch.einsum("bkd,btd->bktd", v_, q_)
    return torch.movedim(weight_norm_fc_fwd(p["h_net"], d_), 3, 1)


def bc_net_forward_with_weights(p: Params, v: torch.Tensor, q: torch.Tensor,
                                w: torch.Tensor, k: int = 1,
                                act: str = "ReLU") -> torch.Tensor:
    """BCNet.forward_with_weights (layers.py:593-604): bilinear pooling
    through one glimpse's map ``w [B, K, T]``."""
    v_ = fc_net_fwd(p["v_net"], v, act)
    q_ = fc_net_fwd(p["q_net"], q, act)
    logits = torch.einsum("bkd,bkt,btd->bd", v_, w, q_)
    if k > 1:
        B, D = logits.shape
        logits = logits.reshape(B, D // k, k).mean(-1) * k
    return logits


def init_bi_attention(seed: Seed, x_dim: int, y_dim: int, z_dim: int,
                      glimpse: int, k: int = 3, device="cuda") -> Params:
    """BiAttention (layers.py:640-668): a BCNet whose ``h_mat`` is weight-
    normed with dim=None (scalar ``h_mat_g``)."""
    p = init_bc_net(seed, x_dim, y_dim, z_dim, glimpse, k=k, device=device)
    v = p.pop("h_mat")
    p["h_mat_v"] = v
    p["h_mat_g"] = l2_norm(v)
    return {"logits": p}


def bi_attention_forward_all(p: Params, v: torch.Tensor, q: torch.Tensor,
                             v_mask: bool = True, act: str = "ReLU"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    bc = p["logits"]
    h_mat = bc["h_mat_v"] * (bc["h_mat_g"] / l2_norm(bc["h_mat_v"]))
    logits = bc_net_fwd(bc, v, q, h_mat.shape[1], h_mat=h_mat, act=act)
    if v_mask:
        empty = v.abs().sum(2) == 0
        logits = logits.masked_fill(empty[:, None, :, None], float("-inf"))
    B, G, K, T = logits.shape
    att = torch.softmax(logits.reshape(B, G, K * T), dim=2)
    return att.reshape(B, G, K, T), logits


# ---------------------------------------------------------------------------
# classic attentions (TopDownBottomUp)
# ---------------------------------------------------------------------------

def init_concatenation_attention(seed: Seed, image_feat_dim: int,
                                 txt_emb_dim: int, hidden_size: int,
                                 device="cuda") -> Params:
    gen = generator(seed)
    return {"fa": init_gated_tanh(gen, image_feat_dim + txt_emb_dim,
                                  hidden_size, device),
            "lc": init_linear(gen, hidden_size, 1, device)}


def concatenation_attention_fwd(p: Params, image_feat: torch.Tensor,
                                question_embedding: torch.Tensor
                                ) -> torch.Tensor:
    """ConcatenationAttention (attention.py:40-58)."""
    B, K = image_feat.shape[:2]
    q = question_embedding[:, None, :].expand(B, K, -1)
    raw = linear_fwd(p["lc"], gated_tanh_fwd(
        p["fa"], torch.cat([image_feat, q], dim=2)))
    return torch.softmax(raw, dim=1).expand(image_feat.shape)


def init_project_attention(seed: Seed, image_feat_dim: int,
                           txt_emb_dim: int, hidden_size: int,
                           device="cuda") -> Params:
    gen = generator(seed)
    return {"fa_image": init_gated_tanh(gen, image_feat_dim, hidden_size,
                                        device),
            "fa_txt": init_gated_tanh(gen, txt_emb_dim, hidden_size, device),
            "lc": init_linear(gen, hidden_size, 1, device)}


def project_attention_raw(p: Params, image_feat: torch.Tensor,
                          question_embedding: torch.Tensor) -> torch.Tensor:
    image_fa = gated_tanh_fwd(p["fa_image"], image_feat)
    question_fa = gated_tanh_fwd(p["fa_txt"], question_embedding)
    return linear_fwd(p["lc"], image_fa * question_fa[:, None, :])


def project_attention_fwd(p: Params, image_feat: torch.Tensor,
                          question_embedding: torch.Tensor) -> torch.Tensor:
    """ProjectAttention (attention.py:61-89)."""
    att = torch.softmax(project_attention_raw(p, image_feat,
                                              question_embedding), dim=1)
    return att.expand(image_feat.shape)


def init_double_project_attention(seed: Seed, image_feat_dim: int,
                                  txt_emb_dim: int, hidden_size: int,
                                  device="cuda") -> Params:
    gen = generator(seed)
    return {"att1": init_project_attention(gen, image_feat_dim, txt_emb_dim,
                                           hidden_size, device),
            "att2": init_project_attention(gen, image_feat_dim, txt_emb_dim,
                                           hidden_size, device)}


def double_project_attention_fwd(p: Params, image_feat: torch.Tensor,
                                 question_embedding: torch.Tensor
                                 ) -> torch.Tensor:
    """DoubleProjectAttention (attention.py:92-112)."""
    raw = (project_attention_raw(p["att1"], image_feat, question_embedding)
           + project_attention_raw(p["att2"], image_feat,
                                   question_embedding))
    return torch.softmax(raw, dim=1).expand(image_feat.shape)


# ---------------------------------------------------------------------------
# BUTD recurrent attention blocks
# ---------------------------------------------------------------------------

def init_top_down_attention_lstm(seed: Seed, image_feat_dim: int,
                                 embed_dim: int, hidden_dim: int,
                                 attention_dim: int, device="cuda") -> Params:
    """TopDownAttentionLSTM (layers.py:398-435); fa_image / fa_hidden are
    dim=0 weight norms."""
    gen = generator(seed)
    return {
        "fa_image": init_weight_norm_fc_dim0(gen, image_feat_dim,
                                             attention_dim, device),
        "fa_hidden": init_weight_norm_fc_dim0(gen, hidden_dim,
                                              attention_dim, device),
        "td_lstm": init_lstm(gen, embed_dim + image_feat_dim + hidden_dim,
                             hidden_dim, device),
    }


def top_down_attention_lstm_fwd(p: Params, image_feat: torch.Tensor,
                                embedding: torch.Tensor, h1: torch.Tensor,
                                c1: torch.Tensor, h2: torch.Tensor):
    """One step with the (h1, c1) state explicit → (joint ``[B, K, att]``,
    h1', c1')."""
    x = torch.cat([h2, image_feat.mean(1), embedding], dim=1)
    h1, c1 = lstm_cell_fwd(p["td_lstm"], x, h1, c1)
    image_fa = weight_norm_fc_dim0_fwd(p["fa_image"], image_feat)
    hidden_fa = weight_norm_fc_dim0_fwd(p["fa_hidden"], h1)
    return torch.relu(image_fa + hidden_fa[:, None, :]), h1, c1


def init_language_decoder(seed: Seed, in_dim: int, out_dim: int,
                          hidden_dim: int, fc_bias_init: float = 0.0,
                          device="cuda") -> Params:
    """LanguageDecoder (decoders.py:55-86): dim=0 weight-norm fc with its
    bias filled with ``fc_bias_init`` (the reference's later uniform fill
    of the wrapped weight is a no-op, so it is not reproduced)."""
    gen = generator(seed)
    v = uniform(gen, (out_dim, hidden_dim), -0.1, 0.1, device)
    return {"fc": {"v": v, "g": l2_norm(v, dim=1),
                   "b": torch.full((out_dim,), float(fc_bias_init),
                                   device=device)},
            "lm_lstm": init_lstm(gen, in_dim + hidden_dim, hidden_dim,
                                 device)}


def language_decoder_fwd(p: Params, weighted_attn: torch.Tensor,
                         h1: torch.Tensor, h2: torch.Tensor, c2: torch.Tensor):
    """One step with (h2, c2) explicit → (logits, h2', c2')."""
    h2, c2 = lstm_cell_fwd(p["lm_lstm"], torch.cat([weighted_attn, h1], 1),
                           h2, c2)
    return weight_norm_fc_dim0_fwd(p["fc"], h2), h2, c2


def init_visdial_discriminator(seed: Seed, emb_out_dim: int,
                               hidden_dim: int, device="cuda") -> Params:
    """VisDialDiscriminator (decoders.py:8-52)."""
    return {"projection": init_linear(seed, emb_out_dim, hidden_dim, device)}


def visdial_discriminator_fwd(p: Params, option_embeddings: torch.Tensor,
                              encoder_output: torch.Tensor) -> torch.Tensor:
    """``option_embeddings [N, n_options, emb_out]``, ``encoder_output
    [N, hidden]`` → scores ``[N, n_options]``."""
    opts = linear_fwd(p["projection"], option_embeddings)
    return (opts * encoder_output[:, None, :]).sum(-1)


# ---------------------------------------------------------------------------
# CNN blocks (the cnn_lstm baseline)
# ---------------------------------------------------------------------------

def init_conv_net(seed: Seed, in_channels: int, out_channels: int,
                  kernel_size: int, device="cuda") -> Params:
    """ConvNet (layers.py:12-42): conv → leaky relu → max pool → BN; the
    kernel is OIHW."""
    gen = generator(seed)
    bound = 1.0 / math.sqrt(in_channels * kernel_size * kernel_size)
    return {"w": uniform(gen, (out_channels, in_channels, kernel_size,
                               kernel_size), -bound, bound, device),
            "b": uniform(gen, (out_channels,), -bound, bound, device),
            "bn": bn_init(out_channels, device)}


def conv_net_fwd(p: Params, x: torch.Tensor, pool_stride: int = 2,
                 bn_eps: float = 1e-5) -> torch.Tensor:
    """``x [B, C, H, W]`` (NCHW)."""
    k = p["w"].shape[-1]
    x = F.conv2d(x, p["w"], p["b"], padding=k // 2)
    x = F.max_pool2d(F.leaky_relu(x, 0.01), pool_stride, pool_stride)
    bn = p["bn"]
    x = (x - bn["mean"][:, None, None]) / torch.sqrt(
        bn["var"][:, None, None] + bn_eps)
    return x * bn["scale"][:, None, None] + bn["bias"][:, None, None]


# ---------------------------------------------------------------------------
# the TextEmbedding dispatcher (embeddings.py:21-56)
# ---------------------------------------------------------------------------

TEXT_EMBEDDING_TYPES = ("identity", "vocab", "projection", "preextracted",
                        "bilstm", "attention", "mcan", "torch")


def init_text_embedding(seed: Seed, emb_type: str, device="cuda", **kwargs):
    """TextEmbedding → ``(params, fwd)``. 'mcan' (SAEmbedding) lives in
    ``models/movie_mcan`` and 'projection' in ``models/encoders``; both are
    dispatched here as in the JAX package."""
    gen = generator(seed)
    if emb_type == "identity":
        return {}, lambda p, x: x
    if emb_type in ("vocab", "torch"):
        return (init_vocab_embedding(gen, kwargs["vocab_size"],
                                     kwargs["embedding_dim"],
                                     kwargs.get("vectors"), device),
                vocab_embedding_fwd)
    if emb_type == "preextracted":
        mod = PreExtractedEmbedding(kwargs["out_dim"], kwargs["base_path"],
                                    device=device)
        return {}, lambda p, qids: mod(qids)
    if emb_type == "bilstm":
        rnn_type = kwargs.get("rnn_type", "GRU")
        bidir = kwargs.get("bidirectional", False)
        p = init_bilstm_text_embedding(gen, kwargs["hidden_dim"],
                                       kwargs["embedding_dim"], bidir,
                                       rnn_type, device)
        return p, (lambda p, x: bilstm_text_embedding_fwd(p, x, rnn_type,
                                                          bidir))
    if emb_type == "attention":
        return (init_attention_text_embedding(
            gen, kwargs["hidden_dim"], kwargs["embedding_dim"],
            kwargs["conv1_out"], kwargs["conv2_out"],
            kwargs.get("bidirectional", False), device),
            attention_text_embedding_fwd)
    if emb_type == "mcan":
        from transformer_mm_explainability_tpu_torch.models import movie_mcan

        cfg = movie_mcan.MovieMcanConfig(**kwargs)
        p = {"lstm": init_lstm(gen, cfg.embedding_dim, cfg.hidden_dim,
                               device),
             "blocks": [movie_mcan.init_self_attention(gen, cfg.hidden_dim,
                                                       device)
                        for _ in range(cfg.num_layers)],
             "attn_pool": movie_mcan.init_attn_pool_1d(
                 gen, cfg.hidden_dim, cfg.num_feat, device)}
        return p, (lambda p, x, mask=None:
                   movie_mcan.sa_embedding_fwd(p, x, mask, cfg))
    if emb_type == "projection":
        return (init_linear(gen, kwargs["in_dim"], kwargs["out_dim"], device),
                linear_fwd)
    raise NotImplementedError("Unknown question embedding '%s'" % emb_type)
