"""MoVie+MCAN (grid-feature VQA, arXiv:2004.11883), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/models/movie_mcan.py``
(``mmf/models/movie_mcan.py`` and its blocks): the MCAN attention stack
(MovieMcanMultiHeadAttention, SelfAttention, SelfGuidedAttention), the
SA / SGA / CBN embeddings, the MoVie bottleneck with its SE module, the
branch-combine layer, AttnPool1d and TripleLinear. Convolutions are NCHW
with OIHW kernels (torch's own layout, kept by the JAX tree too); frozen
batch norms fold into a scale and a shift; LayerNorm eps is torch's 1e-5.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.models import mmf_layers as L
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MovieMcanConfig:
    vocab_size: int = 100
    num_answers: int = 10
    embedding_dim: int = 300
    hidden_dim: int = 1024
    num_attn: int = 8
    num_layers: int = 6         # MCAN SA / SGA depth
    cbn_num_layers: int = 4
    image_feature_dim: int = 2048
    num_feat: int = 2           # attn-pool glimpses of the text vector
    compressed: bool = True
    use_se: bool = True
    cbn_out_dim: int = 1024
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


# ---------------------------------------------------------------------------
# MCAN attention blocks
# ---------------------------------------------------------------------------

def _init_mcan_mha(gen, d, device):
    return {"linears": [L.init_linear(gen, d, d, device) for _ in range(4)]}


def mcan_mha_fwd(p: Params, q, k, v, mask, num_attn: int):
    """MovieMcanMultiHeadAttention (attention.py:166-215); ``mask`` is
    ``[B, S_k]``, True at pads (scores −1e9), or None."""
    B = q.shape[0]
    dh = q.shape[-1] // num_attn

    def split(x, lin):
        return L.linear_fwd(lin, x).reshape(B, -1, num_attn, dh
                                            ).transpose(1, 2)

    qh, kh, vh = (split(x, lin) for x, lin in zip((q, k, v), p["linears"]))
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(dh)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :], -1e9)
    ctx = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vh)
    ctx = ctx.transpose(1, 2).reshape(B, -1, num_attn * dh)
    return L.linear_fwd(p["linears"][3], ctx)


def _init_mcan_ffn(gen, d, device):
    return {"fc1": L.init_linear(gen, d, 4 * d, device),
            "fc2": L.init_linear(gen, 4 * d, d, device)}


def _mcan_ffn(p, x):
    return L.linear_fwd(p["fc2"], torch.relu(L.linear_fwd(p["fc1"], x)))


def init_self_attention(seed: L.Seed, d: int, device="cuda") -> Params:
    gen = L.generator(seed)
    return {"mha": _init_mcan_mha(gen, d, device),
            "ffn": _init_mcan_ffn(gen, d, device),
            "ln_mha": L.ln_init(d, device), "ln_fcn": L.ln_init(d, device)}


def self_attention_fwd(p: Params, x, x_mask, num_attn: int,
                       eps: float = 1e-5):
    """SelfAttention (attention.py:218-236): post-LN MHA + FFN."""
    x = _ln(x + mcan_mha_fwd(p["mha"], x, x, x, x_mask, num_attn),
            p["ln_mha"], eps)
    return _ln(x + _mcan_ffn(p["ffn"], x), p["ln_fcn"], eps)


def init_self_guided_attention(seed: L.Seed, d: int, device="cuda"
                               ) -> Params:
    gen = L.generator(seed)
    return {"mha0": _init_mcan_mha(gen, d, device),
            "mha1": _init_mcan_mha(gen, d, device),
            "ffn": _init_mcan_ffn(gen, d, device),
            "ln0": L.ln_init(d, device), "ln1": L.ln_init(d, device),
            "ln_fcn": L.ln_init(d, device)}


def self_guided_attention_fwd(p: Params, x, y, x_mask, y_mask,
                              num_attn: int, eps: float = 1e-5):
    """SelfGuidedAttention (attention.py:239-277): self, then guided."""
    x = _ln(x + mcan_mha_fwd(p["mha0"], x, x, x, x_mask, num_attn),
            p["ln0"], eps)
    x = _ln(x + mcan_mha_fwd(p["mha1"], x, y, y, y_mask, num_attn),
            p["ln1"], eps)
    return _ln(x + _mcan_ffn(p["ffn"], x), p["ln_fcn"], eps)


def init_attn_pool_1d(seed: L.Seed, d: int, num_attn: int,
                      device="cuda") -> Params:
    gen = L.generator(seed)
    return {"fc1": L.init_linear(gen, d, d // 2, device),
            "fc2": L.init_linear(gen, d // 2, num_attn, device)}


def attn_pool_1d_fwd(p: Params, query, value,
                     mask: Optional[torch.Tensor] = None):
    """AttnPool1d (layers.py:731-758): MLP scores → masked softmax over
    positions → weighted sum per glimpse ``[B, n_attn, D]``."""
    score = L.linear_fwd(p["fc2"], torch.relu(L.linear_fwd(p["fc1"], query))
                         ).transpose(-2, -1)
    if mask is not None:
        score = score.masked_fill(mask[:, None, :], -1e9)
    return torch.einsum("bns,bsd->bnd", torch.softmax(score, dim=-1), value)


# ---------------------------------------------------------------------------
# the MoVie bottleneck branch (NCHW)
# ---------------------------------------------------------------------------

def _conv_init(gen, cout, cin, k, device):
    bound = math.sqrt(1.0 / (cin * k * k))
    return L.uniform(gen, (cout, cin, k, k), -bound, bound, device)


def _conv2d(x, w, stride=1, padding=0, bias=None):
    return F.conv2d(x, w, bias, stride=stride, padding=padding)


def _frozen_bn(x, p):
    scale = p["scale"] / torch.sqrt(p["var"] + 1e-5)
    shift = p["bias"] - p["mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def init_movie_bottleneck(seed: L.Seed, inplanes: int, planes: int,
                          cond_planes: int, downsample: bool,
                          compressed: bool = True, use_se: bool = True,
                          device="cuda") -> Params:
    """MovieBottleneck (bottleneck.py:71-164), expansion 4. The modulation
    conv has ``planes`` outputs when compressed, as in the JAX package (the
    reference hard-codes 256, the width of its one published config)."""
    gen = L.generator(seed)
    width, out_c = planes, planes * 4
    cond_out = width if compressed else inplanes
    p: Params = {
        "conv1": _conv_init(gen, width, inplanes, 1, device),
        "bn1": L.bn_init(width, device),
        "conv2": _conv_init(gen, width, width, 3, device),
        "bn2": L.bn_init(width, device),
        "conv3": _conv_init(gen, out_c, width, 1, device),
        "bn3": L.bn_init(out_c, device),
        "cond": {"linear": L.init_linear(gen, cond_planes, inplanes, device),
                 "conv": _conv_init(gen, cond_out, inplanes, 1, device),
                 "conv_b": torch.zeros(cond_out, device=device)},
    }
    if downsample:
        p["downsample"] = _conv_init(gen, out_c, inplanes, 1, device)
    if use_se:
        p["se"] = {"conv1": _conv_init(gen, out_c // 4, out_c, 1, device),
                   "conv2": _conv_init(gen, out_c, out_c // 4, 1, device),
                   "attn_conv": _conv_init(gen, 1, 1, 7, device)}
    return p


def _se_module(p, x):
    """SEModule (bottleneck.py:21-51): channel gate, then a spatial gate
    from the channel mean through a 7×7 conv."""
    g = torch.relu(_conv2d(x.mean(dim=(2, 3), keepdim=True), p["conv1"]))
    x = x * torch.sigmoid(_conv2d(g, p["conv2"]))
    a = torch.sigmoid(_conv2d(x.mean(dim=1, keepdim=True), p["attn_conv"],
                              padding=3))
    return x * a


def movie_bottleneck_fwd(p: Params, x, cond, compressed: bool = True):
    """MovieBottleneck.forward (bottleneck.py:128-164)."""
    identity = x
    gate = L.linear_fwd(p["cond"]["linear"], cond)[:, :, None, None]
    mod = _conv2d(x * gate, p["cond"]["conv"], bias=p["cond"]["conv_b"])
    if compressed:
        x = _conv2d(x, p["conv1"]) + mod
    else:
        # the reference adds the modulation in place, so its shortcut
        # alias sees x + mod too (bottleneck.py:133-138)
        x = x + mod
        identity = x
        x = _conv2d(x, p["conv1"])
    out = torch.relu(_frozen_bn(x, p["bn1"]))
    out = torch.relu(_frozen_bn(_conv2d(out, p["conv2"], padding=1),
                                p["bn2"]))
    out = _frozen_bn(_conv2d(out, p["conv3"]), p["bn3"])
    shortcut = (_conv2d(identity, p["downsample"])
                if "downsample" in p else identity)
    if "se" in p:
        out = _se_module(p["se"], out)
    return torch.relu(out + shortcut)


# ---------------------------------------------------------------------------
# embeddings and the model
# ---------------------------------------------------------------------------

def init_movie_mcan(seed: L.Seed, cfg: MovieMcanConfig,
                    device="cuda") -> Params:
    gen = L.generator(seed)
    H, E = cfg.hidden_dim, cfg.embedding_dim
    lin = lambda i, o: L.init_linear(gen, i, o, device)
    word = L.normal(gen, (cfg.vocab_size, E), 0.02, device)
    cbns, inplanes = [], cfg.image_feature_dim
    for _ in range(cfg.cbn_num_layers):
        cbns.append(init_movie_bottleneck(
            gen, inplanes, cfg.cbn_out_dim // 4, cfg.hidden_dim,
            downsample=(inplanes != cfg.cbn_out_dim),
            compressed=cfg.compressed, use_se=cfg.use_se, device=device))
        inplanes = cfg.cbn_out_dim
    out2 = cfg.hidden_dim * 2
    return {
        "word_embedding": word,
        "sa": {"lstm": L.init_lstm(gen, E, H, device),
               "blocks": [init_self_attention(gen, H, device)
                          for _ in range(cfg.num_layers)],
               "attn_pool": init_attn_pool_1d(gen, H, cfg.num_feat, device)},
        "sga": {"linear": lin(cfg.image_feature_dim, H),
                "blocks": [init_self_guided_attention(gen, H, device)
                           for _ in range(cfg.num_layers)]},
        "sga_pool": init_attn_pool_1d(gen, H, 1, device),
        "cbn": {"cbns": cbns, "ln": L.ln_init(cfg.cbn_out_dim, device)},
        "combine": {  # BranchCombineLayer
            "linear_cga": [lin(H, out2) for _ in range(2)],
            "linear_cbn": [lin(cfg.cbn_out_dim, out2) for _ in range(2)],
            "linear_ques": [lin(H, out2) for _ in range(2)],
            "ln": [L.ln_init(out2, device) for _ in range(3)],
        },
        "classifier": [lin(out2, cfg.num_answers) for _ in range(3)],
    }


def sa_embedding_fwd(p: Params, x, mask, cfg: MovieMcanConfig):
    """SAEmbedding.forward (embeddings.py:488-501): LSTM → self-attention
    blocks → attn-pool vectors ``[B, num_feat, H]``."""
    out = L.lstm_fwd(p["lstm"], x)
    for blk in p["blocks"]:
        out = self_attention_fwd(blk, out, mask, cfg.num_attn,
                                 cfg.layer_norm_eps)
    vec = attn_pool_1d_fwd(p["attn_pool"], out, out, mask).reshape(
        x.shape[0], cfg.num_feat, -1)
    return out, vec


def sga_embedding_fwd(p: Params, x, y, y_mask, cfg: MovieMcanConfig):
    """SGAEmbedding.forward (embeddings.py:523-540): an NCHW grid becomes
    ``[B, HW, C]`` → linear → guided blocks."""
    if x.dim() == 4:
        B, C, Hh, Ww = x.shape
        x = x.reshape(B, C, Hh * Ww).transpose(1, 2)
    x = L.linear_fwd(p["linear"], x)
    for blk in p["blocks"]:
        x = self_guided_attention_fwd(blk, x, y, None, y_mask, cfg.num_attn,
                                      cfg.layer_norm_eps)
    return x


def cbn_embedding_fwd(p: Params, x, v, cfg: MovieMcanConfig):
    """CBNEmbedding.forward (embeddings.py:589-599)."""
    for cbn in p["cbns"]:
        x = movie_bottleneck_fwd(cbn, x, v, cfg.compressed)
    return _ln(x.mean(dim=(2, 3)), p["ln"], cfg.layer_norm_eps)


def branch_combine_fwd(p: Params, v_cga, v_cbn, q, eps: float,
                       training: bool = False):
    """BranchCombineLayer.forward (layers.py:713-729)."""
    lin = L.linear_fwd
    f0 = _ln(lin(p["linear_ques"][0], q) + lin(p["linear_cbn"][0], v_cbn)
             + lin(p["linear_cga"][0], v_cga), p["ln"][0], eps)
    if not training:
        return f0
    f1 = _ln(lin(p["linear_cbn"][1], v_cbn), p["ln"][1], eps)
    f2 = _ln(lin(p["linear_ques"][1], q) + lin(p["linear_cga"][1], v_cga),
             p["ln"][2], eps)
    return torch.stack([f0, f1, f2], dim=1)


def movie_mcan_forward(params: Params, cfg: MovieMcanConfig,
                       text_tokens: torch.Tensor, image: torch.Tensor,
                       training: bool = False) -> torch.Tensor:
    """MoVieMcan.forward (movie_mcan.py:253-274); ``image`` is an NCHW
    grid. Eval gives the fused branch through TripleLinear's first head,
    training ``[B, 3, A]``."""
    text_mask = text_tokens == 0
    x = params["word_embedding"][text_tokens.long()]
    text_total, text_vec = sa_embedding_fwd(params["sa"], x, text_mask, cfg)
    sga = sga_embedding_fwd(params["sga"], image, text_total, text_mask, cfg)
    sga_pooled = attn_pool_1d_fwd(params["sga_pool"], sga, sga, None)[:, 0]
    cbn = cbn_embedding_fwd(params["cbn"], image, text_vec[:, 0], cfg)
    joint = branch_combine_fwd(params["combine"], sga_pooled, cbn,
                               text_vec[:, 1], cfg.layer_norm_eps, training)
    if training:
        return torch.stack([L.linear_fwd(params["classifier"][i], joint[:, i])
                            for i in range(3)], dim=1)
    return L.linear_fwd(params["classifier"][0], joint)
