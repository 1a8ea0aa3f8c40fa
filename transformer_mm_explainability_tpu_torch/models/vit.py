"""ViT-B/16 (timm ``vit_base_patch16_224`` architecture) in PyTorch, with
attention capture and the relevancy paths.

Counterpart of ``transformer_mm_explainability_tpu/models/vit.py``:

  * ``relevancy`` — the ViT notebook's ``generate_relevance``: capture A
    and ∇A for every layer (one forward, one ``autograd.grad`` with respect
    to the stacked taps), then the rule-6 chain R ← R + Ê·R; the oracle.
  * ``relevancy_streamed`` — the whole R without the capture stacks,
    folded P ← P + P·Ê layer by layer through per-layer VJPs, and
    ``relevancy_streamed_row``, only its CLS row (r ← r + r·Ê); plain
    PyTorch, the second and third oracles.
  * ``relevancy_fused`` — attention through ``ops/flash_attention``'s
    ``flash_fwd_qkv`` / ``flash_bwd_ehat_qkv`` kernels, the rest in plain
    torch, taping (x, x_mid, a1).
  * ``relevancy_fused_block`` — the attention branch of each block
    through ``ops/attn_block``'s kernels, the MLP in plain torch (a1
    taped).
  * ``relevancy_fused_block2`` — both branches through ``ops/attn_block``
    in both directions; the forward tapes only ``(x, x_mid)`` per layer.
  * ``*_forward_probe`` — the forward of each fused path, returning the
    logits, to split a path's time into forward and backward.

Layouts follow the JAX package: images ``[B, H, W, 3]`` (normalised),
weights ``[in, out]``, captures ``[L, B, H, S, S]``. The patch embed is a
reshape and a matmul, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.ops import attn_block as ab
from transformer_mm_explainability_tpu_torch.ops import flash_attention as fa
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl
from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams,
    gelu,
    layer_norm,
    multi_head_self_attention,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    num_classes: int = 1000
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def seq_len(self) -> int:
        return self.grid * self.grid + 1  # patches + CLS


VIT_B_16 = ViTConfig()


def _param(*shape, device, fill: float = 0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, device=device),
                        requires_grad=False)


class Block(nn.Module):
    """One pre-LN transformer block's parameters."""

    def __init__(self, width: int, hidden: int, device):
        super().__init__()
        D, I = width, hidden
        self.ln1_scale = _param(D, device=device, fill=1.0)
        self.ln1_bias = _param(D, device=device)
        self.w_qkv = _param(D, 3 * D, device=device)
        self.b_qkv = _param(3 * D, device=device)
        self.w_out = _param(D, D, device=device)
        self.b_out = _param(D, device=device)
        self.ln2_scale = _param(D, device=device, fill=1.0)
        self.ln2_bias = _param(D, device=device)
        self.w1 = _param(D, I, device=device)
        self.b1 = _param(I, device=device)
        self.w2 = _param(I, D, device=device)
        self.b2 = _param(D, device=device)

    @property
    def attn(self) -> AttentionParams:
        return AttentionParams(self.w_qkv, self.b_qkv, self.w_out, self.b_out)

    # on a tensor-parallel copy (``parallel/mesh.shard_params``): the
    # ``TensorParallel`` of each residual branch whose weights are split
    # over the ranks of its group, whose outputs it sums
    tp_attn = None
    tp_mlp = None

    def forward(self, x: torch.Tensor, tap: Optional[torch.Tensor],
                num_heads: int, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x_out, attention probabilities [B, H, S, S])."""
        h = layer_norm(x, self.ln1_scale, self.ln1_bias, eps)
        attn_out, probs = multi_head_self_attention(
            self.attn, _tp_enter(self.tp_attn, h), num_heads, tap=tap)
        x = x + _tp_exit(self.tp_attn, attn_out)
        h = _tp_enter(self.tp_mlp,
                      layer_norm(x, self.ln2_scale, self.ln2_bias, eps))
        h = gelu(h @ self.w1 + self.b1) @ self.w2 + self.b2
        return x + _tp_exit(self.tp_mlp, h), probs


def _tp_enter(tp, x: torch.Tensor) -> torch.Tensor:
    return x if tp is None else tp.enter(x)


def _tp_exit(tp, x: torch.Tensor) -> torch.Tensor:
    return x if tp is None else tp.exit(x)


class ViT(nn.Module):
    """ViT parameters in the JAX package's layout. Parameters do not
    require grad: explanations only need input cotangents, and a train
    step (``train/steps``) turns grad on for its own forward only."""

    # on a tensor-parallel copy whose heads are split over the ranks of a
    # group (``parallel/mesh.shard_params``; ``cfg.num_heads`` is then the
    # local count): the ``TensorParallel`` that averages Ê over the ranks
    tp_heads = None

    def __init__(self, cfg: ViTConfig = VIT_B_16, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        D, S, P = cfg.width, cfg.seq_len, cfg.patch_size
        self.cfg = cfg
        self.patch_w = _param(P * P * 3, D, device=device)
        self.patch_b = _param(D, device=device)
        self.cls_token = _param(1, D, device=device)
        self.pos_embed = _param(S, D, device=device)
        self.blocks = nn.ModuleList(
            Block(D, cfg.mlp_ratio * D, device) for _ in range(cfg.depth))
        self.norm_scale = _param(D, device=device, fill=1.0)
        self.norm_bias = _param(D, device=device)
        self.head_w = _param(D, cfg.num_classes, device=device)
        self.head_b = _param(cfg.num_classes, device=device)

    def forward(self, images: torch.Tensor,
                taps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward(self, images, taps)

    @staticmethod
    def tree_keys(name: str) -> Tuple[str, ...]:
        """The dict keys of parameter ``name``'s path in the JAX package's
        ViT tree (``blocks.3.ln1_scale`` → ``blocks/ln1/scale``; the four
        attention tensors sit in an ``AttentionParams`` NamedTuple, whose
        fields are no dict keys), for rules keyed on that tree's names
        (``train/steps.bert_no_decay_mask``)."""
        parts = name.split(".")
        if parts[0] == "blocks":
            leaf = parts[-1]
            if leaf in _ATTN_FIELDS:
                return ("blocks", "attn")
            if leaf in ("w1", "b1", "w2", "b2"):
                return ("blocks", "mlp", leaf)
            return ("blocks",) + tuple(leaf.split("_"))
        return _TOP_KEYS[parts[0]]


_ATTN_FIELDS = ("w_qkv", "b_qkv", "w_out", "b_out")
_TOP_KEYS = {"patch_w": ("patch_embed", "w"), "patch_b": ("patch_embed", "b"),
             "cls_token": ("cls_token",), "pos_embed": ("pos_embed",),
             "norm_scale": ("norm", "scale"), "norm_bias": ("norm", "bias"),
             "head_w": ("head", "w"), "head_b": ("head", "b")}


def init_params(seed: Union[int, torch.Generator] = 0,
                cfg: ViTConfig = VIT_B_16, device="cuda") -> ViT:
    """A ViT with random weights (normal, std 0.02; LN at identity; zero
    biases), drawn on the CPU from ``seed`` so that every device gets the
    same numbers."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    model = ViT(cfg, device)
    normal = [model.patch_w, model.cls_token, model.pos_embed, model.head_w]
    for blk in model.blocks:
        normal += [blk.w_qkv, blk.w_out, blk.w1, blk.w2]
    with torch.no_grad():
        for p in normal:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model


def patchify(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N_patches, P*P*3] in (row, col, channel) order,
    the stride-P conv patch embed as a reshape."""
    B, H, W, C = images.shape
    P = patch_size
    x = images.reshape(B, H // P, P, W // P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // P) * (W // P), P * P * C)


def _embed(model: ViT, images: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    B = images.shape[0]
    x = torch.matmul(patchify(images, cfg.patch_size), model.patch_w)
    x = x + model.patch_b
    cls = model.cls_token.expand(B, 1, cfg.width)
    return torch.cat([cls, x], dim=1) + model.pos_embed


def _head(model: ViT, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(x, model.norm_scale, model.norm_bias, model.cfg.ln_eps)
    return h[:, 0] @ model.head_w + model.head_b


def forward(model: ViT, images: torch.Tensor,
            taps: Optional[torch.Tensor] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ViT forward. images: [B, H, W, 3] (normalised). ``taps``: optional
    [L, B, H, S, S] additive attention taps. Returns
    ``(logits [B, C], attn_probs [L, B, H, S, S])``. ``remat`` checkpoints
    each block (``torch.utils.checkpoint``, recomputed in the backward), as
    the JAX package's ``jax.checkpoint``: the same values for about a third
    more work, without the blocks' activations kept for autograd."""
    cfg = model.cfg
    x = _embed(model, images)
    probs = []
    for i, blk in enumerate(model.blocks):
        args = (x, None if taps is None else taps[i], cfg.num_heads,
                cfg.ln_eps)
        x, p = (checkpoint(blk, *args, use_reentrant=False) if remat
                else blk(*args))
        probs.append(p)
    return _head(model, x), torch.stack(probs)


def _score(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Σ_b logits[b, targets[b]]: per-image gradients stay independent."""
    return logits.gather(1, targets[:, None].long()).sum()


def capture(model: ViT, images: torch.Tensor, targets: torch.Tensor,
            remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward and one backward: returns (logits, A, ∇A), A and ∇A
    each [L, B, H, S, S]. ``targets``: [B] class indices. ``remat``: as
    ``forward``'s."""
    cfg = model.cfg
    B = images.shape[0]
    taps = torch.zeros((cfg.depth, B, cfg.num_heads, cfg.seq_len,
                        cfg.seq_len), device=images.device,
                       dtype=images.dtype, requires_grad=True)
    with torch.enable_grad():
        logits, attn = forward(model, images, taps, remat)
        (grads,) = torch.autograd.grad(_score(logits, targets), taps)
    return logits.detach(), attn.detach(), grads


def relevancy(model: ViT, images: torch.Tensor, targets: torch.Tensor,
              start_layer: int = 0, remat: bool = False) -> torch.Tensor:
    """The ViT notebook's ``generate_relevance``: R = I; per block
    R += avg_heads(A, ∇A) @ R; returns R[:, 0, 1:] ([B, S-1]). ``remat``:
    as ``forward``'s."""
    _, attn, grads = capture(model, images, targets, remat)
    e = _head_mean(model, rl.e_hats(attn.movedim(1, 0), grads.movedim(1, 0)))
    return rl.rule6_chain(e[:, start_layer:])[:, 0, 1:]


def _head_mean(model: ViT, e: torch.Tensor) -> torch.Tensor:
    """Ê averaged over every head: on a model whose heads are split over
    the ranks of a group, each rank's mean over its heads averaged over
    the group (the ranks hold equal shares)."""
    return e if model.tp_heads is None else model.tp_heads.mean(e)


def _head_cotangent(model: ViT, x_final: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    xf = x_final.detach().requires_grad_(True)
    with torch.enable_grad():
        (cot,) = torch.autograd.grad(_score(_head(model, xf), targets), xf)
    return cot


def _row0(B: int, S: int, row: int, device) -> torch.Tensor:
    r = torch.zeros((B, S), device=device, dtype=torch.float32)
    r[:, row] = 1.0
    return r


def _taped_forward(model: ViT, images: torch.Tensor, layer
                   ) -> Tuple[torch.Tensor, list]:
    """Embed, then ``x, t = layer(blk, x)`` for each block without autograd;
    returns the final x and the per-block tape entries t."""
    with torch.no_grad():
        x = _embed(model, images).contiguous()
        tape = []
        for blk in model.blocks:
            x, t = layer(blk, x)
            tape.append(t)
    return x, tape


def _streamed(model: ViT, images: torch.Tensor, targets: torch.Tensor,
              state: torch.Tensor, fold) -> torch.Tensor:
    """The streamed paths: the forward tapes each block's input; in reverse
    each block is recomputed and differentiated for (cot_x, ∇A), and
    ``state ← fold(state, Ê_l)``. Plain PyTorch."""
    cfg = model.cfg
    H, eps = cfg.num_heads, cfg.ln_eps
    B, S = images.shape[0], cfg.seq_len
    x, tape = _taped_forward(
        model, images, lambda blk, x: (blk(x, None, H, eps)[0], x))
    cot_x = _head_cotangent(model, x, targets)
    zero_tap = torch.zeros((B, H, S, S), device=images.device,
                           dtype=images.dtype)
    for blk, x_in in zip(reversed(model.blocks), reversed(tape)):
        xi = x_in.requires_grad_(True)
        tap = zero_tap.clone().requires_grad_(True)
        with torch.enable_grad():
            x_out, probs = blk(xi, tap, H, eps)
            cot_x, grad_a = torch.autograd.grad(x_out, (xi, tap), cot_x)
        state = fold(state, _head_mean(model, rl.avg_heads(
            probs.detach().float(), grad_a.float())))
    return state


def relevancy_streamed(model: ViT, images: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """``relevancy`` without the [L, B, H, S, S] capture stacks: the
    per-layer VJPs of ``_streamed`` fold the whole rollout product,
    P ← P + P·Ê_l from the last layer to the first (P = I), so
    P = (I+Ê_L)···(I+Ê_1) = R. Returns P[:, 0, 1:]. Plain PyTorch."""
    B, S = images.shape[0], model.cfg.seq_len
    P = torch.eye(S, device=images.device).expand(B, S, S)
    P = _streamed(model, images, targets, P,
                  lambda P, e: P + torch.einsum("bij,bjk->bik", P, e))
    return P[:, 0, 1:]


def relevancy_streamed_row(model: ViT, images: torch.Tensor,
                           targets: torch.Tensor, row: int = 0
                           ) -> torch.Tensor:
    """Only the CLS row of ``relevancy``'s R: ``_streamed`` folding
    r ← r + r·Ê_l. Plain PyTorch."""
    B, S = images.shape[0], model.cfg.seq_len
    r = _streamed(model, images, targets, _row0(B, S, row, images.device),
                  lambda r, e: r + torch.einsum("bj,bjk->bk", r, e))
    return r[:, 1:]


# ---------------------------------------------------------------------------
# The fused paths. Each block is an attention part x → x_mid and an MLP part
# x_mid → x_out, each with a backward; every path tapes (x, x_mid, aux) per
# block, aux being what its MLP backward needs (the pre-GELU a1, or None).
# ``fast`` is the paths' ``fast_dots``: the kernels' bf16-product mode. The
# plain parts run in the tensors' dtype, as the JAX package leaves them to
# XLA; their LayerNorm VJPs take fp32 statistics whatever the dtype.
# ---------------------------------------------------------------------------

def _attn_flash(cfg: ViTConfig, blk: Block, x: torch.Tensor,
                fast: bool) -> torch.Tensor:
    """LN1 and the two products in plain torch, attention in
    ``flash_fwd_qkv``."""
    h1 = layer_norm(x, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    qkv = h1 @ blk.w_qkv + blk.b_qkv
    out = fa.flash_fwd_qkv(qkv, cfg.num_heads, fast_dots=fast)
    return x + out @ blk.w_out + blk.b_out


def _ln_fwd32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float):
    """``ab._ln_fwd`` with fp32 statistics for bf16 tensors (the JAX
    ``layer_norm``): (y in x's dtype, x̂, 1/σ)."""
    y, xh, inv = ab._ln_fwd(*map(fa.upcast, (x, scale, bias)), eps)
    return y.to(x.dtype), xh, inv


def _ln_vjp32(dy: torch.Tensor, scale: torch.Tensor, xh: torch.Tensor,
              inv: torch.Tensor) -> torch.Tensor:
    """``ab._ln_vjp`` in fp32 for bf16 cotangents, returned in dy's dtype."""
    return ab._ln_vjp(fa.upcast(dy), fa.upcast(scale), xh, inv).to(dy.dtype)


def _attn_flash_bwd(cfg: ViTConfig, blk: Block, x_in: torch.Tensor,
                    cot_mid: torch.Tensor, r: torch.Tensor, fast: bool):
    """qkv recomputed (one product), attention backward and the Ê fold in
    ``flash_bwd_ehat_qkv``, the other products and the LN1 VJP in plain
    torch. Returns (cot_x, e_row)."""
    h1, xh, inv = _ln_fwd32(x_in, blk.ln1_scale, blk.ln1_bias, cfg.ln_eps)
    qkv = h1 @ blk.w_qkv + blk.b_qkv
    d_qkv, e_row = fa.flash_bwd_ehat_qkv(qkv, cot_mid @ blk.w_out.T, r,
                                         cfg.num_heads, fast_dots=fast)
    d_x = _ln_vjp32(d_qkv @ blk.w_qkv.T, blk.ln1_scale, xh, inv)
    return cot_mid + d_x, e_row


def _attn_block(cfg: ViTConfig, blk: Block, x: torch.Tensor,
                fast: bool) -> torch.Tensor:
    return ab.attn_block_fwd(x, blk.w_qkv, blk.b_qkv, blk.w_out, blk.b_out,
                             blk.ln1_scale, blk.ln1_bias, cfg.num_heads,
                             cfg.ln_eps, fast_dots=fast)


def _attn_block_bwd(cfg: ViTConfig, blk: Block, x_in: torch.Tensor,
                    cot_mid: torch.Tensor, r: torch.Tensor, fast: bool):
    return ab.attn_block_bwd(x_in, cot_mid, r, blk.w_qkv, blk.b_qkv,
                             blk.w_out, blk.ln1_scale, blk.ln1_bias,
                             cfg.num_heads, cfg.ln_eps, fast_dots=fast)


def _mlp_taped(cfg: ViTConfig, blk: Block, x_mid: torch.Tensor, fast: bool):
    """LN2 + MLP + residual in plain torch, taping the pre-GELU a1."""
    h2 = layer_norm(x_mid, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    a1 = h2 @ blk.w1 + blk.b1
    return x_mid + gelu(a1) @ blk.w2 + blk.b2, a1


def _mlp_taped_bwd(cfg: ViTConfig, blk: Block, x_mid: torch.Tensor,
                   a1: torch.Tensor, cot_x: torch.Tensor,
                   fast: bool) -> torch.Tensor:
    """cot_mid from the taped a1: two products and the GELU and LN2 VJPs,
    plain torch (no forward product recomputed)."""
    d_a1 = ab._gelu_grad(a1) * (cot_x @ blk.w2.T)
    _, xh, inv = _ln_fwd32(x_mid, blk.ln2_scale, blk.ln2_bias, cfg.ln_eps)
    return cot_x + _ln_vjp32(d_a1 @ blk.w1.T, blk.ln2_scale, xh, inv)


def _mlp_block(cfg: ViTConfig, blk: Block, x_mid: torch.Tensor, fast: bool):
    return ab.mlp_block_fwd(x_mid, blk.w1, blk.b1, blk.w2, blk.b2,
                            blk.ln2_scale, blk.ln2_bias, cfg.ln_eps,
                            fast_dots=fast), None


def _mlp_block_bwd(cfg: ViTConfig, blk: Block, x_mid: torch.Tensor, _,
                   cot_x: torch.Tensor, fast: bool) -> torch.Tensor:
    return ab.mlp_block_bwd(x_mid, cot_x, blk.w1, blk.b1, blk.w2,
                            blk.ln2_scale, blk.ln2_bias, cfg.ln_eps,
                            fast_dots=fast)


# (attention fwd, attention bwd, MLP fwd, MLP bwd) of each fused path
_FUSED = (_attn_flash, _attn_flash_bwd, _mlp_taped, _mlp_taped_bwd)
_FUSED_BLOCK = (_attn_block, _attn_block_bwd, _mlp_taped, _mlp_taped_bwd)
_FUSED_BLOCK2 = (_attn_block, _attn_block_bwd, _mlp_block, _mlp_block_bwd)


def _fused_forward(model: ViT, images: torch.Tensor, parts, fast: bool):
    cfg = model.cfg
    attn, _, mlp, _ = parts

    def layer(blk, x):
        x_mid = attn(cfg, blk, x, fast)
        x_out, aux = mlp(cfg, blk, x_mid, fast)
        return x_out, (x, x_mid, aux)

    return _taped_forward(model, images, layer)


def _fused(model: ViT, images: torch.Tensor, targets: torch.Tensor,
           row: int, parts, fast: bool) -> torch.Tensor:
    """Taped forward, head cotangent, then per block in reverse the MLP and
    attention backwards; the attention backward also returns the rule-6
    increment e_row = r·Ê, so r ← r + e_row (r float32 whatever the
    tensors' dtype)."""
    cfg = model.cfg
    _, attn_bwd, _, mlp_bwd = parts
    B, S = images.shape[0], cfg.seq_len
    x, tape = _fused_forward(model, images, parts, fast)
    cot_x = _head_cotangent(model, x, targets)
    r = _row0(B, S, row, images.device)
    with torch.no_grad():
        for blk, (x_in, x_mid, aux) in zip(reversed(model.blocks),
                                           reversed(tape)):
            cot_mid = mlp_bwd(cfg, blk, x_mid, aux, cot_x, fast)
            cot_x, e_row = attn_bwd(cfg, blk, x_in, cot_mid, r, fast)
            r = r + e_row
    return r[:, 1:]


def _probe(model: ViT, images: torch.Tensor, parts, fast: bool
           ) -> torch.Tensor:
    x, _ = _fused_forward(model, images, parts, fast)
    with torch.no_grad():
        return _head(model, x)


def relevancy_fused(model: ViT, images: torch.Tensor, targets: torch.Tensor,
                    row: int = 0, fast_dots: bool = False) -> torch.Tensor:
    """``relevancy_streamed_row`` with the fused attention kernels: per
    layer ``flash_fwd_qkv`` forward and ``flash_bwd_ehat_qkv`` backward (A
    never stored; the backward also folds e_row = r·Ê). LN, the qkv, out
    and MLP products and the GELU and LN VJPs stay in plain torch, as the
    JAX path leaves them to XLA. The forward tapes (x, x_mid, a1), so the
    MLP backward recomputes no product. ``fast_dots``: the kernels'
    bf16-product mode (see ``relevancy_fused_block2``)."""
    return _fused(model, images, targets, row, _FUSED, fast_dots)


def relevancy_fused_block(model: ViT, images: torch.Tensor,
                          targets: torch.Tensor, row: int = 0,
                          fast_dots: bool = False) -> torch.Tensor:
    """``relevancy_fused`` with the whole attention branch of each block in
    ``ops/attn_block`` (``attn_block_fwd`` / ``attn_block_bwd``); the MLP
    stays in plain torch and tapes a1. ``fast_dots``: as
    ``relevancy_fused_block2``'s."""
    return _fused(model, images, targets, row, _FUSED_BLOCK, fast_dots)


def relevancy_fused_block2(model: ViT, images: torch.Tensor,
                           targets: torch.Tensor, row: int = 0,
                           fast_dots: bool = False) -> torch.Tensor:
    """``relevancy_streamed_row`` through the block kernels of
    ``ops/attn_block``: per layer ``attn_block_fwd`` then ``mlp_block_fwd``
    forward, taping only (x, x_mid); in reverse ``mlp_block_bwd`` (a1
    recomputed) then ``attn_block_bwd``, which also returns the rule-6
    increment e_row = r·Ê. On CUDA tensors every block runs in the
    hand-written kernels; on CPU tensors in their plain versions.

    ``fast_dots`` (the JAX wrappers' switch; ``False`` by default here):
    the kernels' bf16-product mode, every operand of their products
    rounded to bf16 and summed in fp32. A model cast to bfloat16
    (``model.to(torch.bfloat16)``) with bfloat16 images runs the JAX
    bench's throughput mode, which takes ``fast_dots=True`` on CUDA; r
    stays float32 and the maps are float32."""
    return _fused(model, images, targets, row, _FUSED_BLOCK2, fast_dots)


def relevancy_fused_forward_probe(model: ViT, images: torch.Tensor,
                                  fast_dots: bool = False) -> torch.Tensor:
    """The forward of ``relevancy_fused`` (embed, the taping blocks, the
    head), returning the logits: a forward/backward split probe."""
    return _probe(model, images, _FUSED, fast_dots)


def relevancy_fused_block_forward_probe(model: ViT, images: torch.Tensor,
                                        fast_dots: bool = False
                                        ) -> torch.Tensor:
    """The forward of ``relevancy_fused_block``, returning the logits."""
    return _probe(model, images, _FUSED_BLOCK, fast_dots)


def relevancy_fused_block2_forward_probe(model: ViT, images: torch.Tensor,
                                         fast_dots: bool = False
                                         ) -> torch.Tensor:
    """The forward of ``relevancy_fused_block2``, returning the logits."""
    return _probe(model, images, _FUSED_BLOCK2, fast_dots)

