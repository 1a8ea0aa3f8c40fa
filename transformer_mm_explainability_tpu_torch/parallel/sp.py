"""Sequence-parallel relevancy chains over ``torch.distributed``.

Counterpart of ``transformer_mm_explainability_tpu/parallel/sp.py``. The
relevancy state is O(S²) per modality pair, the largest tensor of the
pipeline (DETR's ``R_i_i`` at 800 px, S = 850 to 1,050, behind [L, K, H,
S, S] taps). The chain ``R ← R + Ê·R`` is a row-parallel product
recurrence over the ranks of one mesh axis (``tp`` by default):

  * rows of every per-layer Ê (and of ``R``) are split over the k ranks of
    the axis: each rank keeps a ``[S/k, S]`` block of each tap as soon as
    it gets them (``row_block``), so the taps' copies, Ê and the state
    shrink by k;
  * per layer, one all-gather of the current ``R`` assembles the right
    operand, and each rank computes its row block ``R_loc += Ê_loc @
    R_full``;
  * the result is gathered whole on every rank.

The math is ``ops/relevancy.self_attention_relevancy``,
``self_attention_relevancy_update``, ``compute_rollout_attention`` and
``explain/detr.relevancy_from_capture``; only the layout differs. Padding
S to a multiple of k is exact: padded Ê rows and columns are zero, padded
rows of ``R`` stay identity rows, and padded columns never contribute.
Each function takes whole tensors on every rank and returns whole ones.
Arithmetic is fp32 at least (float64 inputs stay float64), as the
unsharded functions'. The chains are plain PyTorch, as the JAX package's
are plain ``jnp``: kernel #9 (``ops/relevancy_pallas``) takes the whole
rows of a batch and is not on this path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from transformer_mm_explainability_tpu_torch.ops import relevancy as rl
from transformer_mm_explainability_tpu_torch.parallel.mesh import (
    all_reduce, axis_rank, axis_size, gather)


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _blocking(S: int, mesh: DeviceMesh, axis: str) -> Tuple[int, int, int]:
    """(padded S, rows a rank holds, this rank's index on the axis)."""
    k = axis_size(mesh, axis)
    s_pad = -(-S // k) * k
    return s_pad, s_pad // k, axis_rank(mesh, axis)


def row_block(x: torch.Tensor, mesh: DeviceMesh, axis: str,
              pad_cols: bool = True) -> torch.Tensor:
    """This rank's block of the rows (axis -2) of ``x`` ``[..., S, S]``,
    zero-padded to ``[..., S_pad/k, S_pad]`` (only the block is copied)."""
    S = x.shape[-2]
    s_pad, sl, r = _blocking(S, mesh, axis)
    lo, hi = min(r * sl, S), min((r + 1) * sl, S)
    out = x.new_zeros(x.shape[:-2] + (sl, s_pad if pad_cols
                                      else x.shape[-1]))
    out[..., :hi - lo, :x.shape[-1]] = x[..., lo:hi, :]
    return out


def col_block(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """This rank's block of the columns (axis -1) of ``x`` ``[..., Q, S]``,
    zero-padded to ``[..., Q, S_pad/k]``."""
    return row_block(x.transpose(-1, -2), mesh, axis,
                     pad_cols=False).transpose(-1, -2)


def _identity_rows(mesh: DeviceMesh, axis: str, sl: int, s_pad: int,
                   like: torch.Tensor) -> torch.Tensor:
    """This rank's ``[sl, s_pad]`` block of eye(s_pad)."""
    r = axis_rank(mesh, axis)
    return torch.eye(s_pad, dtype=like.dtype, device=like.device)[
        r * sl:(r + 1) * sl]


def sp_self_attention_relevancy(
    cams: torch.Tensor,
    grads: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    start_layer: int = 0,
) -> torch.Tensor:
    """Sequence-parallel ``ops/relevancy.self_attention_relevancy`` of
    ``[L, H, S, S]`` captures → ``[S, S]``, whole on every rank."""
    S = cams.shape[-1]
    s_pad, sl, _ = _blocking(S, mesh, axis)
    e_loc = rl.e_hats(row_block(cams, mesh, axis),
                      row_block(grads, mesh, axis))[start_layer:]
    r_loc = _identity_rows(mesh, axis, sl, s_pad, e_loc)
    for e_l in e_loc:
        r_loc = r_loc + e_l @ gather(r_loc, mesh, axis)
    return gather(r_loc, mesh, axis)[:S, :S]


def sp_self_attention_update(
    R_ss: torch.Tensor,
    R_sq: torch.Tensor,
    cams: torch.Tensor,
    grads: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    aggregate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-parallel rules 6+7 over ``[L, H, S, S]`` captures
    (``ops/relevancy.self_attention_relevancy_update``): ``R_ss`` ``[S, S]``
    and ``R_sq`` ``[S, Q]`` row-split; per layer both are gathered once and
    each rank adds its rows of ``Ê @ R``. Returns both whole."""
    S, Q = cams.shape[-1], R_sq.shape[-1]
    e_loc = rl.e_hats(row_block(cams, mesh, axis),
                      row_block(grads, mesh, axis))
    rss_loc = row_block(R_ss, mesh, axis).to(e_loc.dtype)
    rsq_loc = row_block(R_sq, mesh, axis, pad_cols=False).to(e_loc.dtype)
    for e_l in e_loc:
        add_ss = e_l @ gather(rss_loc, mesh, axis)
        add_sq = e_l @ gather(rsq_loc, mesh, axis)
        if aggregate:
            rss_loc, rsq_loc = rss_loc + add_ss, rsq_loc + add_sq
        else:
            rss_loc, rsq_loc = add_ss, add_sq
    return (gather(rss_loc, mesh, axis)[:S, :S],
            gather(rsq_loc, mesh, axis)[:S, :Q])


class DetrBlocks(NamedTuple):
    """One rank's share of a K-batched DETR capture (K first): the row
    blocks of the encoder taps ``[K, Le, H, S_pad/k, S_pad]``, the decoder
    self-attention taps whole ``[K, Ld, H, Q, Q]``, the key-column blocks
    of the cross-attention taps ``[K, Ld, H, Q, S_pad/k]``, and S."""
    enc_cams: torch.Tensor
    enc_grads: torch.Tensor
    dec_self_cams: torch.Tensor
    dec_self_grads: torch.Tensor
    dec_cross_cams: torch.Tensor
    dec_cross_grads: torch.Tensor
    S: int


def detr_blocks(enc_cams, enc_grads, dec_self_cams, dec_self_grads,
                dec_cross_cams, dec_cross_grads, mesh: DeviceMesh,
                axis: str = "tp") -> DetrBlocks:
    """This rank's ``DetrBlocks`` of whole taps (K first; views are fine):
    only the blocks are copied, so the caller can drop the whole taps."""
    return DetrBlocks(row_block(enc_cams, mesh, axis),
                      row_block(enc_grads, mesh, axis),
                      dec_self_cams, dec_self_grads,
                      col_block(dec_cross_cams, mesh, axis),
                      col_block(dec_cross_grads, mesh, axis),
                      enc_cams.shape[-1])


def detr_chain(blocks: DetrBlocks, mesh: DeviceMesh, axis: str = "tp",
               normalize_self_attention: bool = True,
               apply_self_in_rule_10: bool = True,
               aggregate: bool = True,
               token_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sp_detr_relevancy`` on one rank's ``DetrBlocks`` → ``[K, Q, S]``,
    whole on every rank.

    The encoder chain is ``sp_self_attention_relevancy``'s recurrence;
    eq. 8+9 on ``R_i_i`` is row-local (rows are whole in a block); the
    decoder carries ``R_q_q`` ``[K, Q, Q]`` and ``R_q_i`` ``[K, Q, S]`` are
    small and every rank holds them whole; the rule-10 bridge
    ``Ê_qi @ norm(R_i_i)`` contracts over the split rows, so each rank's
    partial product of its key block is summed over the axis (one
    all-reduce per decoder layer). Padded tokens' rows are pinned inert by
    the valid mask (``ops/relevancy.handle_residual`` documents the NaN
    poisoning it prevents); ``token_valid`` ``[S]`` defaults to all real."""
    S = blocks.S
    s_pad, sl, r = _blocking(S, mesh, axis)
    K, Q = blocks.dec_self_cams.shape[0], blocks.dec_self_cams.shape[-1]
    e_enc = rl.e_hats(blocks.enc_cams, blocks.enc_grads)   # [K, Le, sl, Sp]
    dt, dev = e_enc.dtype, e_enc.device
    eye_loc = _identity_rows(mesh, axis, sl, s_pad, e_enc)
    valid = torch.zeros(s_pad, dtype=dt, device=dev)
    valid[:S] = 1.0 if token_valid is None else token_valid.to(dt)
    valid_loc = valid[r * sl:(r + 1) * sl, None]

    r_loc = eye_loc.expand(K, sl, s_pad)
    for layer in range(e_enc.shape[1]):
        add = e_enc[:, layer] @ gather(r_loc, mesh, axis, dim=1)
        r_loc = r_loc + add if aggregate else add
    if normalize_self_attention:
        r_hat = r_loc - eye_loc
        denom = torch.where(valid_loc > 0, r_hat.sum(-1, keepdim=True),
                            torch.ones_like(valid_loc))
        r_ii = r_hat * valid_loc / denom + eye_loc
    else:
        r_ii = r_loc

    eye_q = torch.eye(Q, dtype=dt, device=dev)
    R_qq = eye_q.expand(K, Q, Q)
    R_qi = torch.zeros((K, Q, s_pad), dtype=dt, device=dev)
    for layer in range(blocks.dec_self_cams.shape[1]):
        e_qq = rl.e_hats(blocks.dec_self_cams[:, layer],
                         blocks.dec_self_grads[:, layer])   # [K, Q, Q]
        add_qq, add_qi = e_qq @ R_qq, e_qq @ R_qi
        if aggregate:
            R_qq, R_qi = R_qq + add_qq, R_qi + add_qi
        else:
            R_qq, R_qi = add_qq, add_qi
        cam_qi = rl.e_hats(blocks.dec_cross_cams[:, layer],
                           blocks.dec_cross_grads[:, layer])   # [K, Q, sl]
        if apply_self_in_rule_10:
            inner = all_reduce(cam_qi @ r_ii, mesh, axis)      # [K, Q, Sp]
            if normalize_self_attention:
                q_hat = R_qq - eye_q
                q_norm = q_hat / q_hat.sum(-1, keepdim=True) + eye_q
            else:
                q_norm = R_qq
            add = q_norm.transpose(-1, -2) @ inner
        else:
            add = gather(cam_qi, mesh, axis, dim=-1)
        add = torch.nan_to_num(add, nan=0.0)
        R_qi = R_qi + add if aggregate else add
    return R_qi[..., :S]


def sp_detr_relevancy(
    enc_cams: torch.Tensor,        # [K, Le, H, S, S]
    enc_grads: torch.Tensor,       # [K, Le, H, S, S]
    dec_self_cams: torch.Tensor,   # [K, Ld, H, Q, Q]
    dec_self_grads: torch.Tensor,  # [K, Ld, H, Q, Q]
    dec_cross_cams: torch.Tensor,  # [K, Ld, H, Q, S]
    dec_cross_grads: torch.Tensor,  # [K, Ld, H, Q, S]
    mesh: DeviceMesh,
    axis: str = "tp",
    normalize_self_attention: bool = True,
    apply_self_in_rule_10: bool = True,
    aggregate: bool = True,
    token_valid: Optional[torch.Tensor] = None,   # [S] 1 = real token
) -> torch.Tensor:
    """Sequence-parallel DETR propagation → ``R_q_i`` ``[K, Q, S]``: the
    counterpart of ``explain/detr.relevancy_from_capture`` (reference
    DETR/modules/ExplanationGenerator.py:110-195) with the encoder taps and
    ``R_i_i`` split by rows over ``mesh[axis]`` (``detr_chain``)."""
    return detr_chain(
        detr_blocks(enc_cams, enc_grads, dec_self_cams, dec_self_grads,
                    dec_cross_cams, dec_cross_grads, mesh, axis),
        mesh, axis, normalize_self_attention, apply_self_in_rule_10,
        aggregate, token_valid)


def sp_rollout_attention(
    layer_matrices: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "tp",
    start_layer: int = 0,
    normalize: bool = True,
) -> torch.Tensor:
    """Sequence-parallel ``ops/relevancy.compute_rollout_attention`` of
    ``[L, S, S]`` head-averaged attention maps → ``[S, S]``, whole on every
    rank. The residual identity and the row normalisation are local to a
    row block; only the chain's product gathers."""
    S = layer_matrices.shape[-1]
    s_pad, sl, _ = _blocking(S, mesh, axis)
    m_loc = row_block(layer_matrices, mesh, axis)
    m_loc = m_loc.to(_wide(m_loc.dtype))
    m_loc = m_loc + _identity_rows(mesh, axis, sl, s_pad, m_loc)
    if normalize:
        # padded rows are identity rows (sum 1): they stay inert
        m_loc = m_loc / m_loc.sum(-1, keepdim=True)
    m_loc = m_loc[start_layer:]
    j_loc = m_loc[0]
    for a_loc in m_loc[1:]:
        j_loc = a_loc @ gather(j_loc, mesh, axis)
    return gather(j_loc, mesh, axis)[:S, :S]
