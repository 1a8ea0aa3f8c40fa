"""DETR explanation generators (encoder-decoder relevancy), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/explain/detr.py``
(reference: DETR/modules/ExplanationGenerator.py).

``generate_ours`` (:142-195, the use_lrp=False path):
  R_ii = I; per encoder layer R_ii += Ê R_ii (rule 6);
  R_qq = I, R_qi = 0; per decoder layer rules 6+7 on the query
  self-attention, then rule 10 (with the NaN→0 guard, :42) on the
  cross-attention; the output is the row R_qi[target_query].

All K explained queries of an image share ONE forward and one K-batched
backward (``models/detr.capture_multi``), and every chain runs batched over
K with tensors (the functions of ``ops/relevancy`` take leading batch
axes), where the JAX package ``vmap``s a per-example chain.

The LRP methods (``ours_with_lrp``, ``transformer_att``, ``partial_lrp``)
read relprop cams (``models/detr_lrp``): the K relprops share the tape of
the one forward (``capture_multi(..., return_tape=True)``, or a forward
without gradients for ``partial_lrp``) and run batched over K. They take
the forward's key-padding bias, where the JAX package's ``_relprop_cams``
recomputes unmasked probabilities (it calls ``detr_lrp.relprop`` without
``mask=``): the reference's relprop reads the recorded inputs of the
masked forward (ROADMAP §C, intended departures).

With ``mesh`` (a ``parallel/mesh.make_mesh`` DeviceMesh), the "ours"
family's propagation runs sequence-parallel over ``mesh[sp_axis]``
(``parallel/sp.detr_chain``): right after the capture each rank keeps only
its row block of every encoder tap (and its key block of every
cross-attention tap) and drops the whole taps; the rows come back whole on
every rank. The other methods read one layer and ignore ``mesh``, as in
the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from transformer_mm_explainability_tpu_torch.models import detr as detr_model
from transformer_mm_explainability_tpu_torch.models import detr_lrp
from transformer_mm_explainability_tpu_torch.models.detr import DETRTaps
from transformer_mm_explainability_tpu_torch.ops import relevancy as rl
from transformer_mm_explainability_tpu_torch.parallel import sp as psp

# the reference mask generator's --method family
# (DETR/mask_generator.py:95-115)
DETR_METHODS = (
    "ours_with_lrp", "ours_no_lrp", "ours_no_lrp_no_norm",
    "ablation_no_self_in_10", "ablation_no_aggregation",
    "transformer_att", "partial_lrp", "raw_attn", "attn_gradcam",
    "rollout",
)
LRP_METHODS = ("ours_with_lrp", "transformer_att", "partial_lrp")


def _wide(dtype: torch.dtype) -> torch.dtype:
    # Ê and both carries accumulate in fp32 at least (float64 captures
    # give float64 rows), whatever the capture dtype
    return torch.promote_types(dtype, torch.float32)


def _avg(cam: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    dt = _wide(cam.dtype)
    return rl.avg_heads(cam.to(dt), grad.to(dt))


def relevancy_from_capture(
    attn: DETRTaps, grads: DETRTaps,
    normalize_self_attention: bool = True,
    apply_self_in_rule_10: bool = True,
    aggregate: bool = True,
    token_valid: Optional[torch.Tensor] = None,  # [S] 1 = real token
) -> torch.Tensor:
    """Propagation → full R_qi ``[..., Q, S]``. attn / grads leaves are
    ``[L, ..., H, ...]``: any batch axes (K queries) between the layer and
    head axes.

    ``token_valid`` marks the real (non-padded) encoder tokens: padded
    rows of R_ii stay identity rows whose plain eq. 8+9 division would be
    0/0; without the mask one padded token NaN-poisons the rule-10 product
    and the NaN→0 guard wipes EVERY cross-attention addition (see
    ``ops/relevancy.handle_residual``)."""
    enc = attn.enc_self
    batch = enc.shape[1:-3]
    S, Q = enc.shape[-1], attn.dec_self.shape[-1]
    dev, dt = enc.device, _wide(enc.dtype)
    R_ii = torch.eye(S, device=dev, dtype=dt).expand(batch + (S, S))
    for cam, grad in zip(attn.enc_self, grads.enc_self):
        add = _avg(cam, grad) @ R_ii
        R_ii = R_ii + add if aggregate else add

    R_qq = torch.eye(Q, device=dev, dtype=dt).expand(batch + (Q, Q))
    R_qi = torch.zeros(batch + (Q, S), device=dev, dtype=dt)
    for c_s, g_s, c_x, g_x in zip(attn.dec_self, grads.dec_self,
                                  attn.dec_cross, grads.dec_cross):
        add_qq, add_qi = rl.apply_self_attention_rules(R_qq, R_qi,
                                                       _avg(c_s, g_s))
        if aggregate:
            R_qq, R_qi = R_qq + add_qq, R_qi + add_qi
        else:
            R_qq, R_qi = add_qq, add_qi
        add_qi, _ = rl.apply_mm_attention_rules(
            R_qq, R_ii, _avg(c_x, g_x),
            apply_normalization=normalize_self_attention,
            apply_self_in_rule_10=apply_self_in_rule_10,
            nan_to_zero=True, q_valid=token_valid)
        R_qi = R_qi + add_qi if aggregate else add_qi
    return R_qi


def _token_valid(image: torch.Tensor, pad_valid: Optional[torch.Tensor],
                 cfg: detr_model.DETRConfig) -> Optional[torch.Tensor]:
    """pad_valid ``[H, W]`` → the flattened ``[S]`` encoder-token mask, the
    strided downsample of the captured forward (``models/detr.forward``)."""
    if pad_valid is None:
        return None
    Him, Wim = image.shape[:2]
    feat_hw = (Him // cfg.stride, Wim // cfg.stride)
    return detr_model.feature_valid(pad_valid, (Him, Wim),
                                    feat_hw).reshape(-1)


def _one_hots(target_queries: torch.Tensor, target_classes: torch.Tensor,
              cfg: detr_model.DETRConfig) -> torch.Tensor:
    """``[K, Q, C+1]`` per-query class one-hots (the backward's
    cotangents)."""
    K = target_queries.shape[0]
    oh = torch.zeros((K, cfg.num_queries, cfg.num_classes + 1),
                     device=target_queries.device)
    oh[torch.arange(K, device=oh.device), target_queries,
       target_classes] = 1.0
    return oh


def _rows(R_qi: torch.Tensor, target_queries: torch.Tensor) -> torch.Tensor:
    return R_qi[torch.arange(R_qi.shape[0], device=R_qi.device),
                target_queries]


def _targets(image, target_queries, target_classes, cfg):
    """``(queries [K], one-hots [K, Q, C+1])`` on the image's device; the
    targets may be numpy arrays or tensors."""
    tq = torch.as_tensor(target_queries, dtype=torch.long,
                         device=image.device)
    tc = torch.as_tensor(target_classes, dtype=torch.long,
                         device=image.device)
    return tq, _one_hots(tq, tc, cfg).to(image.dtype)


def _capture(params, image, target_queries, target_classes, cfg,
             pad_valid, return_tape: bool = False):
    """``capture_multi`` of the K targets → ``(queries, attn, grads,
    token_valid)``, and the forward's tape and the one-hots with
    ``return_tape``."""
    tq, oh = _targets(image, target_queries, target_classes, cfg)
    out, attn, grads = detr_model.capture_multi(params, image, oh, pad_valid,
                                                cfg, return_tape)
    got = (tq, attn, grads, _token_valid(image, pad_valid, cfg))
    return got + (out["tape"], oh) if return_tape else got


def _relprop_cams(params, tape, one_hots, cfg, last_cross_only=False):
    """The K relprops of one image's tape (``models/detr.forward(...,
    return_tape=True)``, B=1), batched over the K one-hot seeds, with the
    forward's key-padding bias: ``DETRTaps`` of ``[L, K, H, ...]`` cams.
    ``last_cross_only`` computes only ``dec_cross[-1]`` (the other
    families None), all that ``transformer_att`` and ``partial_lrp``
    read."""
    args = (params, tape, tape["hs"], one_hots, cfg,
            tape["key_padding_bias"])
    if last_cross_only:
        return DETRTaps(None, None, detr_lrp.last_cross_cam(*args)[None])
    return detr_lrp.relprop(*args)[1]


# the "ours" family: relevancy_from_capture's options per method name
# (mask_generator.py:95-115; the no-aggregation ablation,
# GeneratorAlbationNoAgg, ExplanationGenerator.py:310-403, also skips the
# normalisation)
OURS = {
    "ours_no_lrp": {},
    "ours_no_lrp_no_norm": {"normalize_self_attention": False},
    "ablation_no_self_in_10": {"apply_self_in_rule_10": False},
    "ablation_no_aggregation": {"normalize_self_attention": False,
                                "aggregate": False},
}


def rows_from_capture(method: str, attn: DETRTaps, grads: DETRTaps,
                      target_queries: torch.Tensor,
                      token_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """A non-LRP method's ``[K, S]`` rows from a K-batched capture
    (leaves ``[L, K, H, ...]``, ``models/detr.capture_multi``)."""
    if method in OURS:
        return _rows(relevancy_from_capture(attn, grads,
                                            token_valid=token_valid,
                                            **OURS[method]), target_queries)
    if method == "raw_attn":
        return generate_raw_attn(attn, target_queries)
    if method == "attn_gradcam":
        return generate_attn_gradcam(attn, grads, target_queries)
    if method == "rollout":
        return generate_rollout(attn, target_queries)
    raise ValueError(f"{method!r} is not a non-LRP DETR method")


def _sp_blocks(attn: DETRTaps, grads: DETRTaps, mesh, sp_axis: str):
    """This rank's ``parallel/sp.DetrBlocks`` of a K-batched capture
    (leaves ``[L, K, H, ...]``, moved K first as views)."""
    k_first = lambda t: t.movedim(1, 0)
    return psp.detr_blocks(
        k_first(attn.enc_self), k_first(grads.enc_self),
        k_first(attn.dec_self), k_first(grads.dec_self),
        k_first(attn.dec_cross), k_first(grads.dec_cross), mesh, sp_axis)


def generate_ours(
    params: Dict[str, Any],
    image: torch.Tensor,                 # [H, W, 3]
    target_queries,                      # [K] query indices
    target_classes,                      # [K] class indices
    cfg: detr_model.DETRConfig = detr_model.DETR_R50,
    pad_valid: Optional[torch.Tensor] = None,  # [H, W] 1 = valid
    normalize_self_attention: bool = True,
    apply_self_in_rule_10: bool = True,
    aggregate: bool = True,
    mesh=None,
    sp_axis: str = "tp",
) -> torch.Tensor:
    """K relevancy rows ``[K, S]``: one shared forward, one K-batched
    backward, the chains batched over K. With ``mesh`` the chain runs
    sequence-parallel over ``mesh[sp_axis]``: the same rows, split taps
    and carry."""
    tq, attn, grads, tv = _capture(params, image, target_queries,
                                   target_classes, cfg, pad_valid)
    ours = dict(normalize_self_attention=normalize_self_attention,
                apply_self_in_rule_10=apply_self_in_rule_10,
                aggregate=aggregate)
    if mesh is None:
        return _rows(relevancy_from_capture(attn, grads, token_valid=tv,
                                            **ours), tq)
    blocks = _sp_blocks(attn, grads, mesh, sp_axis)
    del attn, grads   # each rank keeps only its share of the taps
    return _rows(psp.detr_chain(blocks, mesh, sp_axis, token_valid=tv,
                                **ours), tq)


def generate_ours_no_agg(params, image, target_queries, target_classes,
                         cfg=detr_model.DETR_R50, pad_valid=None,
                         normalize_self_attention: bool = False,
                         mesh=None, sp_axis: str = "tp"):
    """Ablation: overwrite instead of aggregate."""
    return generate_ours(params, image, target_queries, target_classes, cfg,
                         pad_valid, normalize_self_attention, True,
                         aggregate=False, mesh=mesh, sp_axis=sp_axis)


def generate_ours_lrp(params, image, target_queries, target_classes,
                      cfg=detr_model.DETR_R50, pad_valid=None,
                      normalize_self_attention: bool = True,
                      apply_self_in_rule_10: bool = True,
                      mesh=None, sp_axis: str = "tp") -> torch.Tensor:
    """'ours_with_lrp' (ExplanationGenerator.py:142-195 use_lrp=True): the
    propagation chain on relprop cams in place of the probabilities. One
    forward and one K-batched backward give the gradients and the tape;
    the K relprops run batched on that tape. ``mesh``: as
    ``generate_ours``."""
    tq, _, grads, tv, tape, oh = _capture(params, image, target_queries,
                                          target_classes, cfg, pad_valid,
                                          return_tape=True)
    cams = _relprop_cams(params, tape, oh, cfg)
    del tape
    ours = dict(normalize_self_attention=normalize_self_attention,
                apply_self_in_rule_10=apply_self_in_rule_10)
    if mesh is None:
        return _rows(relevancy_from_capture(cams, grads, token_valid=tv,
                                            **ours), tq)
    blocks = _sp_blocks(cams, grads, mesh, sp_axis)
    del cams, grads   # each rank keeps only its share of the taps
    return _rows(psp.detr_chain(blocks, mesh, sp_axis, token_valid=tv,
                                **ours), tq)


def _lrp_rows(method, params, image, target_queries, target_classes, cfg,
              pad_valid) -> torch.Tensor:
    if method == "ours_with_lrp":
        return generate_ours_lrp(params, image, target_queries,
                                 target_classes, cfg, pad_valid)
    if method == "transformer_att":
        tq, _, grads, _, tape, oh = _capture(
            params, image, target_queries, target_classes, cfg, pad_valid,
            return_tape=True)
        cams = _relprop_cams(params, tape, oh, cfg, last_cross_only=True)
        return generate_transformer_att(cams, grads, tq)
    # partial_lrp reads relprop cams only: a forward without gradients
    tq, oh = _targets(image, target_queries, target_classes, cfg)
    with torch.no_grad():
        tape = detr_model.forward(
            params, image[None], None if pad_valid is None else pad_valid[None],
            cfg, return_tape=True)["tape"]
        cams = _relprop_cams(params, tape, oh, cfg, last_cross_only=True)
    return generate_partial_lrp(cams, tq)


def generate(method: str, params, image, target_queries, target_classes,
             cfg=detr_model.DETR_R50, pad_valid=None, mesh=None,
             sp_axis: str = "tp") -> torch.Tensor:
    """Dispatch a reference method name → ``[K, S]`` relevancy rows
    (mask_generator.py:95-115): one ``capture_multi`` (the forward's tape
    too for the LRP methods but ``partial_lrp``, which needs no
    gradients), then the method's rows. ``target_queries`` /
    ``target_classes`` may be numpy arrays or tensors. With ``mesh``, the
    "ours" family's propagation (``OURS`` and ``ours_with_lrp``) runs
    sequence-parallel over ``mesh[sp_axis]``."""
    if method not in DETR_METHODS:
        raise ValueError(
            f"unknown DETR explanation method {method!r}; valid: "
            f"{sorted(DETR_METHODS)}")
    if mesh is not None and method in OURS:
        return generate_ours(params, image, target_queries, target_classes,
                             cfg, pad_valid, **OURS[method], mesh=mesh,
                             sp_axis=sp_axis)
    if mesh is not None and method == "ours_with_lrp":
        return generate_ours_lrp(params, image, target_queries,
                                 target_classes, cfg, pad_valid, mesh=mesh,
                                 sp_axis=sp_axis)
    if method in LRP_METHODS:
        return _lrp_rows(method, params, image, target_queries,
                         target_classes, cfg, pad_valid)
    tq, attn, grads, tv = _capture(params, image, target_queries,
                                   target_classes, cfg, pad_valid)
    return rows_from_capture(method, attn, grads, tq, tv)


def generate_transformer_att(cams: DETRTaps, grads: DETRTaps,
                             target_queries: torch.Tensor) -> torch.Tensor:
    """transformer_att baseline (:64-108): the head mean of the LAST
    decoder cross-attention's relu(LRP cam ⊙ grad)."""
    return _rows(_avg(cams.dec_cross[-1], grads.dec_cross[-1]),
                 target_queries)


def generate_partial_lrp(cams: DETRTaps, target_queries: torch.Tensor
                         ) -> torch.Tensor:
    """partial_lrp (:197-224): head mean of the last decoder cross cam,
    min-max normalised per query."""
    cam = cams.dec_cross[-1].mean(dim=1)                 # [K, Q, S]
    lo = cam.amin(dim=(1, 2), keepdim=True)
    hi = cam.amax(dim=(1, 2), keepdim=True)
    return _rows((cam - lo) / (hi - lo), target_queries)


# --- capture-only baselines ------------------------------------------------

def generate_raw_attn(attn: DETRTaps, target_queries: torch.Tensor
                      ) -> torch.Tensor:
    """Head-mean of the last decoder cross-attention (:226-238)."""
    return _rows(attn.dec_cross[-1].mean(dim=1), target_queries)


def generate_attn_gradcam(attn: DETRTaps, grads: DETRTaps,
                          target_queries: torch.Tensor) -> torch.Tensor:
    """GradCAM on the last decoder cross-attention (:282-305)."""
    return _rows(rl.grad_cam(attn.dec_cross[-1], grads.dec_cross[-1]),
                 target_queries)


def generate_rollout(attn: DETRTaps, target_queries: torch.Tensor
                     ) -> torch.Tensor:
    """Rollout baseline (:240-273): separate image and query rollouts
    bridged by the last cross-attention's head mean."""
    R_ii = rl.compute_rollout_attention(attn.enc_self.mean(dim=2).movedim(0, 1))
    R_qq = rl.compute_rollout_attention(attn.dec_self.mean(dim=2).movedim(0, 1))
    cam_qi = attn.dec_cross[-1].mean(dim=1)
    return _rows(R_qq.transpose(-1, -2) @ (cam_qi @ R_ii), target_queries)
