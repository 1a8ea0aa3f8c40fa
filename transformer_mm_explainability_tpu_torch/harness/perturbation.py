"""Positive/negative perturbation evaluation (the paper's quantitative
benchmark), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/perturbation.py``.
Reference protocols:
  * VisualBERT: image steps [0,.5,.75,.95,.96,.97,.98,.99,1], text steps
    [0,.25,.5,.75,.8,.85,.9,.95,1]; keep the top (1−p) tokens / boxes by
    relevancy (negated for positive perturbation); accuracy = the soft
    target of the argmax answer.
  * LXMERT: steps [0,.25,.5,.75,.8,.85,.9,.95,1] for both modalities; text
    keeps [CLS]/[SEP] and keeps the kept tokens in order.

All steps of all samples ride one batch axis through one forward, as in
JAX: dropping a box is the additive −10000 attention mask (the same as
removing it), dropping tokens packs the kept ones into a contiguous
prefix, in order. ``topk_keep_mask`` and ``gather_kept_prefix`` take any
number of leading batch axes. Rankings use a stable sort, as
``jnp.argsort`` does: padded boxes (−inf) and zero relevancies tie.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

IMAGE_STEPS_VISUALBERT = (0.0, 0.5, 0.75, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0)
TEXT_STEPS = (0.0, 0.25, 0.5, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0)
LXMERT_STEPS = TEXT_STEPS

Batch = Dict[str, torch.Tensor]


def _num_keep_table(steps: Sequence[float], n_max: int,
                    device=None) -> torch.Tensor:
    """``int((1 - step) * n)`` for every n in [0, n_max], in host float64
    (float32 is off by one at boundaries, e.g. step 0.9, n 10). Returns
    ``[n_steps, n_max + 1]`` int64."""
    return torch.tensor(
        [[int((1.0 - s) * n) for n in range(n_max + 1)] for s in steps],
        dtype=torch.long, device=device)


def topk_keep_mask(cam: torch.Tensor, num_keep: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean keep mask of the ``num_keep`` highest-relevancy entries.

    ``cam``: ``[..., N]`` relevancy (already negated for positive
    perturbation); ``num_keep``: ``[...]``; ``valid``: ``[..., N]`` entries
    eligible for ranking (the others rank last)."""
    if valid is not None:
        cam = torch.where(valid.bool(), cam,
                          torch.full_like(cam, float("-inf")))
    order = torch.argsort(-cam, dim=-1, stable=True)         # descending
    ar = torch.arange(cam.shape[-1], device=cam.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(-1, order, ar.contiguous())
    return ranks < torch.as_tensor(num_keep, device=cam.device)[..., None]


def gather_kept_prefix(tokens: torch.Tensor, keep: torch.Tensor,
                       pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack the kept tokens of ``[..., N]`` into a contiguous prefix in
    order (the reference's physical removal). Returns ``(packed_tokens,
    packed_mask)``, the mask int32."""
    N = tokens.shape[-1]
    dest = torch.cumsum(keep.long(), dim=-1) - 1
    dest = torch.where(keep, dest, torch.full_like(dest, N))  # → overflow
    packed = torch.full(tokens.shape[:-1] + (N + 1,), pad_id,
                        dtype=tokens.dtype, device=tokens.device)
    packed = packed.scatter(-1, dest, tokens)[..., :N]
    n_keep = keep.long().sum(-1, keepdim=True)
    mask = (torch.arange(N, device=tokens.device) < n_keep).to(torch.int32)
    return packed, mask


def _repeat(batch: Batch, n: int) -> Batch:
    return {k: v.repeat_interleave(n, dim=0) for k, v in batch.items()}


def _picked(targets: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """``targets[n, argmax scores[n, s]]`` → ``[N, n_steps]``."""
    return torch.gather(targets, 1, scores.argmax(-1))


def run_image_perturbation(
        forward_scores: Callable[[Batch], torch.Tensor], batch: Batch,
        cam_image: torch.Tensor, targets: torch.Tensor,
        steps: Sequence[float], positive: bool,
        num_boxes: Optional[torch.Tensor] = None,
        visual_mask_key: str = "visual_mask") -> torch.Tensor:
    """Per-step accuracies ``[len(steps)]`` for ONE sample (batch leaves
    ``[1, ...]``, ``cam_image`` ``[N_boxes]``, ``targets`` ``[labels]``);
    ``forward_scores`` is called once with B = len(steps)."""
    nb = None if num_boxes is None else torch.as_tensor(num_boxes).reshape(1)
    return run_image_perturbation_batch(
        forward_scores, batch, cam_image[None], targets[None], steps,
        positive, nb, visual_mask_key)[0]


def run_text_perturbation(
        forward_scores: Callable[[Batch], torch.Tensor], batch: Batch,
        cam_text: torch.Tensor, targets: torch.Tensor,
        steps: Sequence[float], positive: bool, always_keep: torch.Tensor,
        text_len, input_ids_key: str = "input_ids",
        input_mask_key: str = "input_mask",
        extra_gather_keys: Sequence[str] = ()) -> torch.Tensor:
    """Per-step accuracies for the text perturbation of one sample: ranks
    only unprotected valid tokens and packs the kept ones, in order, into
    a prefix (``extra_gather_keys`` are packed the same way)."""
    text_len = torch.as_tensor(text_len, device=cam_text.device).reshape(1)
    return run_text_perturbation_batch(
        forward_scores, batch, cam_text[None], targets[None], steps,
        positive, always_keep[None], text_len, input_ids_key,
        input_mask_key, extra_gather_keys)[0]


def run_image_perturbation_batch(
        forward_scores: Callable[[Batch], torch.Tensor], batch: Batch,
        cam_image: torch.Tensor, targets: torch.Tensor,
        steps: Sequence[float], positive: bool,
        num_boxes: Optional[torch.Tensor] = None,
        visual_mask_key: str = "visual_mask") -> torch.Tensor:
    """N samples × n_steps on one batch axis (B = N·n_steps) through one
    forward. ``cam_image`` ``[N, N_boxes]``, ``targets`` ``[N, labels]``.
    Returns ``[N, n_steps]`` per-step accuracies."""
    N, Nb = cam_image.shape
    dev = cam_image.device
    cam = -cam_image if positive else cam_image
    num_boxes = (torch.full((N,), Nb, device=dev) if num_boxes is None
                 else torch.as_tensor(num_boxes, device=dev).long())
    n_steps = len(steps)
    num_keep = _num_keep_table(steps, Nb, dev)[:, num_boxes].T    # [N, S]
    valid = torch.arange(Nb, device=dev)[None, :] < num_boxes[:, None]
    keeps = topk_keep_mask(cam[:, None, :].expand(N, n_steps, Nb), num_keep,
                           valid[:, None, :].expand(N, n_steps, Nb))
    big = _repeat(batch, n_steps)
    big[visual_mask_key] = keeps.reshape(N * n_steps, Nb).to(torch.int32)
    scores = forward_scores(big).reshape(N, n_steps, -1)
    return _picked(targets, scores)


def run_text_perturbation_batch(
        forward_scores: Callable[[Batch], torch.Tensor], batch: Batch,
        cam_text: torch.Tensor, targets: torch.Tensor,
        steps: Sequence[float], positive: bool, always_keep: torch.Tensor,
        text_len: torch.Tensor, input_ids_key: str = "input_ids",
        input_mask_key: str = "input_mask",
        extra_gather_keys: Sequence[str] = ()) -> torch.Tensor:
    """N samples × n_steps of text perturbation in one forward.
    ``cam_text`` ``[N, S_text]``, ``always_keep`` ``[N, S_text]`` bool,
    ``text_len`` ``[N]``. Returns ``[N, n_steps]``."""
    N, S = cam_text.shape
    dev = cam_text.device
    cam = -cam_text if positive else cam_text
    n_steps = len(steps)
    text_len = torch.as_tensor(text_len, device=dev)
    valid = torch.arange(S, device=dev)[None, :] < text_len[:, None]
    rankable = valid & ~always_keep
    num_keep = _num_keep_table(steps, S, dev)[:, rankable.sum(1)].T  # [N, S]
    steps_of = lambda t: t[:, None, :].expand(N, n_steps, S)
    keep_ranked = topk_keep_mask(steps_of(cam), num_keep, steps_of(rankable))
    keep = (keep_ranked & steps_of(rankable)) | steps_of(always_keep & valid)
    big = _repeat(batch, n_steps)
    for key in (input_ids_key,) + tuple(extra_gather_keys):
        packed, mask = gather_kept_prefix(steps_of(batch[key]), keep)
        big[key] = packed.reshape(N * n_steps, S)
    big[input_mask_key] = mask.reshape(N * n_steps, S)
    scores = forward_scores(big).reshape(N, n_steps, -1)
    return _picked(targets, scores)


def auc(step_accs: np.ndarray, steps: Sequence[float]) -> float:
    """Area under the per-step accuracy curve (trapezoidal over the
    perturbation fractions), the paper's summary metric."""
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2.0
    return float(trapezoid(step_accs, x=np.asarray(steps)))
