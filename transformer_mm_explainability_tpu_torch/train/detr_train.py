"""DETR training step (C37: main.py/engine.py train path), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/train/detr_train.py``.
One forward per update: the Hungarian assignment is solved on the host
(``models/matcher.match``) from that forward's detached outputs, then the
set-criterion losses of the same forward are differentiated. The JAX
package runs the forward twice (a jitted predict for the matcher, then the
loss-and-gradient program); the assignment and the losses are the same.
Loss weights follow the reference (ce 1, bbox 5, giou 2; eos coef 0.1;
DETR/main.py args).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.models import detr as detr_model
from transformer_mm_explainability_tpu_torch.models import matcher
from transformer_mm_explainability_tpu_torch.train import steps

LOSS_WEIGHTS = {"loss_ce": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0}


def make_detr_train_step(cfg: detr_model.DETRConfig, tx: steps.Recipe,
                         eos_coef: float = 0.1):
    """Returns (predict_fn, step_fn):
      predict_fn(params, images) → (pred_logits, pred_boxes), no graph;
      step_fn(state, batch, match_cfg) → (state, loss dict),
        ``batch`` = {images, tgt_labels, tgt_boxes, n_valid}; the state is
        updated in place.
    Drive with ``train_batch``."""

    def predict(params, images):
        with torch.no_grad():
            out = detr_model.forward(params, images, cfg=cfg)
        return out["pred_logits"], out["pred_boxes"]

    def loss_fn(params, batch):
        out = detr_model.forward(params, batch["images"], cfg=cfg)
        assignment = matcher.match(
            out["pred_logits"].detach(), out["pred_boxes"].detach(),
            batch["tgt_labels"], batch["tgt_boxes"], batch["n_valid"],
            batch["match_cfg"])
        losses = matcher.set_criterion_losses(
            out["pred_logits"], out["pred_boxes"],
            batch["tgt_labels"], batch["tgt_boxes"], assignment,
            eos_coef=eos_coef, num_classes=cfg.num_classes)
        total = sum(LOSS_WEIGHTS[k] * losses[k] for k in LOSS_WEIGHTS)
        return total, losses

    def step(state: steps.TrainState, batch: Dict[str, Any],
             match_cfg: matcher.MatcherConfig = matcher.MatcherConfig()):
        if state.opt_state.recipe is not tx:
            raise ValueError("the state's optimizer was not made by this "
                             "step's tx (init_state(params, tx))")
        (total, losses), grads = steps.value_and_grad(
            loss_fn, state.params, dict(batch, match_cfg=match_cfg),
            has_aux=True)
        state.opt_state.apply(grads)
        state.step += 1
        return state, dict(losses, loss=total)

    return predict, step


def train_batch(params_state: steps.TrainState, images, tgt_labels,
                tgt_boxes, n_valid, predict, step,
                match_cfg: matcher.MatcherConfig = matcher.MatcherConfig()
                ) -> Tuple[steps.TrainState, Dict[str, torch.Tensor]]:
    """One full update: forward → host Hungarian on its outputs →
    loss/grad → update. Returns ``(state, losses)`` with the JAX step's
    keys (``loss_ce``, ``loss_bbox``, ``loss_giou``,
    ``cardinality_error``, ``loss``). The assignment is
    ``matcher.match`` of ``predict``'s outputs before the update;
    ``predict`` itself is not called here: the step matches on its own
    forward."""
    del predict
    return step(params_state, {"images": images, "tgt_labels": tgt_labels,
                               "tgt_boxes": tgt_boxes,
                               "n_valid": np.asarray(n_valid)}, match_cfg)
