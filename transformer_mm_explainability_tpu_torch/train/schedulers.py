"""LR-schedule registry — MMF's four registered schedulers + adam_w
(C24/C25).

Counterpart of ``transformer_mm_explainability_tpu/train/schedulers.py``
(``VisualBERT/mmf/modules/schedulers.py``: pythia:14, warmup_linear:28,
warmup_cosine:34, multi_step:40; ``mmf/modules/optimizers.py``: adam_w:7;
the ``pythia`` lambda of ``mmf/utils/general.py:18-24``).

Each scheduler is a factory returning ``schedule(step) -> multiplier``
(torch's ``LambdaLR`` contract: the base lr times the returned factor).
The optimizers are registered under the JAX package's names (``Adamax``,
``Adam``, ``AdamW``, ``SGD``, ``adam_w``, ``bert_adam``) and return a
``train/steps.Recipe`` with the update rule of the optax transformation
the JAX package maps the name to (``steps.Adam`` and ``steps.SGD`` in
optax's float32 order; ``torch.optim.Adamax``, whose rule is optax's).
"""

from __future__ import annotations

import bisect
import functools
import math
from typing import Sequence

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.train import steps
from transformer_mm_explainability_tpu_torch.train.steps import Schedule

f32 = np.float32


@registry.register_scheduler("pythia")
def pythia(use_warmup: bool = False, warmup_iterations: int = 1000,
           warmup_factor: float = 0.2,
           lr_steps: Sequence[int] = (14000,),
           lr_ratio: float = 0.1) -> Schedule:
    """PythiaScheduler (schedulers.py:14-25) over lr_lambda_update
    (general.py:18-24): optional linear warmup from ``warmup_factor``,
    then staircase decay by ``lr_ratio`` at each milestone, at
    ``bisect_right(lr_steps, step)``."""
    milestones = sorted(lr_steps)

    def schedule(step):
        decay = lr_ratio ** bisect.bisect_right(milestones, step)
        if use_warmup and step <= warmup_iterations:
            alpha = step / float(warmup_iterations)
            return warmup_factor * (1.0 - alpha) + alpha
        return decay

    return schedule


@registry.register_scheduler("warmup_linear")
def warmup_linear(num_warmup_steps: int, num_training_steps: int
                  ) -> Schedule:
    """WarmupLinearScheduler (schedulers.py:28-31) ==
    transformers.get_linear_schedule_with_warmup: linear 0→1 over the
    warmup, then linear 1→0 to the end (float32, as the JAX package)."""
    def schedule(step):
        step = f32(step)
        if step < num_warmup_steps:
            return float(step / f32(max(1.0, num_warmup_steps)))
        return float(max(f32(0.0), (f32(num_training_steps) - step) / f32(
            max(1.0, num_training_steps - num_warmup_steps))))

    return schedule


@registry.register_scheduler("warmup_cosine")
def warmup_cosine(num_warmup_steps: int, num_training_steps: int,
                  num_cycles: float = 0.5) -> Schedule:
    """WarmupCosineScheduler (schedulers.py:34-37) ==
    transformers.get_cosine_schedule_with_warmup (float32, as the JAX
    package)."""
    def schedule(step):
        step = f32(step)
        if step < num_warmup_steps:
            return float(step / f32(max(1.0, num_warmup_steps)))
        progress = (step - f32(num_warmup_steps)) / f32(
            max(1.0, num_training_steps - num_warmup_steps))
        cos = f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi * num_cycles * 2.0) * progress))
        return float(max(f32(0.0), cos))

    return schedule


@registry.register_scheduler("multi_step")
def multi_step(use_warmup: bool = False, lr_steps: Sequence[int] = (14000,),
               lr_ratio: float = 0.1, warmup_iterations: int = 1000,
               warmup_factor: float = 0.2) -> Schedule:
    """MultiStepScheduler (schedulers.py:40-62): the pythia staircase, with
    the warmup ending before the first milestone. The reference zeroes
    warmup_iterations when use_warmup is False (:45-47) BEFORE checking, so
    no-warmup configs with early milestones are legal."""
    if not use_warmup:
        warmup_iterations = 0
    if not warmup_iterations < lr_steps[0]:
        raise ValueError(f"warmup_iterations ({warmup_iterations}) must end "
                         f"before the first milestone ({lr_steps[0]})")
    return pythia(use_warmup=use_warmup,
                  warmup_iterations=warmup_iterations,
                  warmup_factor=warmup_factor, lr_steps=lr_steps,
                  lr_ratio=lr_ratio)


@registry.register_optimizer("adam_w")
def adam_w(lr: float = 1e-4, betas=(0.9, 0.999), eps: float = 1e-8,
           weight_decay: float = 0.01,
           schedule: Schedule = None) -> steps.Recipe:
    """adam_w (optimizers.py:7, transformers.AdamW): decoupled weight
    decay, the step (its decay too) scaled by a registered schedule's
    multiplier when one is given."""
    rate = lr if schedule is None else (lambda count: lr * schedule(count))
    return steps.Recipe(functools.partial(
        steps.Adam, betas=tuple(betas), eps=eps,
        weight_decay=weight_decay), rate)


def _register_torch_named_optimizers():
    """build_optimizer (mmf/utils/build.py:218-219) falls back to
    ``torch.optim`` names when a type isn't registered — the names MMF
    configs use, each with the JAX package's rule (a coupled decay for
    Adamax and SGD, added to the gradient; a decoupled one for Adam, which
    becomes AdamW)."""

    @registry.register_optimizer("Adamax")
    def adamax(lr: float = 2e-3, eps: float = 1e-8,
               weight_decay: float = 0.0, betas=(0.9, 0.999)):
        return steps.Recipe(functools.partial(
            torch.optim.Adamax, betas=tuple(betas), eps=eps,
            weight_decay=weight_decay), lr)

    @registry.register_optimizer("Adam")
    def adam(lr: float = 1e-3, eps: float = 1e-8, betas=(0.9, 0.999),
             weight_decay: float = 0.0):
        return steps.Recipe(functools.partial(
            steps.Adam, betas=tuple(betas), eps=eps,
            weight_decay=weight_decay), lr)

    @registry.register_optimizer("AdamW")
    def adamw(lr: float = 1e-3, eps: float = 1e-8, betas=(0.9, 0.999),
              weight_decay: float = 0.01):
        return steps.Recipe(functools.partial(
            steps.Adam, betas=tuple(betas), eps=eps,
            weight_decay=weight_decay), lr)

    @registry.register_optimizer("SGD")
    def sgd(lr: float = 0.01, momentum: float = 0.0,
            weight_decay: float = 0.0, nesterov: bool = False):
        return steps.Recipe(functools.partial(
            steps.SGD, momentum=momentum, nesterov=nesterov,
            weight_decay=weight_decay), lr)


_register_torch_named_optimizers()
registry.register_optimizer("bert_adam")(steps.make_bert_adam)
