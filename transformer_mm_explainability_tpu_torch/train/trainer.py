"""Training loop with callbacks (the MMF trainer equivalent).

Counterpart of ``transformer_mm_explainability_tpu/train/trainer.py``
(mmf/trainers/**, SURVEY C24/C25):
  * a train step (+ gradient accumulation over micro-batches,
    ``train/steps``),
  * eval-interval validation and early stopping on a watched metric,
  * checkpoint/resume of the full state (``train/checkpoint``),
  * callback hooks (on_train_start/... — the TrainerCallbackHookMixin
    surface), called in the JAX trainer's order,
  * per-update meters + scalar logging,
  * abort on a non-finite loss (the reference's engine.py:47-50 exit).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from transformer_mm_explainability_tpu_torch.core.meter import Meter
from transformer_mm_explainability_tpu_torch.train import checkpoint as ckpt
from transformer_mm_explainability_tpu_torch.train import steps as steps_lib
from transformer_mm_explainability_tpu_torch.utils.logger import (
    ScalarLogger,
    setup_logger,
)


@dataclasses.dataclass
class TrainerConfig:
    max_updates: int = 1000
    update_frequency: int = 1           # gradient accumulation
    evaluation_interval: int = 500
    checkpoint_interval: int = 500
    log_interval: int = 50
    early_stop_patience: int = 0        # 0 = disabled
    early_stop_metric: str = "val/loss"
    early_stop_minimize: bool = True
    save_dir: str = "./save"
    abort_on_nan: bool = True


class Callback:
    """Hook surface (TrainerCallbackHookMixin, callback_hook.py:9-97)."""

    def on_train_start(self, trainer): ...
    def on_train_end(self, trainer): ...
    def on_update_start(self, trainer): ...
    def on_update_end(self, trainer, loss: float): ...
    def on_validation_start(self, trainer): ...
    def on_validation_end(self, trainer, metrics: Dict[str, float]): ...
    def on_checkpoint(self, trainer, step: int): ...


class EarlyStopping:
    """Watch a metric; signal stop after ``patience`` bad evals
    (mmf/utils/early_stopping.py equivalent)."""

    def __init__(self, patience: int, minimize: bool = True):
        self.patience = patience
        self.minimize = minimize
        self.best: Optional[float] = None
        self.bad_count = 0

    def update(self, value: float) -> bool:
        """Returns True if training should stop."""
        improved = (self.best is None
                    or (value < self.best if self.minimize else value > self.best))
        if improved:
            self.best = value
            self.bad_count = 0
        else:
            self.bad_count += 1
        return self.patience > 0 and self.bad_count >= self.patience


class Trainer:
    """Trains ``params`` (a parameter tree or an ``nn.Module``, updated in
    place) with the optimizer recipe ``tx``."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Dict[str, Any]], Any],
        params: Any,
        tx: steps_lib.Recipe,
        config: TrainerConfig = TrainerConfig(),
        eval_fn: Optional[Callable[[Any, Iterable], Dict[str, float]]] = None,
        callbacks: Optional[List[Callback]] = None,
    ):
        self.config = config
        self.loss_fn = loss_fn
        self.tx = tx
        self.state = steps_lib.init_state(params, tx)
        self.eval_fn = eval_fn
        self.callbacks = callbacks or []
        self.meter = Meter()
        self.logger = setup_logger(output_dir=config.save_dir)
        self.scalars = ScalarLogger(config.save_dir)
        self.early = EarlyStopping(config.early_stop_patience,
                                   config.early_stop_minimize)
        if config.update_frequency > 1:
            self._step = steps_lib.make_accum_train_step(
                loss_fn, tx, config.update_frequency)
        else:
            self._step = steps_lib.make_train_step(loss_fn, tx)

    def _hook(self, name: str, *args) -> None:
        for cb in self.callbacks:
            getattr(cb, name)(self, *args)

    def resume(self) -> bool:
        step = ckpt.latest_step(self.config.save_dir)
        if step is None:
            return False
        self.state = ckpt.restore(self.config.save_dir, self.state)
        self.logger.info(f"resumed from update {step}")
        return True

    def train(self, train_iter: Iterable, val_iter: Optional[Iterable] = None):
        cfg = self.config
        self._hook("on_train_start")
        t_last = time.time()
        for batch in train_iter:
            step_no = int(self.state.step)
            if step_no >= cfg.max_updates:
                break
            self._hook("on_update_start")
            self.state, loss = self._step(self.state, batch)
            loss = float(loss)
            if cfg.abort_on_nan and not math.isfinite(loss):
                # reference behaviour: DETR engine.py:47-50 aborts on
                # non-finite loss
                raise FloatingPointError(
                    f"non-finite loss {loss} at update {step_no}")
            self.meter.update(loss=loss)
            self._hook("on_update_end", loss)
            step_no += 1

            if step_no % cfg.log_interval == 0:
                ups = cfg.log_interval / (time.time() - t_last)
                t_last = time.time()
                self.logger.info(
                    f"update {step_no}/{cfg.max_updates} {self.meter} "
                    f"({ups:.2f} updates/s)")
                self.scalars.log(step_no, {"train/loss": loss,
                                           "train/updates_per_s": ups})

            if val_iter is not None and self.eval_fn is not None \
                    and step_no % cfg.evaluation_interval == 0:
                self._hook("on_validation_start")
                metrics = self.eval_fn(self.state.params, val_iter)
                self.scalars.log(step_no, metrics)
                self.logger.info(f"validation @ {step_no}: {metrics}")
                self._hook("on_validation_end", metrics)
                watched = metrics.get(cfg.early_stop_metric)
                if watched is not None and self.early.update(watched):
                    self.logger.info("early stopping triggered")
                    break

            if step_no % cfg.checkpoint_interval == 0:
                ckpt.save(cfg.save_dir, self.state, step_no,
                          best_metric=self.early.best)
                self._hook("on_checkpoint", step_no)

        ckpt.save(cfg.save_dir, self.state, int(self.state.step),
                  best_metric=self.early.best)
        self._hook("on_train_end")
        return self.state
