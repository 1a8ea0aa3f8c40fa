"""Logging setup (mmf/utils/logger.py equivalent).

The port's copy of ``transformer_mm_explainability_tpu/utils/logger.py``
(the same ``train.log`` and ``scalars.jsonl`` files, the same JSON lines).
Colored console formatter + optional file stream + a minimal scalar
logger that always writes JSONL, and TensorBoard event files too where
``torch.utils.tensorboard`` can be imported.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


class _ColorFormatter(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[36m",
        logging.INFO: "\x1b[32m",
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
        logging.CRITICAL: "\x1b[41m",
    }
    RESET = "\x1b[0m"

    def format(self, record: logging.LogRecord) -> str:
        color = self.COLORS.get(record.levelno, "")
        base = super().format(record)
        if color and sys.stderr.isatty():
            return f"{color}{base}{self.RESET}"
        return base


def setup_logger(name: str = "tmmx", output_dir: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = "%(asctime)s | %(levelname)s | %(name)s : %(message)s"
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_ColorFormatter(fmt, datefmt="%H:%M:%S"))
    logger.addHandler(console)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "train.log"))
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.propagate = False
    return logger


class ScalarLogger:
    """Scalar metric stream: JSONL always; TensorBoard when available
    (the TensorboardLogger role, mmf logger.py:254+)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # tensorboard is optional
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
