"""Environment bootstrap: seeding + user-module plugins (C21/C22), in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/core/env.py``
(``VisualBERT/mmf/utils/env.py``):

- ``set_seed`` (:16-29): resolve -1 to an entropy-derived seed, seed
  python ``random``, numpy and torch (``torch.manual_seed``, which seeds
  every CUDA device too), and RETURN the seed, so callers can also build
  explicit ``torch.Generator`` / ``np.random.RandomState`` objects from
  it.
- ``import_user_module`` (:32-60): import a user directory as a module
  so its ``__init__.py`` can register custom models/datasets/
  processors with ``core.registry`` — the MMF plugin mechanism,
  including the ``mmf_user_dir`` alias and module backup/restore.
- ``import_files`` (:62-93): import every sibling .py of a file,
  optionally under a dotted package name.
- ``setup_imports`` (:96-147): one-shot registration of every
  built-in component the port has, guarded by the same ``imports_setup``
  registry flag. The JAX package imports its ``zoo`` module, which needs
  the MMF models (ROADMAP A5c); until they are ported this imports the
  registering modules one by one and registers the three trainers as
  ``zoo`` does.
"""

from __future__ import annotations

import importlib
import logging
import os
import random
import sys
from datetime import datetime
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def set_seed(seed: Optional[int]):
    if seed:
        if seed == -1:
            # from detectron2 (env.py:19-24)
            seed = (os.getpid()
                    + int(datetime.now().strftime("%S%f"))
                    + int.from_bytes(os.urandom(2), "big"))
        np.random.seed(seed)
        random.seed(seed)
        import torch

        torch.manual_seed(seed)
    return seed


def import_user_module(user_dir: str) -> None:
    """Import ``user_dir`` as a module (expects ``__init__.py`` at its
    root); alias it as ``mmf_user_dir`` and restore any module the
    import shadowed (env.py:32-60)."""
    if not user_dir:
        return
    user_dir = os.path.abspath(user_dir)
    module_parent, module_name = os.path.split(user_dir)

    module_bak = sys.modules.pop(module_name, None)
    logger.info("Importing from %s", user_dir)
    sys.path.insert(0, module_parent)
    try:
        importlib.import_module(module_name)
    finally:
        sys.path.remove(module_parent)

    sys.modules["mmf_user_dir"] = sys.modules[module_name]
    if module_bak is not None and module_name != "mmf_user_dir":
        sys.modules[module_name] = module_bak


def import_files(file_path: str,
                 module_name: Optional[str] = None) -> None:
    """Import every non-underscore sibling ``.py`` of ``file_path``
    (used from a plugin package's ``__init__.py``, env.py:62-93)."""
    for file in os.listdir(os.path.dirname(file_path)):
        if file.endswith(".py") and not file.startswith("_"):
            import_name = file[:file.find(".py")]
            if module_name:
                importlib.import_module(f"{module_name}.{import_name}")
            else:
                importlib.import_module(import_name)


# the modules whose imports register losses, metrics, processors,
# builders, schedulers and optimizers; when the MMF models come (ROADMAP
# A5c) this list gives way to one import of ``zoo``, as in the JAX package
_REGISTERING = (
    "core.losses", "core.metrics", "data.processors", "data.builders",
    "data.extra_builders", "data.masked_datasets", "train.schedulers",
    "train.trainer",
)


def setup_imports() -> None:
    """Register every built-in component, once (env.py:96-147)."""
    from transformer_mm_explainability_tpu_torch.core.registry import registry

    if registry.get_state("imports_setup"):
        return
    for name in _REGISTERING:
        importlib.import_module(
            f"transformer_mm_explainability_tpu_torch.{name}")
    from transformer_mm_explainability_tpu_torch.harness.pert_runner import (
        LxmertPerturbationRunner,
        VisualBertPerturbationRunner,
    )
    from transformer_mm_explainability_tpu_torch.train.trainer import Trainer

    if "mmf" not in registry.list("trainer"):
        registry.register_trainer("mmf")(Trainer)
        # the reference's mmf_pert trainer == mmf trainer + the
        # perturbation evaluation mixin; the runners play that role here
        registry.register_trainer("mmf_pert")(VisualBertPerturbationRunner)
        registry.register_trainer("lxmert_pert")(LxmertPerturbationRunner)
    registry.set_state("imports_setup", True)
