"""Checkpoint save/load (mmf/utils/checkpoint.py:88-503 equivalent).

Counterpart of ``transformer_mm_explainability_tpu/train/checkpoint.py``:
the same ``ckpt_{step}.meta.json`` (``step``, ``format``, ``git_sha``,
``best_metric`` and the caller's metadata) and the same ``latest`` file.
The arrays go to ``ckpt_{step}.npz`` (``format: "npz"``; the JAX package
writes orbax where it is installed and this format where it is not), one
entry per leaf under its ``jax.tree_util.keystr`` name: the parameters,
the optimizer's update count and moments, and the step of a
``train/steps.TrainState``. ``load_with_mapping`` is the partial restore
with key prefixes remapped (the ``pretrained_state_mapping`` capability).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from typing import Any, Dict, Optional

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.train import steps


def _git_sha(repo_dir: Optional[str] = None) -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir,
            stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_tree(state):
    """A ``TrainState`` as the tree it is saved as: its params, its
    optimizer's ``state_dict`` and its step."""
    if isinstance(state, steps.TrainState):
        return {steps.Attr("params"): state.params,
                steps.Attr("opt_state"): state.opt_state.state_dict(),
                steps.Attr("step"): state.step}
    return state


def _flatten(state) -> Dict[str, np.ndarray]:
    return {steps.keystr(path): _np(leaf)
            for path, leaf in steps.tree_paths(_as_tree(state))}


def save(directory: str, state: Any, step: int,
         metadata: Optional[Dict[str, Any]] = None,
         best_metric: Optional[float] = None) -> str:
    """Save a tree (or a ``TrainState``). Returns the checkpoint path
    (without the ``.npz`` suffix)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step}")
    np.savez_compressed(path + ".npz", **_flatten(state))
    meta = {
        "step": step,
        "format": "npz",
        "git_sha": _git_sha(),
        "best_metric": best_metric,
        **(metadata or {}),
    }
    with open(os.path.join(directory, f"ckpt_{step}.meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "latest"), "w") as f:
        f.write(str(step))
    return path


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        return int(f.read().strip())


def _load_leaves(target, data, prefix: tuple = ()):
    """``target`` with every leaf loaded from ``data`` by its keystr: a
    tensor leaf is overwritten in place (so an optimizer that holds it
    keeps holding it) and returned; any other leaf is replaced by the
    array, in the leaf's dtype."""
    def load(path, leaf):
        arr = data[steps.keystr(prefix + path)]
        if torch.is_tensor(leaf):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(np.array(arr)))
            return leaf
        return arr.astype(np.asarray(leaf).dtype)

    return steps.tree_map_with_path(load, target)


_OPT_KEY = re.compile(r"^\.opt_state\['state'\]\[(\d+)\]\['(\w+)'\]$")


def _optimizer_state(data) -> Dict[str, Any]:
    """The ``Optimizer.state_dict`` saved under ``.opt_state``."""
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key in data.files:
        m = _OPT_KEY.match(key)
        if m:
            state.setdefault(int(m.group(1)), {})[m.group(2)] = \
                torch.from_numpy(np.array(data[key]))
    return {"count": int(data[".opt_state['count']"]), "state": state}


def restore(directory: str, target: Any, step: Optional[int] = None) -> Any:
    """Load a checkpoint written by :func:`save` into ``target``'s
    structure: tensor leaves in place, and for a ``TrainState`` its
    optimizer's state and its step too. Returns the loaded tree."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step}")
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta["format"] != "npz":
        raise ValueError(f"{path}: format {meta['format']!r}; the port "
                         "reads the npz format only")
    with np.load(path + ".npz") as data:
        if isinstance(target, steps.TrainState):
            params = _load_leaves(target.params, data,
                                  (steps.Attr("params"),))
            target.opt_state.load_state_dict(_optimizer_state(data))
            return steps.TrainState(params, target.opt_state,
                                    int(data[".step"]))
        return _load_leaves(target, data)


def load_with_mapping(state_dict: Dict[str, np.ndarray], target: Any,
                      mapping: Dict[str, str]) -> Any:
    """Partial restore with key prefixes remapped — the MMF
    ``pretrained_state_mapping`` capability (checkpoint.py:367+): each
    keystr of ``state_dict`` starting with a ``mapping`` source takes the
    destination prefix instead; every leaf of ``target`` whose keystr is
    then present is loaded (tensors in place), the others kept."""
    remapped = {}
    for k, v in state_dict.items():
        for src, dst in mapping.items():
            if k.startswith(src):
                remapped[dst + k[len(src):]] = v
                break
        else:
            remapped[k] = v

    def load(path, leaf):
        key = steps.keystr(path)
        if key not in remapped:
            return leaf
        if torch.is_tensor(leaf):
            with torch.no_grad():
                leaf.copy_(torch.as_tensor(np.asarray(remapped[key])))
            return leaf
        return remapped[key]

    return steps.tree_map_with_path(load, target)
