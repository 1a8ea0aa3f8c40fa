"""Device selection for the port's entry points, and moving parameter
trees between devices."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and there
    is none: entry points default to ``"cuda"`` and never move to the CPU
    on their own.

    It also turns TF32 off in cuBLAS and cuDNN: the port computes in fp32,
    and PyTorch's default lets cuDNN round convolution inputs to TF32 (a
    random DETR-R50 moves by 3e-2 in its encoder probabilities for a 1e-7
    change in a feature, ``models/detr.init_params``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def params_to(tree, device):
    """The same tree (dicts, NamedTuples, lists of tensors) with every
    tensor on ``device`` (no copy where it is there already)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(params_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to(v, device) for v in tree)
    return tree.to(device)
