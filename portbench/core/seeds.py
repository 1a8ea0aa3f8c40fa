"""Everything a run draws comes from ``--seed`` through these helpers.

``sub_seed(seed, tag)`` splits one seed (any whole number, also past 2**63)
into independent streams by name, so that the weights, the inputs and the
sample that the judge reads never share a stream. ``generator`` gives a
``torch.Generator`` on the run's device (on the card: Philox, drawn there
in a few large calls), and ``draw_leaves`` makes a whole tree of weights
from one flat normal draw.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for stream ``tag`` of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


# a leaf of a weight layout: (name, shape, kind), kind "normal" (std
# ``std``), "ones" or "zeros"
Leaf = Tuple[str, Tuple[int, ...], str]


def draw_leaves(layout: Sequence[Leaf], seed: int, device, std: float
                ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout`` on ``device``: the normal leaves are views
    of one ``randn`` of their total size (in layout order), scaled by
    ``std``; the others are filled."""
    normal = [(n, s) for n, s, kind in layout if kind == "normal"]
    total = sum(int(np.prod(s)) for _, s in normal)
    flat = torch.randn(total, generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32).mul_(std)
    out, at = {}, 0
    for name, shape, kind in layout:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"unknown leaf kind {kind!r} of {name}")
    return out
