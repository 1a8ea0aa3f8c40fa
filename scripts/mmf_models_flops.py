#!/usr/bin/env python3
"""FLOPs, weights and a predicted rate for each MMF model family of
``chip_smoke.py``'s "mmf models" group, without a GPU.

    python scripts/mmf_models_flops.py

Each family is built at the smoke's published widths on PyTorch's ``meta``
device (shapes only) and run once at the smoke's B = 32 under
``torch.utils.flop_counter.FlopCounterMode`` (products and convolutions).
It prints one line per family: GFLOP per call, the operations that are not
views (about one kernel launch each), the weights in GiB, the largest
single activation, the predicted time of a call, the larger of the FLOPs
at ``RATE_TFLOPS`` (the fp32 cuBLAS rate a full-width forward reached on
the H100) and the operations at ``LAUNCH_US`` each (the host's launch
path), the forwards (or decoded sequences) per second it gives, and a
predicted peak of weights + inputs + 4 × the largest activation.
"""

from __future__ import annotations

import pathlib
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from transformer_mm_explainability_tpu_torch._device import (  # noqa: E402
    params_to)

RATE_TFLOPS = 43.0     # fp32 cuBLAS, a full-width forward on the H100
LAUNCH_US = 10.0       # the host's time to launch one operation


class LargestOutput(TorchDispatchMode):
    """The bytes of the largest tensor any operation returns, and the
    operations that are not views (each about one kernel launch)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(r.alias_info is not None for r in func._schema.returns):
            self.ops += 1
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if torch.is_tensor(t):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def main() -> int:
    B = chip_smoke.MMF_B
    meta = torch.device("meta")
    params = {}
    for i, fam in enumerate(chip_smoke.mmf_model_families()):
        if fam.shares is None:
            params.clear()
            params[fam.name] = fam.init(100 + i, fam.cfg, meta)
        p = params[fam.shares or fam.name]
        x = params_to(fam.inputs(B, torch.Generator().manual_seed(i)), meta)
        big = LargestOutput()
        with torch.no_grad(), FlopCounterMode(display=False) as fc, big:
            fam.run(p, fam.cfg, x)
        flops = fc.get_total_flops()
        flop_ms = flops / (RATE_TFLOPS * 1e12) * 1e3
        host_ms = big.ops * LAUNCH_US / 1e3
        ms = max(flop_ms, host_ms)
        w, inp = nbytes(p), nbytes(x)
        unit = "decoded sequences/s" if fam.decoded else "forwards/s"
        print(f"{fam.name}: {flops / 1e9:.1f} GFLOP and {big.ops} ops at "
              f"B={B}, weights {w / 2**30:.3f} GiB, largest activation "
              f"{big.bytes / 2**30:.3f} GiB → {flop_ms:.2f} ms at "
              f"{RATE_TFLOPS:g} TFLOP/s, {host_ms:.2f} ms of launches: "
              f"{B / ms * 1e3:.0f} {unit}, "
              f"peak ≈ {(w + inp + 4 * big.bytes) / 2**30:.2f} GiB",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
