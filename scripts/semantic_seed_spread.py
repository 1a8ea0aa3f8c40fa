"""Spread of the semantic validation's hard checks over initial draws.

Runs a semantic-validation tool's ``run_family`` with the model's initial
weights drawn at each of several seeds, the flagship method only (the hard
checks read only the flagship's sweeps and the random control), and prints
one JSON line per seed: training steps, eval accuracy, each hard check's
gap or verdict, and ``ok``.

  --impl jax    the JAX package's tool; weights from ``init_params`` at
                ``jax.random.PRNGKey(seed)`` (the tool itself uses 7 for
                VisualBERT and 8 for LXMERT).
  --impl torch  the port's tool; weights from the port's ``init_params``
                at ``torch.Generator().manual_seed(seed)``.

Run:  python scripts/semantic_seed_spread.py --impl jax --model lxmert \\
          --seeds 8,0,1,2,3 [--out JSON]
      python scripts/semantic_seed_spread.py --impl torch --device cuda \\
          --model lxmert --seeds 8,0,1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FLAGSHIP = "ours_no_lrp"


def _run_jax(model: str, seed: int):
    import jax
    import jax.numpy as jnp

    from transformer_mm_explainability_tpu.models import lxmert, visual_bert
    from transformer_mm_explainability_tpu.tools import semantic_validation

    mod = lxmert if model == "lxmert" else visual_bert
    orig = mod.init_params

    def seeded(key, cfg, dtype=jnp.float32):
        return orig(jax.random.PRNGKey(seed), cfg, dtype)

    mod.init_params = seeded
    try:
        return semantic_validation.run_family(
            model, methods=[FLAGSHIP], printer=lambda *a: None)
    finally:
        mod.init_params = orig


def _run_torch(model: str, seed: int, device: str):
    from transformer_mm_explainability_tpu_torch.models import (
        lxmert, visual_bert)
    from transformer_mm_explainability_tpu_torch.tools import (
        semantic_validation)

    mod = lxmert if model == "lxmert" else visual_bert
    orig = semantic_validation._init

    def seeded(name, cfg, dev):
        return mod.init_params(seed, cfg, dev)

    semantic_validation._init = seeded
    try:
        return semantic_validation.run_family(
            model, methods=[FLAGSHIP], printer=lambda *a: None,
            device=device)
    finally:
        semantic_validation._init = orig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--impl", required=True, choices=("jax", "torch"))
    p.add_argument("--model", default="lxmert",
                   choices=("lxmert", "visual_bert"))
    p.add_argument("--seeds", default="8,0,1,2,3")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the port's device (--impl torch)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        fam = (_run_jax(args.model, seed) if args.impl == "jax"
               else _run_torch(args.model, seed, args.device))
        hard = [c for c in fam["semantics"]["checks"] if c["hard"]]
        row = {"impl": args.impl, "model": args.model, "seed": seed,
               "train_steps": fam["train"]["train_steps"],
               "eval_acc": fam["train"]["eval_acc"],
               "hard": [{k: c[k] for k in ("check", "gap", "control_auc",
                                           "ok") if k in c} for c in hard],
               "ok": fam["semantics"]["ok"],
               "wall_s": round(time.perf_counter() - t0, 1)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
