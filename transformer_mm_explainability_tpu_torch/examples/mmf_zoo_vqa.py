"""MMF model-zoo tour on the PyTorch port: build two VQA-family models from
the registry's modules, run a forward on synthetic inputs, and score it
with the registered loss and metric.

    python -m transformer_mm_explainability_tpu_torch.examples.mmf_zoo_vqa \\
        [--device cuda|cpu]

Counterpart of the repo's ``examples/mmf_zoo_vqa.py`` at its tiny shapes
and inputs (numpy seed 0); the weights are seeded random draws
(``utils/convert_mmf`` loads published ones).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def main(argv: Optional[List[str]] = None, weights=None) -> int:
    """``weights``, if given, holds ``{"pythia": tree, "movie_mcan":
    tree}`` of numpy leaves in the JAX package's layout, used in place of
    the seeded draws."""
    ap = argparse.ArgumentParser(prog="mmf_zoo_vqa")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.core import losses as L
    from transformer_mm_explainability_tpu_torch.core import metrics as M
    from transformer_mm_explainability_tpu_torch.models import mmf_zoo as Z
    from transformer_mm_explainability_tpu_torch.models import movie_mcan as MM
    from transformer_mm_explainability_tpu_torch.utils.convert import (
        mmf_from_jax_numpy)
    from transformer_mm_explainability_tpu_torch.zoo import registry

    device = resolve_device(args.device)
    rs = np.random.RandomState(0)
    B, A = 4, 12
    on = lambda a: torch.as_tensor(a, device=device)

    # --- Pythia (registry name "pythia") -------------------------------
    pcfg = Z.PythiaConfig(vocab_size=50, num_answers=A, embedding_dim=16,
                          text_hidden_dim=24, conv1_out=12, conv2_out=2,
                          image_feature_dim=32, combine_hidden_dim=20,
                          classifier_text_hidden=8,
                          classifier_img_hidden=10)
    pparams = (mmf_from_jax_numpy(weights["pythia"], "mmf_zoo", device)
               if weights else Z.init_pythia(0, pcfg, device))
    toks = on(rs.randint(1, 50, (B, 6)))
    feats = [on(rs.randn(B, 9, 32).astype(np.float32))
             for _ in pcfg.image_encoders]
    with torch.no_grad():
        scores = Z.pythia_forward(pparams, pcfg, toks, feats)
    print("pythia scores", tuple(scores.shape))

    # --- MoVie+MCAN (registry name "movie_mcan") -----------------------
    mcfg = MM.MovieMcanConfig(vocab_size=50, num_answers=A,
                              embedding_dim=16, hidden_dim=16, num_attn=4,
                              num_layers=2, cbn_num_layers=1,
                              image_feature_dim=12, cbn_out_dim=16)
    mparams = (mmf_from_jax_numpy(weights["movie_mcan"], "movie_mcan",
                                  device)
               if weights else MM.init_movie_mcan(1, mcfg, device))
    grid = on(rs.randn(B, 12, 2, 3).astype(np.float32))
    with torch.no_grad():
        mm_scores = MM.movie_mcan_forward(mparams, mcfg, toks, grid,
                                          training=True)
    print("movie_mcan training scores", tuple(mm_scores.shape))

    # --- the registered loss and metric --------------------------------
    soft = rs.rand(B, A).astype(np.float32) * (rs.rand(B, A) > 0.5)
    sl = {"targets": on(soft), "dataset_type": "val",
          "dataset_name": "vqa2"}
    loss = L.Losses(["triple_logit_bce"])(sl, {"scores": mm_scores})
    acc = M.Metrics(["vqa_accuracy"])(sl, {"scores": mm_scores})
    print({k: float(v.reshape(-1)[0]) for k, v in loss.items()})
    print(acc)

    # every model name the reference registers resolves here
    print("registered models:", ", ".join(registry.list("model")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
