"""VisualBERT masked pretraining on the MMF ``masked_coco`` feed, on the
PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.examples.visual_bert_pretraining \\
        [--annotations imdb.npy --features feats_dir --vocab-file vocab.txt] \\
        [--steps 20] [--batch-size 8] [--lr 5e-5] [--device cuda|cpu]

Counterpart of the repo's ``examples/visual_bert_pretraining.py``: with
``--annotations`` / ``--features`` it trains on a real MMF-layout
masked-COCO store (two-sentence sampling, masked tokens and regions, the
masked-LM loss through the tied-decoder head) with AdamW (optax's
defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4); without them it
builds a synthetic store and a tiny VisualBERT. It prints the loss curve.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np


def synthetic_store(root: str, n_images: int = 16, n_boxes: int = 5,
                    feat_dim: int = 2048):
    rng = np.random.RandomState(0)
    ann = [{"image_id": i,
            "captions": [f"w{i % 7} w{(i + 1) % 7} w3 w4",
                         f"w{i % 7} w5 w6"]} for i in range(n_images)]
    np.save(os.path.join(root, "ann.npy"),
            np.array([{"metadata": True}] + ann, dtype=object))
    for i in range(n_images):
        np.save(os.path.join(root, f"{i}.npy"),
                rng.rand(n_boxes, feat_dim).astype(np.float32))
    vocab = {w: i for i, w in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
        + [f"w{i}" for i in range(30)])}
    return os.path.join(root, "ann.npy"), root, vocab


def main(argv: Optional[List[str]] = None, weights=None) -> int:
    """``weights``, if given, is ``{"p": encoder tree, "h": head tree}`` of
    numpy leaves in the JAX package's layout, used in place of the seeded
    draws."""
    ap = argparse.ArgumentParser(prog="visual_bert_pretraining")
    ap.add_argument("--annotations")
    ap.add_argument("--features")
    ap.add_argument("--vocab-file", help="bert vocab.txt")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--max-seq-length", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.data import masked_datasets
    from transformer_mm_explainability_tpu_torch.models import bert
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)
    from transformer_mm_explainability_tpu_torch.train import steps
    from transformer_mm_explainability_tpu_torch.utils import convert

    device = resolve_device(args.device)
    tmp = vocab = None
    if args.annotations is None:
        tmp = tempfile.mkdtemp(prefix="vb_pretrain_")
        args.annotations, args.features, vocab = synthetic_store(tmp)
        print(f"[synthetic masked-coco store in {tmp}]")
    elif not args.vocab_file:
        sys.exit("--vocab-file vocab.txt (bert-base-uncased layout) is "
                 "required with --annotations")

    tk = ({"vocab_path": args.vocab_file} if args.vocab_file
          else {"vocab": vocab})
    cfg = {
        "annotations": args.annotations,
        "features": args.features,
        "max_features": 5 if tmp else 100,
        "use_image_feature_masks": True,
        "two_sentence": True,
        "seed": 7,
        "processors": {
            "masked_token_processor": {
                "type": "masked_token",
                "params": {"tokenizer_config": tk,
                           "max_seq_length": args.max_seq_length,
                           "mask_probability": 0.15, "seed": 4}},
            "masked_region_processor": {
                "type": "masked_region", "params": {"seed": 5}},
        },
    }
    ds = masked_datasets.MaskedCOCODataset("masked_coco", cfg, "train")
    print(f"dataset: {len(ds)} samples")

    feat_dim = np.asarray(ds[0]["image_feature_0"]).shape[-1]
    if tmp:
        mcfg = vb.VisualBERTConfig(
            bert=bert.BertConfig(
                vocab_size=35, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=64,
                max_position_embeddings=64),
            visual_embedding_dim=feat_dim)
    else:
        mcfg = vb.VisualBERTConfig(visual_embedding_dim=feat_dim)
    if weights is not None:
        params = {"p": convert.visual_bert_from_jax_numpy(
                      weights["p"], mcfg, device),
                  "h": convert.visual_bert_pretrain_head_from_jax_numpy(
                      weights["h"], mcfg, device)}
    else:
        params = {"p": vb.init_params(0, mcfg, device),
                  "h": vb.init_pretrain_params(1, mcfg, device)}

    def batch_at(step: int):
        idx = [(step * args.batch_size + j) % len(ds)
               for j in range(args.batch_size)]
        rows = [ds[i] for i in idx]
        stack = lambda k, dt=None: torch.as_tensor(
            np.stack([np.asarray(r[k], dt) for r in rows]), device=device)
        return {"input_ids": stack("input_ids"),
                "input_mask": stack("input_mask"),
                "segment_ids": stack("segment_ids"),
                "lm_label_ids": stack("lm_label_ids"),
                "feats": stack("image_feature_0", np.float32)}

    def loss_fn(st, batch):
        return vb.pretrain_forward(
            st["p"], st["h"], batch["input_ids"], batch["input_mask"],
            visual_embeddings=batch["feats"],
            # segment 1 marks the paired second caption, the two-sentence
            # protocol's signal
            token_type_ids=batch["segment_ids"],
            masked_lm_labels=batch["lm_label_ids"], cfg=mcfg)["loss"]

    tx = steps.make_adamw(args.lr)
    state = steps.init_state(params, tx)
    step_fn = steps.make_train_step(loss_fn, tx)
    for step in range(args.steps):
        state, loss = step_fn(state, batch_at(step))
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  masked_lm_loss {float(loss):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
