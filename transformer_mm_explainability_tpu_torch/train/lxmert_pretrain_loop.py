"""LXMERT pretraining loop — data masking + joint-loss training (C36), in
PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/train/lxmert_pretrain_loop.py``
(``lxmert/lxmert/src/pretrain/lxmert_pretrain.py``): ``random_word``
(:71-108 — BERT 80/10/10 masking), ``random_feat`` (:110-131 — 80% zero /
10% random-feature / 10% keep object masking),
``convert_example_to_features`` (:134-211 — [CLS]/[SEP] framing, padding,
multinomial QA answer sampling), and the epoch loop (:309-358 — BertAdam,
per-loss running averages).

Host-side masking draws from an explicit ``np.random.RandomState`` in the
JAX package's order, so one seed gives the same masks there and here; the
step is ``models/lxmert_pretrain.pretrain_loss`` + BertAdam over the model
and the heads together. The dataset is duck-typed: ``len``, indexing to an
example dict, and ``random_feat()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import lxmert as lx
from transformer_mm_explainability_tpu_torch.models import lxmert_pretrain as lp
from transformer_mm_explainability_tpu_torch.train import steps as steps_lib

LOSSES_NAME = ("Mask_LM", "Matched", "Obj", "Feat", "QA")


def random_word(ids: List[int], mask_id: int, vocab_size: int,
                rng: np.random.RandomState,
                word_mask_rate: float = 0.15
                ) -> Tuple[List[int], List[int]]:
    """lxmert_pretrain.py:71-108 in id space on an explicit RandomState:
    80% [MASK], 10% random id, 10% keep; label = original id where
    masked, -1 elsewhere."""
    ids = list(ids)
    output_label: List[int] = []
    for i, tid in enumerate(ids):
        prob = rng.random_sample()
        if prob < word_mask_rate:
            prob /= word_mask_rate
            if prob < 0.8:
                ids[i] = mask_id
            elif prob < 0.9:
                ids[i] = int(rng.randint(vocab_size))
            output_label.append(tid)
        else:
            output_label.append(-1)
    return ids, output_label


def random_feat(feats: np.ndarray, rng: np.random.RandomState,
                random_feat_fn, obj_mask_rate: float = 0.15
                ) -> Tuple[np.ndarray, np.ndarray]:
    """lxmert_pretrain.py:110-131."""
    mask_feats = feats.copy()
    feat_mask = np.zeros((len(feats),), np.float32)
    for i in range(len(feats)):
        prob = rng.random_sample()
        if prob < obj_mask_rate:
            prob /= obj_mask_rate
            if prob < 0.8:
                mask_feats[i, :] = 0.0
            elif prob < 0.9:
                mask_feats[i, :] = random_feat_fn()
            feat_mask[i] = 1.0
    return mask_feats, feat_mask


def convert_example_to_features(example: Dict[str, Any],
                                max_seq_length: int,
                                tokenizer,
                                rng: np.random.RandomState,
                                random_feat_fn,
                                word_mask_rate: float = 0.15,
                                obj_mask_rate: float = 0.15
                                ) -> Dict[str, Any]:
    """lxmert_pretrain.py:134-211; ``tokenizer`` is the port's WordPiece
    tokenizer (data/tokenization.BertTokenizer)."""
    ids = tokenizer.tokenize_ids(example["sent"].strip())
    if len(ids) > max_seq_length - 2:
        ids = ids[:max_seq_length - 2]
    mask_id = tokenizer.vocab.get("[MASK]", 103)
    masked_ids, masked_label = random_word(
        ids, mask_id, len(tokenizer.vocab), rng, word_mask_rate)
    input_ids = [tokenizer.cls] + masked_ids + [tokenizer.sep]
    lm_label_ids = [-1] + masked_label + [-1]
    input_mask = [1] * len(input_ids)
    while len(input_ids) < max_seq_length:
        input_ids.append(0)
        input_mask.append(0)
        lm_label_ids.append(-1)

    feats, boxes = example["visual_feats"]
    obj_labels, _obj_confs = example["obj_labels"]
    masked_feat, feat_mask = random_feat(feats, rng, random_feat_fn,
                                         obj_mask_rate)

    label = example.get("label")
    if not label or example["is_matched"] != 1:
        ans = -1
    else:
        keys, values = zip(*label.items())
        if len(keys) == 1:
            ans = keys[0]
        else:
            p = np.asarray(values, np.float64)
            ans = keys[int(rng.multinomial(1, p / p.sum()).argmax())]
    return {
        "input_ids": np.asarray(input_ids, np.int32),
        "input_mask": np.asarray(input_mask, np.int32),
        "lm_label_ids": np.asarray(lm_label_ids, np.int32),
        "visual_feats": masked_feat.astype(np.float32),
        "visual_pos": np.asarray(boxes, np.float32),
        "obj_labels": np.asarray(obj_labels, np.int64),
        "feat_targets": np.asarray(feats, np.float32),
        "feat_mask": feat_mask,
        "matched_label": np.int32(example["is_matched"]),
        "ans": np.int32(ans if ans != -1 else -100),
    }


def collate(features: Sequence[Dict[str, Any]], device="cuda"
            ) -> Dict[str, torch.Tensor]:
    """Stack per-example features into the pretrain_loss batch on
    ``device`` (its field names: lxmert_pretrain.pretrain_loss)."""
    dev = resolve_device(device)
    batch = {k: np.stack([f[k] for f in features])
             for k in ("input_ids", "input_mask", "visual_feats",
                       "visual_pos", "obj_labels", "feat_targets",
                       "feat_mask", "matched_label", "ans")}
    batch["attention_mask"] = batch.pop("input_mask")
    batch["masked_lm_labels"] = np.stack(
        [np.where(f["lm_label_ids"] == -1, -100, f["lm_label_ids"])
         for f in features])
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    epochs: int = 1
    batch_size: int = 8
    lr: float = 1e-4
    warmup: float = 0.05
    max_seq_length: int = 20
    word_mask_rate: float = 0.15
    obj_mask_rate: float = 0.15


def train(dataset, tokenizer, cfg: lx.LxmertConfig,
          pt: PretrainConfig = PretrainConfig(),
          params=None, head_params=None, seed: int = 0,
          printer=print, device="cuda") -> Dict[str, Any]:
    """The epoch loop (lxmert_pretrain.py:309-358): mask → collate →
    joint-loss BertAdam step over {"model", "heads"}; prints per-loss
    running means. Missing weights are drawn from ``seed`` (heads from
    ``seed + 1``); the masks and the epoch order from
    ``RandomState(seed)``."""
    dev = resolve_device(device)
    if params is None:
        params = lx.init_params(seed, cfg, dev)
    if head_params is None:
        head_params = lp.init_head_params(seed + 1, cfg, device=dev)
    n_batches = max(len(dataset) // pt.batch_size, 1)
    tx = steps_lib.make_bert_adam(pt.lr, warmup=pt.warmup,
                                  total_steps=pt.epochs * n_batches)
    state = steps_lib.init_state({"model": params, "heads": head_params}, tx)

    def loss_fn(ap, batch):
        return lp.pretrain_loss(ap["model"], ap["heads"], batch, cfg)

    rng = np.random.RandomState(seed)
    history: List[Dict[str, float]] = []
    for epoch in range(pt.epochs):
        order = rng.permutation(len(dataset))
        running: Dict[str, float] = {}
        count = 0
        bs = min(pt.batch_size, len(order))
        if bs == 0:
            raise ValueError("empty pretraining dataset")
        for start in range(0, len(order) - bs + 1, bs):
            idxs = order[start:start + bs]
            feats = [convert_example_to_features(
                dataset[int(i)], pt.max_seq_length, tokenizer, rng,
                dataset.random_feat, pt.word_mask_rate,
                pt.obj_mask_rate) for i in idxs]
            batch = collate(feats, dev)
            (_, parts), grads = steps_lib.value_and_grad(
                loss_fn, state.params, batch, has_aux=True)
            state.opt_state.apply(grads)
            state.step += 1
            count += 1
            for k, v in parts.items():
                running[k] = running.get(k, 0.0) + float(v)
        means = {k: v / max(count, 1) for k, v in running.items()}
        printer(f"Epoch {epoch}: " + " ".join(
            f"{k} {v:.4f}" for k, v in sorted(means.items())))
        history.append(means)
    return {"params": state.params["model"],
            "head_params": state.params["heads"], "history": history}
