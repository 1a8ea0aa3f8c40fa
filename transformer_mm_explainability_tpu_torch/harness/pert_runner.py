"""Perturbation benchmark runner, LXMERT part, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/pert_runner.py``.
Streams VQA samples, explains the model's PREDICTED answer with the chosen
method, runs the step-batched perturbation forward, and prints running
per-step accuracies as the reference does.

LXMERT's method table has the reference's 11 names. Seven run here; the
four that need LRP relevance (``_LX_NEEDS_LRP``) raise
``NotImplementedError`` until the LRP engine (``models/lxmert_lrp.py``,
ROADMAP slice 6) is ported. ``VisualBertPerturbationRunner`` and
``--model visual_bert`` wait for the VisualBERT slice and raise the same
way.

N samples × n_steps ride one batch axis through one explain + perturb
call; ``run_loop`` collates to a fixed batch and keeps one batch in flight
on the device while the host collates the next.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.explain import lxmert as elx
from transformer_mm_explainability_tpu_torch.harness import perturbation as pert
from transformer_mm_explainability_tpu_torch.models import lxmert as lx

# LXMERT method names (reference: perturbation.py:217-240)
LXMERT_METHODS = (
    "ours_no_lrp", "ours_no_lrp_no_norm", "ours_with_lrp",
    "ours_with_lrp_no_normalization", "ablation_no_self_in_10",
    "ablation_no_aggregation", "transformer_att", "partial_lrp",
    "raw_attn", "rollout", "attn_gradcam",
)
_LXMERT_ALIASES = {
    "transformer_attribution": "transformer_att",
    "ours_no_lrp_no_normalization": "ours_no_lrp_no_norm",
}
_LX_NEEDS_LRP = {"ours_with_lrp", "ours_with_lrp_no_normalization",
                 "transformer_att", "partial_lrp"}
VISUALBERT_METHODS = (
    "transformer_attribution", "ours_no_lrp", "partial_lrp",
    "raw_attn", "attn_gradcam", "rollout",
)
_NOT_PORTED_LRP = ("needs LRP relevance: the LRP engine "
                   "(models/lxmert_lrp.py) is not ported yet (ROADMAP "
                   "slice 6)")
_NOT_PORTED_VB = ("the VisualBERT perturbation runner is not ported yet "
                  "(ROADMAP, the VisualBERT slice)")


def _resolve(method: str, table, aliases, model: str) -> str:
    method = aliases.get(method, method)
    if method not in table:
        raise ValueError(
            f"unknown {model} perturbation method {method!r}; "
            f"valid: {sorted(table)}")
    return method


def _as_2d(soft_targets) -> np.ndarray:
    soft = np.asarray(soft_targets)
    return soft[None] if soft.ndim == 1 else soft


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class VisualBertPerturbationRunner:
    """The VisualBERT runner of the JAX package; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED_VB)


class LxmertPerturbationRunner:
    """LXMERT VQA pipeline (the reference's ``ModelPert``) on ``device``.

    Consumes precomputed FRCNN features (the reference recomputes the CNN
    per step on the same image, which gives the same features). The
    parameters are moved to ``device`` (no copy where they are there
    already); batch leaves may be numpy arrays or tensors and go to it."""

    def __init__(self, params, cfg, method: str = "ours_no_lrp",
                 positive: bool = False, text_pert: bool = False,
                 device="cuda"):
        method = _resolve(method, LXMERT_METHODS, _LXMERT_ALIASES, "lxmert")
        if method in _LX_NEEDS_LRP:
            raise NotImplementedError(f"lxmert method {method!r} "
                                      + _NOT_PORTED_LRP)
        self.device = resolve_device(device)
        self.params = lx.params_to(params, self.device)
        self.cfg = cfg
        self.method = method
        self.positive = positive
        self.text_pert = text_pert
        self.steps = pert.LXMERT_STEPS

    def _batch(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _explain(self, batch):
        """(scores, cam_text [N, St], cam_image [N, Sv]) for the predicted
        answer."""
        method = self.method
        scores, attn, grads = lx.capture(self.params, batch, None, self.cfg)
        # padding masks: without them one padded token / box NaN-poisons
        # the normalised bi-modal chain
        tv = batch["attention_mask"]
        vv = batch.get("visual_mask")
        if method == "ours_no_lrp":
            tt, ti = elx.generate_ours(attn, grads, text_valid=tv,
                                       visual_valid=vv)
        elif method == "ours_no_lrp_no_norm":
            tt, ti = elx.generate_ours(attn, grads,
                                       normalize_self_attention=False,
                                       text_valid=tv, visual_valid=vv)
        elif method == "ablation_no_self_in_10":
            tt, ti = elx.generate_ours(attn, grads,
                                       apply_self_in_rule_10=False,
                                       text_valid=tv, visual_valid=vv)
        elif method == "ablation_no_aggregation":
            tt, ti = elx.generate_ours_no_agg(
                attn, grads, normalize_self_attention=False, text_valid=tv,
                visual_valid=vv)
        elif method == "raw_attn":
            tt, ti = elx.generate_raw_attn(attn)
        elif method == "rollout":
            tt, ti = elx.generate_rollout(attn)
        else:  # attn_gradcam
            tt, ti = elx.generate_attn_gradcam(attn, grads)
        # text relevancy: the CLS row; image: the CLS row of R_t_i
        return scores, tt[:, 0], ti[:, 0]

    def _forward_scores(self, b):
        with torch.no_grad():
            return lx.forward(self.params, b["input_ids"],
                              b["attention_mask"], b["visual_feats"],
                              b["visual_pos"],
                              visual_mask=b.get("visual_mask"),
                              cfg=self.cfg)["qa_scores"]

    def explain_batched(self, batch):
        """``(scores, cam_text, cam_image)`` as numpy arrays."""
        scores, cam_text, cam_image = self._explain(self._batch(batch))
        return _host(scores), _host(cam_text), _host(cam_image)

    def submit_batched(self, batch, soft_targets) -> torch.Tensor:
        """Explain + N × steps perturbation; returns the DEVICE tensor
        ``[N, n_steps]`` without waiting for it, so that a caller can
        overlap the next batch's host work."""
        batch = self._batch(batch)
        targets = torch.as_tensor(_as_2d(soft_targets), device=self.device)
        _, cam_text, cam_image = self._explain(batch)
        if self.text_pert:
            S_text = batch["input_ids"].shape[1]
            text_len = batch["attention_mask"].sum(dim=1)
            ar = torch.arange(S_text, device=self.device)[None, :]
            # protect [CLS](0) and [SEP](len-1)
            always = (ar == 0) | (ar == (text_len - 1)[:, None])
            return pert.run_text_perturbation_batch(
                self._forward_scores, batch, cam_text, targets, self.steps,
                self.positive, always, text_len, input_ids_key="input_ids",
                input_mask_key="attention_mask")
        return pert.run_image_perturbation_batch(
            self._forward_scores, batch, cam_image, targets, self.steps,
            self.positive, num_boxes=batch.get("num_boxes"))

    def run_samples_batched(self, batch, soft_targets) -> np.ndarray:
        """N samples explained + perturbed in one call → ``[N, steps]``."""
        return _host(self.submit_batched(batch, soft_targets))

    def run_sample(self, batch, soft_targets) -> np.ndarray:
        return self.run_samples_batched(batch, soft_targets)[0]


def _collate(buf):
    """Stack single-sample (batch, soft) pairs into one N-batch: numpy
    leaves on the host (one upload per key per batch), tensor leaves with
    ``torch.cat`` where they lie."""
    batches, softs = zip(*buf)
    big = {}
    for k in batches[0]:
        leaves = [b[k] for b in batches]
        if all(isinstance(x, np.ndarray) for x in leaves):
            big[k] = np.concatenate(leaves, axis=0)
        else:
            big[k] = torch.cat([torch.as_tensor(x) for x in leaves])
    return big, np.stack([np.asarray(s).reshape(-1) for s in softs])


def run_loop(runner, samples: Iterable, max_samples: int, printer=print,
             batch_size: int = 8) -> np.ndarray:
    """Accumulate per-step accuracies with the reference's running
    printout. Collates ``batch_size`` samples per call (the last chunk is
    padded to the same size). Returns the final per-step accuracies."""
    totals = None
    n = 0
    buf = []
    last_print = 0
    pending = None  # (device accs, k): one batch kept in flight

    def settle():
        nonlocal totals, n, pending, last_print
        if pending is None:
            return
        dev, k = pending
        pending = None
        accs = _host(dev)[:k]
        totals = (accs.sum(axis=0) if totals is None
                  else totals + accs.sum(axis=0))
        n += k
        if n - last_print >= 100 or n >= max_samples:
            last_print = n
            running = totals / n
            printer(f"[{n}/{max_samples}] step accuracies: "
                    + " ".join(f"{a*100:.2f}" for a in running))

    def flush():
        """Submit the buffered samples, then settle the PREVIOUS batch."""
        nonlocal buf, pending
        if not buf:
            return
        k = len(buf)
        padded = buf + [buf[-1]] * (batch_size - k)
        big, softs = _collate(padded)
        submit = (runner.submit_batched
                  if hasattr(runner, "submit_batched")
                  else runner.run_samples_batched)
        dev = submit(big, softs)
        settle()
        pending = (dev, k)
        buf = []

    admitted = 0
    for sample in samples:
        if admitted >= max_samples:
            break
        buf.append(sample)
        admitted += 1
        if len(buf) == batch_size:
            flush()
    flush()
    settle()
    running = (np.zeros((len(runner.steps),), np.float64) if totals is None
               else totals / max(n, 1))
    printer(json.dumps({
        "num_samples": n,
        "steps": list(runner.steps),
        "step_accuracies": [float(a) for a in running],
        "auc": pert.auc(running, runner.steps),
    }))
    return running


def methods_for(model: str):
    return LXMERT_METHODS if model == "lxmert" else VISUALBERT_METHODS


def run_from_args(args) -> int:
    """CLI adapter (``cli perturbation``)."""
    from transformer_mm_explainability_tpu_torch.data import vqa as vqa_data
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)

    model = getattr(args, "model", "visual_bert")
    if model != "lxmert":
        raise NotImplementedError(_NOT_PORTED_VB)
    batch_size = getattr(args, "batch_size", 8) or 8
    device = getattr(args, "device", "cuda")

    if not (args.questions and args.features and args.ans2label):
        print("perturbation: needs --questions/--features/--ans2label "
              "(and optionally --checkpoint). Without data this command "
              "validates the pipeline on synthetic samples.")
        return _smoke(args)

    vocab = vqa_data.AnswerVocab(args.ans2label, args.label2ans)
    dataset = vqa_data.VQADataset([args.questions], vocab)
    if not getattr(args, "bert_vocab", None):
        print("perturbation: --bert-vocab vocab.txt is required with "
              "--questions (WordPiece vocabulary)")
        return 2
    tok = BertTokenizer(vocab_path=args.bert_vocab)

    feats = vqa_data.FeatureStore(vqa_data.load_obj_tsv(args.features),
                                  max_boxes=36)
    cfg = dataclasses.replace(lx.LXMERT_VQA, num_qa_labels=len(vocab))
    params = (lx.init_params(args.seed, cfg, device) if not args.checkpoint
              else _load_lx(args.checkpoint, cfg, device))
    runner = LxmertPerturbationRunner(params, cfg, args.method,
                                      args.is_positive_pert,
                                      args.is_text_pert, device=device)

    def gen():
        for item in dataset.sampled(args.num_samples, args.seed):
            if item["img_id"] not in feats:
                continue
            f = feats[item["img_id"]]
            enc = tok.encode_vqa(item["sent"], max_len=20)
            # host (numpy) samples: _collate stacks them on the host
            batch = {
                "input_ids": enc["input_ids"][None],
                "attention_mask": enc["input_mask"][None],
                "visual_feats": f["features"][None],
                "visual_pos": f["boxes"][None],
                "num_boxes": np.asarray([f["num_boxes"]], np.int32),
                "visual_mask": (np.arange(36) < f["num_boxes"])[None]
                .astype(np.int32),
            }
            yield batch, vocab.soft_scores(item.get("label", {}))

    run_loop(runner, gen(), args.num_samples, batch_size=batch_size)
    return 0


def _load_lx(path, cfg, device="cuda"):
    from transformer_mm_explainability_tpu_torch.utils import convert

    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert.lxmert_from_state_dict(sd, cfg, device)


# the tiny LXMERT of the synthetic run (the JAX package's, for both)
SMOKE_LXMERT = dict(vocab_size=100, hidden_size=64, num_attention_heads=4,
                    intermediate_size=128, l_layers=2, x_layers=2,
                    r_layers=2, num_qa_labels=13, visual_feat_dim=32,
                    max_position_embeddings=40)


def _smoke(args) -> int:
    """The pipeline on synthetic samples and a tiny random LXMERT."""
    if getattr(args, "model", "visual_bert") != "lxmert":
        raise NotImplementedError(_NOT_PORTED_VB)
    device = getattr(args, "device", "cuda")
    rng = np.random.RandomState(args.seed)
    n = min(args.num_samples, 4)
    cfg = lx.LxmertConfig(**SMOKE_LXMERT)
    params = lx.init_params(args.seed, cfg, device)
    runner = LxmertPerturbationRunner(params, cfg, args.method,
                                      args.is_positive_pert,
                                      args.is_text_pert, device=device)

    def gen():
        for _ in range(n):
            yield ({
                "input_ids": rng.randint(1, 99, (1, 12)),
                "attention_mask": np.ones((1, 12), np.int32),
                "visual_feats": rng.randn(1, 9, 32).astype(np.float32),
                "visual_pos": rng.rand(1, 9, 4).astype(np.float32),
            }, _soft(rng, 13))

    run_loop(runner, gen(), n, batch_size=min(4, n))
    return 0


def _soft(rng, num_labels):
    soft = np.zeros(num_labels, np.float32)
    soft[rng.randint(num_labels)] = 1.0
    return soft
