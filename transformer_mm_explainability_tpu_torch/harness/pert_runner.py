"""Perturbation benchmark runners, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/pert_runner.py``.
Streams VQA samples, explains the model's PREDICTED answer with the chosen
method, runs the step-batched perturbation forward, and prints running
per-step accuracies as the reference does.

Method tables have the reference's names: VisualBERT's 6 (plus the
``transformer_att`` alias and the JAX package's ``ours_with_lrp``
extension) and LXMERT's 11. The methods that need LRP relevance
(``_VB_NEEDS_LRP``, ``_LX_NEEDS_LRP``) take the tape of the capture's
forward and run the relprop (``models/visual_bert.relprop``,
``models/lxmert_lrp.relprop``) for the predicted answers; its sums are
per example, so each sample's map is the reference's one-sample map
whatever the batch.

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

from transformer_mm_explainability_tpu_torch._device import (
    params_to,
    resolve_device,
)
from transformer_mm_explainability_tpu_torch.explain import lxmert as elx
from transformer_mm_explainability_tpu_torch.explain import visual_bert as evb
from transformer_mm_explainability_tpu_torch.harness import perturbation as pert
from transformer_mm_explainability_tpu_torch.models import bert
from transformer_mm_explainability_tpu_torch.models import lxmert as lx
from transformer_mm_explainability_tpu_torch.models import lxmert_lrp
from transformer_mm_explainability_tpu_torch.models import visual_bert as vb

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
# VisualBERT method names (reference: evaluation_loop.py:82-87)
VISUALBERT_METHODS = (
    "transformer_attribution", "ours_no_lrp", "partial_lrp",
    "raw_attn", "attn_gradcam", "rollout",
)
_VISUALBERT_ALIASES = {
    # the LXMERT pipeline's name for the same baseline
    "transformer_att": "transformer_attribution",
}
_VB_NEEDS_LRP = {"transformer_attribution", "partial_lrp", "ours_with_lrp"}


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


def _as_batch(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class _Runner:
    """What both runners share over their ``submit_batched``."""

    def run_samples_batched(self, batch, soft_targets) -> np.ndarray:
        """N samples explained + perturbed in one call → ``[N, steps]``."""
        return _host(self.submit_batched(batch, soft_targets))

    def run_sample(self, batch, soft_targets) -> np.ndarray:
        return self.run_samples_batched(batch, soft_targets)[0]


class VisualBertPerturbationRunner(_Runner):
    """MMF-style VisualBERT VQA pipeline on ``device``. Batch leaves carry
    a leading sample axis N (N=1 for the reference's per-sample protocol),
    may be numpy arrays or tensors, and go to ``device``; the parameters
    are moved there (no copy where they are there already)."""

    def __init__(self, params, cfg, method: str = "ours_no_lrp",
                 positive: bool = False, text_pert: bool = False,
                 device="cuda"):
        # "ours_with_lrp": the JAX package's extension beyond the
        # reference's 6-name table
        method = _resolve(method, VISUALBERT_METHODS + ("ours_with_lrp",),
                          _VISUALBERT_ALIASES, "visual_bert")
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.method = method
        self.positive = positive
        self.text_pert = text_pert
        self.steps = (pert.TEXT_STEPS if text_pert
                      else pert.IMAGE_STEPS_VISUALBERT)

    def _explain(self, batch):
        """(scores, cam [N, S]) for the predicted answer."""
        method, cfg = self.method, self.cfg
        if method == "ours_no_lrp":
            # the streamed row fold: no [L, N, H, S, S] stacks
            return vb.relevancy_row(self.params, batch, None, cfg)
        cls_index = vb.cls_index(batch["input_mask"])
        if method not in _VB_NEEDS_LRP:
            scores, attn, grads = vb.capture(self.params, batch, None, cfg)
            return scores, evb.METHODS_FROM_CAPTURE[method](attn, grads,
                                                            cls_index)
        if method == "partial_lrp":
            # the relprop cams alone: a forward without gradients
            with torch.no_grad():
                out = vb.forward(
                    self.params, batch["input_ids"], batch["input_mask"],
                    batch.get("visual_embeddings"),
                    visual_mask=batch.get("visual_mask"), cfg=cfg,
                    return_tape=True)
            scores, tape = out["scores"], out["tape"]
        else:
            # one forward gives the gradients and the relprop's tape
            scores, _, grads, tape = vb.capture(self.params, batch, None,
                                                cfg, return_tape=True)
        one_hot = torch.nn.functional.one_hot(scores.argmax(-1),
                                              cfg.num_labels)
        _, cams = vb.relprop(self.params, tape, one_hot, cfg)
        if method == "partial_lrp":
            return scores, evb.generate_partial_lrp(cams, cls_index)
        if method == "transformer_attribution":
            return scores, evb.generate_transformer_att(cams, grads,
                                                        cls_index)
        return scores, evb.generate_ours(cams, grads, cls_index)

    def _forward_scores(self, b):
        with torch.no_grad():
            return vb.forward(self.params, b["input_ids"], b["input_mask"],
                              b.get("visual_embeddings"),
                              visual_mask=b.get("visual_mask"),
                              cfg=self.cfg)["scores"]

    def explain_batched(self, batch):
        """``(scores, cam)`` as numpy arrays."""
        scores, cam = self._explain(_as_batch(batch, self.device))
        return _host(scores), _host(cam)

    def submit_batched(self, batch, soft_targets) -> torch.Tensor:
        """Explain + N × steps perturbation; returns the DEVICE tensor
        ``[N, n_steps]`` without waiting for it."""
        batch = _as_batch(batch, self.device)
        targets = torch.as_tensor(_as_2d(soft_targets), device=self.device)
        _, cam = self._explain(batch)
        S_text = batch["input_ids"].shape[1]
        if self.text_pert:
            text_len = batch["input_mask"].sum(dim=1)
            ar = torch.arange(S_text, device=self.device)[None, :]
            # protect [CLS](0), '?'(len-2) and [SEP](len-1)
            always = (ar == 0) | (ar >= (text_len - 2)[:, None])
            return pert.run_text_perturbation_batch(
                self._forward_scores, batch, cam[:, :S_text], targets,
                self.steps, self.positive, always, text_len)
        return pert.run_image_perturbation_batch(
            self._forward_scores, batch, cam[:, S_text:], targets,
            self.steps, self.positive, num_boxes=batch.get("num_boxes"))


class LxmertPerturbationRunner(_Runner):
    """LXMERT VQA pipeline (the reference's ``ModelPert``) on ``device``.

    Consumes precomputed FRCNN features (the reference recomputes the CNN
    per step on the same image, which gives the same features). The
    parameters are moved to ``device`` (no copy where they are there
    already); batch leaves may be numpy arrays or tensors and go to it."""

    def __init__(self, params, cfg, method: str = "ours_no_lrp",
                 positive: bool = False, text_pert: bool = False,
                 device="cuda"):
        method = _resolve(method, LXMERT_METHODS, _LXMERT_ALIASES, "lxmert")
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.method = method
        self.positive = positive
        self.text_pert = text_pert
        self.steps = pert.LXMERT_STEPS

    def _explain(self, batch):
        """(scores, cam_text [N, St], cam_image [N, Sv]) for the predicted
        answer."""
        method, cfg = self.method, self.cfg
        if method == "partial_lrp":
            # the relprop cams alone: a forward without gradients
            with torch.no_grad():
                out = self._forward(batch, return_tape=True)
            scores, tape = out["qa_scores"], out["tape"]
        elif method in _LX_NEEDS_LRP:
            # one forward gives the gradients and the relprop's tape
            scores, attn, grads, tape = lx.capture(
                self.params, batch, None, cfg, return_tape=True)
        else:
            scores, attn, grads = lx.capture(self.params, batch, None, cfg)
        if method in _LX_NEEDS_LRP:
            one_hot = torch.nn.functional.one_hot(scores.argmax(-1),
                                                  cfg.num_qa_labels)
            _, _, cams = lxmert_lrp.relprop(
                self.params, tape, one_hot, tape["lang_mask"],
                tape["visn_mask"], cfg)
        # padding masks: without them one padded token / box NaN-poisons
        # the normalised bi-modal chain
        tv = batch["attention_mask"]
        vv = batch.get("visual_mask")
        if method == "ours_with_lrp":
            tt, ti = elx.generate_ours_lrp(cams, grads, text_valid=tv,
                                           visual_valid=vv)
        elif method == "ours_with_lrp_no_normalization":
            tt, ti = elx.generate_ours_lrp(cams, grads,
                                           normalize_self_attention=False,
                                           text_valid=tv, visual_valid=vv)
        elif method == "transformer_att":
            tt, ti = elx.generate_transformer_att(cams, grads)
        elif method == "partial_lrp":
            tt, ti = elx.generate_partial_lrp(cams)
        elif method == "ours_no_lrp":
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

    def _forward(self, b, return_tape: bool = False):
        return lx.forward(self.params, b["input_ids"], b["attention_mask"],
                          b["visual_feats"], b["visual_pos"],
                          visual_mask=b.get("visual_mask"), cfg=self.cfg,
                          return_tape=return_tape)

    def _forward_scores(self, b):
        with torch.no_grad():
            return self._forward(b)["qa_scores"]

    def explain_batched(self, batch):
        """``(scores, cam_text, cam_image)`` as numpy arrays."""
        scores, cam_text, cam_image = self._explain(
            _as_batch(batch, self.device))
        return _host(scores), _host(cam_text), _host(cam_image)

    def submit_batched(self, batch, soft_targets) -> torch.Tensor:
        """Explain + N × steps perturbation; returns the DEVICE tensor
        ``[N, n_steps]`` without waiting for it, so that a caller can
        overlap the next batch's host work."""
        batch = _as_batch(batch, self.device)
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

    if model == "lxmert":
        max_boxes, max_len, mask_key = 36, 20, "attention_mask"
        cfg = dataclasses.replace(lx.LXMERT_VQA, num_qa_labels=len(vocab))
        params = (lx.init_params(args.seed, cfg, device)
                  if not args.checkpoint
                  else _load_lx(args.checkpoint, cfg, device))
        runner = LxmertPerturbationRunner(params, cfg, args.method,
                                          args.is_positive_pert,
                                          args.is_text_pert, device=device)
    else:
        max_boxes, max_len, mask_key = 100, 128, "input_mask"
        cfg = dataclasses.replace(vb.VISUAL_BERT_VQA2, num_labels=len(vocab))
        params = (vb.init_params(args.seed, cfg, device)
                  if not args.checkpoint
                  else _load_vb(args.checkpoint, cfg, device))
        runner = VisualBertPerturbationRunner(params, cfg, args.method,
                                              args.is_positive_pert,
                                              args.is_text_pert,
                                              device=device)
    feats = vqa_data.FeatureStore(vqa_data.load_obj_tsv(args.features),
                                  max_boxes=max_boxes)

    def gen():
        for item in dataset.sampled(args.num_samples, args.seed):
            if item["img_id"] not in feats:
                continue
            f = feats[item["img_id"]]
            enc = tok.encode_vqa(item["sent"], max_len=max_len)
            # host (numpy) samples: _collate stacks them on the host
            batch = {
                "input_ids": enc["input_ids"][None],
                mask_key: enc["input_mask"][None],
                "num_boxes": np.asarray([f["num_boxes"]], np.int32),
                "visual_mask": (np.arange(max_boxes) < f["num_boxes"])[None]
                .astype(np.int32),
            }
            if model == "lxmert":
                batch["visual_feats"] = f["features"][None]
                batch["visual_pos"] = f["boxes"][None]
            else:
                batch["visual_embeddings"] = f["features"][None]
            yield batch, vocab.soft_scores(item.get("label", {}))

    run_loop(runner, gen(), args.num_samples, batch_size=batch_size)
    return 0


def _load_vb(path, cfg, device="cuda"):
    from transformer_mm_explainability_tpu_torch.utils.mmf_loader import (
        load_visual_bert)

    params, _ = load_visual_bert(path, cfg, device)
    return params


def _load_lx(path, cfg, device="cuda"):
    from transformer_mm_explainability_tpu_torch.utils import convert

    sd = torch.load(path, map_location="cpu")
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return convert.lxmert_from_state_dict(sd, cfg, device)


# the tiny models of the synthetic run (the JAX package's)
SMOKE_LXMERT = dict(vocab_size=100, hidden_size=64, num_attention_heads=4,
                    intermediate_size=128, l_layers=2, x_layers=2,
                    r_layers=2, num_qa_labels=13, visual_feat_dim=32,
                    max_position_embeddings=40)
SMOKE_BERT = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=40)
SMOKE_VISUAL_BERT = vb.VisualBERTConfig(bert=bert.BertConfig(**SMOKE_BERT),
                                        visual_embedding_dim=32,
                                        num_labels=13)


def _smoke(args) -> int:
    """The pipeline on synthetic samples and a tiny random model."""
    model = getattr(args, "model", "visual_bert")
    device = getattr(args, "device", "cuda")
    rng = np.random.RandomState(args.seed)
    n = min(args.num_samples, 4)
    if model == "lxmert":
        cfg = lx.LxmertConfig(**SMOKE_LXMERT)
        runner = LxmertPerturbationRunner(
            lx.init_params(args.seed, cfg, device), cfg, args.method,
            args.is_positive_pert, args.is_text_pert, device=device)
        mask_key, visual_key = "attention_mask", "visual_feats"
    else:
        cfg = SMOKE_VISUAL_BERT
        runner = VisualBertPerturbationRunner(
            vb.init_params(args.seed, cfg, device), cfg, args.method,
            args.is_positive_pert, args.is_text_pert, device=device)
        mask_key, visual_key = "input_mask", "visual_embeddings"

    def gen():
        for _ in range(n):
            sample = {
                "input_ids": rng.randint(1, 99, (1, 12)),
                mask_key: np.ones((1, 12), np.int32),
                visual_key: rng.randn(1, 9, 32).astype(np.float32),
            }
            if model == "lxmert":
                sample["visual_pos"] = rng.rand(1, 9, 4).astype(np.float32)
            yield sample, _soft(rng, 13)

    run_loop(runner, gen(), n, batch_size=min(4, n))
    return 0


def _soft(rng, num_labels):
    soft = np.zeros(num_labels, np.float32)
    soft[rng.randint(num_labels)] = 1.0
    return soft
