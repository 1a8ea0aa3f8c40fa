"""Semantic validation of the perturbation protocols: trained weights,
sloped curves, on the PyTorch port.

Counterpart of ``transformer_mm_explainability_tpu/tools/semantic_validation.py``
with the same names, task, seeds and checks. Random weights leave the
protocols' accuracy curves at chance, which cannot detect a bug that
scrambles relevancy; this tool is the semantic evidence without released
checkpoints:

  1. a synthetic *causal* VQA task where the answer is fully determined by
     ONE image box and ONE text token (every box carries a colour code, two
     boxes also carry distinct marker codes, the question holds exactly one
     marker token naming the box to look at, the answer is that box's
     colour); the draws are numpy ``RandomState`` streams, so a seed gives
     the JAX tool's batches;
  2. train a small VisualBERT (and LXMERT) on it to >= 90 % accuracy
     (``torch.optim.Adam``, lr 3e-4, B = 128; stop once the mean of the
     last 20 batch accuracies reaches 0.97, at most 4000 steps), from the
     JAX tool's initial weights (``INIT_PATH``);
  3. run the REAL perturbation runners (``harness/pert_runner``) for every
     method, pos/neg × text/image, plus a random-relevancy control;
  4. check what the harness exists to measure: negative-perturbation AUC
     well above positive, the random control strictly between them
     (hard), and 'ours' at least the attention baselines (soft).

Run:  python -m transformer_mm_explainability_tpu_torch.tools.semantic_validation \\
          [--device cuda|cpu] [--models visual_bert,lxmert] [--out JSON]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device

# --- task constants --------------------------------------------------------
NUM_COLORS = 6          # answer space
NUM_MARKERS = 4         # marker vocabulary (text token <-> box code)
NUM_BOXES = 20          # boxes per image
TEXT_LEN = 20           # fixed question length (incl. CLS/?/SEP)
VIS_DIM = 64            # box feature dim
# token ids: 1=[CLS], 2=[SEP], 3='?', 4..7 markers, 10..59 filler
CLS_ID, SEP_ID, QMARK_ID = 1, 2, 3
MARKER_ID0 = 4
FILLER0, FILLER1 = 10, 60
VOCAB = 64


class CausalVQATask:
    """Generator for the causal task. Colour/marker codes are fixed
    random directions in feature space (seeded), so train/eval/pert
    batches are all drawn from the same distribution."""

    def __init__(self, seed: int = 0, noise: float = 0.1):
        rng = np.random.RandomState(seed)
        self.color_vecs = rng.randn(NUM_COLORS, VIS_DIM).astype(np.float32)
        self.marker_vecs = rng.randn(NUM_MARKERS + 1,
                                     VIS_DIM).astype(np.float32)
        self.marker_vecs[0] = 0.0  # code 0 = unmarked
        self.noise = noise

    def batch(self, rng: np.random.RandomState, n: int) -> Dict:
        colors = rng.randint(0, NUM_COLORS, size=(n, NUM_BOXES))
        # two distinct marked boxes with distinct colours per sample
        slot = np.stack([rng.permutation(NUM_BOXES)[:2] for _ in range(n)])
        marks = np.stack([rng.permutation(NUM_MARKERS)[:2] + 1
                          for _ in range(n)])
        # force the two marked boxes to different colours (else the text
        # selector would not be causal)
        cA = colors[np.arange(n), slot[:, 0]]
        cB = (cA + 1 + rng.randint(0, NUM_COLORS - 1, n)) % NUM_COLORS
        colors[np.arange(n), slot[:, 1]] = cB
        codes = np.zeros((n, NUM_BOXES), np.int64)
        codes[np.arange(n), slot[:, 0]] = marks[:, 0]
        codes[np.arange(n), slot[:, 1]] = marks[:, 1]
        feats = (self.color_vecs[colors] + self.marker_vecs[codes]
                 + self.noise
                 * rng.randn(n, NUM_BOXES, VIS_DIM)).astype(np.float32)

        which = rng.randint(0, 2, n)                  # ask about A or B
        ask_mark = marks[np.arange(n), which]
        ans_slot = slot[np.arange(n), which]
        labels = colors[np.arange(n), ans_slot]

        ids = rng.randint(FILLER0, FILLER1, size=(n, TEXT_LEN))
        ids[:, 0] = CLS_ID
        ids[:, TEXT_LEN - 2] = QMARK_ID
        ids[:, TEXT_LEN - 1] = SEP_ID
        mark_pos = rng.randint(1, TEXT_LEN - 2, n)
        ids[np.arange(n), mark_pos] = MARKER_ID0 + ask_mark - 1
        mask = np.ones((n, TEXT_LEN), np.int32)

        boxes = rng.rand(n, NUM_BOXES, 4).astype(np.float32)
        return {
            "input_ids": ids.astype(np.int32), "input_mask": mask,
            "visual_feats": feats, "visual_pos": boxes,
            "labels": labels.astype(np.int32),
            "causal_box": ans_slot.astype(np.int32),
            "causal_token": mark_pos.astype(np.int32),
        }


# --- model adapters ---------------------------------------------------------

def _vb_config():
    from transformer_mm_explainability_tpu_torch.models import bert
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)

    return vb.VisualBERTConfig(
        bert=bert.BertConfig(
            vocab_size=VOCAB, hidden_size=128, num_hidden_layers=4,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=TEXT_LEN + NUM_BOXES + 4),
        visual_embedding_dim=VIS_DIM, num_labels=NUM_COLORS)


def _lx_config():
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx

    return lx.LxmertConfig(
        vocab_size=VOCAB, hidden_size=128, num_attention_heads=4,
        intermediate_size=256, l_layers=3, x_layers=2, r_layers=2,
        num_qa_labels=NUM_COLORS, visual_feat_dim=VIS_DIM,
        max_position_embeddings=TEXT_LEN + 4)


# The JAX tool draws its initial weights with jax.random at PRNGKey(7)
# (VisualBERT) and PRNGKey(8) (LXMERT). The port cannot make JAX's stream
# without JAX, so it ships those draws (``data/assets/semantic_init.npz``,
# written from the JAX tool by ``tests/test_torch_semantic_validation.py``,
# which also holds them equal to it) and trains from them: the same seeds
# give the same models as the JAX tool.
INIT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "assets", "semantic_init.npz")
INIT_SEEDS = {"visual_bert": 7, "lxmert": 8}


def jax_init(model: str) -> Dict:
    """The JAX tool's initial weights of ``model`` as a tree of numpy
    arrays in the JAX package's layout (dicts; ``attn.w_qkv``-style keys
    are the fields of its attention NamedTuples), for
    ``utils/convert.{visual_bert,lxmert}_from_jax_numpy``."""
    z = np.load(INIT_PATH)
    tree: Dict = {}
    for key in z.files:
        if not key.startswith(model + "/"):
            continue
        *path, leaf = key.split("/")[1:]
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = z[key]
    return _named(tree)


def _named(tree):
    """``{"attn.w_qkv": a, "attn.b_qkv": b, ...}`` → ``{"attn":
    NamedTuple(w_qkv=a, b_qkv=b, ...)}``, recursively."""
    if not isinstance(tree, dict):
        return tree
    out: Dict = {}
    for k, v in tree.items():
        if "." in k:
            name, field = k.split(".")
            out.setdefault(name, {})[field] = v
        else:
            out[k] = _named(v)
    return {k: (collections.namedtuple(k, list(v))(**v)
                if any("." in f for f in tree if f.startswith(k + "."))
                else v) for k, v in out.items()}


def _init(model: str, cfg, device):
    from transformer_mm_explainability_tpu_torch.utils import convert

    from_jax = (convert.lxmert_from_jax_numpy if model == "lxmert"
                else convert.visual_bert_from_jax_numpy)
    return from_jax(jax_init(model), cfg, device)


def _vb_setup(device="cuda"):
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)

    cfg = _vb_config()
    params = _init("visual_bert", cfg, device)

    def scores(params, b):
        return vb.forward(params, b["input_ids"], b["input_mask"],
                          b["visual_embeddings"], cfg=cfg)["scores"]

    def to_model_batch(raw):
        return {"input_ids": raw["input_ids"],
                "input_mask": raw["input_mask"],
                "visual_embeddings": raw["visual_feats"]}

    return cfg, params, scores, to_model_batch


def _lx_setup(device="cuda"):
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx

    cfg = _lx_config()
    params = _init("lxmert", cfg, device)

    def scores(params, b):
        return lx.forward(params, b["input_ids"], b["attention_mask"],
                          b["visual_feats"], b["visual_pos"],
                          cfg=cfg)["qa_scores"]

    def to_model_batch(raw):
        return {"input_ids": raw["input_ids"],
                "attention_mask": raw["input_mask"],
                "visual_feats": raw["visual_feats"],
                "visual_pos": raw["visual_pos"]}

    return cfg, params, scores, to_model_batch


# --- training ---------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    """Every tensor of a parameter tree (dicts, NamedTuples, lists)."""
    if torch.is_tensor(tree):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def _to_device(raw: Dict, device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    if "input_ids" in out:
        out["input_ids"] = out["input_ids"].long()
    return out


def train(task: CausalVQATask, params, scores_fn, to_model_batch,
          max_steps: int = 4000, batch: int = 128, lr: float = 3e-4,
          target_acc: float = 0.97, seed: int = 1, printer=print,
          device="cuda") -> Tuple[object, Dict]:
    """Adam on the cross-entropy of ``scores_fn(params, batch)``, in place
    on ``params``' tensors (which must lie on ``device``); stops once the
    mean of the last 20 batch accuracies reaches ``target_acc``. Returns
    ``(params, info)`` with the held-out accuracy (seed + 1000, 512
    samples)."""
    device = resolve_device(device)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)
    rng = np.random.RandomState(seed)

    t0 = time.perf_counter()
    recent: List[float] = []
    n_steps = 0
    for i in range(max_steps):
        raw = task.batch(rng, batch)
        b = _to_device(to_model_batch(raw), device)
        labels = torch.as_tensor(raw["labels"], device=device).long()
        with torch.enable_grad():
            s = scores_fn(params, b)
            logp = torch.log_softmax(s, dim=-1)
            loss = -logp.gather(1, labels[:, None]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
        opt.step()
        recent.append(float((s.detach().argmax(-1) == labels).float()
                            .mean()))
        recent = recent[-20:]
        n_steps = i + 1
        if (i + 1) % 200 == 0:
            printer(f"  step {i + 1}: loss {float(loss.detach()):.4f} "
                    f"acc {np.mean(recent):.3f}")
        if len(recent) == 20 and np.mean(recent) >= target_acc:
            break
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None

    # held-out eval
    eval_rng = np.random.RandomState(seed + 1000)
    raw = task.batch(eval_rng, 512)
    with torch.no_grad():
        pred = scores_fn(params, _to_device(to_model_batch(raw), device))
    eval_acc = float((pred.argmax(-1).cpu().numpy()
                      == raw["labels"]).mean())
    info = {"train_steps": n_steps, "train_wall_s":
            round(time.perf_counter() - t0, 1),
            "train_acc_recent": round(float(np.mean(recent)), 4),
            "eval_acc": round(eval_acc, 4), "eval_n": 512}
    printer(f"  trained: {info}")
    return params, info


# --- perturbation sweeps ----------------------------------------------------

def _soft_targets(labels: np.ndarray) -> np.ndarray:
    soft = np.zeros((len(labels), NUM_COLORS), np.float32)
    soft[np.arange(len(labels)), labels] = 1.0
    return soft


def _control(model: str, params, cfg, text_pert: bool, steps, b, cam, tgt):
    """The random-relevancy control's batch: the perturbation harness's
    batch helpers with the method replaced by an iid cam."""
    from transformer_mm_explainability_tpu_torch.harness import (
        perturbation as pert)
    from transformer_mm_explainability_tpu_torch.models import lxmert as lxm
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vbm)

    mask_key = "attention_mask" if model == "lxmert" else "input_mask"

    def fwd_scores(b):
        with torch.no_grad():
            if model == "lxmert":
                return lxm.forward(params, b["input_ids"],
                                   b["attention_mask"], b["visual_feats"],
                                   b["visual_pos"],
                                   visual_mask=b.get("visual_mask"),
                                   cfg=cfg)["qa_scores"]
            return vbm.forward(params, b["input_ids"], b["input_mask"],
                               b.get("visual_embeddings"),
                               visual_mask=b.get("visual_mask"),
                               cfg=cfg)["scores"]

    if text_pert:
        S = b["input_ids"].shape[1]
        tl = b[mask_key].sum(dim=1)
        ar = torch.arange(S, device=tl.device)[None, :]
        if model == "lxmert":
            always = (ar == 0) | (ar == (tl - 1)[:, None])
        else:
            always = (ar == 0) | (ar >= (tl - 2)[:, None])
        return pert.run_text_perturbation_batch(
            fwd_scores, b, cam, tgt, steps, False, always, tl,
            input_mask_key=mask_key)
    return pert.run_image_perturbation_batch(fwd_scores, b, cam, tgt, steps,
                                             False)


def run_sweeps(model: str, params, cfg, methods: List[str],
               task: CausalVQATask, num_samples: int = 256,
               batch_size: int = 32, seed: int = 42,
               printer=print, device="cuda") -> List[Dict]:
    """pos/neg x text/image for every method through the REAL protocol
    runners, plus a matched random-relevancy control."""
    from transformer_mm_explainability_tpu_torch.harness import (
        perturbation as pert)
    from transformer_mm_explainability_tpu_torch.harness import pert_runner

    device = resolve_device(device)
    runner_cls = (pert_runner.LxmertPerturbationRunner if model == "lxmert"
                  else pert_runner.VisualBertPerturbationRunner)

    rng = np.random.RandomState(seed)
    raw = task.batch(rng, num_samples)
    soft = _soft_targets(raw["labels"])
    if model == "lxmert":
        keys = {"input_ids": raw["input_ids"],
                "attention_mask": raw["input_mask"],
                "visual_feats": raw["visual_feats"],
                "visual_pos": raw["visual_pos"]}
    else:
        keys = {"input_ids": raw["input_ids"],
                "input_mask": raw["input_mask"],
                "visual_embeddings": raw["visual_feats"]}
    keys = _to_device(keys, device)
    batches = [{k: v[s:s + batch_size] for k, v in keys.items()}
               for s in range(0, num_samples, batch_size)]

    out: List[Dict] = []
    for method in methods:
        for positive in (False, True):
            for text_pert in (False, True):
                runner = runner_cls(params, cfg, method, positive=positive,
                                    text_pert=text_pert, device=device)
                accs = [runner.run_samples_batched(
                    b, soft[s:s + batch_size]) for b, s in
                    zip(batches, range(0, num_samples, batch_size))]
                curve = np.concatenate(accs).mean(axis=0)
                entry = {
                    "method": method, "positive": positive,
                    "text_pert": text_pert,
                    "num_samples": num_samples,
                    "steps": list(runner.steps),
                    "step_accuracies":
                        [round(float(a), 4) for a in curve],
                    "auc": round(float(pert.auc(curve, runner.steps)), 4),
                }
                out.append(entry)
                printer(f"  {model} {method} pos={positive} "
                        f"text={text_pert}: auc={entry['auc']} "
                        f"curve={entry['step_accuracies']}")

    # random-relevancy control: same harness mechanics, cam drawn iid,
    # separates "the harness moves accuracy" from "the method ranks the
    # causal input first"
    ctl_rng = np.random.RandomState(seed + 7)
    for text_pert in (False, True):
        steps = (pert.TEXT_STEPS if text_pert else
                 (pert.LXMERT_STEPS if model == "lxmert"
                  else pert.IMAGE_STEPS_VISUALBERT))
        accs = []
        for b, s in zip(batches, range(0, num_samples, batch_size)):
            n = b["input_ids"].shape[0]
            width = TEXT_LEN if text_pert else NUM_BOXES
            cam = torch.as_tensor(ctl_rng.rand(n, width).astype(np.float32),
                                  device=device)
            tgt = torch.as_tensor(soft[s:s + batch_size], device=device)
            accs.append(_control(model, params, cfg, text_pert, steps, b,
                                 cam, tgt).cpu().numpy())
        curve = np.concatenate(accs).mean(axis=0)
        entry = {"method": "random_control", "positive": False,
                 "text_pert": text_pert, "num_samples": num_samples,
                 "steps": list(steps),
                 "step_accuracies": [round(float(a), 4) for a in curve],
                 "auc": round(float(pert.auc(curve, steps)), 4)}
        out.append(entry)
        printer(f"  {model} random_control text={text_pert}: "
                f"auc={entry['auc']}")
    return out


# --- assertions -------------------------------------------------------------

def check_semantics(sweeps: List[Dict], flagship: str,
                    min_gap: float = 0.25) -> Dict:
    """The properties the harness exists to measure. Returns a record
    with per-check ok flags; 'ok' is the conjunction of the HARD checks
    (neg >> pos for the flagship, control strictly between them)."""
    def get(method, positive, text):
        for e in sweeps:
            if (e["method"] == method and e["positive"] == positive
                    and e["text_pert"] == text):
                return e
        return None

    checks = []
    for text in (False, True):
        neg = get(flagship, False, text)
        pos = get(flagship, True, text)
        ctl = get("random_control", False, text)
        gap = neg["auc"] - pos["auc"]
        checks.append({
            "check": f"{'text' if text else 'image'}: neg_auc >> pos_auc "
                     f"({flagship})",
            "neg_auc": neg["auc"], "pos_auc": pos["auc"],
            "gap": round(gap, 4), "min_gap": min_gap,
            "hard": True, "ok": bool(gap >= min_gap)})
        if ctl is not None:
            between = bool(pos["auc"] < ctl["auc"] < neg["auc"])
            checks.append({
                "check": f"{'text' if text else 'image'}: random control "
                         f"strictly between pos and neg ({flagship})",
                "control_auc": ctl["auc"], "hard": True, "ok": between})
        for baseline in ("raw_attn", "rollout", "attn_gradcam"):
            b = get(baseline, False, text)
            if b is None:
                continue
            checks.append({
                "check": f"{'text' if text else 'image'}: neg_auc "
                         f"{flagship} >= {baseline} - 0.02",
                "ours": neg["auc"], "baseline": b["auc"],
                "hard": False, "ok": bool(neg["auc"] >= b["auc"] - 0.02)})
    return {"checks": checks,
            "ok": all(c["ok"] for c in checks if c["hard"])}


# --- CLI ---------------------------------------------------------------------

def run_family(model: str, methods: Optional[List[str]] = None,
               num_samples: int = 256, max_steps: int = 4000,
               printer=print, device="cuda") -> Dict:
    device = resolve_device(device)
    task = CausalVQATask()
    if model == "lxmert":
        cfg, params, scores_fn, to_mb = _lx_setup(device)
        methods = methods or ["ours_no_lrp", "transformer_att",
                              "partial_lrp", "raw_attn", "rollout",
                              "attn_gradcam"]
    else:
        cfg, params, scores_fn, to_mb = _vb_setup(device)
        methods = methods or ["ours_no_lrp", "transformer_attribution",
                              "partial_lrp", "raw_attn", "rollout",
                              "attn_gradcam"]
    printer(f"[{model}] training on the causal task ...")
    params, train_info = train(task, params, scores_fn, to_mb,
                               max_steps=max_steps, printer=printer,
                               device=device)
    printer(f"[{model}] perturbation sweeps ({len(methods)} methods x "
            f"pos/neg x text/image + control) ...")
    t0 = time.perf_counter()
    sweeps = run_sweeps(model, params, cfg, methods, task,
                        num_samples=num_samples, printer=printer,
                        device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    semantics = check_semantics(sweeps, "ours_no_lrp")
    return {
        "model": model,
        "init": {"draw": "jax", "seed": INIT_SEEDS[model]},
        "task": {"num_colors": NUM_COLORS, "num_markers": NUM_MARKERS,
                 "num_boxes": NUM_BOXES, "text_len": TEXT_LEN,
                 "vis_dim": VIS_DIM,
                 "design": "answer = color of the box named by the "
                           "question's marker token; exactly one causal "
                           "box + one causal text token per sample"},
        "train": train_info,
        "sweep_wall_s": round(time.perf_counter() - t0, 1),
        "sweeps": sweeps,
        "semantics": semantics,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--models", default="visual_bert,lxmert")
    p.add_argument("--num-samples", type=int, default=256)
    p.add_argument("--max-train-steps", type=int, default=4000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    results = {"artifact": "semantic_validation",
               "devices": [torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"],
               "backend": device.type}

    def write():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
                f.write("\n")

    ok = True
    for model in args.models.split(","):
        fam = run_family(model.strip(), num_samples=args.num_samples,
                         max_steps=args.max_train_steps, device=device)
        results[model.strip()] = fam
        ok &= fam["semantics"]["ok"]
        ok &= fam["train"]["eval_acc"] >= 0.9
        write()
    results["ok"] = bool(ok)
    print(json.dumps({k: v for k, v in results.items()
                      if k in ("artifact", "backend", "ok")}))
    write()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
