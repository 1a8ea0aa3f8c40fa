"""LXMERT per-task finetune loops (C36: lxmert/src/tasks/{vqa,gqa,nlvr2}.py),
in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/train/lxmert_tasks.py``,
the reference VQA finetune protocol (tasks/vqa.py:33-140, the task heads
of tasks/vqa_model.py:11-50 / gqa_model.py / nlvr2_model.py, and the
run/vqa_finetune.bash hyperparameters):

  * model: LXMERT encoder (``--llayers 9 --xlayers 5 --rlayers 5``) +
    the GELU answer head sized to the task's answer vocabulary;
  * loss: ``BCEWithLogitsLoss()(logit, target) * num_answers``
    (tasks/vqa.py:96-97) on soft VQA targets;
  * optimizer: BertAdam (no bias correction, decoupled weight decay,
    warmup_linear schedule with warmup=0.1 over
    ``epochs * batches_per_epoch`` total steps, lr 5e-5, batch 32);
  * grad clipping: global norm 5.0 BEFORE the optimizer
    (tasks/vqa.py:100 ``clip_grad_norm_(…, 5.)``), by optax's rule;
  * per-epoch train/valid accuracy via the VQAEvaluator semantics
    (soft score of the argmax answer, the train accuracy from the logits
    of the step's own forward, made before its update), best-parameter
    tracking (a copy: the updates are in place).

The GQA loop (tasks/gqa.py) is the same protocol over the GQA reader;
NLVR2 pairs each sentence with two images. Every entry point takes
``device`` (default ``"cuda"``; ``_device.resolve_device`` raises when
CUDA is asked for and missing).
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import lxmert as lx
from transformer_mm_explainability_tpu_torch.ops.attention import (
    gelu,
    layer_norm,
)
from transformer_mm_explainability_tpu_torch.train import steps


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """The run/vqa_finetune.bash surface."""
    llayers: int = 9
    xlayers: int = 5
    rlayers: int = 5
    batch_size: int = 32
    lr: float = 5e-5
    epochs: int = 4
    warmup: float = 0.1
    grad_clip: float = 5.0     # tasks/vqa.py:100
    max_text_len: int = 20
    task: str = "vqa"


def bce_vqa_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss (mean over all elements) * num_answers
    (tasks/vqa.py:96-97) == per-sample sum of BCE, batch-averaged."""
    per_elem = F.binary_cross_entropy_with_logits(logits, targets,
                                                  reduction="none")
    return per_elem.mean() * logits.shape[-1]


def _clone(tree):
    return steps.tree_map(lambda t: t.detach().clone(), tree)


def _call_batches(fn: Callable, epoch: int) -> Iterable:
    """``fn(epoch)`` when ``fn`` takes an argument (a per-epoch shuffle),
    else ``fn()``: decided from the signature, so that a TypeError raised
    inside ``fn`` is not taken for a signature mismatch."""
    return fn(epoch) if inspect.signature(fn).parameters else fn()


class _TaskTrainer:
    """The epoch loop shared by the VQA/GQA and NLVR2 trainers: a
    BertAdam state, ``loss_fn(params, batch) -> (loss, logits)`` and
    ``hits(logits, batch) -> (score sum, n)``."""

    ft: FinetuneConfig
    state: steps.TrainState

    def _init_train(self, params, batches_per_epoch: int) -> None:
        t_total = self.ft.epochs * batches_per_epoch
        self.tx = steps.make_bert_adam(
            self.ft.lr, warmup=self.ft.warmup, total_steps=max(t_total, 1),
            grad_clip=self.ft.grad_clip)
        self.state = steps.init_state(params, self.tx)
        self.best_valid = 0.0
        self.best_params = None

    def train_step(self, batch) -> Tuple[float, torch.Tensor]:
        """One update: (its loss, the logits of its forward, made before
        the update)."""
        (loss, logits), grads = steps.value_and_grad(
            self.loss_fn, self.state.params, batch, has_aux=True)
        self.state.opt_state.apply(grads)
        self.state.step += 1
        return float(loss), logits

    def train_epoch(self, batches: Iterable[Dict[str, torch.Tensor]],
                    printer=print) -> Tuple[float, float]:
        """One epoch → (mean loss, train accuracy) (tasks/vqa.py:104-109)."""
        losses: List[float] = []
        score_sum, n = 0.0, 0
        for batch in batches:
            loss, logits = self.train_step(batch)
            losses.append(loss)
            s, k = self.hits(logits, batch)
            score_sum += s
            n += k
        return float(np.mean(losses)), score_sum / max(n, 1)

    def evaluate(self, batches: Iterable[Dict[str, torch.Tensor]]) -> float:
        score_sum, n = 0.0, 0
        with torch.no_grad():
            for batch in batches:
                s, k = self.hits(self.predict(self.state.params, batch),
                                 batch)
                score_sum += s
                n += k
        return score_sum / max(n, 1)

    def fit(self, train_batches_fn: Callable[..., Iterable],
            valid_batches_fn: Optional[Callable[[], Iterable]] = None,
            printer=print) -> Dict[str, List[float]]:
        """The reference epoch loop with best-parameter tracking
        (tasks/vqa.py:81-127); ``train_batches_fn`` may take the epoch
        (reshuffled per epoch like the reference's DataLoader)."""
        log: Dict[str, List[float]] = {"loss": [], "train_acc": [],
                                       "valid_acc": []}
        for epoch in range(self.ft.epochs):
            loss, train_acc = self.train_epoch(
                _call_batches(train_batches_fn, epoch), printer)
            line = f"Epoch {epoch}: Train {train_acc * 100:.2f}"
            log["loss"].append(loss)
            log["train_acc"].append(train_acc)
            if valid_batches_fn is not None:
                valid = self.evaluate(valid_batches_fn())
                log["valid_acc"].append(valid)
                if valid > self.best_valid:
                    self.best_valid = valid
                    self.best_params = _clone(self.state.params)
                line += (f"  Valid {valid * 100:.2f}  "
                         f"Best {self.best_valid * 100:.2f}")
            printer(line)
        return log


def _soft_hits(logits: torch.Tensor, batch) -> Tuple[float, int]:
    """Σ soft score of the argmax answer over the valid samples, and their
    count (the VQAEvaluator)."""
    pred = logits.argmax(-1).cpu().numpy()
    tgt = batch["target"].cpu().numpy()
    valid = (batch["sample_valid"].cpu().numpy()
             if "sample_valid" in batch else np.ones(tgt.shape[0], bool))
    return float(tgt[np.arange(len(pred)), pred][valid].sum()), \
        int(valid.sum())


class LxmertTaskTrainer(_TaskTrainer):
    """tasks/vqa.py's VQA class."""

    def __init__(self, num_answers: int,
                 ft: FinetuneConfig = FinetuneConfig(),
                 model_cfg: Optional[lx.LxmertConfig] = None,
                 batches_per_epoch: int = 1000,
                 params: Optional[Dict[str, Any]] = None,
                 seed: int = 9595, device="cuda"):
        self.ft = ft
        self.device = resolve_device(device)
        self.cfg = model_cfg or dataclasses.replace(
            lx.LXMERT_VQA, l_layers=ft.llayers, x_layers=ft.xlayers,
            r_layers=ft.rlayers, num_qa_labels=num_answers)
        if self.cfg.num_qa_labels != num_answers:
            raise ValueError(f"model_cfg has {self.cfg.num_qa_labels} "
                             f"answers, the task {num_answers}")
        if params is None:
            params = lx.init_params(seed, self.cfg, self.device)
        self._init_train(params, batches_per_epoch)

    def predict(self, params, batch) -> torch.Tensor:
        return lx.forward(params, batch["input_ids"], batch["attention_mask"],
                          batch["visual_feats"], batch["visual_pos"],
                          visual_mask=batch.get("visual_mask"),
                          cfg=self.cfg)["qa_scores"]

    def loss_fn(self, params, batch):
        logits = self.predict(params, batch)
        return bce_vqa_loss(logits, batch["target"]), logits

    hits = staticmethod(_soft_hits)


def make_batches(dataset, feats, tokenizer, vocab, ft: FinetuneConfig,
                 max_boxes: int = 36, shuffle_seed: Optional[int] = None,
                 drop_last: bool = False, device="cuda"):
    """Collate VQA items into fixed-shape padded batches on ``device``
    (the DataLoader/VQATorchDataset equivalent). ``drop_last=True``
    matches the reference's train loader (tasks/vqa.py:37); otherwise the
    tail is padded and masked via ``sample_valid``."""
    dev = resolve_device(device)
    items = [it for it in dataset.data if it["img_id"] in feats]
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed)
        rng.shuffle(items)
    B = ft.batch_size
    batches = []
    for start in range(0, len(items), B):
        chunk = items[start:start + B]
        k = len(chunk)
        if k < B and drop_last:
            break
        pad = chunk + [chunk[-1]] * (B - k)
        enc = [tokenizer.encode_vqa(it["sent"], max_len=ft.max_text_len)
               for it in pad]
        f = [feats[it["img_id"]] for it in pad]
        batch = {
            "input_ids": np.stack([e["input_ids"] for e in enc]),
            "attention_mask": np.stack([e["input_mask"] for e in enc]),
            "visual_feats": np.stack([x["features"] for x in f]),
            "visual_pos": np.stack([x["boxes"] for x in f]),
            "visual_mask": np.stack(
                [(np.arange(max_boxes) < x["num_boxes"]).astype(np.int32)
                 for x in f]),
            "target": np.stack(
                [vocab.soft_scores(it.get("label", {})) for it in pad]),
            "sample_valid": np.arange(B) < k,
        }
        batches.append({key: torch.from_numpy(v).to(dev)
                        for key, v in batch.items()})
    return batches


def _load_params(path, ft, num_answers, device):
    from transformer_mm_explainability_tpu_torch.utils import convert

    sd = torch.load(path, map_location="cpu")
    cfg = dataclasses.replace(
        lx.LXMERT_VQA, l_layers=ft.llayers, x_layers=ft.xlayers,
        r_layers=ft.rlayers, num_qa_labels=num_answers)
    return convert.lxmert_from_state_dict(sd, cfg, device)


def run_from_args(args) -> int:
    """CLI adapter (``cli lxmert-finetune`` — the run/vqa_finetune.bash
    surface)."""
    ft = FinetuneConfig(
        llayers=args.llayers, xlayers=args.xlayers, rlayers=args.rlayers,
        batch_size=args.batch_size, lr=args.lr, epochs=args.epochs,
        task=args.task)
    device = resolve_device(args.device)

    needs_ans = ft.task != "nlvr2"   # NLVR2 is binary, no answer vocab
    if not (args.train_questions and args.features
            and (args.ans2label or not needs_ans)):
        print("lxmert-finetune: no --train-questions/--features"
              + ("/--ans2label" if needs_ans else "")
              + "; running the synthetic smoke protocol")
        return (_smoke_nlvr2(ft, args.seed, device) if ft.task == "nlvr2"
                else _smoke(ft, args.seed, device))

    from transformer_mm_explainability_tpu_torch.data import vqa as vqa_data
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)

    if not getattr(args, "bert_vocab", None):
        print("lxmert-finetune: --bert-vocab vocab.txt required")
        return 2

    if ft.task == "nlvr2":
        return _run_nlvr2(args, ft, vqa_data, BertTokenizer, device)
    vocab = vqa_data.AnswerVocab(args.ans2label, args.label2ans)
    reader = (vqa_data.GQADataset if ft.task == "gqa"
              else vqa_data.VQADataset)
    train_set = reader([args.train_questions], vocab)
    valid_set = (reader([args.valid_questions], vocab)
                 if args.valid_questions else None)
    feats = vqa_data.FeatureStore(
        vqa_data.load_obj_tsv(args.features), max_boxes=36)
    tok = BertTokenizer(vocab_path=args.bert_vocab)

    n_train = len([it for it in train_set.data if it["img_id"] in feats])
    trainer = LxmertTaskTrainer(
        len(vocab), ft, batches_per_epoch=max(n_train // ft.batch_size, 1),
        params=None if not args.checkpoint
        else _load_params(args.checkpoint, ft, len(vocab), device),
        seed=args.seed, device=device)

    def train_batches(epoch: int = 0):
        return make_batches(train_set, feats, tok, vocab, ft,
                            shuffle_seed=args.seed + epoch,
                            drop_last=True, device=device)

    valid_batches = (None if valid_set is None else
                     (lambda: make_batches(valid_set, feats, tok, vocab,
                                           ft, device=device)))
    log = trainer.fit(train_batches, valid_batches)
    print(json.dumps({"loss": log["loss"],
                      "train_acc": log["train_acc"],
                      "valid_acc": log["valid_acc"],
                      "best_valid": trainer.best_valid}))
    return 0


SMOKE_CFG = dict(vocab_size=60, hidden_size=32, num_attention_heads=4,
                 intermediate_size=48, max_position_embeddings=24,
                 l_layers=2, x_layers=1, r_layers=1, visual_feat_dim=16,
                 num_qa_labels=5)


def _smoke(ft: FinetuneConfig, seed: int, device) -> int:
    """Tiny-config end-to-end training demo (protocol validation)."""
    cfg = lx.LxmertConfig(**SMOKE_CFG)
    ft = dataclasses.replace(ft, batch_size=4, epochs=3)
    rng = np.random.RandomState(seed)
    N = 8
    batches = []
    for _ in range(0, N, ft.batch_size):
        tgt = np.zeros((ft.batch_size, 5), np.float32)
        tgt[np.arange(ft.batch_size),
            rng.randint(0, 5, ft.batch_size)] = 1.0
        batch = {
            "input_ids": rng.randint(1, 59, (ft.batch_size, 8)),
            "attention_mask": np.ones((ft.batch_size, 8), np.int32),
            "visual_feats": rng.randn(ft.batch_size, 6, 16).astype(
                np.float32),
            "visual_pos": rng.rand(ft.batch_size, 6, 4).astype(np.float32),
            "target": tgt,
        }
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()})
    trainer = LxmertTaskTrainer(5, ft, model_cfg=cfg,
                                batches_per_epoch=len(batches), seed=seed,
                                device=device)
    log = trainer.fit(lambda: batches, lambda: batches)
    ok = log["loss"][-1] < log["loss"][0]
    print(json.dumps({"loss": log["loss"], "valid_acc": log["valid_acc"],
                      "loss_decreased": bool(ok)}))
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# NLVR2 (tasks/nlvr2.py + tasks/nlvr2_model.py)
# ---------------------------------------------------------------------------

def init_nlvr2_head(seed, hidden: int, device="cuda") -> Dict[str, Any]:
    """nlvr2_model.NLVR2Model.logit_fc (:19-24): Linear(2h,2h) -> GeLU
    -> LayerNorm(eps 1e-12) -> Linear(2h,2), bert-initialised
    (normal 0.02 / zero bias), drawn on the CPU from ``seed`` (an int or a
    ``torch.Generator``)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    h2 = hidden * 2
    nrm = lambda *s: (torch.randn(s, generator=gen) * 0.02).to(device)
    return {
        "fc1": {"w": nrm(h2, h2), "b": torch.zeros(h2, device=device)},
        "ln": {"scale": torch.ones(h2, device=device),
               "bias": torch.zeros(h2, device=device)},
        "fc2": {"w": nrm(h2, 2), "b": torch.zeros(2, device=device)},
    }


def nlvr2_logits(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 cfg: lx.LxmertConfig) -> torch.Tensor:
    """NLVR2Model.forward (:27-52): each sentence is paired with both
    images ([B,2,O,f] flattened to [2B,O,f], the sentence repeated),
    the two pooled cross-modal CLS vectors are concatenated per sample
    and classified to 2 logits."""
    B, two, O, Fd = batch["visual_feats"].shape
    feats = batch["visual_feats"].reshape(B * 2, O, Fd)
    pos = batch["visual_pos"].reshape(B * 2, O, 4)
    vmask = (batch["visual_mask"].reshape(B * 2, O)
             if batch.get("visual_mask") is not None else None)
    rep = lambda t: torch.repeat_interleave(t, 2, dim=0)
    out = lx.forward(params["lxmert"], rep(batch["input_ids"]),
                     rep(batch["attention_mask"]), feats, pos,
                     visual_mask=vmask, cfg=cfg)
    x = out["pooled"].reshape(B, -1)                    # [B, 2h]
    head = params["head"]
    h = gelu(x @ head["fc1"]["w"] + head["fc1"]["b"])
    h = layer_norm(h, head["ln"]["scale"], head["ln"]["bias"], 1e-12)
    return h @ head["fc2"]["w"] + head["fc2"]["b"]     # [B, 2]


def nlvr2_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss(ignore_index=-1) (tasks/nlvr2.py:58)."""
    valid = labels >= 0
    per = -torch.log_softmax(logits, -1).gather(
        1, labels.clamp(min=0).long()[:, None])[:, 0]
    return (per * valid).sum() / valid.sum().clamp(min=1)


def _nlvr2_hits(logits: torch.Tensor, batch) -> Tuple[float, int]:
    pred = logits.argmax(-1).cpu().numpy()
    lbl = batch["label"].cpu().numpy()
    valid = lbl >= 0
    return float((pred[valid] == lbl[valid]).sum()), int(valid.sum())


class Nlvr2TaskTrainer(_TaskTrainer):
    """tasks/nlvr2.py NLVR2 class: same BertAdam/warmup/clip protocol
    as VQA (run/nlvr2_finetune.bash: batch 32, lr 5e-5, 4 epochs),
    exact-match accuracy instead of soft VQA scores. The head is drawn
    from ``seed + 1``."""

    def __init__(self, ft: FinetuneConfig = FinetuneConfig(task="nlvr2"),
                 model_cfg: Optional[lx.LxmertConfig] = None,
                 batches_per_epoch: int = 1000,
                 lxmert_params: Optional[Dict[str, Any]] = None,
                 seed: int = 9595, device="cuda"):
        self.ft = ft
        self.device = resolve_device(device)
        self.cfg = model_cfg or dataclasses.replace(
            lx.LXMERT_VQA, l_layers=ft.llayers, x_layers=ft.xlayers,
            r_layers=ft.rlayers)
        if lxmert_params is None:
            lxmert_params = lx.init_params(seed, self.cfg, self.device)
        params = {"lxmert": lxmert_params,
                  "head": init_nlvr2_head(seed + 1, self.cfg.hidden_size,
                                          self.device)}
        self._init_train(params, batches_per_epoch)

    def predict(self, params, batch) -> torch.Tensor:
        return nlvr2_logits(params, batch, self.cfg)

    def loss_fn(self, params, batch):
        logits = self.predict(params, batch)
        return nlvr2_loss(logits, batch["label"]), logits

    hits = staticmethod(_nlvr2_hits)


def make_nlvr2_batches(dataset, feats, tokenizer, ft: FinetuneConfig,
                       max_boxes: int = 36,
                       shuffle_seed: Optional[int] = None,
                       drop_last: bool = False, device="cuda"):
    """Collate NLVR2 records ({uid, img0, img1, sent, label}) into
    [B, 2, O, ...] padded batches on ``device`` (tasks/nlvr2_data.py
    pairing); a padded tail takes label -1 (ignored)."""
    dev = resolve_device(device)
    items = [it for it in dataset.data
             if it["img0"] in feats and it["img1"] in feats]
    if shuffle_seed is not None:
        np.random.RandomState(shuffle_seed).shuffle(items)
    B = ft.batch_size
    batches = []
    for start in range(0, len(items), B):
        chunk = items[start:start + B]
        k = len(chunk)
        if k < B and drop_last:
            break
        pad = chunk + [chunk[-1]] * (B - k)
        enc = [tokenizer.encode_vqa(it["sent"], max_len=ft.max_text_len)
               for it in pad]
        pair = lambda it, f: np.stack(
            [feats[it["img0"]][f], feats[it["img1"]][f]])
        batch = {
            "input_ids": np.stack([e["input_ids"] for e in enc]),
            "attention_mask": np.stack([e["input_mask"] for e in enc]),
            "visual_feats": np.stack([pair(it, "features") for it in pad]),
            "visual_pos": np.stack([pair(it, "boxes") for it in pad]),
            "visual_mask": np.stack(
                [np.stack([(np.arange(max_boxes)
                            < feats[it[s]]["num_boxes"]).astype(np.int32)
                           for s in ("img0", "img1")]) for it in pad]),
            "label": np.asarray([int(it["label"]) if i < k else -1
                                 for i, it in enumerate(pad)], np.int32),
        }
        batches.append({key: torch.from_numpy(v).to(dev)
                        for key, v in batch.items()})
    return batches


def _run_nlvr2(args, ft: FinetuneConfig, vqa_data, BertTokenizer,
               device) -> int:
    """The tasks/nlvr2.py file-driven loop (run/nlvr2_finetune.bash)."""
    train_set = vqa_data.NLVR2Dataset([args.train_questions])
    valid_set = (vqa_data.NLVR2Dataset([args.valid_questions])
                 if args.valid_questions else None)
    feats = vqa_data.FeatureStore(
        vqa_data.load_obj_tsv(args.features), max_boxes=36)
    tok = BertTokenizer(vocab_path=args.bert_vocab)

    n_train = len([it for it in train_set.data
                   if it["img0"] in feats and it["img1"] in feats])
    trainer = Nlvr2TaskTrainer(
        ft, batches_per_epoch=max(n_train // ft.batch_size, 1),
        seed=args.seed, device=device)

    def train_batches(epoch: int = 0):
        return make_nlvr2_batches(train_set, feats, tok, ft,
                                  shuffle_seed=args.seed + epoch,
                                  drop_last=True, device=device)

    valid_batches = (None if valid_set is None else
                     (lambda: make_nlvr2_batches(valid_set, feats, tok,
                                                 ft, device=device)))
    log = trainer.fit(train_batches, valid_batches)
    print(json.dumps({"loss": log["loss"],
                      "train_acc": log["train_acc"],
                      "valid_acc": log["valid_acc"],
                      "best_valid": trainer.best_valid}))
    return 0


def _smoke_nlvr2(ft: FinetuneConfig, seed: int, device) -> int:
    """Tiny-config NLVR2 end-to-end training demo."""
    cfg = lx.LxmertConfig(**SMOKE_CFG)
    ft = dataclasses.replace(ft, batch_size=4, epochs=3)
    rng = np.random.RandomState(seed)
    batches = []
    for _ in range(2):
        batch = {
            "input_ids": rng.randint(1, 59, (4, 8)),
            "attention_mask": np.ones((4, 8), np.int32),
            "visual_feats": rng.randn(4, 2, 6, 16).astype(np.float32),
            "visual_pos": rng.rand(4, 2, 6, 4).astype(np.float32),
            "visual_mask": np.ones((4, 2, 6), np.int32),
            "label": rng.randint(0, 2, (4,)).astype(np.int32),
        }
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in batch.items()})
    trainer = Nlvr2TaskTrainer(ft, model_cfg=cfg,
                               batches_per_epoch=len(batches), seed=seed,
                               device=device)
    log = trainer.fit(lambda: batches, lambda: batches)
    ok = log["loss"][-1] < log["loss"][0]
    print(json.dumps({"loss": log["loss"], "valid_acc": log["valid_acc"],
                      "loss_decreased": bool(ok)}))
    return 0 if ok else 1
