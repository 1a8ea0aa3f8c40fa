"""VisualBERT on VQA2 through the port: ``models/visual_bert.relevancy_row``
(task ``explain``) and ``harness/pert_runner.VisualBertPerturbationRunner``
(task ``perturb``, the image-perturbation protocol).

Samples, drawn on the device from the seed: a question of
``question_tokens`` WordPieces (uniform lengths; the last one the question
mark) between [CLS] and [SEP], padded to ``max_seq_length``;
``max_features`` boxes of ``visual_embedding_dim`` post-ReLU features, all
valid. ``explain`` explains answers drawn from the seed on batches kept on
the device (pool entry i mod ``pool_batches``). ``perturb`` keeps a pool of
``pool_samples`` samples on the host and collates ``batch`` of them per
call in the window, as ``pert_runner.run_loop`` does; the runner explains
its own predicted answer. Its soft targets give every answer a distinct
score (a seeded permutation of 1/C … 1), so each step's reported accuracy
names the answer that step picked and the judge can check it (a one-hot
target reads 0 at nearly every step of a random model, whatever it picks).
The mix's ``method``, ``positive`` and ``modality`` have to be what the
reference's ``perturb`` computes (``ours_no_lrp``, negative, image boxes);
anything else raises before a run, as a ``precision`` other than the fp32
contract does. Outputs go to the host right behind each batch's kernels
(``loop.Posted``).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from portbench.core import judge, loop, seeds
from portbench.drivers.vit import check_precision
from portbench.flops import visual_bert as flops
from portbench.reference import visual_bert as ref


def port_config(cfg: Dict):
    from transformer_mm_explainability_tpu_torch.models import bert
    from transformer_mm_explainability_tpu_torch.models import visual_bert
    return visual_bert.VisualBERTConfig(
        bert=bert.BertConfig(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            intermediate_size=cfg["intermediate_size"],
            max_position_embeddings=cfg["max_position_embeddings"],
            type_vocab_size=cfg["type_vocab_size"],
            layer_norm_eps=cfg["layer_norm_eps"]),
        visual_embedding_dim=cfg["visual_embedding_dim"],
        num_labels=cfg["num_labels"], pooler_strategy=cfg["pooler"])


def port_params(w: Dict[str, torch.Tensor]) -> Dict:
    """The port's parameter tree holding copies of the benchmark's
    weights."""
    from transformer_mm_explainability_tpu_torch.ops.attention import (
        AttentionParams)
    c = lambda k: w[k].clone()
    pair = lambda k: {"scale": c(f"{k}_scale"), "bias": c(f"{k}_bias")}
    return {
        "embeddings": {"word": c("word"), "position": c("position"),
                       "token_type": c("token_type"), "ln": pair("emb_ln")},
        "visual": {"projection": {"w": c("vis_w"), "b": c("vis_b")},
                   "token_type": c("vis_token_type"),
                   "position": c("vis_position")},
        "encoder": {"attn": AttentionParams(c("w_qkv"), c("b_qkv"),
                                            c("w_out"), c("b_out")),
                    "attn_ln": pair("attn_ln"),
                    "mlp": {k: c(k) for k in ("w1", "b1", "w2", "b2")},
                    "mlp_ln": pair("mlp_ln")},
        "head": {"transform": {"w": c("head_w"), "b": c("head_b"),
                               "ln": pair("head_ln")},
                 "classifier": {"w": c("cls_w"), "b": c("cls_b")}},
    }


def samples(cfg: Dict, mix: Dict, n: int, seed: int, device
            ) -> Dict[str, torch.Tensor]:
    """``n`` samples' model inputs, leaves ``[n, ...]``."""
    St, Nv = cfg["max_seq_length"], cfg["max_features"]
    tok = cfg["tokens"]
    g = seeds.generator(seed, "samples", device)
    lo, hi = mix["question_tokens"]
    q = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    ids = torch.randint(tok["first_word"], cfg["vocab_size"], (n, St),
                        generator=g, device=device)
    ar = torch.arange(St, device=device)[None, :]
    rows = torch.arange(n, device=device)
    ids = torch.where(ar <= q[:, None] + 1, ids, torch.zeros_like(ids))
    ids[:, 0] = tok["cls"]
    ids[rows, q] = tok["question_mark"]
    ids[rows, q + 1] = tok["sep"]
    feats = torch.randn((n, Nv, cfg["visual_embedding_dim"]), generator=g,
                        device=device).clamp_(min=0.0)
    return {"input_ids": ids,
            "input_mask": (ar <= q[:, None] + 1).to(torch.int32),
            "visual_embeddings": feats,
            "visual_mask": torch.ones((n, Nv), dtype=torch.int32,
                                      device=device),
            "num_boxes": torch.full((n,), Nv, dtype=torch.int32,
                                    device=device)}


class _Task:
    """What both tasks share: weights, the port's parameters, the trace's
    ranges (``mark``, set by the harness in a traced run)."""

    def __init__(self, cfg, mix, seed, device, control):
        check_precision(cfg)
        self.cfg, self.seed, self.device = cfg, seed, device
        self.batch_units = mix["batch"]
        self.mark = None
        self.w = ref.weights(cfg, seed, device)
        if not control:
            self.params = port_params(self.w)
            self.w = None

    def _span(self, name):
        return (self.mark(name) if self.mark is not None
                else contextlib.nullcontext())

    def release(self) -> None:
        self.params = self.runner = self.w = None

    def _ref_weights(self):
        return ref.weights(self.cfg, self.seed, self.device)


class Explain(_Task):
    unit = "maps"

    def __init__(self, cfg, mix, seed, device, control: bool = False):
        super().__init__(cfg, mix, seed, device, control)
        B, P = mix["batch"], mix["pool_batches"]
        self.pool = P
        s = samples(cfg, mix, P * B, seed, device)
        self.batches = [{k: t[p * B:(p + 1) * B] for k, t in s.items()}
                        for p in range(P)]
        self.targets = torch.randint(
            0, cfg["num_labels"], (P, B), device=device,
            generator=seeds.generator(seed, "answers", device))
        if control:
            w = self.w
            self.call = lambda b, t: ref.explain(w, cfg, b, t, tf32=True)
        else:
            from transformer_mm_explainability_tpu_torch.models import (
                visual_bert)
            vcfg, params = port_config(cfg), self.params
            self.call = lambda b, t: visual_bert.relevancy_row(params, b, t,
                                                               vcfg)

    def submit(self, i: int):
        p = i % self.pool
        return p, loop.Posted(*self.call(self.batches[p], self.targets[p]))

    def settle(self, handle):
        p, posted = handle
        scores, cam = posted.get()
        return p, scores, cam

    def release(self) -> None:
        super().release()
        self.call = None

    def judge(self, kept) -> Dict[str, float]:
        """``score_err``, ``cam_err``: the largest max|Δ| / max|ref| of a
        kept row of scores, of relevancy."""
        w = self._ref_weights()
        refs = {}
        for p in sorted({rec[0] for _, rec in kept}):
            s, c = ref.explain(w, self.cfg, self.batches[p], self.targets[p])
            refs[p] = (s.cpu().numpy(), c.cpu().numpy())
        return {
            "score_err": max(judge.row_err(s, refs[p][0])
                             for _, (p, s, _) in kept),
            "cam_err": max(judge.row_err(c, refs[p][1])
                           for _, (p, _, c) in kept)}

    def flops_per_unit(self) -> float:
        return flops.explain_per_map(self.cfg)


# what the reference's ``perturb`` computes: the mix's keys that select the
# protocol, and their only values
PROTOCOL = {"method": "ours_no_lrp", "positive": False, "modality": "image"}


class Perturb(_Task):
    unit = "samples"

    def __init__(self, cfg, mix, seed, device, control: bool = False):
        protocol = {k: mix.get(k) for k in PROTOCOL}
        if protocol != PROTOCOL:
            raise ValueError(f"the mix asks for the protocol {protocol!r}; "
                             f"the reference and the judge compute "
                             f"{PROTOCOL!r} only")
        super().__init__(cfg, mix, seed, device, control)
        n, C = mix["pool_samples"], cfg["num_labels"]
        s = samples(cfg, mix, n, seed, device)
        g = seeds.generator(seed, "soft", device)
        perm = torch.argsort(torch.rand((n, C), generator=g, device=device))
        soft = (perm.to(torch.float32) + 1.0) / C
        self.host = {k: t.cpu().numpy() for k, t in s.items()}
        self.soft = soft.cpu().numpy()
        self.order = seeds.rng(seed, "order").permutation(n)
        self.steps = tuple(mix["steps"])
        self._rec = {}
        if control:
            w = self.w
            self.submit_batched = lambda b, t: self._control(w, b, t)
            return
        from transformer_mm_explainability_tpu_torch.harness import pert_runner
        self.runner = pert_runner.VisualBertPerturbationRunner(
            self.params, port_config(cfg), method=mix["method"],
            positive=mix["positive"], text_pert=False, device=device)
        if tuple(self.runner.steps) != self.steps:
            raise ValueError(f"the mix's steps {self.steps} are not the "
                             f"runner's {self.runner.steps}")
        explain, forward = self.runner._explain, self.runner._forward_scores

        def kept_explain(batch):
            with self._span("portbench.explain"):
                scores, cam = explain(batch)
            self._rec.update(scores=scores, cam=cam)
            return scores, cam

        def kept_forward(b):
            with self._span("portbench.forward"):
                out = forward(b)
            self._rec.update(masks=b["visual_mask"], fwd=out)
            return out

        # instance attributes: the runner's own methods call these
        self.runner._explain = kept_explain
        self.runner._forward_scores = kept_forward
        self.submit_batched = self.runner.submit_batched

    def _control(self, w, batch, soft):
        dev = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        acc, rec = ref.perturb(w, self.cfg, dev,
                               torch.as_tensor(soft, device=self.device),
                               self.steps, tf32=True)
        self._rec.update(rec)
        return acc

    def _indices(self, i: int) -> np.ndarray:
        B, n = self.batch_units, len(self.order)
        return self.order[(i * B + np.arange(B)) % n]

    def submit(self, i: int):
        idx = self._indices(i)
        batch = {k: np.take(v, idx, axis=0) for k, v in self.host.items()}
        self._rec = {}
        acc = self.submit_batched(batch, np.take(self.soft, idx, axis=0))
        return idx, loop.Posted(acc), self._rec

    def settle(self, handle):
        idx, posted, rec = handle
        (acc,) = posted.get()
        return dict(rec, idx=idx, acc=acc)

    def judge(self, kept) -> Dict[str, float]:
        """``score_err`` (the explained forward's and every step's scores),
        ``cam_err`` (against the reference's relevancy for the answer the
        program's scores pick), and two exact counts. ``answers_off``: steps
        whose reported accuracy no answer within twice the row's measured
        score error of the reference's best explains. ``keep_off``: steps
        whose kept boxes are not the
        protocol's count or rank a dropped box above a kept one by more
        than twice the sample's measured relevancy error."""
        w = self._ref_weights()
        St, n = self.cfg["max_seq_length"], len(self.steps)
        out = {"score_err": 0.0, "cam_err": 0.0, "answers_off": 0,
               "keep_off": 0}
        for _, rec in kept:
            batch = {k: torch.as_tensor(v[rec["idx"]], device=self.device)
                     for k, v in self.host.items()}
            soft = self.soft[rec["idx"]]
            scores = rec["scores"].cpu().numpy()
            cam = rec["cam"].cpu().numpy()
            masks = rec["masks"].bool()
            fwd = rec["fwd"].cpu().numpy()
            answers = torch.as_tensor(scores.argmax(-1), device=self.device)
            r_scores, r_cam = ref.explain(w, self.cfg, batch, answers)
            big = {k: t.repeat_interleave(n, dim=0) for k, t in batch.items()}
            big["visual_mask"] = masks.to(torch.int32)
            r_fwd = ref.forward(w, self.cfg, big).cpu().numpy()
            r_scores, r_cam = r_scores.cpu().numpy(), r_cam.cpu().numpy()
            out["score_err"] = max(out["score_err"],
                                   judge.row_err(scores, r_scores),
                                   judge.row_err(fwd, r_fwd))
            out["cam_err"] = max(out["cam_err"], judge.row_err(cam, r_cam))
            out["answers_off"] += _answers_off(
                fwd, r_fwd, np.repeat(soft, n, axis=0),
                rec["acc"].reshape(-1))
            out["keep_off"] += _keep_off(
                cam[:, St:], r_cam[:, St:], masks.cpu().numpy(),
                batch["visual_mask"].cpu().numpy(), self.steps)
        return out

    def flops_per_unit(self) -> float:
        return flops.perturb_per_sample(self.cfg, self.steps)


def _answers_off(prog, refs, values, reported) -> int:
    """Rows whose ``reported`` value is ``values[row, a]`` for no answer a
    whose reference score lies within 2·max|prog − ref| of the row's best.
    Any answer the program's own argmax could give is such an answer when
    its scores are within that error; an altered one is not."""
    prog, refs = prog.astype(np.float64), refs.astype(np.float64)
    eps = np.abs(prog - refs).max(axis=1, keepdims=True)
    best = refs.max(axis=1, keepdims=True)
    slack = 1e-12 * np.abs(best) + 1e-30
    near = refs >= best - 2.0 * eps - slack
    match = values == np.asarray(reported)[:, None]
    return int((~(near & match).any(axis=1)).sum())


def _keep_off(cam, r_cam, masks, valid, steps) -> int:
    """Steps whose kept set is not the protocol's count of valid boxes, or
    drops a box whose reference relevancy exceeds a kept box's by more
    than twice the sample's max|cam − ref|."""
    n = len(steps)
    off = 0
    for s_i in range(len(cam)):
        eps = np.abs(cam[s_i].astype(np.float64) - r_cam[s_i]).max()
        ok = valid[s_i].astype(bool)
        counts = ref.num_keep(steps, int(ok.sum()))
        r = r_cam[s_i].astype(np.float64)
        slack = 1e-12 * np.abs(r).max() + 1e-30
        for j in range(n):
            m = masks[s_i * n + j]
            if m.sum() != counts[j] or (m & ~ok).any():
                off += 1
                continue
            kept, dropped = r[m], r[ok & ~m]
            if len(kept) and len(dropped) and \
                    dropped.max() - kept.min() > 2.0 * eps + slack:
                off += 1
    return off


TASKS = {"explain": Explain, "perturb": Perturb}
