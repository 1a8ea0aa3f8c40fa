"""LXMERT VQA perturbation benchmark (lxmert/perturbation.py as a script),
on the PyTorch port.

    python -m transformer_mm_explainability_tpu_torch.examples.lxmert_perturbation \\
        --questions valid.json --features val2014_obj36.tsv \\
        --ans2label trainval_ans2label.json \\
        --label2ans trainval_label2ans.json [--bert-vocab vocab.txt] \\
        [--checkpoint lxmert_vqa.bin] [--method ours_no_lrp] \\
        [--num-samples 10000] [--is-positive-pert true] \\
        [--is-text-pert false] [--device cuda|cpu]

Counterpart of the repo's ``examples/lxmert_perturbation.py``: the paper's
positive / negative perturbation protocol (seed 1234, steps
[0,.25,.5,.75,.8,.85,.9,.95,1]) through
``harness/pert_runner.LxmertPerturbationRunner``, printing per-step
accuracies and the AUC. Without the data arguments it runs three synthetic
samples through a random full-width LXMERT_VQA (smoke mode).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="lxmert_perturbation")
    ap.add_argument("--questions")
    ap.add_argument("--features")
    ap.add_argument("--ans2label")
    ap.add_argument("--label2ans")
    ap.add_argument("--bert-vocab", default="vocab.txt",
                    help="bert-base-uncased vocab.txt")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--method", default="ours_no_lrp")
    ap.add_argument("--num-samples", type=int, default=10000)
    ap.add_argument("--is-positive-pert", default="false")
    ap.add_argument("--is-text-pert", default="false")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    positive = args.is_positive_pert.lower() in ("1", "true", "yes")
    text_pert = args.is_text_pert.lower() in ("1", "true", "yes")

    from transformer_mm_explainability_tpu_torch._device import resolve_device
    from transformer_mm_explainability_tpu_torch.harness.pert_runner import (
        LxmertPerturbationRunner, run_loop)
    from transformer_mm_explainability_tpu_torch.models import lxmert as lx

    device = resolve_device(args.device)
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils.clip_loader import (
            load_lxmert_hf)

        params, cfg = load_lxmert_hf(args.checkpoint, device=device)
    else:
        print("note: no --checkpoint; random weights (smoke mode)")
        cfg = lx.LXMERT_VQA
        params = lx.init_params(args.seed, cfg, device)

    runner = LxmertPerturbationRunner(params, cfg, args.method, positive,
                                      text_pert, device=device)

    if not (args.questions and args.features and args.ans2label):
        rng = np.random.RandomState(args.seed)

        def gen(n):
            for _ in range(n):
                batch = {
                    "input_ids": rng.randint(1, 30000, (1, 20)),
                    "attention_mask": np.ones((1, 20), np.int64),
                    "visual_feats": rng.randn(1, 36, 2048).astype(
                        np.float32),
                    "visual_pos": rng.rand(1, 36, 4).astype(np.float32),
                }
                soft = np.zeros(cfg.num_qa_labels, np.float32)
                soft[rng.randint(cfg.num_qa_labels)] = 1.0
                yield batch, soft

        n = min(args.num_samples, 3)
        run_loop(runner, gen(n), n)
        return 0

    from transformer_mm_explainability_tpu_torch.data import vqa as vqa_data
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)

    vocab = vqa_data.AnswerVocab(args.ans2label, args.label2ans)
    dataset = vqa_data.VQADataset([args.questions], vocab)
    feats = vqa_data.FeatureStore(vqa_data.load_obj_tsv(args.features),
                                  max_boxes=36)
    tok = BertTokenizer(vocab_path=args.bert_vocab)

    def gen():
        for item in dataset.sampled(args.num_samples, args.seed):
            if item["img_id"] not in feats:
                continue
            f = feats[item["img_id"]]
            enc = tok.encode_vqa(item["sent"], max_len=20)
            # host (numpy) samples: run_loop's collate stacks them on the
            # host, one upload per key per batch
            yield ({
                "input_ids": np.asarray(enc["input_ids"][None]),
                "attention_mask": np.asarray(enc["input_mask"][None]),
                "visual_feats": np.asarray(f["features"][None]),
                "visual_pos": np.asarray(f["boxes"][None]),
            }, vocab.soft_scores(item.get("label", {})))

    run_loop(runner, gen(), args.num_samples)
    return 0


if __name__ == "__main__":
    sys.exit(main())
