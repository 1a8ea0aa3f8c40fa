"""Prediction run → EvalAI-style report files (C23/C28), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/harness/predict.py``
(the reference's ``mmf_cli/predict.py`` flow, which sets
``evaluation.predict=true`` and routes through
``TrainerReportingMixin``/``TestReporter``): run VisualBERT over a
registered MMF dataset in inference mode, convert each batched report
through the registered ``prediction.argmax`` processor, and flush
timestamped json/csv files via ``core/test_reporter.TestReporter``.

Samples are collated by ``core.sample.collate`` and moved to the model's
device by ``SampleList.to_device``; the last batch keeps its own size
(the JAX package pads it to avoid a recompile, which PyTorch does not
need; the report rows are the same).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.core.sample import collate
from transformer_mm_explainability_tpu_torch.core.test_reporter import (
    TestReporter)


def batch_scores(params, cfg, samples: Sequence[Dict[str, Any]],
                 device) -> torch.Tensor:
    """VisualBERT scores ``[B, num_labels]`` of dataset samples (the
    ``input_ids``/``input_mask``/``image_feature_0`` fields of a
    ``bert_tokenizer`` text processor and a features db) on ``device``."""
    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as vb)

    keys = ("input_ids", "input_mask", "image_feature_0")
    batch = collate([{k: np.asarray(s[k]) for k in keys}
                     for s in samples]).to_device(device)
    with torch.no_grad():
        return vb.forward(params, batch["input_ids"], batch["input_mask"],
                          visual_embeddings=batch["image_feature_0"].float(),
                          cfg=cfg)["scores"]


def predict_visual_bert(params, cfg, dataset, report_folder: str,
                        dataset_name: str = "vqa2",
                        batch_size: int = 32,
                        label2ans: Optional[Sequence[str]] = None,
                        max_samples: Optional[int] = None,
                        file_format: str = "json",
                        experiment_name: str = "") -> List[str]:
    """VisualBERT classification scores → ``{question_id, answer}``
    rows (the evalai_answer_processor protocol) on the device the
    parameters are on; returns the written report paths."""
    device = params["embeddings"]["word"].device
    proc_cls = registry.get("processor", "prediction.argmax")
    argmax_proc = proc_cls({"id_key": "question_id",
                            "result_key": "answer"})

    def processor(report: Dict[str, Any]) -> List[Dict[str, Any]]:
        rows = argmax_proc({"scores": report["scores"],
                            "id": report["question_id"]})
        if label2ans is not None:
            for row in rows:
                row["answer"] = label2ans[int(row["answer"])]
        return rows

    reporter = TestReporter([dataset_name], report_folder,
                            experiment_name=experiment_name,
                            dataset_type="test",
                            file_format=file_format,
                            prediction_processor=processor)
    reporter.next_dataset()

    if label2ans is not None and len(label2ans) < cfg.num_labels:
        raise ValueError(
            f"label2ans has {len(label2ans)} entries but the model "
            f"predicts {cfg.num_labels} classes — wrong answer vocab?")

    n = len(dataset) if max_samples is None else min(max_samples,
                                                     len(dataset))
    for start in range(0, n, batch_size):
        rows = [dataset[i] for i in range(start,
                                          min(start + batch_size, n))]
        scores = batch_scores(params, cfg, rows, device)
        reporter.add_to_report({
            "scores": scores.cpu().numpy(),
            "question_id": [int(r["question_id"]) for r in rows]})
    reporter.next_dataset()  # flushes the last dataset
    return reporter.written
