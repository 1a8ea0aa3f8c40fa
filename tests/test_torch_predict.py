"""``cli predict`` and ``harness/predict`` of the port against the JAX
package's command on the same generated files: an imdb of 10 questions
(``question_tokens``/``question_str``), a directory of 10-box feature
``.npy`` files, a WordPiece ``vocab.txt``, an answer vocabulary and one MMF
VisualBERT checkpoint, with ``VISUAL_BERT_VQA2`` narrowed to 2 layers and
hidden 32 on both sides by monkeypatch.

Stated bars: the report files (json and csv, with and without
``--label2ans``) equal row for row, the last partial batch included (the
JAX command pads it, the port does not); the scores of
``harness/predict.batch_scores`` within rtol 1e-4 / atol 1e-5 of the JAX
forward on the same collated batch.
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_visual_bert import mmf_state_dict
from transformer_mm_explainability_tpu import cli as jcli
from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import visual_bert as jvb
from transformer_mm_explainability_tpu_torch import cli as tcli
from transformer_mm_explainability_tpu_torch.harness import predict
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import visual_bert as tvb

BERT = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
JCFG = jvb.VisualBERTConfig(bert=jbert.BertConfig(**BERT),
                            visual_embedding_dim=16, num_labels=9)
TCFG = tvb.VisualBERTConfig(bert=tbert.BertConfig(**BERT),
                            visual_embedding_dim=16, num_labels=9)
WORDS = ["what", "color", "is", "the", "dog", "cat", "how", "many",
         "are", "there", "on", "table", "red", "sky", "?"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("predict")
    rng = np.random.RandomState(15)
    (root / "vocab.txt").write_text("\n".join(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS) + "\n")
    (root / "answers.txt").write_text("\n".join(
        f"answer{k}" for k in range(9)) + "\n")
    (root / "feats").mkdir()
    rows = [{"dataset_name": "vqa2"}]
    for i in range(10):
        toks = list(rng.choice(WORDS[:-1], rng.randint(3, 9))) + ["?"]
        rows.append({"image_id": 100 + i % 4, "question_id": 5000 + i,
                     "question_tokens": toks,
                     "question_str": " ".join(toks),
                     "feature_path": f"{100 + i % 4}.npy"})
    for k in range(4):
        np.save(root / "feats" / f"{100 + k}.npy",
                rng.randn(rng.randint(6, 11), 16).astype(np.float32))
    np.save(root / "imdb.npy", np.array(rows, dtype=object))
    torch.save({"model": mmf_state_dict(TCFG, seed=3)}, root / "model.ckpt")
    return root


def argv(files, out, *extra):
    return ["predict", "--annotations", str(files / "imdb.npy"),
            "--features", str(files / "feats"),
            "--bert-vocab", str(files / "vocab.txt"),
            "--report-folder", str(out), "--batch-size", "4",
            "--max-seq-length", "16", "--max-features", "10",
            "--checkpoint", str(files / "model.ckpt"), *extra]


def read(path):
    if path.endswith(".csv"):
        with open(path) as f:
            return list(csv.DictReader(f))
    with open(path) as f:
        return json.load(f)


@pytest.fixture
def narrowed(monkeypatch):
    monkeypatch.setattr(jvb, "VISUAL_BERT_VQA2", JCFG)
    monkeypatch.setattr(tvb, "VISUAL_BERT_VQA2", TCFG)


@pytest.mark.parametrize("extra", [
    (), ("--file-format", "csv", "--label2ans", "LABELS"),
    ("--max-samples", "7", "--label2ans", "LABELS")])
def test_cli_predict_equals_jax(files, tmp_path, narrowed, capsys, extra):
    extra = tuple(str(files / "answers.txt") if e == "LABELS" else e
                  for e in extra)
    assert jcli.main(argv(files, tmp_path / "jax", *extra)) == 0
    jpaths = capsys.readouterr().out.split()
    assert tcli.main(argv(files, tmp_path / "torch", *extra,
                          "--device", "cpu")) == 0
    tpaths = capsys.readouterr().out.split()
    assert len(jpaths) == len(tpaths) == 1
    assert tpaths[0].split("/")[-1].split("_test_")[0] == "vqa2"
    want, got = read(jpaths[0]), read(tpaths[0])
    n = 7 if "--max-samples" in extra else 10
    assert len(got) == n and got == want
    assert [int(r["question_id"]) for r in got] == list(range(5000,
                                                              5000 + n))


def test_batch_scores_equal_jax(files, narrowed):
    from transformer_mm_explainability_tpu_torch.core import env
    from transformer_mm_explainability_tpu_torch.core.registry import (
        registry)
    from transformer_mm_explainability_tpu_torch.utils import mmf_loader

    env.setup_imports()
    ds = registry.get("builder", "vqa2")().load({
        "annotations": str(files / "imdb.npy"),
        "features": str(files / "feats"), "max_features": 10,
        "processors": {"text_processor": {"type": "bert_tokenizer",
                                          "params": {"tokenizer_config": {
                                              "vocab_path": str(
                                                  files / "vocab.txt")},
                                              "max_seq_length": 16}}}},
        "test")
    samples = [ds[i] for i in range(5)]
    params, _ = mmf_loader.load_visual_bert(str(files / "model.ckpt"), TCFG,
                                            device="cpu")
    got = predict.batch_scores(params, TCFG, samples, "cpu")
    from transformer_mm_explainability_tpu.utils import mmf_loader as jmmf

    jparams, _ = jmmf.load_visual_bert(str(files / "model.ckpt"), JCFG)
    want = jvb.forward(jparams, *(jnp.asarray(np.stack(
        [np.asarray(s[k]) for s in samples])) for k in (
        "input_ids", "input_mask", "image_feature_0")), cfg=JCFG)["scores"]
    assert got.shape == (5, 9) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_cli_predict_needs_a_vocab_and_defaults_to_cuda(files, tmp_path,
                                                       capsys):
    args = argv(files, tmp_path)
    i = args.index("--bert-vocab")
    no_vocab = args[:i] + args[i + 2:]
    assert tcli.main(no_vocab) == 2
    assert "--bert-vocab" in capsys.readouterr().out
    assert tcli.build_parser().parse_args(args).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(args)
        assert not (tmp_path / "vqa2").exists()
