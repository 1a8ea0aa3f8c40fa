"""``cli lxmert-finetune`` and the VQA / GQA / NLVR2 readers and batchers
of the port (``data/vqa``, ``train/lxmert_tasks``) against the JAX
package's, on files in the layout of ``tests/test_lxmert_finetune.py``.

Bars: the readers' records and the batches equal; the command's losses
within rtol 1e-4 of the JAX command's on the same files and checkpoint,
its accuracies equal."""

import base64
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_lxmert import _hf_lxmert_state_dict
from transformer_mm_explainability_tpu import cli as jcli
from transformer_mm_explainability_tpu.data import vqa as jvqa
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.train import lxmert_tasks as jtasks
from transformer_mm_explainability_tpu_torch import cli as tcli
from transformer_mm_explainability_tpu_torch.data import vqa as tvqa
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.train import lxmert_tasks as ttasks


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "color", "is", "the",
         "dog", "?", "two", "dogs"]


def _files(tmp_path, n_questions=12, feat_dim=2048):
    """The layout of ``tests/test_lxmert_finetune.py``: questions, answer
    vocabulary, a base64 object TSV of four images, a WordPiece vocab."""
    rng = np.random.RandomState(0)
    questions = [
        {"question_id": i, "img_id": f"img_{i % 4}",
         "sent": "what color is the dog?",
         "label": {"brown": 1.0} if i % 3 == 0 else
         {"black": 0.9, "yes": 0.3}}
        for i in range(n_questions)]
    (tmp_path / "q.json").write_text(json.dumps(questions))
    (tmp_path / "ans2label.json").write_text(
        json.dumps({"brown": 0, "black": 1, "yes": 2}))
    (tmp_path / "label2ans.json").write_text(
        json.dumps(["brown", "black", "yes"]))
    rows = []
    b64 = lambda a: base64.b64encode(a.tobytes()).decode()
    for i in range(4):
        n = 5 + i
        rows.append("\t".join([
            f"img_{i}", "480", "640",
            b64(rng.randint(0, 9, n).astype(np.int64)),
            b64(rng.rand(n).astype(np.float32)),
            b64(rng.randint(0, 9, n).astype(np.int64)),
            b64(rng.rand(n).astype(np.float32)), str(n),
            b64((rng.rand(n, 4) * 100).astype(np.float32)),
            b64(rng.randn(n, feat_dim).astype(np.float32))]))
    (tmp_path / "f.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB) + "\n")
    nlvr2 = [{"uid": f"u{i}", "img0": f"img_{i % 4}",
              "img1": f"img_{(i + 1) % 4}", "sent": "two dogs",
              "label": i % 2} for i in range(6)]
    (tmp_path / "nlvr2.json").write_text(json.dumps(nlvr2))
    return tmp_path


def test_readers_equal_jax(tmp_path):
    d = _files(tmp_path, feat_dim=8)
    for topk in (None, 2):
        got = tvqa.load_obj_tsv(str(d / "f.tsv"), topk)
        # the JAX package's Python reader gives every field; its C++ reader
        # the ones the models read
        for native in (False, True):
            want = jvqa.load_obj_tsv(str(d / "f.tsv"), topk,
                                     use_native=native)
            assert len(got) == len(want) == (topk or 4)
            for a, b in zip(got, want):
                assert set(b) <= set(a) and (native or set(a) == set(b))
                for k in b:
                    np.testing.assert_array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]))
    for name in ("VQADataset", "GQADataset"):
        jv = jvqa.AnswerVocab(str(d / "ans2label.json"),
                              str(d / "label2ans.json"))
        tv = tvqa.AnswerVocab(str(d / "ans2label.json"),
                              str(d / "label2ans.json"))
        jd = getattr(jvqa, name)([str(d / "q.json")], jv)
        td = getattr(tvqa, name)([str(d / "q.json")], tv)
        assert td.data == jd.data and td.by_qid == jd.by_qid
        assert len(td) == len(jd) and td[3] == jd[3]
    jn = jvqa.NLVR2Dataset([str(d / "nlvr2.json")])
    tn = tvqa.NLVR2Dataset([str(d / "nlvr2.json")])
    assert tn.data == jn.data and tn.by_uid == jn.by_uid
    assert len(tn) == 6 and tn[2] == jn[2]


TINY_WIDE = dict(hidden_size=32, num_attention_heads=4,
                 intermediate_size=48, vocab_size=len(VOCAB))


def _cli_json(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][-1])


def test_cli_lxmert_finetune_from_files_equals_jax(tmp_path, capsys,
                                                   monkeypatch):
    """Both commands on the same files and the same checkpoint (an HF
    LXMERT state dict, 1/1/1 layers): ``LXMERT_VQA`` narrowed to width 32
    in both packages, the 2048-d features kept."""
    d = _files(tmp_path)
    monkeypatch.setattr(jlx, "LXMERT_VQA", dataclasses.replace(
        jlx.LXMERT_VQA, **TINY_WIDE))
    monkeypatch.setattr(tlx, "LXMERT_VQA", dataclasses.replace(
        tlx.LXMERT_VQA, **TINY_WIDE))
    cfg = dataclasses.replace(tlx.LXMERT_VQA, l_layers=1, x_layers=1,
                              r_layers=1, num_qa_labels=3)
    torch.save(_hf_lxmert_state_dict(cfg), d / "ckpt.pth")
    argv = ["lxmert-finetune", "--task", "vqa",
            "--train-questions", str(d / "q.json"),
            "--valid-questions", str(d / "q.json"),
            "--features", str(d / "f.tsv"),
            "--ans2label", str(d / "ans2label.json"),
            "--label2ans", str(d / "label2ans.json"),
            "--bert-vocab", str(d / "vocab.txt"),
            "--llayers", "1", "--xlayers", "1", "--rlayers", "1",
            "--batch-size", "4", "--epochs", "2", "--lr", "1e-3",
            "--checkpoint", str(d / "ckpt.pth")]
    jrc, want = _cli_json(jcli.main, argv, capsys)
    trc, got = _cli_json(tcli.main, argv + ["--device", "cpu"], capsys)
    assert jrc == trc == 0
    assert set(got) == set(want) == {"loss", "train_acc", "valid_acc",
                                     "best_valid"}
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert got["train_acc"] == pytest.approx(want["train_acc"], rel=1e-6)
    assert got["valid_acc"] == pytest.approx(want["valid_acc"], rel=1e-6)
    assert len(got["loss"]) == 2
    # GQA is the same loop over the GQA reader (``test_readers_equal_jax``)
    rc, gqa = _cli_json(tcli.main, [a if a != "vqa" else "gqa" for a in argv]
                        + ["--device", "cpu"], capsys)
    assert rc == 0 and gqa == got


@pytest.mark.parametrize("task", ["vqa", "nlvr2"])
def test_cli_smoke_without_files_exits_0(capsys, task):
    rc, payload = _cli_json(tcli.main, ["lxmert-finetune", "--task", task,
                                        "--device", "cpu"], capsys)
    assert rc == 0 and payload["loss_decreased"]
    assert len(payload["loss"]) == 3


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tcli.main(["lxmert-finetune"])


def test_cli_nlvr2_from_files_runs(tmp_path, capsys, monkeypatch):
    d = _files(tmp_path)
    monkeypatch.setattr(tlx, "LXMERT_VQA", dataclasses.replace(
        tlx.LXMERT_VQA, **TINY_WIDE))
    rc, got = _cli_json(tcli.main, [
        "lxmert-finetune", "--task", "nlvr2",
        "--train-questions", str(d / "nlvr2.json"),
        "--valid-questions", str(d / "nlvr2.json"),
        "--features", str(d / "f.tsv"), "--bert-vocab",
        str(d / "vocab.txt"), "--llayers", "1", "--xlayers", "1",
        "--rlayers", "1", "--batch-size", "2", "--epochs", "2",
        "--device", "cpu"], capsys)
    assert rc == 0 and len(got["loss"]) == 2
    assert all(np.isfinite(got["loss"])) and 0 <= got["best_valid"] <= 1


def test_make_batches_equal_jax(tmp_path):
    from transformer_mm_explainability_tpu.data.tokenization import (
        BertTokenizer as JTok)
    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer as TTok)

    d = _files(tmp_path, feat_dim=8)
    vocab = (jvqa.AnswerVocab(str(d / "ans2label.json"),
                              str(d / "label2ans.json")),
             tvqa.AnswerVocab(str(d / "ans2label.json"),
                              str(d / "label2ans.json")))
    ft = (jtasks.FinetuneConfig(batch_size=5, max_text_len=8),
          ttasks.FinetuneConfig(batch_size=5, max_text_len=8))
    feats = (jvqa.FeatureStore(jvqa.load_obj_tsv(str(d / "f.tsv")), 36),
             tvqa.FeatureStore(tvqa.load_obj_tsv(str(d / "f.tsv")), 36))
    toks = (JTok(vocab_path=str(d / "vocab.txt")),
            TTok(vocab_path=str(d / "vocab.txt")))
    for drop_last in (True, False):
        want = jtasks.make_batches(jvqa.VQADataset([str(d / "q.json")]),
                                   feats[0], toks[0], vocab[0], ft[0],
                                   shuffle_seed=3, drop_last=drop_last)
        got = ttasks.make_batches(tvqa.VQADataset([str(d / "q.json")]),
                                  feats[1], toks[1], vocab[1], ft[1],
                                  shuffle_seed=3, drop_last=drop_last,
                                  device="cpu")
        assert len(got) == len(want) == (2 if drop_last else 3)
        for a, b in zip(got, want):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    nl = (jvqa.NLVR2Dataset([str(d / "nlvr2.json")]),
          tvqa.NLVR2Dataset([str(d / "nlvr2.json")]))
    want = jtasks.make_nlvr2_batches(nl[0], feats[0], toks[0], ft[0])
    got = ttasks.make_nlvr2_batches(nl[1], feats[1], toks[1], ft[1],
                                    device="cpu")
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
