"""The port's perturbation harness against the JAX package: the keep masks,
the packed prefixes, the step-batched image and text perturbations on
given cams, the VisualBERT and LXMERT runners' perturbation programs,
``run_loop``, the ``perturbation`` CLI for both models, the data readers
and the LXMERT example.

Stated tolerance: exact everywhere. Rankings are stable sorts in both
packages (padded boxes at −inf and zero relevancies tie), keep counts come
from the same float64 host table, and a step's accuracy is the soft target
of an argmax.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.data import tokenization as jtok
from transformer_mm_explainability_tpu.data import vqa as jvqa
from transformer_mm_explainability_tpu.harness import pert_runner as jrunner
from transformer_mm_explainability_tpu.harness import perturbation as jpert
from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.data import tokenization as ttok
from transformer_mm_explainability_tpu_torch.data import vqa as tvqa
from transformer_mm_explainability_tpu_torch.examples import (
    lxmert_explainability as example)
from transformer_mm_explainability_tpu_torch.harness import pert_runner
from transformer_mm_explainability_tpu_torch.harness import perturbation as tpert
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

from test_torch_lxmert import JCFG, TCFG, lxmert_batch, lxmert_numpy_params
import test_torch_visual_bert as tvbt


def _tied_cams(rng, N, S):
    """Relevancies with ties: a few distinct values, zeros among them."""
    return rng.choice(np.array([0.0, 0.0, 0.25, 0.5, 1.0], np.float32),
                      size=(N, S))


def test_num_keep_table_equals_jax():
    for steps in (tpert.LXMERT_STEPS, tpert.IMAGE_STEPS_VISUALBERT):
        np.testing.assert_array_equal(
            tpert._num_keep_table(steps, 40).numpy(),
            np.asarray(jpert._num_keep_table(steps, 40)))


@pytest.mark.parametrize("positive", [False, True])
def test_topk_keep_mask_with_ties_equals_jax(positive):
    rng = np.random.RandomState(int(positive))
    cam = _tied_cams(rng, 6, 15)
    cam = -cam if positive else cam
    valid = rng.rand(6, 15) > 0.2
    num_keep = rng.randint(0, 16, 6)
    want = jax.vmap(jpert.topk_keep_mask)(jnp.asarray(cam),
                                         jnp.asarray(num_keep),
                                         jnp.asarray(valid))
    got = tpert.topk_keep_mask(torch.from_numpy(cam),
                               torch.from_numpy(num_keep),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = tpert.topk_keep_mask(torch.from_numpy(cam[0]), int(num_keep[0]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(
        jpert.topk_keep_mask(jnp.asarray(cam[0]), int(num_keep[0]))))


def test_gather_kept_prefix_equals_jax():
    rng = np.random.RandomState(2)
    tokens = rng.randint(1, 50, (5, 11)).astype(np.int32)
    keep = rng.rand(5, 11) > 0.4
    want = jax.vmap(jpert.gather_kept_prefix)(jnp.asarray(tokens),
                                             jnp.asarray(keep))
    got = tpert.gather_kept_prefix(torch.from_numpy(tokens),
                                   torch.from_numpy(keep))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# a stand-in model for the perturbation functions: scores linear in the
# visual mask and in embeddings of the (packed) token ids, so that every
# drop changes the argmax somewhere
_RNG = np.random.RandomState(3)
_WV = _RNG.randn(9, 13).astype(np.float32)
_EMB = _RNG.randn(100, 13).astype(np.float32)
_POS = _RNG.randn(12, 13).astype(np.float32) * 0.3


def _jax_scores(b):
    s = b["visual_mask"].astype(jnp.float32) @ _WV
    ids = b["input_ids"]
    m = b["attention_mask"].astype(jnp.float32)[..., None]
    return s + ((jnp.asarray(_EMB)[ids] + _POS) * m).sum(1)


def _torch_scores(b):
    s = b["visual_mask"].float() @ torch.from_numpy(_WV)
    m = b["attention_mask"].float()[..., None]
    emb = torch.from_numpy(_EMB)[b["input_ids"].long()] + torch.from_numpy(
        _POS)
    return s + (emb * m).sum(1)


def _pert_batch(seed):
    b = lxmert_batch(seed)
    return {"input_ids": b["input_ids"], "attention_mask": b["attention_mask"],
            "visual_mask": b["visual_mask"],
            "num_boxes": b["visual_mask"].sum(1).astype(np.int32)}


@pytest.mark.parametrize("positive", [False, True])
@pytest.mark.parametrize("text", [False, True])
def test_step_batched_perturbation_equals_jax(positive, text):
    """run_*_perturbation_batch on given cams (with ties) and a stand-in
    model: the same step accuracies; the one-sample functions give the
    batch functions' rows."""
    rng = np.random.RandomState(4)
    b = _pert_batch(1)
    N = b["input_ids"].shape[0]
    targets = rng.rand(N, 13).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    if text:
        cam = _tied_cams(rng, N, 12)
        text_len = b["attention_mask"].sum(1)
        ar = np.arange(12)[None]
        always = (ar == 0) | (ar == (text_len - 1)[:, None])
        want = jpert.run_text_perturbation_batch(
            _jax_scores, jb, jnp.asarray(cam), jnp.asarray(targets),
            tpert.LXMERT_STEPS, positive, jnp.asarray(always),
            jnp.asarray(text_len), input_mask_key="attention_mask")
        got = tpert.run_text_perturbation_batch(
            _torch_scores, tb, torch.from_numpy(cam),
            torch.from_numpy(targets), tpert.LXMERT_STEPS, positive,
            torch.from_numpy(always), torch.from_numpy(text_len),
            input_mask_key="attention_mask")
        one = tpert.run_text_perturbation(
            _torch_scores, {k: v[:1] for k, v in tb.items()},
            torch.from_numpy(cam[0]), torch.from_numpy(targets[0]),
            tpert.LXMERT_STEPS, positive, torch.from_numpy(always[0]),
            int(text_len[0]), input_mask_key="attention_mask")
    else:
        cam = _tied_cams(rng, N, 9)
        nb = b["num_boxes"]
        want = jpert.run_image_perturbation_batch(
            _jax_scores, jb, jnp.asarray(cam), jnp.asarray(targets),
            tpert.LXMERT_STEPS, positive, num_boxes=jnp.asarray(nb))
        got = tpert.run_image_perturbation_batch(
            _torch_scores, tb, torch.from_numpy(cam),
            torch.from_numpy(targets), tpert.LXMERT_STEPS, positive,
            num_boxes=torch.from_numpy(nb))
        one = tpert.run_image_perturbation(
            _torch_scores, {k: v[:1] for k, v in tb.items()},
            torch.from_numpy(cam[0]), torch.from_numpy(targets[0]),
            tpert.LXMERT_STEPS, positive, num_boxes=int(nb[0]))
    assert got.shape == (N, len(tpert.LXMERT_STEPS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())
    assert len(np.unique(got.numpy())) > 1


@pytest.fixture(scope="module")
def params():
    jp = lxmert_numpy_params(JCFG, seed=1)
    return jp, tconvert.lxmert_from_jax_numpy(jp, TCFG, device="cpu")


@pytest.mark.parametrize("text", [False, True])
def test_runner_perturbation_equals_jax(params, text):
    """ours_no_lrp, positive perturbation: the port's run_samples_batched
    gives the JAX runner's step accuracies."""
    jp, tp = params
    b = lxmert_batch(3)
    b["num_boxes"] = b["visual_mask"].sum(1).astype(np.int32)
    soft = np.random.RandomState(5).rand(3, 13).astype(np.float32)
    want = jrunner.LxmertPerturbationRunner(
        jp, JCFG, "ours_no_lrp", positive=True, text_pert=text
    ).run_samples_batched({k: jnp.asarray(v) for k, v in b.items()}, soft)
    runner = pert_runner.LxmertPerturbationRunner(
        tp, TCFG, "ours_no_lrp", positive=True, text_pert=text, device="cpu")
    got = runner.run_samples_batched(b, soft)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(runner.run_sample(
        {k: v[:1] for k, v in b.items()}, soft[0]), got[0])
    dev = runner.submit_batched(b, soft)
    assert torch.is_tensor(dev) and torch.equal(dev, torch.from_numpy(got))


@pytest.fixture(scope="module")
def vb_params():
    jp = tvbt.numpy_params(lambda: tvbt.jvb.init_params(
        jax.random.PRNGKey(0), tvbt.JCFG), seed=1)
    return jp, tconvert.visual_bert_from_jax_numpy(jp, tvbt.TCFG,
                                                   device="cpu")


@pytest.mark.parametrize("method,positive,text", [
    ("ours_no_lrp", False, False), ("ours_no_lrp", True, False),
    ("ours_no_lrp", False, True), ("ours_no_lrp", True, True),
    ("rollout", False, False)])
def test_visual_bert_runner_perturbation_equals_jax(vb_params, method,
                                                    positive, text):
    """The port's VisualBERT run_samples_batched gives the JAX runner's
    step accuracies (padded text and boxes; the text steps keep CLS, ``?``
    and SEP), and its explain step the JAX runner's cams."""
    jp, tp = vb_params
    b = tvbt.vb_batch(10)
    b["num_boxes"] = b["visual_mask"].sum(1).astype(np.int32)
    soft = np.random.RandomState(11).rand(3, 13).astype(np.float32)
    jr = jrunner.VisualBertPerturbationRunner(jp, tvbt.JCFG, method,
                                              positive=positive,
                                              text_pert=text)
    want = jr.run_samples_batched(tvbt.jx(b), soft)
    runner = pert_runner.VisualBertPerturbationRunner(
        tp, tvbt.TCFG, method, positive=positive, text_pert=text,
        device="cpu")
    got = runner.run_samples_batched(b, soft)
    assert got.shape == (3, 9) and runner.steps == jr.steps
    np.testing.assert_array_equal(got, want)
    js, jcam = jr.explain_batched(tvbt.jx(b))
    ts, tcam = runner.explain_batched(b)
    np.testing.assert_allclose(ts, js, **tvbt.TOL)
    np.testing.assert_allclose(tcam, jcam, **tvbt.MAP_TOL)
    np.testing.assert_array_equal(runner.run_sample(
        {k: v[:1] for k, v in b.items()}, soft[0]), got[0])


def test_visual_bert_runner_aliases_and_unknown_methods(vb_params):
    """``transformer_att`` is the LXMERT name of VisualBERT's
    ``transformer_attribution`` (an LRP method, which runs now); names of
    the LXMERT table alone are unknown to VisualBERT."""
    _, tp = vb_params
    alias = pert_runner.VisualBertPerturbationRunner(tp, tvbt.TCFG,
                                                     "transformer_att",
                                                     device="cpu")
    assert alias.method == "transformer_attribution"
    b = tvbt.vb_batch(9)
    own = pert_runner.VisualBertPerturbationRunner(
        tp, tvbt.TCFG, "transformer_attribution", device="cpu")
    for g, w in zip(alias.explain_batched(b), own.explain_batched(b)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="unknown visual_bert"):
        pert_runner.VisualBertPerturbationRunner(tp, tvbt.TCFG,
                                                 "ours_no_lrp_no_norm",
                                                 device="cpu")
    assert cli.main(["perturbation", "--device", "cpu", "--method",
                     "ablation_no_aggregation"]) == 2


def test_run_loop_collates_and_pads(params):
    _, tp = params
    runner = pert_runner.LxmertPerturbationRunner(tp, TCFG, "raw_attn",
                                                  device="cpu")
    b = lxmert_batch(6)
    soft = np.random.RandomState(6).rand(3, 13).astype(np.float32)
    samples = [({k: v[i:i + 1] for k, v in b.items()}, soft[i])
               for i in range(3)]
    lines = []
    got = pert_runner.run_loop(runner, iter(samples + samples), 5,
                               printer=lines.append, batch_size=2)
    want = np.concatenate([runner.run_samples_batched(b, soft),
                           runner.run_samples_batched(
                               {k: v[:2] for k, v in b.items()}, soft[:2])])
    np.testing.assert_allclose(got, want.mean(0), rtol=1e-6)
    summary = json.loads(lines[-1])
    assert summary["num_samples"] == 5
    assert summary["auc"] == pytest.approx(tpert.auc(got, runner.steps))
    big, softs = pert_runner._collate(samples[:2])
    assert isinstance(big["input_ids"], np.ndarray) and softs.shape == (2, 13)


def test_cli_perturbation_lxmert_smoke_on_cpu(capsys):
    assert cli.main(["perturbation", "--model", "lxmert", "--device", "cpu",
                     "--num-samples", "3", "--is-text-pert", "true"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_samples"] == 3 and len(summary["steps"]) == 9


@pytest.mark.parametrize("text", ["false", "true"])
def test_cli_perturbation_visual_bert_smoke_on_cpu(capsys, text):
    """The default model (VisualBERT), synthetic samples."""
    assert cli.main(["perturbation", "--device", "cpu", "--num-samples", "3",
                     "--is-text-pert", text]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_samples"] == 3
    assert summary["steps"] == list(
        tpert.TEXT_STEPS if text == "true" else tpert.IMAGE_STEPS_VISUALBERT)


@pytest.mark.parametrize("argv,steps", [
    (["--model", "visual_bert", "--device", "cpu", "--method",
      "partial_lrp"], tpert.IMAGE_STEPS_VISUALBERT),
    (["--model", "lxmert", "--device", "cpu", "--method", "partial_lrp"],
     tpert.LXMERT_STEPS)])
def test_cli_perturbation_unported_parts_exit_2(capsys, argv, steps):
    """An LRP method, which exited 2 before the LRP engine was ported, runs
    the synthetic pipeline and prints the JSON summary (an unknown method
    still exits 2: ``test_visual_bert_runner_aliases_and_unknown_methods``)."""
    assert cli.main(["perturbation", *argv, "--num-samples", "2"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_samples"] == 2
    assert summary["steps"] == list(steps)
    assert all(0.0 <= a <= 1.0 for a in summary["step_accuracies"])


def _feature_tsv(path):
    import base64

    rows = []
    for i, n in enumerate((3, 40)):
        rng = np.random.RandomState(i)
        enc = lambda a: base64.b64encode(a.tobytes()).decode()
        rows.append("\t".join([
            f"img{i}", "480", "640", enc(np.arange(n, dtype=np.int64)),
            enc(rng.rand(n).astype(np.float32)),
            enc(np.arange(n, dtype=np.int64)),
            enc(rng.rand(n).astype(np.float32)), str(n),
            enc((rng.rand(n, 4) * 400).astype(np.float32)),
            enc(rng.randn(n, 2048).astype(np.float32))]))
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def test_data_readers_equal_jax(tmp_path):
    tsv = _feature_tsv(tmp_path / "feats.tsv")
    want = jvqa.FeatureStore(jvqa.load_obj_tsv(tsv, use_native=False))
    got = tvqa.FeatureStore(tvqa.load_obj_tsv(tsv))
    for img in ("img0", "img1"):
        for k in ("features", "boxes", "num_boxes"):
            np.testing.assert_array_equal(got[img][k], want[img][k])
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "on", "the",
         "table", "?", "##s", "cup"])}
    q = "What is on the tables? Cups?"
    want = jtok.BertTokenizer(vocab=vocab).encode_vqa(q, max_len=20)
    got = ttok.BertTokenizer(vocab=vocab).encode_vqa(q, max_len=20)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    (tmp_path / "a2l.json").write_text(json.dumps({"yes": 0, "cup": 1}))
    (tmp_path / "l2a.json").write_text(json.dumps(["yes", "cup"]))
    (tmp_path / "q.json").write_text(json.dumps(
        [{"question_id": i, "img_id": "img0", "sent": q,
          "label": {"cup": 0.6}} for i in range(5)]))
    tv = tvqa.AnswerVocab(str(tmp_path / "a2l.json"),
                          str(tmp_path / "l2a.json"))
    jv = jvqa.AnswerVocab(str(tmp_path / "a2l.json"),
                          str(tmp_path / "l2a.json"))
    np.testing.assert_array_equal(tv.soft_scores({"cup": 0.6}),
                                  jv.soft_scores({"cup": 0.6}))
    assert [d["question_id"] for d in tvqa.VQADataset(
        [str(tmp_path / "q.json")]).sampled(3, 7)] == [
        d["question_id"] for d in jvqa.VQADataset(
            [str(tmp_path / "q.json")]).sampled(3, 7)]


def test_cli_perturbation_lxmert_with_data_files_on_cpu(monkeypatch,
                                                        tmp_path, capsys):
    """The protocol path: questions, features, answer vocabulary and
    WordPiece vocabulary from files, random weights (of the tiny LXMERT
    with 2048-d visual features in place of LXMERT_VQA, to keep the test
    short); the sample whose image has no features is skipped."""
    monkeypatch.setattr(pert_runner.lx, "LXMERT_VQA", tlx.LxmertConfig(
        **dict(pert_runner.SMOKE_LXMERT, visual_feat_dim=2048)))
    tsv = _feature_tsv(tmp_path / "feats.tsv")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "on", "the",
             "table", "?"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    (tmp_path / "a2l.json").write_text(json.dumps({"yes": 0, "cup": 1}))
    (tmp_path / "l2a.json").write_text(json.dumps(["yes", "cup"]))
    (tmp_path / "q.json").write_text(json.dumps(
        [{"question_id": i, "img_id": f"img{i}", "sent": "what is on the "
          "table?", "label": {"cup": 0.6}} for i in range(3)]))
    rc = cli.main(["perturbation", "--model", "lxmert", "--device", "cpu",
                   "--num-samples", "3", "--batch-size", "2",
                   "--questions", str(tmp_path / "q.json"),
                   "--features", tsv, "--ans2label", str(tmp_path / "a2l.json"),
                   "--label2ans", str(tmp_path / "l2a.json"),
                   "--bert-vocab", str(tmp_path / "vocab.txt")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_samples"] == 2
    assert all(0.0 <= a <= 0.6 for a in summary["step_accuracies"])


def test_cli_perturbation_visual_bert_with_data_files_on_cpu(
        monkeypatch, tmp_path, capsys):
    """The VisualBERT protocol path on 2 samples: 128-token questions,
    features padded to 100 boxes, random weights (of a tiny BERT with
    2048-d visual features and 128 positions in place of VISUAL_BERT_VQA2,
    to keep the test short); the sample whose image has no features is
    skipped."""
    from transformer_mm_explainability_tpu_torch.models import bert as tbert

    monkeypatch.setattr(pert_runner.vb, "VISUAL_BERT_VQA2",
                        pert_runner.vb.VisualBERTConfig(
                            bert=tbert.BertConfig(**dict(
                                pert_runner.SMOKE_BERT,
                                max_position_embeddings=128))))
    tsv = _feature_tsv(tmp_path / "feats.tsv")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "what", "is", "on", "the",
             "table", "?"]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")
    (tmp_path / "a2l.json").write_text(json.dumps({"yes": 0, "cup": 1}))
    (tmp_path / "l2a.json").write_text(json.dumps(["yes", "cup"]))
    (tmp_path / "q.json").write_text(json.dumps(
        [{"question_id": i, "img_id": f"img{i}", "sent": "what is on the "
          "table?", "label": {"cup": 0.6}} for i in range(3)]))
    rc = cli.main(["perturbation", "--device", "cpu", "--num-samples", "3",
                   "--batch-size", "2", "--is-positive-pert", "true",
                   "--questions", str(tmp_path / "q.json"),
                   "--features", tsv, "--ans2label", str(tmp_path / "a2l.json"),
                   "--label2ans", str(tmp_path / "l2a.json"),
                   "--bert-vocab", str(tmp_path / "vocab.txt")])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["num_samples"] == 2
    assert summary["steps"] == list(tpert.IMAGE_STEPS_VISUALBERT)
    # soft scores are float32: 0.6 reads 0.6000000238
    assert all(0.0 <= a <= np.float32(0.6)
               for a in summary["step_accuracies"]), summary


def test_lxmert_example_on_cpu(tmp_path, capsys):
    """image → tiny FRCNN → tiny LXMERT → the two figures, on the CPU."""
    from PIL import Image

    arr = (np.random.RandomState(7).rand(90, 140, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "in.png")
    prefix = str(tmp_path / "out")
    assert example.main([str(tmp_path / "in.png"), "what is on the table?",
                         "--device", "cpu", "--tiny-lxmert",
                         "--output-prefix", prefix]) == 0
    out = capsys.readouterr().out
    assert "FRCNN:" in out and "A: label #" in out
    assert np.asarray(Image.open(prefix + "_image.png")).shape == (90, 140, 3)
    assert "<span" in (tmp_path / "out_text.html").read_text()


def test_example_and_cli_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["perturbation", "--model", "lxmert"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        example.main([str(tmp_path / "missing.png"), "q?"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        pert_runner.LxmertPerturbationRunner(
            tlx.init_params(0, TCFG, "cpu"), TCFG)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["perturbation"])
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        pert_runner.VisualBertPerturbationRunner(
            tvbt.tvb.init_params(0, tvbt.TCFG, "cpu"), tvbt.TCFG)
