"""The port's MMF core against the JAX package: every registered loss and
metric, the ``Losses`` / ``Metrics`` orchestrators, the m4c evaluators,
the config cascade, ``core/env`` (seeding, user plugins, ``setup_imports``
against the JAX registry), ``TestReporter``, ``Sample`` / ``collate`` /
``to_device`` / ``Report`` and the ``core/build`` helpers.

Inputs are numpy draws from a seed, fed to both sides. Stated bars: losses
and tensor metrics within rtol 1e-5 (atol 1e-6; fp32 on both sides in
other summation orders); the host metrics (sklearn, nltk, EvalAI strings),
configs, collated batches and report files exactly.
"""

import json
import random
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.core import build as JB
from transformer_mm_explainability_tpu.core import config as JC
from transformer_mm_explainability_tpu.core import losses as JL
from transformer_mm_explainability_tpu.core import metrics as JM
from transformer_mm_explainability_tpu.core import sample as JS
from transformer_mm_explainability_tpu.core import test_reporter as JR
from transformer_mm_explainability_tpu.core.registry import (
    registry as jregistry)
from transformer_mm_explainability_tpu.utils import m4c_evaluators as JE
from transformer_mm_explainability_tpu_torch.core import build as TB
from transformer_mm_explainability_tpu_torch.core import config as TC
from transformer_mm_explainability_tpu_torch.core import env as tenv
from transformer_mm_explainability_tpu_torch.core import losses as TL
from transformer_mm_explainability_tpu_torch.core import metrics as TM
from transformer_mm_explainability_tpu_torch.core import sample as TS
from transformer_mm_explainability_tpu_torch.core import test_reporter as TR
from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.utils import m4c_evaluators as TE

TOL = dict(rtol=1e-5, atol=1e-6)


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def soft_targets(b, c, seed=1):
    rs = np.random.RandomState(seed)
    return rs.rand(b, c).astype(np.float32) * (rs.rand(b, c) > 0.6)


def both(tree):
    """The same numpy tree as JAX arrays and as torch tensors."""
    def conv(fn):
        def go(x):
            if isinstance(x, dict):
                return {k: go(v) for k, v in x.items()}
            if isinstance(x, list):
                return [go(v) for v in x]
            return fn(x) if isinstance(x, np.ndarray) else x
        return go
    return conv(jnp.asarray)(tree), conv(torch.from_numpy)(tree)


def loss_inputs(name, scale):
    """(sample_list, model_output, params) numpy inputs of one loss."""
    B, C = 6, 11
    scores = rand(B, C, seed=3, scale=scale)
    targets = soft_targets(B, C, seed=4)
    if name == "bce":
        scores = (1.0 / (1.0 + np.exp(-scores))).astype(np.float32)
    if name == "nll_loss":
        e = np.exp(scores - scores.max(1, keepdims=True))
        scores = np.log(np.maximum(e / e.sum(1, keepdims=True), 1e-9)
                        ).astype(np.float32)
    if name == "triple_logit_bce":
        scores = rand(B, 3, C, seed=6, scale=scale)
    if name == "cross_entropy":
        targets = np.random.RandomState(5).randint(0, C, (B,))
        targets[1] = -100
        return {"targets": targets}, {"scores": scores}, {
            "label_smoothing": 0.1}
    if name == "caption_cross_entropy":
        T, V = 6, 13
        return ({"targets": np.random.RandomState(9).randint(0, V, (4, T)),
                 "caption_len": np.array([6, 4, 5, 3], np.int64)},
                {"scores": rand(4, T, V, seed=8, scale=scale)}, {})
    if name == "m4c_decoding_bce_with_mask":
        T = 4
        return ({"targets": (np.random.RandomState(13).rand(B, T, C) > 0.7
                             ).astype(np.float32),
                 "train_loss_mask": (np.random.RandomState(14).rand(B, T)
                                     > 0.3).astype(np.float32)},
                {"scores": rand(B, T, C, seed=12, scale=scale)}, {})
    if name == "attention_supervision":
        attn = (1.0 / (1.0 + np.exp(-rand(3, 5, 7, seed=15, scale=scale)))
                ).astype(np.float32)
        sup = (np.random.RandomState(16).rand(3, 5, 7) > 0.5
               ).astype(np.int64)
        return ({"info": {"attention_supervision": sup}},
                {"attentions": [attn]}, {})
    params = {"weight_softmax": 0.3} if name == "bce_kl_combined" else {}
    return {"targets": targets}, {"scores": scores}, params


LOSSES = sorted(jregistry.list("loss"))


def test_loss_registry_names():
    assert sorted(registry.list("loss")) == LOSSES and len(LOSSES) == 12


def bce_oracle(p, t):
    """torch's binary_cross_entropy in float64: log terms clamped at
    -100."""
    p, t = np.float64(p), np.float64(t)
    with np.errstate(divide="ignore"):
        lo = np.maximum(np.log(p), -100.0)
        l1 = np.maximum(np.log(1.0 - p), -100.0)
    return -(t * lo + (1.0 - t) * l1)


# probabilities from scores of |x| ~ 100 are exactly 0 or 1 in float32:
# the JAX package's exp(-100) clamp is flushed to 0 on XLA:CPU and gives
# NaN there (losses._bce), so these two hold the port to the oracle
ORACLE = {("bce", 40.0), ("attention_supervision", 40.0)}


@pytest.mark.parametrize("scale", [2.0, 40.0])
@pytest.mark.parametrize("name", LOSSES)
def test_loss_parity(name, scale):
    """Each registered loss at moderate scores and at |x| up to ~150,
    where an unstable BCE-with-logits would overflow."""
    sl, mo, params = loss_inputs(name, scale)
    (jsl, tsl), (jmo, tmo) = both(sl), both(mo)
    got = registry.get("loss", name)(tsl, tmo, **params)
    assert got.ndim == 0
    if (name, scale) in ORACLE:
        if name == "bce":
            want = bce_oracle(mo["scores"], sl["targets"]).mean() * 11
        else:
            sup = sl["info"]["attention_supervision"]
            want = (bce_oracle(mo["attentions"][0], sup) * sup).mean() * 5
    else:
        want = float(jregistry.get("loss", name)(jsl, jmo, **params))
    assert np.isfinite(want)
    np.testing.assert_allclose(float(got), want, **TOL)


def test_bce_clamp_at_zero_and_one():
    """``bce`` on probabilities of exactly 0 and 1 is finite (torch's
    -100 clamp of each log term); where every probability is a normal
    float32 it equals the JAX package's."""
    p = np.array([[0.0, 1.0, 0.5, 1e-30], [1.0, 0.0, 0.25, 1.0]],
                 np.float32)
    t = np.array([[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 0.0, 1.0]], np.float32)
    got = float(TL.bce({"targets": torch.from_numpy(t)},
                       {"scores": torch.from_numpy(p)}))
    np.testing.assert_allclose(got, bce_oracle(p, t).mean() * 4, **TOL)
    q = np.clip(p, 1e-6, 1 - 1e-6)
    want = float(JL.bce({"targets": jnp.asarray(t)},
                        {"scores": jnp.asarray(q)}))
    got = float(TL.bce({"targets": torch.from_numpy(t)},
                       {"scores": torch.from_numpy(q)}))
    np.testing.assert_allclose(got, want, **TOL)


def test_loss_orchestration():
    scores = rand(4, 8, seed=17, scale=2.0)
    targets = soft_targets(4, 8, seed=18)
    spec = {"type": "multi", "params": [
        {"type": "logit_bce", "weight": 0.3, "params": {}},
        {"type": "softmax_kldiv", "weight": 0.7, "params": {}}]}
    specs = [spec, "wrong", {"type": "bce_kl_combined",
                             "params": {"weight_softmax": 0.5}}]
    meta = {"dataset_type": "train", "dataset_name": "vqa2"}
    (jsl, tsl), (jmo, tmo) = both({"targets": targets}), both(
        {"scores": scores})
    want = JL.Losses(specs)({**jsl, **meta}, jmo)
    got = TL.Losses(specs)({**tsl, **meta}, tmo)
    assert list(got) == list(want) == [
        "train/vqa2/multi", "train/vqa2/wrong", "train/vqa2/bce_kl_combined"]
    for k in want:
        assert got[k].shape == (1,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
    assert TL.Losses(["logit_bce"])({}, tmo) == {}
    with pytest.raises(ValueError):
        TL.MMFLoss({"params": {}})


def metric_inputs(case):
    B, C = 8, 10
    scores = rand(B, C, seed=20, scale=2.0)
    if case == "labels":
        return scores, np.random.RandomState(22).randint(0, C, (B,))
    if case == "one_hot":
        return scores, np.eye(C, dtype=np.float32)[
            np.random.RandomState(22).randint(0, C, (B,))]
    if case == "column":
        return scores, np.random.RandomState(22).randint(0, C, (B, 1))
    if case == "soft":
        return scores, soft_targets(B, C, seed=21)
    if case == "three":
        return rand(B, 3, C, seed=23, scale=2.0), soft_targets(B, C, seed=21)
    # ranks over 100 candidates with ties (scores rounded to 0.5)
    s = np.round(rand(B, 100, seed=24, scale=2.0) * 2) / 2
    return s.astype(np.float32), np.eye(100, dtype=np.float32)[
        np.random.RandomState(25).randint(0, 100, (B,))]


@pytest.mark.parametrize("name,case,params", [
    ("accuracy", "labels", {}), ("accuracy", "one_hot", {}),
    ("accuracy", "column", {}), ("vqa_accuracy", "soft", {}),
    ("vqa_accuracy", "three", {}), ("top_k_accuracy", "labels", {"k": 3}),
    ("top_k_accuracy", "ranks", {}), ("r@1", "ranks", {}),
    ("r@5", "ranks", {}), ("r@10", "ranks", {}), ("mean_r", "ranks", {}),
    ("mean_rr", "ranks", {}),
])
def test_tensor_metric_parity(name, case, params):
    scores, targets = metric_inputs(case)
    want = JM.compute(name, jnp.asarray(scores), jnp.asarray(targets),
                      **params)
    got = registry.get("metric", name)(
        {"targets": torch.from_numpy(targets)},
        {"scores": torch.from_numpy(scores)}, **params)
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **TOL)


@pytest.mark.parametrize("name,params", [
    ("f1", {"average": "macro"}), ("macro_f1", {}), ("micro_f1", {}),
    ("binary_f1", {}),
    ("multilabel_f1", {"average": "weighted"}),
    ("multilabel_micro_f1", {}), ("multilabel_macro_f1", {}),
    ("roc_auc", {}), ("micro_roc_auc", {}), ("macro_roc_auc", {}),
    ("ap", {}), ("micro_ap", {}), ("macro_ap", {}), ("binary_ap", {}),
    ("r@pk", {"p_threshold": 60}),
])
def test_sklearn_metric_parity(name, params):
    B = 24
    C = 2 if name in ("binary_f1", "binary_ap", "r@pk") else 5
    scores = rand(B, C, seed=26, scale=2.0)
    targets = np.random.RandomState(27).randint(0, C, (B,))
    if name.startswith("multilabel"):
        targets = (np.random.RandomState(28).rand(B, C) > 0.5
                   ).astype(np.float32)
    want = JM.compute(name, jnp.asarray(scores), jnp.asarray(targets),
                      **params)
    got = TM.compute(name, torch.from_numpy(scores),
                     torch.from_numpy(targets), **params)
    assert got == want


def test_host_string_metrics():
    """caption_bleu4 (nltk), vqa_evalai_accuracy and the m4c metrics on
    the same inputs: equal values."""
    vocab = ["<pad>", "a", "cat", "sat", "on", "the", "mat", "dog"]

    class Proc:
        def __call__(self, ids):
            return {"tokens": [vocab[i] for i in ids if i != 0]}

    answers = np.array([[[1, 2, 3, 4, 5, 6], [1, 7, 3, 0, 0, 0]],
                        [[5, 7, 3, 4, 5, 6], [1, 2, 0, 0, 0, 0]]])
    scores = rand(2, 6, len(vocab), seed=29, scale=2.0)
    want = JM.caption_bleu4({"answers": answers},
                            {"scores": jnp.asarray(scores)},
                            caption_processor=Proc())
    got = TM.caption_bleu4({"answers": answers},
                           {"scores": torch.from_numpy(scores)},
                           caption_processor=Proc())
    assert got == want

    class Answers:
        def get_true_vocab_size(self):
            return 6

        def idx2word(self, i):
            return ["<unk>", "two", "dogs", "red", "blue", "yes"][i]

    scores = rand(3, 8, seed=30, scale=2.0)
    sl = {"answers": [["two", "2", "two"] * 3 + ["dogs"]] * 3,
          "context_tokens": [["Red", "x"], ["yes", "y"], ["a", "b"]]}
    want = JM.vqa_evalai_accuracy(sl, {"scores": jnp.asarray(scores)},
                                  answer_processor=Answers())
    got = TM.vqa_evalai_accuracy(sl, {"scores": torch.from_numpy(scores)},
                                 answer_processor=Answers())
    assert got == want
    kw = dict(idx2word=Answers().idx2word, eos_idx=5, answer_space_size=6)
    ids = np.random.RandomState(31).randint(0, 8, (3, 4, 8)).astype(
        np.float32)
    for name in ("textvqa_accuracy", "stvqa_accuracy", "ocrvqa_accuracy",
                 "stvqa_anls", "textcaps_bleu4"):
        want = jregistry.get("metric", name)(sl, {"scores": ids}, **kw)
        got = registry.get("metric", name)(
            sl, {"scores": torch.from_numpy(ids)}, **kw)
        assert got == want, name


def test_m4c_evaluators_parity():
    cases = ["Two, dogs?", "an apple; a day", "it's 3.50 dollars",
             "one hundred", "  YALL aint ready ", "semi-colon;test",
             "1,000,000 things", "he's (not) here"]
    for s in cases:
        assert TE.EvalAIAnswerProcessor()(s) == JE.EvalAIAnswerProcessor()(s)
    preds = [{"pred_answer": "two dogs",
              "gt_answers": ["two dogs", "2 dogs", "two dogs", "dogs",
                             "two dogs", "a dog", "2 dogs", "two dogs",
                             "dogs", "two dogs"]},
             {"pred_answer": "blue",
              "gt_answers": ["red", "green", "blue", "blue", "red", "red",
                             "green", "blue", "red", "red"]}]
    for cls in ("TextVQAAccuracyEvaluator", "STVQAAccuracyEvaluator",
                "STVQAANLSEvaluator", "TextCapsBleu4Evaluator"):
        assert (getattr(TE, cls)().eval_pred_list(preds)
                == getattr(JE, cls)().eval_pred_list(preds)), cls
    rs = np.random.RandomState(31)
    for _ in range(20):
        a = "".join(rs.choice(list("abcd"), rs.randint(0, 7)))
        b = "".join(rs.choice(list("abcd"), rs.randint(0, 7)))
        assert TE.levenshtein(a, b) == JE.levenshtein(a, b)


def test_metrics_orchestrator():
    scores = rand(4, 6, seed=33)
    targets = np.eye(6, dtype=np.float32)[
        np.random.RandomState(34).randint(0, 6, (4,))]
    specs = ["accuracy", {"type": "top_k_accuracy", "key": "top2",
                          "params": {"k": 2}}, "mean_rr"]
    meta = {"dataset_type": "val", "dataset_name": "vqa2"}
    want = JM.Metrics(specs)({"targets": jnp.asarray(targets), **meta},
                             {"scores": jnp.asarray(scores)})
    got = TM.Metrics(specs)({"targets": torch.from_numpy(targets), **meta},
                            {"scores": torch.from_numpy(scores)})
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               **TOL)
    with pytest.raises(RuntimeError):
        TM.Metrics(["accuracy", "accuracy"])
    assert TM.build_m4c_predictions(
        [[2, 1, 3], [4, 2, 1]], [["street"], ["Sign"]],
        [["yes"], ["sign yes"]], {0: "<pad>", 1: "<eos>", 2: "yes",
                                  3: "no"}.get, 1, 4) == \
        JM.build_m4c_predictions(
            [[2, 1, 3], [4, 2, 1]], [["street"], ["Sign"]],
            [["yes"], ["sign yes"]], {0: "<pad>", 1: "<eos>", 2: "yes",
                                      3: "no"}.get, 1, 4)


# ---------------------------------------------------------------------------
# config, env, reporter, sample, build
# ---------------------------------------------------------------------------

def test_config_cascade_and_includes(tmp_path, monkeypatch):
    """defaults → yaml (with ``includes:``) → dotlist → json blob, env
    and ``${a.b}`` interpolation: the same dict on both sides."""
    monkeypatch.setenv("TMMX_TEST_ROOT", "/data/x")
    (tmp_path / "base.yaml").write_text(
        "training:\n  batch_size: 32\n  max_updates: 100\n"
        "dataset_config:\n  vqa2:\n    max_features: 100\n")
    (tmp_path / "proj.yaml").write_text(
        "includes:\n  - base.yaml\ntraining:\n  batch_size: 480\n"
        "root: ${env:TMMX_TEST_ROOT,/tmp}\n"
        "steps: ${training.max_updates}\nlabel: s=${training.batch_size}\n"
        "dangling: ${no.such.key}\n")
    kw = dict(defaults={"optimizer": {"type": "adam_w"}},
              config_paths=[str(tmp_path / "proj.yaml")],
              overrides=["optimizer.params.lr=0.5", "training.seed=-1"],
              config_override_json='{"extra": [1, 2]}')
    want = JC.build_config(**kw).to_dict()
    got = TC.build_config(**kw)
    assert got.to_dict() == want
    assert got.steps == 100 and got.root == "/data/x"
    got.freeze()
    with pytest.raises(RuntimeError):
        got.training.batch_size = 1
    json_path = tmp_path / "c.json"
    json_path.write_text(json.dumps({"includes": [str(tmp_path / "base.yaml")],
                                     "a": 1}))
    assert TC.load_yaml(str(json_path)) == JC.load_yaml(str(json_path))


def test_set_seed():
    assert tenv.set_seed(None) is None
    assert tenv.set_seed(0) == 0
    tenv.set_seed(1234)
    a = (np.random.rand(3), random.random(), torch.rand(3))
    tenv.set_seed(1234)
    b = (np.random.rand(3), random.random(), torch.rand(3))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and torch.equal(a[2], b[2])
    s = tenv.set_seed(-1)
    assert isinstance(s, int) and s != -1


def test_import_user_module_and_files(tmp_path, monkeypatch):
    plugin = tmp_path / "my_port_plugin"
    plugin.mkdir()
    (plugin / "__init__.py").write_text(
        "from transformer_mm_explainability_tpu_torch.core.registry import "
        "registry\n"
        "@registry.register_model('port_plugin_model')\n"
        "class PortPluginModel:\n"
        "    pass\n")
    (plugin / "mod_a.py").write_text("VALUE = 'a'\n")
    (plugin / "_private.py").write_text("raise RuntimeError('skipped')\n")
    try:
        tenv.import_user_module(str(plugin))
        assert registry.get("model", "port_plugin_model").__name__ == \
            "PortPluginModel"
        assert sys.modules["mmf_user_dir"].__name__ == "my_port_plugin"
        assert str(tmp_path) not in sys.path
        monkeypatch.syspath_prepend(str(tmp_path))
        tenv.import_files(str(plugin / "__init__.py"), "my_port_plugin")
        assert sys.modules["my_port_plugin.mod_a"].VALUE == "a"
        assert "my_port_plugin._private" not in sys.modules
    finally:
        registry._namespaces["model"].pop("port_plugin_model", None)
        for m in ("my_port_plugin", "my_port_plugin.mod_a", "mmf_user_dir"):
            sys.modules.pop(m, None)
    tenv.import_user_module("")


def test_setup_imports_registers_the_jax_names():
    """``setup_imports`` registers every loss, metric, processor (but
    ``phoc``, which waits for ``native/``) and builder name the JAX
    registry holds after importing the same modules, and the three
    trainers ``zoo`` registers."""
    import importlib

    for name in ("core.losses", "core.metrics", "data.processors",
                 "data.builders", "data.extra_builders",
                 "data.masked_datasets"):
        importlib.import_module(f"transformer_mm_explainability_tpu.{name}")
    tenv.setup_imports()
    tenv.setup_imports()  # idempotent
    assert registry.get_state("imports_setup") is True
    for ns in ("loss", "metric", "processor", "builder"):
        want = set(jregistry.list(ns)) - {"phoc"}
        assert set(registry.list(ns)) == want, ns
    assert "phoc" in jregistry.list("processor")
    assert set(registry.list("trainer")) >= {"mmf", "mmf_pert",
                                             "lxmert_pert"}
    from transformer_mm_explainability_tpu_torch.harness import pert_runner
    assert registry.get("trainer", "mmf_pert") is \
        pert_runner.VisualBertPerturbationRunner


@pytest.mark.parametrize("fmt", ["json", "csv"])
def test_test_reporter_files(tmp_path, fmt):
    """The same rows through both reporters: byte-equal files with the
    same names."""
    def proc(report):
        return [{"question_id": int(q), "answer": int(s.argmax())}
                for q, s in zip(report["id"], np.asarray(report["scores"]))]

    paths = []
    for mod, sub in ((JR, "jax"), (TR, "torch")):
        rep = mod.TestReporter(["vqa2", "gqa"], str(tmp_path / sub),
                               experiment_name="exp", file_format=fmt,
                               prediction_processor=proc, clock=lambda: 0.0)
        assert rep.next_dataset()
        rep.add_to_report({"id": [1, 2],
                           "scores": np.array([[0.1, 0.9], [0.8, 0.2]])})
        assert rep.next_dataset()
        rep.add_to_report({"id": [3], "scores": np.array([[0.4, 0.6]])})
        assert not rep.next_dataset()
        paths.append(rep.written)
    for j, t in zip(*paths):
        assert j.split("/")[-1] == t.split("/")[-1]
        assert open(j, "rb").read() == open(t, "rb").read()
    with pytest.raises(ValueError):
        TR.TestReporter(["x"], str(tmp_path)).add_to_report({"id": []})


def test_sample_collate_to_device_report():
    rs = np.random.RandomState(40)
    samples = [{"x": rs.randn(n, 3).astype(np.float32),
                "ids": rs.randint(0, 9, (n,)), "qid": np.int64(i),
                "score": 0.5 * i, "words": ["w"] * n}
               for i, n in enumerate((4, 2, 3))]
    kw = dict(pad_lengths={"ids": 6}, pad_values={"x": -1.0})
    want = JS.collate(samples, **kw)
    got = TS.collate(samples, **kw)
    assert list(got) == list(want) and got.batch_size == 3
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]
    dev = got.to_device("cpu")
    assert isinstance(dev, TS.SampleList)
    assert torch.is_tensor(dev.x) and dev.x.dtype == torch.float32
    assert dev.ids.dtype == torch.int64 and dev.words == got.words
    np.testing.assert_array_equal(dev.x.numpy(), want["x"])

    r1 = TS.Report({"id": [1, 2]}, {"scores": np.ones((2, 3))})
    r2 = TS.Report({"id": [3]}, {"scores": np.zeros((1, 3))})
    j1 = JS.Report({"id": [1, 2]}, {"scores": np.ones((2, 3))})
    j1.accumulate_tensor_fields(JS.Report({"id": [3]},
                                          {"scores": np.zeros((1, 3))}),
                                ["scores"])
    r1.accumulate_tensor_fields(r2, ["scores"])
    assert r1.batch_size == j1.batch_size == 2
    np.testing.assert_array_equal(r1.scores, j1.scores)
    t1 = TS.Report({"id": [1]}, {"scores": torch.ones(1, 2)})
    t1.accumulate_tensor_fields(TS.Report({"id": [2]},
                                          {"scores": torch.zeros(1, 2)}),
                                ["scores"])
    assert t1.scores.shape == (2, 2)


def test_build_helpers():
    tenv.setup_imports()
    # the JAX modules that register the processors and schedulers used
    import transformer_mm_explainability_tpu.data.processors  # noqa: F401
    import transformer_mm_explainability_tpu.train.schedulers  # noqa: F401

    class DS(list):
        dataset_type = "train"

    ds = DS(JS.Sample(x=np.full((2,), i, np.float32), idx=i)
            for i in range(10))
    cfg = {"batch_size": 3, "shard": 1, "num_shards": 2, "seed": 1}
    want = list(JB.build_dataloader_and_sampler(ds, cfg)[0](1))
    it, sampler = TB.build_dataloader_and_sampler(ds, cfg)
    got = list(it(1))
    assert sampler is None and len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g, TS.SampleList)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])

    recipe = TB.build_optimizer(None, {"optimizer": {
        "type": "adam_w", "params": {"lr": 1e-3}}})
    p = {"w": torch.ones(3, requires_grad=True)}
    opt = recipe.init(p)
    assert opt is not None
    with pytest.raises(ValueError):
        TB.build_optimizer(None, {"optimizer": {"params": {}}})
    with pytest.warns(UserWarning):
        sched = TB.build_scheduler({"scheduler": {}})
    assert float(sched(0)) == 1.0
    spec = {"scheduler": {"type": "warmup_linear", "params": {
        "num_warmup_steps": 2, "num_training_steps": 10}}}
    js, ts = JB.build_scheduler(spec), TB.build_scheduler(spec)
    for step in range(12):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=1e-6)

    procs = TB.build_processors({
        "text_processor": {"type": "simple_sentence", "params": {}},
        "disabled": None})
    assert set(procs) == {"text_processor"}
    assert procs["text_processor"]({"text": "Two dogs?"})["text"] == \
        JB.build_processors({"t": {"type": "simple_sentence",
                                   "params": {}}})["t"](
            {"text": "Two dogs?"})["text"]
    from transformer_mm_explainability_tpu_torch.train.trainer import Trainer
    assert TB.build_trainer({"training": {"trainer": "mmf"}}) is Trainer
    registry.register_model("port_build_model")(TB)
    try:
        assert TB.build_model({"model": "port_build_model"}) is TB
    finally:
        registry._namespaces["model"].pop("port_build_model")
    with pytest.raises(KeyError):
        TB.build_model({"model": "no_such_model"})
    assert TB.build_config(TC.Config({"a": 1})).a == 1
