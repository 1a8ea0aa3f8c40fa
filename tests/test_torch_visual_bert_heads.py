"""The port's VisualBERT pretraining, NLVR2 and bypass heads against the
JAX package, at a tiny VisualBERT (2 layers, hidden 32, 4 heads, vocab 60,
8-d boxes): ``pretrain_forward`` (logits, ``seq_relationship``, attention
and the masked-LM loss with the labels extended over the visual span),
three AdamW updates of it through ``train/steps`` against the JAX step on
a collated ``masked_vqa2`` batch, ``forward_nlvr2`` with its pairing
rule, ``forward_bypass``, the ``init_*`` trees and the converters.

Weights are numpy draws in the JAX package's trees (``jax.eval_shape`` of
its ``init_*``), carried across by ``utils/convert``; inputs are numpy from
a seed with padded tokens and boxes. Stated bars: rtol 1e-5 / atol 1e-6
for losses; rtol 1e-4 / atol 1e-5 for logits, scores, hidden states and
attention (fp32 on both sides in other summation orders, the tolerance of
the VisualBERT slice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import visual_bert as jvb
from transformer_mm_explainability_tpu.train import steps as jsteps
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import visual_bert as tvb
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

BERT = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=40)
JCFG = jvb.VisualBERTConfig(bert=jbert.BertConfig(**BERT),
                            visual_embedding_dim=8, num_labels=7)
TCFG = tvb.VisualBERTConfig(bert=tbert.BertConfig(**BERT),
                            visual_embedding_dim=8, num_labels=7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
B, ST, NV = 3, 10, 5


def numpy_params(init, seed):
    """``init()``'s JAX tree filled with numpy draws: std 0.05, LN scales
    near 1."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return np.asarray(1 + 0.1 * rng.randn(*s.shape), np.float32)
        return np.asarray(rng.randn(*s.shape) * 0.05, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    j = {"params": numpy_params(lambda: jvb.init_params(key, JCFG), 0),
         "pretrain": numpy_params(
             lambda: jvb.init_pretrain_params(key, JCFG), 1),
         "nlvr2": numpy_params(lambda: jvb.init_nlvr2_head(key, JCFG), 2),
         "bypass": numpy_params(lambda: jvb.init_bypass_layer(key, JCFG), 3)}
    t = {"params": tconvert.visual_bert_from_jax_numpy(j["params"], TCFG,
                                                       "cpu"),
         "pretrain": tconvert.visual_bert_pretrain_head_from_jax_numpy(
             j["pretrain"], TCFG, "cpu"),
         "nlvr2": tconvert.visual_bert_nlvr2_head_from_jax_numpy(
             j["nlvr2"], TCFG, "cpu"),
         "bypass": tconvert.visual_bert_bypass_layer_from_jax_numpy(
             j["bypass"], TCFG, "cpu")}
    return j, t


def batch(seed, n=B, alignment=False):
    rng = np.random.RandomState(seed)
    im = np.ones((n, ST), np.int32)
    im[1, 7:] = 0
    im[-1, 4:] = 0
    vm = np.ones((n, NV), np.int32)
    vm[0, 3:] = 0
    labels = np.full((n, ST), -1, np.int32)
    labels[rng.rand(n, ST) < 0.4] = rng.randint(0, 60)
    labels[:, 1] = rng.randint(5, 60, n)
    b = {"input_ids": (rng.randint(1, 60, (n, ST)) * im).astype(np.int32),
         "input_mask": im,
         "visual_embeddings": rng.randn(n, NV, 8).astype(np.float32),
         "visual_mask": vm, "masked_lm_labels": labels,
         "token_type_ids": (np.arange(ST)[None] >= 6).astype(np.int32)
         .repeat(n, 0)}
    if alignment:
        ita = rng.randint(0, ST, (n, NV, 2)).astype(np.int32)
        ita[rng.rand(n, NV, 2) < 0.4] = -1
        b["image_text_alignment"] = ita
    return b


# each JAX function jitted once for the module (op-by-op JAX on the CPU
# compiles every operation)
J_PRETRAIN = jax.jit(lambda p, h, kw: jvb.pretrain_forward(p, h, **kw,
                                                           cfg=JCFG))
J_NLVR2 = jax.jit(lambda p, h, kw: jvb.forward_nlvr2(p, h, **kw, cfg=JCFG))
J_BYPASS = jax.jit(lambda p, h, kw: jvb.forward_bypass(p, h, **kw,
                                                       cfg=JCFG))


def jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def tt(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("variant", ["plain", "alignment", "no_visual_mask"])
def test_pretrain_forward_equals_jax(models, variant):
    j, t = models
    b = batch(4, alignment=variant == "alignment")
    if variant == "no_visual_mask":
        del b["visual_mask"]
    want = J_PRETRAIN(j["params"], j["pretrain"], jx(b))
    got = tvb.pretrain_forward(t["params"], t["pretrain"], **tt(b),
                               cfg=TCFG)
    assert got["logits"].shape == (B, ST + NV, 60)
    for k in ("logits", "seq_relationship", "attn"):
        close(got[k], want[k])
    close(got["loss"], want["loss"], LOSS_TOL)
    assert got["loss"] is got["masked_lm_loss"]


def test_pretrain_loss_ignores_the_visual_span_and_all_ignored(models):
    """Labels cover the text span only (the visual span is -1), and an
    all-ignored batch gives 0, not NaN, as on the JAX side; the LM
    decoder is the word embedding matrix itself."""
    j, t = models
    b = batch(5)
    b["masked_lm_labels"][:] = -1
    got = tvb.pretrain_forward(t["params"], t["pretrain"], **tt(b),
                               cfg=TCFG)
    want = J_PRETRAIN(j["params"], j["pretrain"], jx(b))
    assert float(got["loss"]) == float(want["loss"]) == 0.0
    b = batch(5)
    del b["masked_lm_labels"]
    out = tvb.pretrain_forward(t["params"], t["pretrain"], **tt(b),
                               cfg=TCFG)
    assert "loss" not in out
    word = t["params"]["embeddings"]["word"].clone().requires_grad_(True)
    params = dict(t["params"], embeddings=dict(t["params"]["embeddings"],
                                               word=word))
    bb = batch(6)
    bb["masked_lm_labels"][:] = -1
    bb["masked_lm_labels"][0, 1] = 7
    bb["input_ids"][:, :] = 3
    loss = tvb.pretrain_forward(params, t["pretrain"], **tt(bb),
                                cfg=TCFG)["loss"]
    (g,) = torch.autograd.grad(loss, [word])
    # the decoder reads every row of the tied matrix; the embedding
    # lookup only row 3 and 0: other rows' gradient is the decoder's
    assert float(g[7].abs().sum()) > 0 and float(g[11].abs().sum()) > 0


def test_pretrain_adamw_updates_on_masked_vqa2(models, tmp_path):
    """A collated ``masked_vqa2`` batch (the port's builder and collate)
    through three AdamW updates of model + head: the port's
    ``train/steps`` against the JAX step (optax), each loss within
    rtol 1e-5."""
    from transformer_mm_explainability_tpu_torch.core.registry import (
        registry)
    from transformer_mm_explainability_tpu_torch.core.sample import collate
    from transformer_mm_explainability_tpu_torch.core import env

    env.setup_imports()
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "color",
             "is", "the", "sky", "blue", "dog", "red"]
    rows = [{"image_id": i, "question_id": i,
             "question_str": q, "question_tokens": q.split(),
             "answers": [a] * 10, "all_answers": [a] * 10,
             "feature_path": f"f{i}.npy"}
            for i, (q, a) in enumerate([("what color is the sky", "blue"),
                                        ("what color is the dog", "red"),
                                        ("is the dog blue", "blue")])]
    np.save(tmp_path / "ann.npy", np.array([{"metadata": True}] + rows,
                                           dtype=object))
    rng = np.random.RandomState(7)
    for i in range(3):
        np.save(tmp_path / f"f{i}.npy", rng.randn(4, 8).astype(np.float32))
    vocab = {w: k for k, w in enumerate(words)}
    cfg = {"annotations": str(tmp_path / "ann.npy"),
           "features": str(tmp_path), "max_features": NV,
           "processors": {
               "masked_token_processor": {
                   "type": "masked_token",
                   "params": {"tokenizer_config": {"vocab": vocab},
                              "max_seq_length": ST, "mask_probability": 0.3,
                              "seed": 3}},
               "text_processor": {"type": "bert_tokenizer", "params": {
                   "tokenizer_config": {"vocab": vocab},
                   "max_seq_length": ST}},
               "answer_processor": {"type": "vqa_answer", "params": {
                   "vocab": ["blue", "red"], "preprocessor": "simple_word"}}}}
    ds = registry.get("builder", "masked_vqa2")().load(cfg, "train")
    sl = collate([ds[i] for i in range(3)])
    assert (sl["lm_label_ids"] >= 0).any()
    b = {"input_ids": sl["input_ids"].astype(np.int32),
         "input_mask": sl["input_mask"].astype(np.int32),
         "token_type_ids": sl["segment_ids"].astype(np.int32),
         "masked_lm_labels": sl["lm_label_ids"].astype(np.int32),
         "visual_embeddings": sl["image_feature_0"]}

    j, t = models

    def jloss(tree, kw):
        return jvb.pretrain_forward(tree["p"], tree["h"], **kw,
                                    cfg=JCFG)["loss"]

    tx = jsteps.make_adamw(1e-3)
    jstate = {"p": j["params"], "h": j["pretrain"]}
    opt = tx.init(jstate)
    jgrad = jax.jit(jax.value_and_grad(jloss))
    want = []
    import optax

    for _ in range(3):
        loss, g = jgrad(jstate, jx(b))
        upd, opt = tx.update(g, opt, jstate)
        jstate = optax.apply_updates(jstate, upd)
        want.append(float(loss))

    def tloss(tree, kw):
        return tvb.pretrain_forward(tree["p"], tree["h"], **kw,
                                    cfg=TCFG)["loss"]

    ttx = tsteps.make_adamw(1e-3)
    tree = tsteps.tree_map(lambda x: x.clone(), {"p": t["params"],
                                                 "h": t["pretrain"]})
    state = tsteps.init_state(tree, ttx)
    step = tsteps.make_train_step(tloss, ttx)
    got = [float(step(state, tt(b))[1]) for _ in range(3)]
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got[2] < got[0]


def test_nlvr2_equals_jax_and_pairs_halves(models):
    j, t = models
    b = batch(8, n=2 * B)
    del b["masked_lm_labels"]
    want = J_NLVR2(j["params"], j["nlvr2"], jx(b))
    got = tvb.forward_nlvr2(t["params"], t["nlvr2"], **tt(b), cfg=TCFG)
    assert got["scores"].shape == (B, 2)
    close(got["scores"], want["scores"])
    close(got["attn"], want["attn"])
    # rows [:B] pair with rows [B:]: a permutation within the pairs only
    # permutes the scores
    rp = np.array([1, 2, 0])
    perm = np.concatenate([rp, rp + B])
    pb = {k: v[perm] for k, v in b.items()}
    got_p = tvb.forward_nlvr2(t["params"], t["nlvr2"], **tt(pb), cfg=TCFG)
    np.testing.assert_allclose(got_p["scores"].numpy(),
                               got["scores"].numpy()[rp], rtol=0, atol=1e-5)


def test_bypass_equals_jax(models):
    j, t = models
    b = batch(9, alignment=True)
    del b["masked_lm_labels"]
    want = J_BYPASS(j["params"], j["bypass"], jx(b))
    got = tvb.forward_bypass(t["params"], t["bypass"], **tt(b), cfg=TCFG)
    for k in ("sequence_output", "pooled_output", "text_attn", "joint_attn"):
        close(got[k], want[k])
    assert got["text_attn"].shape[-1] == ST
    assert got["joint_attn"].shape[-1] == ST + NV


def test_init_trees_and_converters(models):
    """The port's ``init_*`` give the JAX trees' structure and shapes;
    the converters refuse trees of other widths."""
    j, _ = models

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return {f: shapes(v) for f, v in zip(tree._fields, tree)}
        return tuple(tree.shape)

    for name, init in (("pretrain", tvb.init_pretrain_params),
                       ("nlvr2", tvb.init_nlvr2_head),
                       ("bypass", tvb.init_bypass_layer)):
        assert shapes(init(1, TCFG, device="cpu")) == shapes(j[name]), name
    wider = dataclasses.replace(
        TCFG, bert=dataclasses.replace(TCFG.bert, hidden_size=64,
                                       intermediate_size=128))
    for name, conv in (
            ("pretrain", tconvert.visual_bert_pretrain_head_from_jax_numpy),
            ("nlvr2", tconvert.visual_bert_nlvr2_head_from_jax_numpy),
            ("bypass", tconvert.visual_bert_bypass_layer_from_jax_numpy)):
        with pytest.raises(ValueError):
            conv(j[name], wider, "cpu")
