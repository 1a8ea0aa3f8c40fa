"""The port's LXMERT pretraining (``models/lxmert_pretrain``,
``train/lxmert_pretrain_loop``) against the JAX package's, at LXMERT
1/1/1 layers, width 16, on a small in-test dataset (``len``, indexing,
``random_feat``: all the loop asks of its dataset).

Bars: the masking functions equal to JAX's exactly for one RandomState
(and they leave it in the same state); the total and its five parts
within rtol 1e-5, the gradients of the heads and of the tied
``embeddings.word`` within rtol 1e-5 plus 1e-5 of each leaf's max|g|; two
``train`` epochs give the same history of per-loss means within rtol
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_helpers import numpy_tree
from transformer_mm_explainability_tpu.data.tokenization import (
    BertTokenizer as JTok)
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import lxmert_pretrain as jlp
from transformer_mm_explainability_tpu.train import lxmert_pretrain_loop as jloop
from transformer_mm_explainability_tpu_torch.data.tokenization import (
    BertTokenizer as TTok)
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.models import lxmert_pretrain as tlp
from transformer_mm_explainability_tpu_torch.train import lxmert_pretrain_loop as tloop
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.utils import convert

VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4,
         "a": 5, "man": 6, "standing": 7, "how": 8, "many": 9,
         "cats": 10, "who": 11, "is": 12, "it": 13, "someone": 14,
         "here": 15, "unused": 16}
CFG_KW = dict(vocab_size=len(VOCAB), hidden_size=16, num_attention_heads=2,
              intermediate_size=24, max_position_embeddings=16,
              l_layers=1, x_layers=1, r_layers=1, visual_feat_dim=16,
              visual_pos_dim=4, num_qa_labels=3)
JCFG = jlx.LxmertConfig(**CFG_KW)
TCFG = tlx.LxmertConfig(**CFG_KW)
N_OBJ = 9     # object classes of the heads


class Examples:
    """Seven pretraining examples (the LXMERTPretrainData item layout)
    and a ``random_feat`` drawing from its own RandomState."""

    SENTS = ["a man standing", "who is it", "how many cats",
             "someone here", "a man is here", "how many", "cats standing"]

    def __init__(self, seed: int = 3):
        rng = np.random.RandomState(7)
        self.items = []
        for i, sent in enumerate(self.SENTS):
            label = ({0: 0.9, 2: 0.3} if i % 3 == 0 else
                     {1: 1.0} if i % 3 == 1 else None)
            self.items.append({
                "sent": sent,
                "visual_feats": (rng.randn(5, 16).astype(np.float32),
                                 rng.rand(5, 4).astype(np.float32)),
                "obj_labels": (rng.randint(0, N_OBJ, 5),
                               np.ones(5, np.float32)),
                "label": label, "is_matched": int(i % 4 != 3)})
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def random_feat(self):
        return self.rng.randn(16).astype(np.float32)


def _weights(seed=0):
    key = jax.random.PRNGKey(0)
    model = numpy_tree(jax.eval_shape(lambda: jlx.init_params(key, JCFG)),
                       seed)
    heads = numpy_tree(jax.eval_shape(lambda: jlp.init_head_params(
        key, JCFG, num_object_labels=N_OBJ)), seed + 1)
    return model, heads


def test_random_word_and_feat_equal_jax():
    ids = list(range(5, 16)) * 40
    a, b = np.random.RandomState(0), np.random.RandomState(0)
    assert tloop.random_word(ids, 4, 17, a) == jloop.random_word(ids, 4, 17,
                                                                 b)
    feats = np.random.RandomState(1).randn(300, 8).astype(np.float32)
    fa, fb = np.random.RandomState(2), np.random.RandomState(2)
    got = tloop.random_feat(feats, a, lambda: fa.randn(8), 0.15)
    want = jloop.random_feat(feats, b, lambda: fb.randn(8), 0.15)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    assert 0.08 < got[1].mean() < 0.25
    assert a.randint(1 << 30) == b.randint(1 << 30)


@pytest.mark.parametrize("i", range(7))
def test_convert_example_to_features_equals_jax(i):
    ex = Examples()
    dj, dt = Examples(), Examples()
    a, b = np.random.RandomState(i), np.random.RandomState(i)
    got = tloop.convert_example_to_features(ex[i], 6, TTok(vocab=VOCAB), a,
                                            dt.random_feat, 0.3, 0.3)
    want = jloop.convert_example_to_features(ex[i], 6, JTok(vocab=VOCAB), b,
                                             dj.random_feat, 0.3, 0.3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    assert a.randint(1 << 30) == b.randint(1 << 30)


def _batch(seed=4):
    ex = Examples(seed)
    rng = np.random.RandomState(seed)
    feats = [jloop.convert_example_to_features(
        ex[i], 8, JTok(vocab=VOCAB), rng, ex.random_feat, 0.4, 0.4)
        for i in range(len(ex))]
    jb = jloop.collate(feats)
    tb = tloop.collate(feats, "cpu")
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    return jb, tb


def test_pretrain_loss_parts_and_gradients_equal_jax():
    model, heads = _weights()
    jb, tb = _batch()
    tm = convert.lxmert_from_jax_numpy(model, TCFG, device="cpu")
    th = convert.lxmert_pretrain_heads_from_jax_numpy(heads, TCFG,
                                                      device="cpu")

    def jloss(m, h):
        return jlp.pretrain_loss(m, h, jb, JCFG)

    (jtotal, jparts), (gm, gh) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, model), jax.tree.map(jnp.asarray,
                                                           heads))
    (ttotal, tparts), grads = tsteps.value_and_grad(
        lambda p, b: tlp.pretrain_loss(p["model"], p["heads"], b, TCFG),
        {"model": tm, "heads": th}, tb, has_aux=True)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)
    assert set(tparts) == set(jparts)
    for k in jparts:
        assert float(jparts[k]) > 0, k
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    by_path = dict(zip(
        [tsteps.keystr(p) for p, _ in tsteps.tree_paths(
            {"model": tm, "heads": th})], grads))
    want = {f"['heads']{jax.tree_util.keystr(p)}": g for p, g in
            jax.tree_util.tree_flatten_with_path(gh)[0]}
    want["['model']['embeddings']['word']"] = gm["embeddings"]["word"]
    for path, g in want.items():
        g = np.asarray(g)
        top = float(np.abs(g).max())
        assert top > 0, path
        np.testing.assert_allclose(by_path[path].numpy(), g, rtol=1e-5,
                                   atol=1e-5 * top, err_msg=path)


def test_tied_decoder_gradient_sums_both_uses():
    """The LM decoder is ``embeddings.word`` itself: its gradient is the
    embedding lookup's part plus the decoder's, each non-zero."""
    model, heads = _weights()
    _, tb = _batch()
    tm = convert.lxmert_from_jax_numpy(model, TCFG, device="cpu")
    th = convert.lxmert_pretrain_heads_from_jax_numpy(heads, TCFG,
                                                      device="cpu")
    word = tm["embeddings"]["word"]
    eps = TCFG.layer_norm_eps
    with tsteps.trainable([word]):
        lang = tlx.forward(tm, tb["input_ids"], tb["attention_mask"],
                           tb["visual_feats"], tb["visual_pos"],
                           cfg=TCFG)["lang_output"]
        parts = [tlp.lm_logits(th, w, x, eps).square().sum()
                 for w, x in ((word, lang), (word.detach(), lang),
                              (word, lang.detach()))]
        both, lookup, dec = (torch.autograd.grad(p, word, retain_graph=True)[0]
                             for p in parts)
    assert float(lookup.abs().max()) > 0 and float(dec.abs().max()) > 0
    np.testing.assert_allclose(both.numpy(), (lookup + dec).numpy(),
                               rtol=1e-5, atol=1e-6 * float(both.abs().max()))


def test_train_epochs_equal_jax():
    model, heads = _weights()
    pt = dict(epochs=2, batch_size=3, max_seq_length=8, lr=1e-3)
    jlines, tlines = [], []
    jout = jloop.train(Examples(), JTok(vocab=VOCAB), JCFG,
                       jloop.PretrainConfig(**pt),
                       params=jax.tree.map(jnp.asarray, model),
                       head_params=jax.tree.map(jnp.asarray, heads), seed=5,
                       printer=jlines.append)
    tout = tloop.train(Examples(), TTok(vocab=VOCAB), TCFG,
                       tloop.PretrainConfig(**pt),
                       params=convert.lxmert_from_jax_numpy(model, TCFG,
                                                            device="cpu"),
                       head_params=convert.lxmert_pretrain_heads_from_jax_numpy(
                           heads, TCFG, device="cpu"),
                       seed=5, printer=tlines.append, device="cpu")
    assert len(tout["history"]) == len(jout["history"]) == 2
    for t, j in zip(tout["history"], jout["history"]):
        assert set(t) == set(j)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, err_msg=k)
    assert [ln.split(":")[0] for ln in tlines] == \
        [ln.split(":")[0] for ln in jlines]
    assert tout["history"][-1]["masked_lm"] != tout["history"][0]["masked_lm"]
