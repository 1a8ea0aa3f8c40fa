"""The port's LXMERT finetune trainers (``train/lxmert_tasks``:
``LxmertTaskTrainer``, ``Nlvr2TaskTrainer``, their losses) against the JAX
package's, at LXMERT 2/1/1 layers, width 32
(``test_torch_train_lxmert_cli.py`` holds the command and the readers).

Both sides start from the same numpy weights (carried across by
``utils/convert``) and train on the same batches. Bars: each epoch's loss
within rtol 1e-5 and its train and valid accuracy equal; every parameter
after three updates within 1e-5 of its max|p|, moved by at least 100 times
that (BertAdam's eps of 1e-6 keeps the zero-gradient key biases still in
both)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_helpers import assert_params_close, numpy_tree
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.train import lxmert_tasks as jtasks
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.train import lxmert_tasks as ttasks
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.utils import convert

CFG_KW = dict(vocab_size=40, hidden_size=32, num_attention_heads=4,
              intermediate_size=48, max_position_embeddings=24,
              l_layers=2, x_layers=1, r_layers=1, visual_feat_dim=16,
              num_qa_labels=6)
JCFG = jlx.LxmertConfig(**CFG_KW)
TCFG = tlx.LxmertConfig(**CFG_KW)
B, ST, SV = 4, 8, 6


def _weights(cfg_kw=CFG_KW, seed=0):
    shapes = jax.eval_shape(lambda: jlx.init_params(
        jax.random.PRNGKey(0), jlx.LxmertConfig(**cfg_kw)))
    return numpy_tree(shapes, seed)


def _vqa_batches(n=3, seed=1):
    """Batches of B with padded tokens and boxes, soft targets, and one
    masked-out sample (``sample_valid``) in the last batch."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        am = np.ones((B, ST), np.int32)
        am[1, 5:] = 0
        vm = np.ones((B, SV), np.int32)
        vm[2, 4:] = 0
        tgt = (rng.rand(B, 6) < 0.3).astype(np.float32) * 0.9
        tgt[np.arange(B), rng.randint(0, 6, B)] = 1.0
        out.append({
            "input_ids": rng.randint(1, 39, (B, ST)).astype(np.int32),
            "attention_mask": am,
            "visual_feats": rng.randn(B, SV, 16).astype(np.float32),
            "visual_pos": rng.rand(B, SV, 4).astype(np.float32),
            "visual_mask": vm, "target": tgt,
            "sample_valid": np.arange(B) < (B - 1 if i == n - 1 else B)})
    return out


def _nlvr2_batches(n=3, seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        vm = np.ones((B, 2, SV), np.int32)
        vm[0, 1, 3:] = 0
        out.append({
            "input_ids": rng.randint(1, 39, (B, ST)).astype(np.int32),
            "attention_mask": np.ones((B, ST), np.int32),
            "visual_feats": rng.randn(B, 2, SV, 16).astype(np.float32),
            "visual_pos": rng.rand(B, 2, SV, 4).astype(np.float32),
            "visual_mask": vm,
            "label": np.asarray([0, 1, 1, -1], np.int32)})
    return out


def _jb(batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def _tb(batches):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]


FT = dict(batch_size=B, epochs=3, lr=1e-3, warmup=0.1)


def _fit(trainer, batches, epochs_batches):
    """fit over ``epochs_batches`` batches an epoch (the epoch's slice of
    ``batches``), validated on all of them."""
    return trainer.fit(
        lambda epoch: batches[epoch * epochs_batches:
                              (epoch + 1) * epochs_batches],
        lambda: batches, printer=lambda *a: None)


def test_vqa_task_trainer_equals_jax():
    w = _weights()
    ft_j = jtasks.FinetuneConfig(**FT)
    ft_t = ttasks.FinetuneConfig(**FT)
    jtr = jtasks.LxmertTaskTrainer(6, ft_j, model_cfg=JCFG,
                                   batches_per_epoch=1, params=jax.tree.map(
                                       jnp.asarray, w))
    params = convert.lxmert_from_jax_numpy(w, TCFG, device="cpu")
    before = [t.clone() for t in tsteps.tree_leaves(params)]
    ttr = ttasks.LxmertTaskTrainer(6, ft_t, model_cfg=TCFG,
                                   batches_per_epoch=1, params=params,
                                   device="cpu")
    batches = _vqa_batches()
    jlog = _fit(jtr, _jb(batches), 1)
    tlog = _fit(ttr, _tb(batches), 1)
    np.testing.assert_allclose(tlog["loss"], jlog["loss"], rtol=1e-5)
    assert tlog["train_acc"] == pytest.approx(jlog["train_acc"], rel=1e-6)
    assert tlog["valid_acc"] == pytest.approx(jlog["valid_acc"], rel=1e-6)
    assert ttr.best_valid == pytest.approx(jtr.best_valid, rel=1e-6)
    assert ttr.state.step == 3
    want = convert.lxmert_from_jax_numpy(
        jax.tree.map(np.asarray, jtr.state.params), TCFG, device="cpu")
    assert_params_close(tsteps.tree_leaves(ttr.state.params),
                        tsteps.tree_leaves(want), before)
    # best_params is a copy, not the live (updated in place) tree
    best = tsteps.tree_leaves(ttr.best_params)
    live = tsteps.tree_leaves(ttr.state.params)
    assert all(a is not b for a, b in zip(best, live))
    assert not any(t.requires_grad for t in live)


def test_vqa_loss_is_mean_times_answers():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 11).astype(np.float32)
    targets = (rng.rand(6, 11) < 0.2).astype(np.float32) * 0.9
    want = float(jtasks.bce_vqa_loss(jnp.asarray(logits),
                                     jnp.asarray(targets)))
    got = float(ttasks.bce_vqa_loss(torch.from_numpy(logits),
                                    torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)


def test_nlvr2_task_trainer_equals_jax():
    w = _weights()
    ft = dict(FT, task="nlvr2")
    jtr = jtasks.Nlvr2TaskTrainer(jtasks.FinetuneConfig(**ft),
                                  model_cfg=JCFG, batches_per_epoch=1,
                                  lxmert_params=jax.tree.map(jnp.asarray, w))
    ttr = ttasks.Nlvr2TaskTrainer(
        ttasks.FinetuneConfig(**ft), model_cfg=TCFG, batches_per_epoch=1,
        lxmert_params=convert.lxmert_from_jax_numpy(w, TCFG, device="cpu"),
        device="cpu")
    head = convert.nlvr2_head_from_jax_numpy(
        jax.tree.map(np.asarray, jtr.state.params["head"]), 32, device="cpu")
    with torch.no_grad():
        for dst, src in zip(tsteps.tree_leaves(ttr.state.params["head"]),
                            tsteps.tree_leaves(head)):
            dst.copy_(src)
    before = [t.clone() for t in tsteps.tree_leaves(ttr.state.params)]
    batches = _nlvr2_batches()
    jlog = _fit(jtr, _jb(batches), 1)
    tlog = _fit(ttr, _tb(batches), 1)
    np.testing.assert_allclose(tlog["loss"], jlog["loss"], rtol=1e-5)
    assert tlog["train_acc"] == jlog["train_acc"]
    assert tlog["valid_acc"] == jlog["valid_acc"]
    want = {"lxmert": convert.lxmert_from_jax_numpy(
        jax.tree.map(np.asarray, jtr.state.params["lxmert"]), TCFG,
        device="cpu"), "head": convert.nlvr2_head_from_jax_numpy(
            jax.tree.map(np.asarray, jtr.state.params["head"]), 32,
            device="cpu")}
    assert_params_close(tsteps.tree_leaves(ttr.state.params),
                        tsteps.tree_leaves(want), before)


def test_nlvr2_loss_ignores_label_minus_one():
    logits = np.asarray([[3.0, -3.0], [0.5, 0.2], [9.0, -9.0]], np.float32)
    labels = np.asarray([0, 1, -1], np.int32)
    want = float(jtasks.nlvr2_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = ttasks.nlvr2_loss(torch.from_numpy(logits),
                            torch.from_numpy(labels))
    sub = ttasks.nlvr2_loss(torch.from_numpy(logits[:2]),
                            torch.from_numpy(labels[:2]))
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(got) == pytest.approx(float(sub), rel=1e-6)
