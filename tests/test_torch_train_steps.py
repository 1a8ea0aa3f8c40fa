"""The port's optimizers, schedules, registry and train steps
(``train/steps``, ``train/schedulers``, ``core/registry``) against the JAX
package's, on the same parameter trees and gradient sequences.

Bars: optimizers within rtol 1e-6 after 5 updates (the port's Adam, SGD
and BertAdam take optax's float32 arithmetic in its order); schedules
within rtol 1e-6 at every step of [0, total + 5]; the tiny ViT's train
steps within rtol 1e-5 on the loss and 1e-5 of max|p| on every parameter
after three updates that moved it by at least 100 times that
(``_train_helpers.assert_params_close``), but the elements whose gradient
is zero by construction (the attention's key bias), which AdamW moves by
steps whose sign rounding decides: those are held to the most three AdamW
updates can move them (|m̂|/√v̂ < 3.2 per update). A model trained by the
port keeps parameters that do not require grad, and its maps are those of
a fresh model with the same weights."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _train_helpers import (JVIT, LOSS_RTOL, TVIT, assert_params_close,
                            numpy_tree, vit_batch, vit_weights,
                            zero_gradients)
from transformer_mm_explainability_tpu.core.registry import (
    registry as jregistry)
from transformer_mm_explainability_tpu.models import detr as jdetr
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu.train import schedulers as jsched
from transformer_mm_explainability_tpu.train import steps as jsteps
from transformer_mm_explainability_tpu_torch.core.registry import (
    registry as tregistry)
from transformer_mm_explainability_tpu_torch.models import detr as tdetr
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.train import schedulers as tsched
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.utils import convert

OPT_RTOL = 1e-6


def _toy_tree(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    return {"encoder": {"attn": {"w": r(4, 6), "b": r(6)},
                        "attn_ln": {"scale": 1 + 0.1 * r(6),
                                    "bias": r(6)}},
            "classifier": {"w": r(6, 3), "b": r(3)}}


def _grads(tree, n, seed=1, scale=2.0):
    rng = np.random.RandomState(seed)
    return [jax.tree.map(lambda x: (scale * rng.randn(*x.shape)).astype(
        np.float32), tree) for _ in range(n)]


def _run_both(jtx, ttx, tree, n=5, seed=1, scale=2.0):
    """n updates of the same gradients through optax and the port; returns
    (JAX leaves, port leaves), both numpy, in JAX's leaf order (the port's
    trees flatten with sorted keys, as JAX's)."""
    jp = jax.tree.map(jnp.asarray, tree)
    st = jtx.init(jp)
    tp = jax.tree.map(torch.tensor, tree)
    opt = ttx.init(tp)
    for g in _grads(tree, n, seed, scale):
        u, st = jtx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, u)
        opt.apply([torch.from_numpy(x) for x in jax.tree.leaves(g)])
    assert opt.count == n
    return ([np.asarray(x) for x in jax.tree.leaves(jp)],
            [t.numpy() for t in tsteps.tree_leaves(tp)])


def _assert_opt_equal(jtx, ttx, tree=None, **kw):
    tree = _toy_tree() if tree is None else tree
    want, got = _run_both(jtx, ttx, tree, **kw)
    moved = max(float(np.abs(w - b).max())
                for w, b in zip(want, jax.tree.leaves(tree)))
    assert moved > 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-2, weight_decay=1e-2),
    dict(learning_rate=1e-2, weight_decay=1e-4, warmup_steps=2,
         total_steps=6, grad_clip=0.5),
    dict(learning_rate=3e-3, grad_clip=100.0),
])
def test_make_adamw_equals_optax(kw):
    _assert_opt_equal(jsteps.make_adamw(**kw), tsteps.make_adamw(**kw))


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-2, warmup=0.2, total_steps=5),
    dict(learning_rate=5e-3, warmup=0.1, total_steps=20, weight_decay=0.0,
         grad_clip=1e9),
])
def test_make_bert_adam_equals_jax(kw):
    _assert_opt_equal(jsteps.make_bert_adam(**kw),
                      tsteps.make_bert_adam(**kw))


def test_bert_adam_first_update_moves_nothing():
    """warmup_linear is 0 at step 0: the first update only fills m and v."""
    tree = _toy_tree()
    want, got = _run_both(jsteps.make_bert_adam(1e-2, 0.2, 5),
                          tsteps.make_bert_adam(1e-2, 0.2, 5), tree, n=1)
    for g, w, b in zip(got, want, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g, b)
        np.testing.assert_array_equal(w, b)


@pytest.mark.parametrize("name,kw", [
    ("Adamax", dict(weight_decay=0.01)), ("Adamax", {}),
    ("Adam", {}), ("Adam", dict(weight_decay=0.01)),
    ("AdamW", {}), ("SGD", dict(momentum=0.9, nesterov=True,
                                weight_decay=0.01)),
    ("SGD", dict(momentum=0.9)), ("SGD", {}),
    ("adam_w", {}), ("bert_adam", dict(total_steps=8)),
])
def test_registered_optimizers_equal_jax(name, kw):
    _assert_opt_equal(jregistry.get("optimizer", name)(**kw),
                      tregistry.get("optimizer", name)(**kw))


def test_adam_w_with_a_registered_schedule_equals_jax():
    _assert_opt_equal(
        jsched.adam_w(1e-2, schedule=jsched.warmup_linear(2, 6)),
        tsched.adam_w(1e-2, schedule=tsched.warmup_linear(2, 6)))


def test_registry_resolves_every_jax_name():
    for ns in ("optimizer", "scheduler"):
        names = jregistry.list(ns)
        assert names and set(names) <= set(tregistry.list(ns))
        for name in names:
            assert callable(tregistry.get(ns, name))
    with pytest.raises(KeyError, match="not found"):
        tregistry.get("optimizer", "nope")
    with pytest.raises(KeyError, match="already registered"):
        tregistry.register_optimizer("Adam")(lambda: None)


def test_clip_by_global_norm_is_optax_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    got = tsteps.clip_by_global_norm(g, 1.0)
    want = jax.tree.leaves(optax.clip_by_global_norm(1.0).update(
        [jnp.asarray([3.0, 4.0]), jnp.asarray([0.0])], None)[0])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    same = tsteps.clip_by_global_norm(g, 5.0 + 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(same, g))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("pythia", dict()),
    ("pythia", dict(lr_steps=(3, 6, 9), lr_ratio=0.5)),
    ("pythia", dict(use_warmup=True, warmup_iterations=4,
                    warmup_factor=0.25, lr_steps=(4, 7), lr_ratio=0.1)),
    ("pythia", dict(use_warmup=True, warmup_iterations=3,
                    lr_steps=(9, 2, 5))),
    ("warmup_linear", dict(num_warmup_steps=3, num_training_steps=10)),
    ("warmup_linear", dict(num_warmup_steps=0, num_training_steps=7)),
    ("warmup_cosine", dict(num_warmup_steps=3, num_training_steps=10)),
    ("warmup_cosine", dict(num_warmup_steps=2, num_training_steps=9,
                           num_cycles=1.5)),
    ("multi_step", dict(lr_steps=(2, 5))),
    ("multi_step", dict(use_warmup=True, warmup_iterations=3,
                        lr_steps=(5, 8), lr_ratio=0.2)),
    ("multi_step", dict(use_warmup=False, warmup_iterations=50,
                        lr_steps=(3,))),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_equal_jax_at_every_step(name, kw):
    js = jregistry.get("scheduler", name)(**kw)
    ts = tregistry.get("scheduler", name)(**kw)
    total = max(list(kw.get("lr_steps", [])) + [kw.get(
        "num_training_steps", 0), kw.get("warmup_iterations", 0), 10])
    for step in range(total + 6):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-7, err_msg=f"step {step}")


def test_multi_step_rejects_warmup_past_first_milestone():
    with pytest.raises(AssertionError):
        jsched.multi_step(use_warmup=True, warmup_iterations=5,
                          lr_steps=(5,))
    with pytest.raises(ValueError, match="first milestone"):
        tsched.multi_step(use_warmup=True, warmup_iterations=5,
                          lr_steps=(5,))


@pytest.mark.parametrize("warmup,total", [(3, 10), (1, 4), (5, 6)])
def test_warmup_cosine_decay_equals_optax(warmup, total):
    js = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, total)
    ts = tsteps.warmup_cosine_decay(0.0, 2e-3, warmup, total)
    for step in range(total + 6):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6,
                                   atol=1e-12)
    assert ts(0) == 0.0


# ---------------------------------------------------------------------------
# BERT parameter groups
# ---------------------------------------------------------------------------

def _jax_mask(tree):
    return {jax.tree_util.keystr(p): bool(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                jsteps.bert_no_decay_mask(tree))[0]}


def _port_tree(family):
    key = jax.random.PRNGKey(0)
    if family == "toy":
        tree = _toy_tree()
        return tree, jax.tree.map(torch.tensor, tree)
    if family == "lxmert":
        cfg = dict(hidden_size=16, num_attention_heads=2,
                   intermediate_size=24, l_layers=2, x_layers=1, r_layers=1,
                   vocab_size=30, num_qa_labels=5, visual_feat_dim=8)
        tree = numpy_tree(jax.eval_shape(
            lambda: jlx.init_params(key, jlx.LxmertConfig(**cfg))))
        return tree, convert.lxmert_from_jax_numpy(
            tree, tlx.LxmertConfig(**cfg), device="cpu")
    cfg = dict(num_classes=5, num_queries=4, d_model=16, nheads=2,
               num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=32)
    tree = numpy_tree(jax.eval_shape(
        lambda: jdetr.init_params(key, jdetr.DETRConfig(**cfg))))
    return tree, convert.detr_from_jax_numpy(
        tree, tdetr.DETRConfig(**cfg), device="cpu")


@pytest.mark.parametrize("family", ["toy", "lxmert", "detr"])
def test_no_decay_mask_equals_jax(family):
    jtree, ttree = _port_tree(family)
    want = _jax_mask(jtree)
    got = tsteps.bert_no_decay_mask(ttree)
    assert got == want
    assert any(want.values()) and not all(want.values())


def test_no_decay_mask_on_the_vit_module_equals_jax():
    jtree, model = vit_weights()
    want = _jax_mask(jtree)
    got = tsteps.bert_no_decay_mask(model)
    for name, _ in model.named_parameters():
        keys = tvit.ViT.tree_keys(name)
        leaf = name.split(".")[-1]
        jkey = "".join(f"['{k}']" for k in keys) + (
            f".{leaf}" if keys == ("blocks", "attn") else "")
        assert got["." + name] == want[jkey], name
    assert not got[".blocks.0.ln1_scale"] and not got[".patch_b"]
    assert got[".blocks.0.b_qkv"] and got[".norm_scale"]


@pytest.mark.parametrize("mult", [0.0, 0.5, 1.0])
def test_make_bert_optimizer_equals_jax(mult):
    """Decay mask and the lr multiplier of every subtree but the
    classifier: the same updates, so the same leaves in each group."""
    jtree, _ = _port_tree("toy")
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              finetune_lr_multiplier=mult)
    want, got = _run_both(jsteps.make_bert_optimizer(jtree, **kw),
                          tsteps.make_bert_optimizer(
                              jax.tree.map(torch.tensor, jtree), **kw),
                          jtree, n=3, scale=0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=0)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jtree)[0]]
    for path, w, before in zip(paths, want, jax.tree.leaves(jtree)):
        frozen = mult == 0.0 and not path.startswith("['classifier']")
        assert np.array_equal(w, before) == frozen, path


@pytest.mark.parametrize("family", ["lxmert", "detr"])
def test_make_bert_optimizer_groups_equal_jax(family):
    """On a model's tree, each leaf's group (its decay and its lr) is the
    one JAX's mask and ``multi_transform`` labels give it: decay where
    ``bert_no_decay_mask`` says so, lr × multiplier off the classifier
    (``answer_head`` for LXMERT, ``class_embed`` for DETR)."""
    jtree, ttree = _port_tree(family)
    cls = "answer_head" if family == "lxmert" else "class_embed"
    mask = _jax_mask(jtree)
    recipe = tsteps.make_bert_optimizer(ttree, learning_rate=1e-2,
                                        weight_decay=0.1,
                                        finetune_lr_multiplier=0.25,
                                        classifier_key=cls)
    paths = [tsteps.keystr(p) for p, _ in tsteps.tree_paths(ttree)]
    group_of = {}
    for leaf_mask, opts in recipe.groups(ttree):
        for path, m in zip(paths, leaf_mask):
            if m:
                assert path not in group_of
                group_of[path] = opts
    assert set(group_of) == set(mask)
    for path, opts in group_of.items():
        assert (opts["weight_decay"] > 0) == mask[path], path
        want_lr = 1e-2 if path.startswith(f"['{cls}']") else 1e-2 * 0.25
        assert opts["lr"] == pytest.approx(want_lr), path


def test_make_bert_optimizer_schedule_sets_every_group():
    jtree, _ = _port_tree("toy")
    kw = dict(learning_rate=1.0, weight_decay=0.1,
              finetune_lr_multiplier=0.5)
    want, got = _run_both(
        jsteps.make_bert_optimizer(jtree, **kw,
                                   schedule=optax.linear_schedule(
                                       1e-3, 1e-2, 4)),
        tsteps.make_bert_optimizer(jax.tree.map(torch.tensor, jtree), **kw,
                                   schedule=lambda c: float(
                                       optax.linear_schedule(
                                           1e-3, 1e-2, 4)(c))),
        jtree, n=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=OPT_RTOL, atol=0)


# ---------------------------------------------------------------------------
# train steps on the tiny ViT
# ---------------------------------------------------------------------------

def _jax_loss(p, batch):
    logits, _ = jvit.forward(p, batch["images"], JVIT)
    return jsteps.softmax_xent(logits, batch["labels"])


def _port_loss(model, batch):
    logits, _ = tvit.forward(model, batch["images"])
    return tsteps.softmax_xent(logits, batch["labels"])


def zero_gradients_tree(grads):
    """``zero_gradients`` of a JAX gradient tree, as a tree of 0/1 float
    arrays (so that the ViT converter can lay it out as parameters)."""
    leaves, treedef = jax.tree_util.tree_flatten(grads)
    return jax.tree_util.tree_unflatten(treedef, [
        m.astype(np.float32) for m in zero_gradients(leaves)])


def _vit_params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.fixture(scope="module")
def jax_vit_runs():
    """JAX's three plain updates and three accumulated ones (2 micro
    batches of 4) of the tiny ViT from ``vit_weights``: (losses, params
    converted into the port's ViT)."""
    jtree, _ = vit_weights()
    batch = vit_batch(8)
    grads = jax.grad(_jax_loss)(jax.tree.map(jnp.asarray, jtree),
                                jax.tree.map(jnp.asarray, batch))
    skip = [p.numpy() for p in convert.vit_from_jax_numpy(
        zero_gradients_tree(grads), TVIT, device="cpu").parameters()]
    out = {"skip": [s > 0.5 for s in skip]}
    for accum in (1, 2):
        tx = jsteps.make_adamw(1e-3)
        state = jsteps.init_state(jax.tree.map(jnp.asarray, jtree), tx)
        if accum == 1:
            step = jax.jit(jsteps.make_train_step(_jax_loss, tx))
            b = batch
        else:
            step = jax.jit(jsteps.make_accum_train_step(_jax_loss, tx, 2))
            b = {k: v.reshape((2, 4) + v.shape[1:]) for k, v in
                 batch.items()}
        losses = []
        for _ in range(3):
            state, loss = step(state, jax.tree.map(jnp.asarray, b))
            losses.append(float(loss))
        out[accum] = (losses, convert.vit_from_jax_numpy(
            jax.tree.map(np.asarray, state.params), TVIT, device="cpu"))
    return out


@pytest.mark.parametrize("accum", [1, 2])
def test_vit_train_step_equals_jax(jax_vit_runs, accum):
    _, model = vit_weights()
    before = _vit_params(model)
    batch = {k: torch.from_numpy(v) for k, v in vit_batch(8).items()}
    tx = tsteps.make_adamw(1e-3)
    state = tsteps.init_state(model, tx)
    if accum == 1:
        step = tsteps.make_train_step(_port_loss, tx)
    else:
        step = tsteps.make_accum_train_step(_port_loss, tx, 2)
        batch = {k: v.reshape((2, 4) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
    losses = []
    for _ in range(3):
        state, loss = step(state, batch)
        losses.append(float(loss))
    want_losses, want_model = jax_vit_runs[accum]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert state.step == 3 and state.params is model
    assert_params_close(list(model.parameters()),
                        list(want_model.parameters()), before,
                        skip=jax_vit_runs["skip"],
                        step_bound=3 * 3.2 * 1e-3)
    assert not any(p.requires_grad for p in model.parameters())


def test_train_step_checks_its_optimizer():
    _, model = vit_weights()
    state = tsteps.init_state(model, tsteps.make_adamw(1e-3))
    step = tsteps.make_train_step(_port_loss, tsteps.make_adamw(1e-3))
    with pytest.raises(ValueError, match="init_state"):
        step(state, {k: torch.from_numpy(v)
                     for k, v in vit_batch(2).items()})


def test_training_leaves_the_explanation_paths_alone():
    """Train a copy of a ViT: the original's parameters, their no-grad
    flags and its maps do not change; the trained copy's parameters do
    not require grad either, and its maps (the capture chain and the fused
    block path, plain versions on the CPU) are those of a fresh ViT loaded
    with its weights."""
    _, model = vit_weights()
    rng = np.random.RandomState(3)
    images = torch.from_numpy(rng.randn(2, 32, 32, 3).astype(np.float32))
    targets = torch.tensor([1, 7])
    paths = (tvit.relevancy, tvit.relevancy_fused_block2)
    maps = [fn(model, images, targets) for fn in paths]
    before = _vit_params(model)

    trained = copy.deepcopy(model)
    tx = tsteps.make_adamw(1e-2)
    state = tsteps.init_state(trained, tx)
    step = tsteps.make_train_step(_port_loss, tx)
    batch = {k: torch.from_numpy(v) for k, v in vit_batch(4).items()}
    for _ in range(2):
        step(state, batch)

    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), before))
    assert not any(p.requires_grad for p in model.parameters())
    for fn, want in zip(paths, maps):
        assert torch.equal(fn(model, images, targets), want)
    assert not any(p.requires_grad for p in trained.parameters())
    assert any(not torch.equal(a, b)
               for a, b in zip(trained.parameters(), before))
    fresh = tvit.ViT(TVIT, "cpu")
    with torch.no_grad():
        for dst, src in zip(fresh.parameters(), trained.parameters()):
            dst.copy_(src)
    for fn in paths:
        got = fn(trained, images, targets)
        assert torch.equal(got, fn(fresh, images, targets))
        assert not torch.equal(got, fn(model, images, targets))
