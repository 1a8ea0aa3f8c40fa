"""The port's DETR train step (``train/detr_train``) against the JAX
package's (``test_torch_train_detr_transforms.py`` holds the augmentation).

DETR at width 32, one encoder and one decoder layer, the backbone cut to
one block per stage, 64×64 images, from the JAX init's weights;
``train_batch`` three times with ``make_adamw(1e-4, weight_decay=1e-4,
grad_clip=0.1)``: ``predict`` equal to JAX's (rtol 1e-4 / atol 1e-5), the
same assignment each update, each loss within rtol 1e-4, every parameter
within 1e-5 of the tree's max|p| (not its own: the zero-initialised
biases and frozen-BN means hold only the updates, 3 lr, where the two
packages' backbone gradients differ by ~2e-5 of themselves), some
parameter moved by at least 100 times 1e-5 of its own max|p|
(``_train_helpers``; the elements whose gradient is zero by construction
held to the most AdamW moves them). The JAX test's "the loss falls over 8
updates" holds in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_helpers import assert_params_close, zero_gradients
from transformer_mm_explainability_tpu.models import detr as jdetr
from transformer_mm_explainability_tpu.models import matcher as jmatcher
from transformer_mm_explainability_tpu.train import detr_train as jtrain
from transformer_mm_explainability_tpu.train import steps as jsteps
from transformer_mm_explainability_tpu_torch.models import detr as tdetr
from transformer_mm_explainability_tpu_torch.models import matcher as tmatcher
from transformer_mm_explainability_tpu_torch.train import detr_train as ttrain
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.utils import convert


CFG_KW = dict(num_classes=5, num_queries=4, d_model=32, nheads=4,
              num_encoder_layers=1, num_decoder_layers=1, dim_feedforward=64,
              backbone_stages=(1, 1, 1, 1))
JCFG = jdetr.DETRConfig(**CFG_KW)
TCFG = tdetr.DETRConfig(**CFG_KW)
TX = dict(learning_rate=1e-4, weight_decay=1e-4, grad_clip=0.1)


def _data():
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 64, 3).astype(np.float32)
    labels = np.asarray([[1, 2], [3, 0]], np.int32)
    boxes = np.stack([[[0.3, 0.3, 0.2, 0.2], [0.7, 0.7, 0.2, 0.3]],
                      [[0.5, 0.5, 0.4, 0.4], [0.0, 0.0, 0.0, 0.0]]]
                     ).astype(np.float32)
    return images, labels, boxes, np.asarray([2, 1])


def _jax_weights():
    return jax.tree.map(np.asarray, jdetr.init_params(jax.random.PRNGKey(0),
                                                      JCFG))


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run()


def _jax_run():
    """JAX's three updates: per update the assignment and the losses; the
    first forward's logits and the final params."""
    images, labels, boxes, n_valid = _data()
    w = _jax_weights()
    tx = jsteps.make_adamw(**TX)
    state = jsteps.init_state(jax.tree.map(jnp.asarray, w), tx)
    predict, step = jtrain.make_detr_train_step(JCFG, tx)
    args = (jnp.asarray(images), jnp.asarray(labels), jnp.asarray(boxes))
    assignments, losses = [], []
    logits0 = predict(state.params, args[0])[0]
    for _ in range(3):
        lg, bx = predict(state.params, args[0])
        assignments.append(jmatcher.match(lg, bx, args[1], args[2],
                                          n_valid))
        state, l = jtrain.train_batch(state, *args, n_valid, predict, step)
        losses.append({k: float(v) for k, v in l.items()})

    return {"assignments": assignments, "losses": losses,
            "logits0": np.asarray(logits0),
            "params": convert.detr_from_jax_numpy(
                jax.tree.map(np.asarray, state.params), TCFG, device="cpu")}


def _skip(params, images, labels, boxes, assignment):
    """``zero_gradients`` of the first update's loss, from the port's
    gradient (the zeros are structural, the same in both packages)."""
    def loss(p, _):
        out = tdetr.forward(p, images, cfg=TCFG)
        parts = tmatcher.set_criterion_losses(
            out["pred_logits"], out["pred_boxes"], labels, boxes,
            assignment, num_classes=TCFG.num_classes)
        return sum(ttrain.LOSS_WEIGHTS[k] * parts[k]
                   for k in ttrain.LOSS_WEIGHTS)

    _, grads = tsteps.value_and_grad(loss, params, None)
    return zero_gradients([g.numpy() for g in grads])


def test_train_batch_equals_jax(jax_run):
    images, labels, boxes, n_valid = _data()
    params = convert.detr_from_jax_numpy(_jax_weights(), TCFG, device="cpu")
    before = [t.clone() for t in tsteps.tree_leaves(params)]
    tx = tsteps.make_adamw(**TX)
    state = tsteps.init_state(params, tx)
    predict, step = ttrain.make_detr_train_step(TCFG, tx)
    args = (torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(boxes))
    logits, _ = predict(params, args[0])
    assert not logits.requires_grad
    np.testing.assert_allclose(logits.numpy(), jax_run["logits0"],
                               rtol=1e-4, atol=1e-5)
    skip = _skip(params, *args, torch.as_tensor(jax_run["assignments"][0]))
    for k in range(3):
        lg, bx = predict(state.params, args[0])
        np.testing.assert_array_equal(
            tmatcher.match(lg, bx, args[1], args[2], n_valid),
            jax_run["assignments"][k])
        state, losses = ttrain.train_batch(state, *args, n_valid, predict,
                                           step)
        want = jax_run["losses"][k]
        assert set(losses) == set(want)
        for name in want:
            np.testing.assert_allclose(float(losses[name]), want[name],
                                       rtol=1e-4, err_msg=name)
    assert state.step == 3
    assert_params_close(tsteps.tree_leaves(state.params),
                        tsteps.tree_leaves(jax_run["params"]), before,
                        skip=skip, step_bound=3 * 3.2 * 1e-4,
                        scale="tree")


def test_loss_falls_over_8_updates():
    """tests/test_train_extras.py::test_detr_train_step_decreases_loss on
    the port (make_adamw(1e-4), the same images and targets)."""
    images, labels, boxes, n_valid = _data()
    params = convert.detr_from_jax_numpy(_jax_weights(), TCFG, device="cpu")
    tx = tsteps.make_adamw(1e-4)
    state = tsteps.init_state(params, tx)
    predict, step = ttrain.make_detr_train_step(TCFG, tx)
    args = (torch.from_numpy(images), torch.from_numpy(labels),
            torch.from_numpy(boxes))
    first = None
    for _ in range(8):
        state, losses = ttrain.train_batch(state, *args, n_valid, predict,
                                           step)
        first = first or losses
    assert float(losses["loss"]) < float(first["loss"])
    for k in ("loss_ce", "loss_bbox", "loss_giou"):
        assert np.isfinite(float(losses[k]))
