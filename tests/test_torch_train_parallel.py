"""The dp×tp train step of ``parallel/mesh`` (``make_train_step`` on a
``shard_params`` copy and a ``shard_batch`` slice) against the port's and
the JAX package's unsharded steps, and the meters' synchronisation over a
process group.

Four spawned gloo ranks (``parallel/launch.RankPool``), started once for
the file, on a (dp = 2, tp = 2) mesh; the tiny ViT of
``tests/test_parallel.py``, ``make_adamw(1e-3)``, batch 8. Bars (those of
``tests/test_parallel.py:56-59``): the loss within rtol 1e-5 and ``w_qkv``
within atol 1e-5 of both unsharded steps, after each of two updates (the
second shows that the row-parallel biases, held on the first tp rank, are
counted once); every other parameter within atol 1e-5 of the port's
unsharded step but the attention's key bias, whose gradient is zero by
construction and whose AdamW steps rounding decides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _train_helpers import JVIT, vit_batch, vit_weights
from _train_ranks import (dp_tp_steps, shard_round_trip, synced_meter,
                          vit_loss)
from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu.train import steps as jsteps
from transformer_mm_explainability_tpu_torch.parallel.launch import (
    MeshArg, RankPool)
from transformer_mm_explainability_tpu_torch.train import steps as tsteps

TP_MESH = MeshArg(dp=2, tp=2)


@pytest.fixture(scope="module")
def pool():
    """Four gloo ranks for the whole module; each rendezvous, call and join
    bounded by 300 s."""
    with RankPool(4, "gloo", "cpu", timeout_s=300) as p:
        yield p


def _jax_steps(n=2):
    jtree, _ = vit_weights()
    batch = {k: jnp.asarray(v) for k, v in vit_batch(8).items()}

    def loss_fn(p, b):
        logits, _ = jvit.forward(p, b["images"], JVIT)
        return jsteps.softmax_xent(logits, b["labels"])

    tx = jsteps.make_adamw(1e-3)
    state = jsteps.init_state(jax.tree.map(jnp.asarray, jtree), tx)
    step = jax.jit(jsteps.make_train_step(loss_fn, tx))
    losses, w_qkv = [], []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
        w_qkv.append(np.asarray(state.params["blocks"]["attn"].w_qkv))
    return losses, w_qkv


def _port_steps(n=2):
    _, model = vit_weights()
    batch = {k: torch.from_numpy(v) for k, v in vit_batch(8).items()}
    tx = tsteps.make_adamw(1e-3)
    state = tsteps.init_state(model, tx)
    step = tsteps.make_train_step(vit_loss, tx)
    losses, params = [], []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(float(loss))
        params.append({name: p.detach().clone()
                       for name, p in model.named_parameters()})
    return losses, params


def test_dp_tp_step_equals_unsharded_steps(pool):
    _, model = vit_weights()
    b = vit_batch(8)
    outs = pool.run(dp_tp_steps, model, torch.from_numpy(b["images"]),
                    torch.from_numpy(b["labels"]), TP_MESH)
    losses, params = outs[0]
    for other_losses, other_params in outs[1:]:
        assert torch.equal(other_losses, losses)
        for a, c in zip(other_params, params):
            for name in a:
                assert torch.equal(a[name], c[name]), name
    jl, jw = _jax_steps()
    tl, tp = _port_steps()
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-5)
    np.testing.assert_allclose(losses.numpy(), tl, rtol=1e-5)
    for k in range(2):
        for i in range(JVIT.depth):
            w = params[k][f"blocks.{i}.w_qkv"].numpy()
            np.testing.assert_allclose(w, jw[k][i], rtol=0, atol=1e-5)
            np.testing.assert_allclose(w, tp[k][f"blocks.{i}.w_qkv"].numpy(),
                                       rtol=0, atol=1e-5)
        for name, want in tp[k].items():
            if name.endswith("b_qkv"):
                D = want.shape[0] // 3
                got = params[k][name]
                for part in (slice(0, D), slice(2 * D, 3 * D)):
                    np.testing.assert_allclose(got[part].numpy(),
                                               want[part].numpy(), rtol=0,
                                               atol=1e-5, err_msg=name)
                continue
            np.testing.assert_allclose(params[k][name].numpy(),
                                       want.numpy(), rtol=0, atol=1e-5,
                                       err_msg=name)
    moved = float((params[1]["blocks.0.b_out"]
                   - model.blocks[0].b_out).abs().max())
    assert moved > 1e-3


@pytest.mark.parametrize("mesh", [TP_MESH, MeshArg(dp=1, tp=4)])
def test_unshard_inverts_shard(pool, mesh):
    _, model = vit_weights()
    for got in pool.run(shard_round_trip, model, mesh):
        for (name, a), b in zip(got.named_parameters(), model.parameters()):
            assert torch.equal(a, b), name
        assert got.cfg == model.cfg


def test_meter_synchronises_over_the_group(pool):
    for count, total in pool.run(synced_meter):
        assert (float(count), float(total)) == (10.0, 30.0)
