"""Functions that the ranks of ``tests/test_torch_train_parallel.py`` and
``tests/test_torch_parallel.py`` run (``parallel/launch.RankPool`` pickles
them by name, so they live in a module that imports torch and the port
only)."""

import torch
import torch.distributed as dist

from transformer_mm_explainability_tpu_torch.core.meter import SmoothedValue
from transformer_mm_explainability_tpu_torch.models import vit
from transformer_mm_explainability_tpu_torch.parallel import mesh as pmesh
from transformer_mm_explainability_tpu_torch.train import steps


def vit_loss(model, batch):
    logits, _ = vit.forward(model, batch["images"])
    return steps.softmax_xent(logits, batch["labels"])


def dp_tp_steps(model, images, labels, mesh, n: int = 2, lr: float = 1e-3):
    """``n`` updates of the dp×tp train step (``parallel/mesh``) on this
    rank's tp shard of ``model`` and dp slice of the batch, with
    ``make_adamw(lr)``: (losses [n], the whole model's parameters after each
    update, gathered back over tp)."""
    tx = steps.make_adamw(lr)
    state = steps.init_state(pmesh.shard_params(model, mesh), tx)
    step = pmesh.make_train_step(vit_loss, tx, mesh)
    batch = pmesh.shard_batch({"images": images, "labels": labels}, mesh)
    losses, params = [], []
    for _ in range(n):
        state, loss = step(state, batch)
        losses.append(loss)
        whole = pmesh.unshard_params(state.params, mesh)
        params.append({name: p.detach().clone()
                       for name, p in whole.named_parameters()})
    assert not any(p.requires_grad for p in state.params.parameters())
    return torch.stack(losses), params


def synced_meter():
    """A SmoothedValue of rank r holding r + 1 updates of value r + 1,
    synchronised: (count, total) over the group."""
    r = dist.get_rank()
    sv = SmoothedValue()
    sv.update(float(r + 1), n=r + 1)
    sv.synchronize_between_processes()
    return torch.tensor([sv.count, sv.total], dtype=torch.float64)


def shard_round_trip(model, mesh):
    """``unshard_params(shard_params(model))`` on this rank."""
    return pmesh.unshard_params(pmesh.shard_params(model, mesh), mesh)


def mesh_ranks(devices, dp=None, tp=None):
    """``parallel/mesh.make_mesh(devices, dp, tp)`` on this rank: (its
    ranks as a nested list, its axis names)."""
    mesh = pmesh.make_mesh(devices, dp, tp)
    return mesh.mesh.tolist(), tuple(mesh.mesh_dim_names)
