"""Device mesh and sharding layouts over ``torch.distributed``.

Counterpart of ``transformer_mm_explainability_tpu/parallel/mesh.py``. The
reference scales with NCCL DDP only (SURVEY.md §2.6). The JAX package lays
arrays on a ``jax.sharding.Mesh`` with named axes and lets XLA insert the
collectives; here every rank is a process, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with axes ``("dp", "tp")``,
and the collectives are explicit:

  * ``make_mesh`` — factorise the process group's ranks (all, or the
    ``devices`` given) into (dp, tp) by the JAX rule (``mesh_shape``); the
    caller initialises the process group
    (``torch.distributed.init_process_group``, or ``parallel/launch``): no
    mesh is made without one;
  * ``spec_for_path`` — the Megatron layout by parameter name (qkv and
    MLP-in column-parallel, attention-out and MLP-out row-parallel);
  * ``shard_params`` — a ViT whose blocks hold this rank's tp shard, which
    ``models/vit.relevancy`` and ``relevancy_streamed_row`` run
    tensor-parallel: heads split over tp, one all-reduce per residual
    branch, Ê's head mean averaged over tp (``TensorParallel``);
  * ``make_train_step`` — the dp×tp train step on such a copy: this rank's
    batch slice, gradients averaged over dp in one all-reduce, the
    row-parallel biases held on the tp group's first rank only;
    ``unshard_params`` gathers the copy back into a whole ViT;
  * ``shard_batch`` / ``replicated`` / ``dp_shard_map`` — the data-parallel
    layout: each dp rank takes its slice of the batch and the results are
    gathered whole on every rank. ``dp_shard_map`` is how the kernel paths
    (``relevancy_fused``, ``relevancy_fused_block2``) run on several cards,
    as ``jax.shard_map`` hands the JAX package's Mosaic kernels their local
    blocks.

Collectives use ``dist.all_gather`` into a list and ``dist.all_reduce``,
which gloo (CPU tensors, or CUDA tensors staged through the host) and NCCL
both provide.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from transformer_mm_explainability_tpu_torch.train import steps

AXES = ("dp", "tp")


def mesh_shape(n: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) for ``n`` ranks: by default tp = 4, else 2, where it
    divides n and is below n (a 2-D mesh where it can be), else 1; dp =
    n // tp. Raises when dp · tp != n."""
    if tp is None:
        tp = next((c for c in (4, 2) if n % c == 0 and c < n), 1)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp ({dp}) * tp ({tp}) != n ({n})")
    return dp, tp


def make_mesh(devices: Optional[Sequence[int]] = None,
              dp: Optional[int] = None,
              tp: Optional[int] = None) -> DeviceMesh:
    """A (dp, tp) ``DeviceMesh`` over ``devices``, ranks of the initialised
    process group laid out row-major as the JAX ``make_mesh`` lays its
    devices (default: every rank, in order), with ``mesh_shape``'s
    defaults. Every rank of the group calls it with the same ``devices``
    (the mesh's groups are made collectively); a rank outside them holds
    the mesh without a place in it. The device type follows the backend:
    ``cuda`` over NCCL, ``cpu`` over gloo (whose collectives also take
    CUDA tensors)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group (or use "
            "parallel/launch.RankPool) first")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if devices is None:
        shape = mesh_shape(dist.get_world_size(), dp, tp)
        return init_device_mesh(device_type, shape, mesh_dim_names=AXES)
    ranks = [int(r) for r in devices]
    world = dist.get_world_size()
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"devices {ranks} are not distinct ranks of the "
                         f"process group (world size {world})")
    shape = mesh_shape(len(ranks), dp, tp)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str,
           dim: int = 0) -> torch.Tensor:
    """The ``axis`` group's blocks of ``x`` concatenated along ``dim``, in
    rank order, on every rank of the group."""
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Σ of ``x`` over the ``axis`` group (a new tensor) on every rank."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out


# ---------------------------------------------------------------------------
# The Megatron layout
# ---------------------------------------------------------------------------

COLUMN_WEIGHTS = ("w_qkv", "w1", "w_q", "w_k", "w_v")
COLUMN_BIASES = ("b_qkv", "b1", "b_q", "b_k", "b_v")
ROW_WEIGHTS = ("w_out", "w2")


def _leaf_name(path: str) -> str:
    """The last name of a parameter path: ``['blocks']['mlp']['w1']``
    (a JAX key path), ``['blocks']['attn'].w_qkv`` or ``blocks.0.w1``."""
    return re.findall(r"\w+", path)[-1]


def spec_for_path(path: str) -> tuple:
    """The Megatron layout of a leaf stacked over layers (``[L, ...]``, the
    JAX package's layout; the layer axis is never sharded): ``"tp"`` on the
    output axis of a column-parallel weight or bias, on the input axis of a
    row-parallel weight, ``()`` (replicated) for everything else. A
    per-layer tensor of the port takes ``spec[1:]``."""
    name = _leaf_name(path)
    if name in COLUMN_WEIGHTS:
        return (None, None, "tp")
    if name in COLUMN_BIASES:
        return (None, "tp")
    if name in ROW_WEIGHTS:
        return (None, "tp", None)
    return ()


class _Enter(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group backward
    (the input of a column-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Exit(torch.autograd.Function):
    """The partial outputs summed over the group forward; identity backward
    (the output of a row-parallel product)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """One tp group's collectives for the blocks of ``shard_params``."""

    def __init__(self, group, size: int):
        self.group = group
        self.size = size

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _Exit.apply(x, self.group)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the group of a tensor outside autograd."""
        out = x.detach().contiguous().clone()
        dist.all_reduce(out, group=self.group)
        return out / self.size


def _split(t: torch.Tensor, dim: int, k: int, r: int,
           groups: int = 1) -> torch.Tensor:
    """Rank ``r``'s block of ``k`` along ``dim``; with ``groups``, the dim is
    ``groups`` equal parts (q, k, v) and each is split alike."""
    shape = t.shape
    t = t.unflatten(dim, (groups, shape[dim] // groups))
    n = t.shape[dim + 1] // k
    return t.narrow(dim + 1, r * n, n).flatten(dim, dim + 1).clone()


def shard_params(model, mesh: DeviceMesh, axis: str = "tp"):
    """A copy of the ViT ``model`` (``models/vit.ViT``) holding this rank's
    tp shard of every block, by ``spec_for_path``: ``w_qkv``/``b_qkv`` by
    heads (each of q, k, v split alike), ``w1``/``b1`` by columns,
    ``w_out``/``w2`` by rows; each row-parallel bias kept on the group's
    first rank only, so that the sum over the group adds it once. A
    branch whose split axis does not divide by tp (heads for attention,
    the MLP width for the MLP) stays replicated, as the JAX layout
    replicates such a leaf. ``cfg.num_heads`` of the copy is the local
    head count; ``row_biases`` names the row-parallel biases, which a train
    step keeps at 0 off the group's first rank (``make_train_step``)."""
    k, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    tp = TensorParallel(mesh.get_group(axis), k)
    cfg = model.cfg
    out = copy.deepcopy(model)
    out.row_biases = frozenset()
    if k == 1:
        return out
    split_attn = cfg.num_heads % k == 0
    split_mlp = (cfg.mlp_ratio * cfg.width) % k == 0
    out.row_biases = frozenset(
        f"blocks.{i}.{name}" for i in range(cfg.depth)
        for name, split in (("b_out", split_attn), ("b2", split_mlp))
        if split)
    with torch.no_grad():
        for blk in out.blocks:
            if split_attn:
                blk.w_qkv = _param(_split(blk.w_qkv, 1, k, r, groups=3))
                blk.b_qkv = _param(_split(blk.b_qkv, 0, k, r, groups=3))
                blk.w_out = _param(_split(blk.w_out, 0, k, r))
                blk.b_out = _param(blk.b_out * (r == 0))
                blk.tp_attn = tp
            if split_mlp:
                blk.w1 = _param(_split(blk.w1, 1, k, r))
                blk.b1 = _param(_split(blk.b1, 0, k, r))
                blk.w2 = _param(_split(blk.w2, 0, k, r))
                blk.b2 = _param(blk.b2 * (r == 0))
                blk.tp_mlp = tp
    if split_attn:
        out.cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // k)
        out.tp_heads = tp
    return out


def _param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


def _merge(parts, dim: int, groups: int = 1) -> torch.Tensor:
    """The inverse of ``_split``: the ranks' blocks joined along ``dim``
    (within each of ``groups`` equal parts)."""
    parts = [p.unflatten(dim, (groups, p.shape[dim] // groups))
             for p in parts]
    return torch.cat(parts, dim=dim + 1).flatten(dim, dim + 1)


def unshard_params(model, mesh: DeviceMesh, axis: str = "tp"):
    """The whole ViT from this rank's tp copy (``shard_params``' inverse),
    equal on every rank of the group: split tensors gathered and joined,
    the row-parallel biases summed."""
    from transformer_mm_explainability_tpu_torch.models.vit import ViT

    k = axis_size(mesh, axis)
    heads = model.cfg.num_heads * (k if model.tp_heads is not None else 1)
    out = ViT(dataclasses.replace(model.cfg, num_heads=heads),
              model.patch_w.device)

    def whole(t, dim, groups=1):
        parts = [torch.empty_like(t) for _ in range(k)]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=mesh.get_group(axis))
        return _merge(parts, dim, groups)

    with torch.no_grad():
        for (name, dst), src in zip(out.named_parameters(),
                                    model.parameters()):
            blk = model.blocks[int(name.split(".")[1])] \
                if name.startswith("blocks.") else None
            leaf = name.split(".")[-1]
            attn = blk is not None and blk.tp_attn is not None
            mlp = blk is not None and blk.tp_mlp is not None
            if attn and leaf in ("w_qkv", "b_qkv"):
                src = whole(src, src.dim() - 1, groups=3)
            elif (attn and leaf == "w_out") or (mlp and leaf == "w2"):
                src = whole(src, 0)
            elif mlp and leaf in ("w1", "b1"):
                src = whole(src, src.dim() - 1)
            elif (attn and leaf == "b_out") or (mlp and leaf == "b2"):
                src = all_reduce(src, mesh, axis)
            dst.copy_(src)
    return out


def make_train_step(loss_fn: Callable, tx, mesh: DeviceMesh):
    """``train/steps.make_train_step`` on a ``shard_params`` copy and a
    ``shard_batch`` slice: ``loss_fn`` gives this rank's mean loss over
    its slice; the gradients are averaged over dp in one all-reduce (the
    tp collectives of ``_Enter``/``_Exit`` already made the replicated
    leaves' gradients equal within a tp group), the gradient of a
    row-parallel bias is dropped off the tp group's first rank (it reaches
    that bias on every rank; counted k times otherwise), and the returned
    loss is the mean over dp — the whole batch's."""
    dp = axis_size(mesh, "dp")
    first = axis_rank(mesh, "tp") == 0

    def reduce(model, loss, grads):
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in grads])
        if dp > 1:
            dist.all_reduce(flat, group=mesh.get_group("dp"))
            flat = flat / dp
        out, off = [], 1
        for (name, _), g in zip(model.named_parameters(), grads):
            g = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
            out.append(torch.zeros_like(g) if not first
                       and name in getattr(model, "row_biases", ()) else g)
        return flat[0], out

    return steps.make_train_step(loss_fn, tx, reduce)


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

def _local(x, mesh: DeviceMesh):
    """This dp rank's slice of ``x``'s leading axis (tensors; dicts, lists
    and tuples of them)."""
    if isinstance(x, dict):
        return {key: _local(v, mesh) for key, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_local(v, mesh) for v in x)
    n, dp = x.shape[0], axis_size(mesh, "dp")
    if n % dp:
        raise ValueError(f"batch of {n} does not split over dp = {dp}")
    return x.narrow(0, axis_rank(mesh, "dp") * (n // dp), n // dp)


def shard_batch(batch, mesh: DeviceMesh):
    """The leading (batch) axis of every leaf split over dp: this rank's
    slice."""
    return _local(batch, mesh)


def replicated(tree, mesh: DeviceMesh):
    """``tree`` (a tensor, an ``nn.Module``, or dicts, lists and tuples of
    tensors) with every tensor equal to the one of the mesh's first rank
    (a broadcast; the input is not changed)."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().contiguous().clone()
        dist.broadcast(t, src=src)
        return t

    if isinstance(tree, torch.nn.Module):
        out = copy.deepcopy(tree)
        with torch.no_grad():
            for p in list(out.parameters()) + list(out.buffers()):
                p.copy_(bcast(p))
        return out
    if isinstance(tree, dict):
        return {key: replicated(v, mesh) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicated(v, mesh) for v in tree)
    return bcast(tree)


def dp_shard_map(fn: Callable, mesh: DeviceMesh,
                 batch_argnums: Sequence[int] = (1, 2)) -> Callable:
    """``fn`` run data-parallel over the mesh's dp axis.

    The arguments at ``batch_argnums`` are split on their leading axis over
    dp; the others are passed whole; the output (a tensor, or a tuple of
    them) is gathered over dp along its leading axis, whole on every
    rank. Inside ``fn`` each rank sees its local batch (B / dp), as
    ``jax.shard_map`` gives each device its block: this is the multi-card
    wrapper of the kernel paths, whose wrappers take local tensors."""
    batch_argnums = tuple(batch_argnums)

    def wrapped(*args):
        local = [_local(a, mesh) if i in batch_argnums else a
                 for i, a in enumerate(args)]
        out = fn(*local)
        if isinstance(out, tuple):
            return tuple(gather(o, mesh, "dp") for o in out)
        return gather(out, mesh, "dp")

    return wrapped
