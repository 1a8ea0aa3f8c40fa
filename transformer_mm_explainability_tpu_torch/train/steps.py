"""Training steps, optimizers and parameter trees.

Counterpart of ``transformer_mm_explainability_tpu/train/steps.py``. The
JAX package differentiates a params pytree with ``jax.value_and_grad`` and
updates it with an optax transformation; here:

  * a parameter tree is a tree of dicts, NamedTuples and lists whose leaves
    are tensors (LXMERT, DETR), or an ``nn.Module`` (ViT, whose leaves are
    its parameters). The leaves are updated in place;
  * a leaf requires grad only inside a step (``trainable``), so a model
    trained here still hands the explanation paths parameters that do not
    require grad: those paths take input cotangents only;
  * an optimizer factory (``make_adamw``, ``make_bert_adam``, the
    registered ones of ``train/schedulers``) returns a ``Recipe``, and
    ``recipe.init(params)`` the ``Optimizer`` over that tree's leaves, as
    ``tx.init(params)`` gives optax's state. An ``Optimizer`` clips the
    gradients by their global norm (optax's rule: scaled by max/‖g‖ only
    when ‖g‖ ≥ max), sets each param group's learning rate from the update
    count (optax evaluates a schedule at the count before the update, so
    the first update takes the schedule's value at 0), and steps a
    ``torch.optim`` optimizer: ``Adam``, ``SGD`` and ``BertAdam`` below
    take optax's (and the JAX BertAdam's) float32 arithmetic in its order,
    so that a step of the port and of the JAX package agree to rounding;
  * a step keeps the contract ``step(state, batch) -> (state, loss)``; it
    updates ``state`` in place and returns it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.nn.functional as F

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

class Attr(str):
    """A NamedTuple field or a module attribute in a leaf's path (JAX's
    ``GetAttrKey``); a plain ``str`` is a dict key, an ``int`` a list
    index."""


def tree_paths(tree, path: tuple = ()) -> List[Tuple[tuple, Any]]:
    """``(path, leaf)`` for every leaf, dict keys sorted as
    ``jax.tree_util`` sorts them. An ``nn.Module`` contributes its
    parameters, each under its dotted name split into ``Attr`` parts; a
    ``None`` is no leaf."""
    if isinstance(tree, torch.nn.Module):
        return [(path + tuple(Attr(p) for p in name.split(".")), t)
                for name, t in tree.named_parameters()]
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_paths(tree[k], path + (k,))]
    if hasattr(tree, "_fields"):
        return [item for f, v in zip(tree._fields, tree)
                for item in tree_paths(v, path + (Attr(f),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in tree_paths(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr``'s spelling: ``['key']``, ``.attr``,
    ``[index]``."""
    return "".join(f".{p}" if isinstance(p, Attr)
                   else f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """The tree with every leaf replaced by ``fn(path, leaf)`` (dicts,
    NamedTuples and lists rebuilt; ``None`` kept). An ``nn.Module`` is
    returned itself after ``fn`` has seen each of its parameters (for an
    ``fn`` that works in place)."""
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.named_parameters():
            fn(path + tuple(Attr(p) for p in name.split(".")), t)
        return tree
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (Attr(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def tree_map(fn: Callable, tree):
    """The tree with every tensor leaf replaced by ``fn(leaf)`` (other
    leaves kept)."""
    return tree_map_with_path(
        lambda _, x: fn(x) if torch.is_tensor(x) else x, tree)


@contextlib.contextmanager
def trainable(leaves: Sequence[torch.Tensor]) -> Iterator[None]:
    """The leaves require grad inside the block and return to their former
    flags after it."""
    flags = [t.requires_grad for t in leaves]
    try:
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            yield
    finally:
        for t, flag in zip(leaves, flags):
            t.requires_grad_(flag)


def value_and_grad(loss_fn: Callable, params, batch, has_aux: bool = False):
    """``jax.value_and_grad(loss_fn, has_aux)(params, batch)``: returns
    ``(loss, grads)`` or ``((loss, aux), grads)``, the loss and aux
    detached, ``grads`` one tensor per leaf of ``params`` in
    ``tree_leaves`` order, zeros where the loss does not reach the leaf."""
    leaves = tree_leaves(params)
    with trainable(leaves):
        out = loss_fn(params, batch)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    if has_aux:
        return (loss.detach(), tree_map(torch.Tensor.detach, out[1])), grads
    return loss.detach(), grads


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: unchanged when ‖g‖ < max_norm,
    else each gradient / ‖g‖ · max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else (lambda count, lr=lr: lr)


def _f32_power_gap(b: float, count: int) -> float:
    """1 − b^count in float32, as optax computes its bias corrections (the
    cancellation in 1 − 0.999^t moves float64's value by ~1e-5)."""
    b32 = torch.tensor(b, dtype=torch.float32)
    return float(1 - b32 ** torch.tensor(count, dtype=torch.int32))


def _sqrt(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Correctly rounded square roots, by way of float64: torch's
    vectorised float32 sqrt on the CPU is off by up to an ulp, where
    optax's (and numpy's) is exact."""
    return [x.double().sqrt_().to(x.dtype) for x in xs]


def _group(opt: torch.optim.Optimizer, group: dict):
    """(params, grads, per-param state) of the params with a gradient; the
    update count of the group, kept per param as ``step``."""
    ps = [p for p in group["params"] if p.grad is not None]
    return ps, [p.grad for p in ps], [opt.state[p] for p in ps]


class Adam(torch.optim.Optimizer):
    """``optax.adam`` / ``optax.adamw`` in float32, in optax's order:
    μ ← (1−b1)·g + b1·μ, ν ← (1−b2)·g² + b2·ν, u = μ̂ / (√ν̂ + eps) with
    the bias corrections in float32, u += wd·p (decoupled), p ← p − lr·u.
    ``torch.optim.AdamW`` is the same rule with float64 bias corrections,
    which differ from optax's by ~1e-5 of the update."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps, gs, sts = _group(self, group)
            if not ps:
                continue
            b1, b2 = group["betas"]
            for p, st in zip(ps, sts):
                if not st:
                    st.update(step=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
            mu = torch._foreach_add(torch._foreach_mul(gs, 1 - b1),
                                    torch._foreach_mul([s["mu"] for s in sts],
                                                       b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                torch._foreach_mul([s["nu"] for s in sts], b2))
            count = int(sts[0]["step"]) + 1
            u = torch._foreach_div(
                torch._foreach_div(mu, _f32_power_gap(b1, count)),
                torch._foreach_add(_sqrt(torch._foreach_div(
                    nu, _f32_power_gap(b2, count))), group["eps"]))
            if group["weight_decay"]:
                u = torch._foreach_add(
                    u, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_add_(ps, torch._foreach_mul(u, -group["lr"]))
            for st, m, n in zip(sts, mu, nu):
                st.update(step=count, mu=m, nu=n)


class SGD(torch.optim.Optimizer):
    """``optax.sgd`` after ``add_decayed_weights`` (a decay coupled to the
    gradient), in optax's order: g += wd·p; t ← g + m·t; u = g + m·t
    (Nesterov) or t; p ← p − lr·u."""

    def __init__(self, params, lr: float = 0.01, momentum: float = 0.0,
                 weight_decay: float = 0.0, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps, gs, sts = _group(self, group)
            if not ps:
                continue
            if group["weight_decay"]:
                gs = torch._foreach_add(
                    gs, torch._foreach_mul(ps, group["weight_decay"]))
            m = group["momentum"]
            if m:
                for p, st in zip(ps, sts):
                    if not st:
                        st["trace"] = torch.zeros_like(p)
                trace = torch._foreach_add(gs, torch._foreach_mul(
                    [s["trace"] for s in sts], m))
                for st, t in zip(sts, trace):
                    st["trace"] = t
                gs = (torch._foreach_add(gs, torch._foreach_mul(trace, m))
                      if group["nesterov"] else trace)
            torch._foreach_add_(ps, torch._foreach_mul(gs, -group["lr"]))


class BertAdam(torch.optim.Optimizer):
    """lxrt/optimization.py's BertAdam update without its schedule (the
    ``Optimizer`` sets each group's lr per update), in the JAX package's
    order: moments WITHOUT bias correction, m ← b1·m + (1−b1)·g,
    v ← b2·v + (1−b2)·g·g, p ← p − lr · (m / (√v + eps) + wd · p)."""

    def __init__(self, params, lr: float = 5e-5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps, gs, sts = _group(self, group)
            if not ps:
                continue
            b1, b2 = group["b1"], group["b2"]
            for p, st in zip(ps, sts):
                if not st:
                    st.update(m=torch.zeros_like(p), v=torch.zeros_like(p))
            m = torch._foreach_add(torch._foreach_mul([s["m"] for s in sts],
                                                      b1),
                                   torch._foreach_mul(gs, 1 - b1))
            v = torch._foreach_add(
                torch._foreach_mul([s["v"] for s in sts], b2),
                torch._foreach_mul(torch._foreach_mul(gs, 1 - b2), gs))
            u = torch._foreach_add(
                torch._foreach_div(m, torch._foreach_add(
                    _sqrt(v), group["eps"])),
                torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_add_(ps, torch._foreach_mul(u, -group["lr"]))
            for st, m_, v_ in zip(sts, m, v):
                st.update(m=m_, v=v_)


class Optimizer:
    """A ``torch.optim`` optimizer over one tree's leaves, with the
    recipe's global-norm clip and per-group learning-rate schedules;
    ``count`` is the number of updates applied."""

    def __init__(self, recipe: "Recipe", params):
        self.recipe = recipe
        self.leaves = tree_leaves(params)
        groups = (recipe.groups(params) if recipe.groups is not None
                  else [(None, {})])
        torch_groups, self._lr = [], []
        for mask, opts in groups:
            opts = dict(opts)
            ps = self.leaves if mask is None else \
                [t for t, m in zip(self.leaves, mask) if m]
            if not ps:
                continue
            lr = _as_schedule(opts.pop("lr", recipe.lr))
            self._lr.append(lr)
            torch_groups.append({"params": ps, "lr": lr(0), **opts})
        self.opt = recipe.make(torch_groups)
        self.count = 0

    def apply(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from one gradient per leaf."""
        if self.recipe.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.recipe.grad_clip)
        for p, g in zip(self.leaves, grads):
            p.grad = g
        for group, lr in zip(self.opt.param_groups, self._lr):
            group["lr"] = lr(self.count)
        self.opt.step()
        for p in self.leaves:
            p.grad = None
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """``{"count", "state": {leaf index: {name: tensor}}}``."""
        return {"count": self.count,
                "state": {i: dict(self.opt.state[p])
                          for i, p in enumerate(self.leaves)
                          if p in self.opt.state}}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        order = {id(p): j for j, p in enumerate(
            p for g in self.opt.param_groups for p in g["params"])}
        torch_sd = self.opt.state_dict()
        torch_sd["state"] = {order[id(self.leaves[int(i)])]: dict(st)
                             for i, st in sd["state"].items()}
        self.opt.load_state_dict(torch_sd)
        self.count = int(sd["count"])


@dataclasses.dataclass(frozen=True)
class Recipe:
    """An optimizer for any tree (optax's ``GradientTransformation``):
    ``make(param_groups)`` builds the ``torch.optim`` optimizer, ``lr`` is
    a learning rate or a schedule of the update count, ``grad_clip`` > 0
    clips by global norm first, and ``groups(params)``, when given, returns
    ``(leaf mask, group options)`` pairs (an option ``lr`` overrides the
    recipe's)."""
    make: Callable[[List[dict]], torch.optim.Optimizer]
    lr: Union[float, Schedule]
    grad_clip: float = 0.0
    groups: Optional[Callable[[Any], List[Tuple[Optional[List[bool]],
                                                dict]]]] = None

    def init(self, params) -> Optimizer:
        return Optimizer(self, params)


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` with end value 0, in float32
    as optax computes it: linear from ``init_value`` to ``peak_value``
    over the warmup, then peak · ½(1 + cos(π t / (decay_steps − warmup))),
    t counted from the warmup's end and held at its last value."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) \
                / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        span = f32(decay_steps - warmup_steps)
        t = min(f32(count - warmup_steps), span)
        return float(f32(peak_value) * (f32(0.5) * (f32(1) + np.cos(
            f32(math.pi) * t / span))))

    return schedule


def make_adamw(learning_rate: float = 5e-5, weight_decay: float = 1e-4,
               warmup_steps: int = 0, total_steps: int = 10000,
               grad_clip: float = 0.0) -> Recipe:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with optional linear warmup then
    cosine decay, and optional global-norm clip — the reference's optimizer
    family (VQA2 config: AdamW 5e-5 warmup 6000; DETR: AdamW + StepLR)."""
    lr = (warmup_cosine_decay(0.0, learning_rate, warmup_steps, total_steps)
          if warmup_steps > 0 else learning_rate)
    return Recipe(functools.partial(Adam, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=weight_decay),
                  lr, grad_clip)


def bert_adam_schedule(learning_rate: float, warmup: float,
                       total_steps: int) -> Schedule:
    """BertAdam's ``warmup_linear`` in float32, as the JAX package computes
    it: frac = min(step / total, 1); lr · frac / warmup below the warmup,
    lr · (1 − frac) / (1 − warmup) after (0 at step 0: the first update
    only fills the moments)."""
    f32 = np.float32

    def schedule(count: int) -> float:
        frac = min(f32(count) / f32(total_steps), f32(1.0))
        if frac < f32(warmup):
            return float(f32(learning_rate) * (frac / f32(warmup)))
        return float(f32(learning_rate)
                     * ((f32(1.0) - frac) / f32(1.0 - warmup)))

    return schedule


def make_bert_adam(learning_rate: float = 5e-5, warmup: float = 0.1,
                   total_steps: int = 10000, weight_decay: float = 0.01,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                   grad_clip: float = 1.0) -> Recipe:
    """BertAdam — the LXMERT finetune optimizer (lxrt/optimization.py):
    Adam WITHOUT bias correction, decoupled weight decay, linear warmup
    then linear decay ("warmup_linear"), global-norm clip at 1."""
    return Recipe(functools.partial(BertAdam, b1=b1, b2=b2, eps=eps,
                                    weight_decay=weight_decay),
                  bert_adam_schedule(learning_rate, warmup, total_steps),
                  grad_clip)


# ---------------------------------------------------------------------------
# States, losses and steps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Optimizer
    step: int


def init_state(params, tx: Recipe) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def soft_target_bce(scores: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """VQA soft-label binary cross-entropy (MMF's logit_bce — the VQA2
    training loss), mean over batch, summed over answers."""
    logp = F.logsigmoid(scores)
    lognp = F.logsigmoid(-scores)
    return -(targets * logp + (1 - targets) * lognp).sum(-1).mean()


Reduce = Callable[[Any, torch.Tensor, List[torch.Tensor]],
                  Tuple[torch.Tensor, List[torch.Tensor]]]


def _check_state(state: TrainState, tx: Recipe) -> None:
    if state.opt_state.recipe is not tx:
        raise ValueError("the state's optimizer was not made by this "
                         "step's tx (init_state(params, tx))")


def make_train_step(loss_fn: Callable[[Any, Dict[str, Any]], torch.Tensor],
                    tx: Recipe, reduce: Optional[Reduce] = None
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Tuple[TrainState, torch.Tensor]]:
    """A ``(state, batch) -> (state, loss)`` step: loss and gradients of
    every leaf, ``reduce(params, loss, grads) -> (loss, grads)`` if given
    (the collectives of a sharded step, ``parallel/mesh``), then one
    update of ``state`` in place."""

    def step(state: TrainState, batch):
        _check_state(state, tx)
        loss, grads = value_and_grad(loss_fn, state.params, batch)
        if reduce is not None:
            loss, grads = reduce(state.params, loss, grads)
        state.opt_state.apply(grads)
        state.step += 1
        return state, loss

    return step


def _micro(batches, i: int):
    if isinstance(batches, dict):
        return {k: _micro(v, i) for k, v in batches.items()}
    return batches[i]


def make_accum_train_step(loss_fn, tx: Recipe, accum_steps: int):
    """Gradient accumulation (reference: MMF ``update_frequency``,
    training_loop.py:77-107). Every leaf of ``batch`` gains a leading
    [accum_steps] axis; the micro-batch gradients are summed in order and
    divided by ``accum_steps``, and the loss is their mean."""

    def step(state: TrainState, batches):
        _check_state(state, tx)
        grads = [torch.zeros_like(t) for t in state.opt_state.leaves]
        total = 0.0
        for i in range(accum_steps):
            loss, g = value_and_grad(loss_fn, state.params,
                                     _micro(batches, i))
            grads = [a + b for a, b in zip(grads, g)]
            total = total + loss
        state.opt_state.apply([g / accum_steps for g in grads])
        state.step += 1
        return state, total / accum_steps

    return step


# ---------------------------------------------------------------------------
# BERT-style parameter groups
# ---------------------------------------------------------------------------

NO_DECAY_KEYS = {"b", "bias", "conv_b", "decoder_bias"}
NORM_SCOPES = {"ln", "layer_norm", "layernorm", "attn_ln", "mlp_ln",
               "ln0", "ln1", "ln_mha", "ln_fcn", "ln_f", "bn",
               "bn1", "bn2", "bn3"}


def _dict_keys(params, path: tuple) -> Tuple[str, ...]:
    """The dict keys of a leaf's path in the JAX tree: a module that keeps
    its parameters in the JAX package's layout under other names (the
    ViT's ``blocks.3.ln1_scale`` is ``['blocks']['ln1']['scale']``) says so
    by ``tree_keys(name)``; elsewhere the path's dict keys (a NamedTuple
    field is no key, as in JAX)."""
    if isinstance(params, torch.nn.Module) and hasattr(params, "tree_keys"):
        return tuple(params.tree_keys(".".join(path)))
    return tuple(p for p in path if type(p) is str)


def _decay(keys: Sequence[str]) -> bool:
    return not any(k in NO_DECAY_KEYS or k.lower() in NORM_SCOPES
                   for k in keys)


def bert_no_decay_mask(params) -> Dict[str, bool]:
    """get_bert_configured_parameters (mmf/utils/modeling.py:18-41):
    bias and LayerNorm parameters get weight_decay 0, by the JAX package's
    rule on the leaf's dict keys (a bias-like key or a norm-scope key).
    Returns ``{keystr(path): True}`` where decay APPLIES."""
    return {keystr(path): _decay(_dict_keys(params, path))
            for path, _ in tree_paths(params)}


def make_bert_optimizer(params, learning_rate: float = 5e-5,
                        weight_decay: float = 0.01,
                        finetune_lr_multiplier: float = 1.0,
                        classifier_key: str = "classifier",
                        schedule: Optional[Schedule] = None) -> Recipe:
    """get_optimizer_parameters_for_bert (mmf/utils/modeling.py:44-67):
    AdamW whose decay skips bias/LayerNorm leaves and, when
    ``finetune_lr_multiplier != 1``, every subtree but ``classifier_key``
    trained at lr × multiplier: param groups with ``weight_decay`` 0 and a
    scaled lr. A ``schedule`` (an absolute learning rate per update) sets
    every group's lr, the multiplier's too, as the JAX package's
    ``multi_transform`` does."""
    def groups(tree):
        paths = [p for p, _ in tree_paths(tree)]
        decay = [_decay(_dict_keys(tree, p)) for p in paths]
        top = [(_dict_keys(tree, p) or ("",))[0] for p in paths]
        out = []
        for is_cls in (True, False):
            lr = schedule if schedule is not None else (
                learning_rate if is_cls or finetune_lr_multiplier == 1.0
                else learning_rate * finetune_lr_multiplier)
            for d in (True, False):
                mask = [dk == d and ((t == classifier_key) == is_cls)
                        for dk, t in zip(decay, top)]
                out.append((mask, {"lr": lr,
                                   "weight_decay": weight_decay if d
                                   else 0.0}))
        return out

    return Recipe(functools.partial(Adam, betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=weight_decay),
                  learning_rate if schedule is None else schedule,
                  groups=groups)
