"""LRP relevance-propagation rules (the "relprop" op library), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/ops/lrp.py``: each rule
is a pure function of the relevance ``R`` and the recorded inputs of the
op; the model-level passes (``models/{bert,lxmert,detr}_lrp.py``) walk the
layers in reverse and rematerialise each layer's internals from its taped
input.

Rule semantics (the reference's lxmert/lxmert/src/layers.py):
  safe_divide        :10-13
  RelPropSimple      :48-60  (Z=f(X); S=R/Z; C=vjp(S); out=X·C)
  Add (sum-conserving factor split)    :107-130
  Clone (sum of cotangents)            :161-179
  IndexSelect / Cat                    :139-157, 182-196
  Linear α-β (uniform S=R/(Z1+Z2))     :219-242, and layers_lrp.py's
  per-branch S1=R/Z1, S2=R/Z2 (BERT_orig_lrp's ``uniform=False``).

**The leading axis is the example axis.** The reference runs one sample
at a time, and its whole-tensor sums (the Add rule's three, DETR's value
collapse test) are sums over that one sample. Here every such sum reduces
over all axes but the leading one (``example_sum``), so each example of a
batch gets the reference's N=1 result whatever its batchmates. An operand
may carry a leading axis of 1 against a relevance batched over examples
(DETR's B=1 tape against K per-query relevances): its cotangent keeps the
relevance's leading axis, one per example, and is summed only over the
other axes the operand was broadcast along. At equal leading axes both
rules are exactly the JAX package's (``jax.vjp``) at batch size 1.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def safe_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with the reference's exact guard (layers.py:10-13):
    den = clamp(b, min=1e-9) + clamp(b, max=1e-9); +1e-9 where zero;
    result zeroed where b == 0."""
    den = b.clamp(min=1e-9) + b.clamp(max=1e-9)
    den = den + (den == 0).to(den.dtype) * 1e-9
    return a / den * (b != 0).to(b.dtype)


def example_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the leading (example) one, kept as 1s."""
    return x.reshape(x.shape[0], -1).sum(1).reshape(
        (x.shape[0],) + (1,) * (x.dim() - 1))


def _reduce_to(c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The cotangent ``c`` of a broadcast ``x``: summed over the axes that
    ``x`` lacks or holds as 1, but the leading (example) axis."""
    extra = c.dim() - x.dim()
    if extra:
        c = c.sum(dim=tuple(range(extra)))
    dims = tuple(i for i in range(1, c.dim())
                 if x.shape[i] == 1 and c.shape[i] != 1)
    return c.sum(dim=dims, keepdim=True) if dims else c


def relprop_simple(f: Callable, xs: Sequence[torch.Tensor],
                   R: torch.Tensor) -> List[torch.Tensor]:
    """Generic RelPropSimple, the cotangent from ``torch.autograd.grad``:
    any op whose relevance rule is X ⊙ ∇f·(R/Z) (index selections,
    concatenations)."""
    leaves = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        Z = f(*leaves)
        Cs = torch.autograd.grad(Z, leaves, safe_divide(R, Z.detach()),
                                 allow_unused=True)
    return [x * (torch.zeros_like(x) if c is None else c)
            for x, c in zip(xs, Cs)]


def matmul_relprop(a: torch.Tensor, b: torch.Tensor, R: torch.Tensor,
                   halve: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """RelPropSimple on ``a @ b``: S = R/Z, out ``a ⊙ (S bᵀ)`` and
    ``b ⊙ (aᵀ S)``. The attention relprops halve both outputs
    (lxmert_lrp.py:427-430, 443-445)."""
    S = safe_divide(R, a @ b)
    Ra = a * _reduce_to(S @ b.transpose(-1, -2), a)
    Rb = b * _reduce_to(a.transpose(-1, -2) @ S, b)
    if halve:
        return Ra / 2, Rb / 2
    return Ra, Rb


def add_relprop_simple(x1: torch.Tensor, x2: torch.Tensor, R: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain RelPropSimple on ``x1 + x2`` (the layers_lrp.py variant)."""
    S = safe_divide(R, x1 + x2)
    return x1 * _reduce_to(S, x1), x2 * _reduce_to(S, x2)


def add_relprop(x1: torch.Tensor, x2: torch.Tensor, R: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sum-conserving Add split (layers.py:107-130): RelPropSimple, then
    each branch renormalised so that the branch totals split R's total by
    their |mass|; every total is per example."""
    a, b = add_relprop_simple(x1, x2, R)
    a_sum, b_sum, r_sum = example_sum(a), example_sum(b), example_sum(R)
    tot = a_sum.abs() + b_sum.abs()
    a_fact = safe_divide(a_sum.abs(), tot) * r_sum
    b_fact = safe_divide(b_sum.abs(), tot) * r_sum
    return a * safe_divide(a_fact, a_sum), b * safe_divide(b_fact, b_sum)


def clone_relprop(x: torch.Tensor, Rs: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    """Clone: each consumer's R is divided by X and the cotangents sum
    (layers.py:161-179) → R = X · Σ (R_i / X)."""
    S = sum(safe_divide(r, x) for r in Rs)
    return x * S


def linear_alpha_beta(
    R: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
    alpha: float = 1.0, uniform: bool = True,
) -> torch.Tensor:
    """α-β LRP for y = x @ w (``[..., in] @ [in, out]``).

    ``uniform=True`` → S1 = S2 = R/(Z1+Z2) (lxmert layers.py:227-235 and
    layers_ours.py); ``uniform=False`` → per-branch S1 = R/Z1, S2 = R/Z2
    (layers_lrp.py). The bias is ignored by the rule, as in the reference.
    At α = 1 (β = 0) the inhibitor's term is 0 and is not computed."""
    beta = alpha - 1.0
    pw, nw = w.clamp(min=0.0), w.clamp(max=0.0)
    px, nx = x.clamp(min=0.0), x.clamp(max=0.0)

    def f(w1, w2):
        Z1, Z2 = px @ w1, nx @ w2
        if uniform:
            S1 = S2 = safe_divide(R, Z1 + Z2)
        else:
            S1, S2 = safe_divide(R, Z1), safe_divide(R, Z2)
        return px * (S1 @ w1.T) + nx * (S2 @ w2.T)

    activator = f(pw, nw)
    if beta == 0.0:
        return alpha * activator
    return alpha * activator - beta * f(nw, pw)


def index_select_relprop(x: torch.Tensor, dim: int, indices: torch.Tensor,
                         R: torch.Tensor) -> torch.Tensor:
    return relprop_simple(
        lambda a: torch.index_select(a, dim, indices), (x,), R)[0]


def cat_relprop(xs: Sequence[torch.Tensor], dim: int, R: torch.Tensor
                ) -> List[torch.Tensor]:
    return relprop_simple(lambda *a: torch.cat(a, dim=dim), xs, R)
