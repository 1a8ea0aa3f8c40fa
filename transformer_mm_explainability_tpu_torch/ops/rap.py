"""RAP (Relative Attributing Propagation) relevance rules, in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/ops/rap.py``: the
per-op ``RAP_relprop`` rules of the reference's richest op copy
(DETR/modules/layers.py: RelPropSimple:69-92, Clone:272-302, Cat:319-343,
BatchNorm2d:369-407, Linear:439-533, Conv2d:585-664). No reference entry
point calls RAP, and no model path of this package does: these are the op
rules alone.

The layouts are the JAX package's, so that both take the same arrays:
linear weights ``[in, out]`` (y = x @ w + b), convolutions NHWC with HWIO
weights (``F.conv2d`` runs on permuted views). The reference's
idiosyncrasies are kept: Clone's RAP takes the PRODUCT of the positive-
and negative-part cotangents (:291); RelPropSimple's RAP scales every
input by the cotangent of the FIRST input (:73). The "first propagation"
switch that the reference infers from ``R_p.max() == 1`` (:520) is an
explicit ``first=`` argument. Every sum is per example (over all axes but
the leading one).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from transformer_mm_explainability_tpu_torch.ops.lrp import safe_divide


def _vjp(f: Callable, xs: Sequence[torch.Tensor], S: torch.Tensor
         ) -> List[torch.Tensor]:
    """Cotangents of ``f`` at ``xs`` with seed ``S`` (the reference's
    gradprop)."""
    leaves = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        return list(torch.autograd.grad(f(*leaves), leaves, S))


def _vjp1(f: Callable, x: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    return _vjp(f, [x], S)[0]


def _value(f: Callable, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    with torch.no_grad():
        return f(*xs)


# ---------------------------------------------------------------------------
# generic ops
# ---------------------------------------------------------------------------

def rap_simple(f: Callable, xs: Sequence[torch.Tensor], R_p: torch.Tensor
               ) -> List[torch.Tensor]:
    """RelPropSimple.RAP_relprop (layers.py:69-92): Sp = R_p/Z, then every
    input scaled by the cotangent of the FIRST input."""
    Sp = safe_divide(R_p, _value(f, xs))
    Cp = _vjp(f, xs, Sp)[0]
    return [x * Cp for x in xs]


def rap_add(x1: torch.Tensor, x2: torch.Tensor, R_p: torch.Tensor
            ) -> List[torch.Tensor]:
    """Add inherits RelPropSimple's RAP (layers.py:194, :69-92)."""
    return rap_simple(torch.add, (x1, x2), R_p)


def rap_clone(x: torch.Tensor, R_ps: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """Clone.RAP_relprop (layers.py:272-302): each consumer's relevance
    split into +/- parts, both cotangent sums accumulated, combined as
    X * (Cpp * Cpn)."""
    Cpp = sum(safe_divide(rp.clamp(min=0.0), x) for rp in R_ps)
    Cpn = sum(safe_divide(rp.clamp(max=0.0), x) for rp in R_ps)
    return x * (Cpp * Cpn)


def rap_cat(xs: Sequence[torch.Tensor], dim: int, R_p: torch.Tensor
            ) -> List[torch.Tensor]:
    """Cat.RAP_relprop (layers.py:319-343)."""
    f = lambda *a: torch.cat(a, dim=dim)
    Cps = _vjp(f, xs, safe_divide(R_p, _value(f, xs)))
    return [x * cp for x, cp in zip(xs, Cps)]


# ---------------------------------------------------------------------------
# BatchNorm2d (frozen / eval semantics, NHWC)
# ---------------------------------------------------------------------------

def rap_batchnorm2d(R_p: torch.Tensor, x: torch.Tensor,
                    weight: torch.Tensor, running_var: torch.Tensor,
                    eps: float, bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """BatchNorm2d.RAP_relprop (layers.py:369-407), NHWC. The channel gain
    is the reference's w / sqrt(running_var**2 + eps), the VARIANCE
    squared (:378-380); the bias mass is peeled off over the nonzero
    support of R_p per (N, C) slice (:382-386) and propagated through the
    same gain (:390-393)."""
    w_eff = weight / torch.sqrt(running_var ** 2 + eps)

    def f(R):
        return x * (safe_divide(R, x * w_eff) * w_eff)

    if bias is None:
        return f(R_p)
    nz = (R_p != 0).to(R_p.dtype)
    bias_p = safe_divide(bias * nz, nz.sum(dim=(1, 2), keepdim=True))
    return f(R_p - bias_p) + f(bias_p)


# ---------------------------------------------------------------------------
# Linear ([..., in] @ [in, out] + b)
# ---------------------------------------------------------------------------

def _shift_rel(R: torch.Tensor, R_val: torch.Tensor, dims) -> torch.Tensor:
    """shift_rel (layers.py:440-444 / :586-591): the surplus R_val taken
    evenly off R's nonzero support along ``dims``."""
    nz = (R != 0).to(R.dtype)
    return R - safe_divide(R_val, nz.sum(dim=dims, keepdim=True)) * nz


def _pos_prop(R, fa1, fa2, x1, dims, conv: bool):
    """pos_prop (layers.py:446-462, conv :593-609). The conv copy seeds
    C1n with R_neg·mask / Za2 through fa2 (:598-599), the linear copy with
    / Za1 through fa1."""
    Za1, Za2 = _value(fa1, [x1]), _value(fa2, [x1])
    R_pos, R_neg = R.clamp(min=0.0), R.clamp(max=0.0)
    mask = safe_divide(Za1 + Za2, Za1 + Za2)
    share2 = safe_divide(Za2, Za1 + Za2)
    C1 = x1 * _vjp1(fa1, x1, safe_divide(R_pos * mask, Za1))
    if conv:
        C1n = x1 * _vjp1(fa2, x1, safe_divide(R_neg * mask, Za2))
    else:
        C1n = x1 * _vjp1(fa1, x1, safe_divide(R_neg * mask, Za1))
    C2 = x1 * _vjp1(fa2, x1, safe_divide(R_pos * share2, Za2))
    C2n = x1 * _vjp1(fa2, x1, safe_divide(R_neg * share2, Za2))
    C = (C1 + C2) + (C2n + C1n)
    return _shift_rel(C, C.sum(dim=dims, keepdim=True)
                      - R.sum(dim=dims, keepdim=True), dims)


def _dual_prop(R, op, pw, nw, px, nx, dims, conv: bool):
    """f (layers.py:464-475): activator / inhibitor decomposition."""
    R_nz = (R != 0).to(R.dtype)
    fa1 = lambda t: op(t, pw) * R_nz
    fa2 = lambda t: -op(t, nw) * R_nz
    fb1 = lambda t: -op(t, pw) * R_nz
    fb2 = lambda t: op(t, nw) * R_nz
    return (_pos_prop(R, fa1, fa2, px, dims, conv)
            + _pos_prop(R, fb1, fb2, nx, dims, conv))


def rap_linear(R_p: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None,
               first: bool = False) -> torch.Tensor:
    """Linear.RAP_relprop (layers.py:439-533). ``first=True`` is the
    reference's "first propagation" branch (:520-526): sign-decomposed
    forward mass, bias split, redistribution. Otherwise the dual pos_prop
    flows (:528-531)."""
    pw, nw = w.clamp(min=0.0), w.clamp(max=0.0)
    px, nx = x.clamp(min=0.0), x.clamp(max=0.0)
    if first:
        return _linear_first_prop(R_p, px, nx, pw, nw, b)
    return _dual_prop(R_p, torch.matmul, pw, nw, px, nx, -1, conv=False)


def _linear_first_prop(pd, px, nx, pw, nw, b):
    """first_prop + redistribute (layers.py:477-518)."""
    Z1, Z2, Z3, Z4 = px @ pw, px @ nw, nx @ pw, nx @ nw
    Rpp, Rpn, Rnp, Rnn = Z1 * pd, Z2 * pd, Z3 * pd, Z4 * pd
    Pos = (Rpp + Rnn).sum(dim=-1, keepdim=True)
    Neg = (Rpn + Rnp).sum(dim=-1, keepdim=True)
    C1 = px * (safe_divide(Rpp, Z1) @ pw.T)
    C2 = px * (safe_divide(Rpn, Z2) @ nw.T)
    C3 = nx * (safe_divide(Rnp, Z3) @ pw.T)
    C4 = nx * (safe_divide(Rnn, Z4) @ nw.T)
    bp = b * pd * safe_divide(Pos, Pos + Neg)
    bn = b * pd * safe_divide(Neg, Pos + Neg)
    Cb1 = px * (safe_divide(bp, Z1) @ pw.T)
    Cb2 = px * (safe_divide(bn, Z2) @ nw.T)
    Rp_tmp = C1 + C4 + Cb1 + C2 + C3 + Cb2
    # redistribute (:507-513): (Rp - Rn) / |R|_tot · ΣR
    Rp, Rn = Rp_tmp.clamp(min=0.0), Rp_tmp.clamp(max=0.0)
    R_tot = (Rp - Rn).sum(dim=-1, keepdim=True)
    total = (Rp + Rn).sum(dim=-1, keepdim=True)
    return safe_divide(Rp - Rn, R_tot) * total


# ---------------------------------------------------------------------------
# Conv2d (NHWC, HWIO)
# ---------------------------------------------------------------------------

def _conv(x: torch.Tensor, w: torch.Tensor, stride, padding
          ) -> torch.Tensor:
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (padding, padding) if isinstance(padding, int) else tuple(padding)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=s,
                 padding=p)
    return y.permute(0, 2, 3, 1)


def rap_conv2d(R_p: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
               stride=1, padding=0, first: Optional[bool] = None
               ) -> torch.Tensor:
    """Conv2d.RAP_relprop (layers.py:585-664), NHWC / HWIO.

    ``first`` is the zB input-layer rule (:639-655); the reference picks
    it when the input has 3 channels (:662). 1×1-high kernels take the
    |x|·|w| rule (:612-618); the others the dual pos_prop flows
    (:620-632)."""
    if first is None:
        first = x.shape[-1] == 3
    pw, nw = w.clamp(min=0.0), w.clamp(max=0.0)
    px, nx = x.clamp(min=0.0), x.clamp(max=0.0)
    conv = lambda t, k: _conv(t, k, stride, padding)

    if first:
        # final_backward (:639-655): zB rule bounded by each image's min
        # (L) and max (H) activation
        L = x.amin(dim=(1, 2, 3), keepdim=True).expand_as(x)
        H = x.amax(dim=(1, 2, 3), keepdim=True).expand_as(x)
        Sp = safe_divide(R_p, conv(x, w) - conv(L, pw) - conv(H, nw))
        g = lambda k: _vjp1(lambda t: conv(t, k), x, Sp)
        return x * g(w) - L * g(pw) - H * g(nw)

    if w.shape[0] == 1:  # the reference checks kernel height == 1 (:613)
        R_nz = (R_p != 0).to(R_p.dtype)
        xabs, wabs = x.abs(), w.abs()
        fabs = lambda t: conv(t, wabs) * R_nz
        S = safe_divide(R_p, _value(fabs, [xabs]))
        return xabs * _vjp1(fabs, xabs, S)

    return _dual_prop(R_p, conv, pw, nw, px, nx, (1, 2, 3), conv=True)
