"""Shared pieces of the MMF-model parity tests (``test_torch_mmf_*``):
one weight tree both packages run, the JAX forward jitted, and the bar.

The tree is the port's init (a ``torch.Generator`` draw, cheap) turned into
numpy leaves in the JAX tree's classes, after its structure and shapes are
held to the JAX init's by ``jax.eval_shape`` (traced, never compiled: a
compiled JAX random init costs more than the forward it feeds). The port
then gets the same numpy tree through ``utils/convert.mmf_from_jax_numpy``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transformer_mm_explainability_tpu.ops import attention as jattn
from transformer_mm_explainability_tpu_torch.utils.convert import (
    mmf_from_jax_numpy,
)

K = jax.random.PRNGKey
REL = 1e-5
_JAX_NAMED = {cls._fields: cls for cls in (jattn.AttentionParams,
                                           jattn.CrossAttentionParams)}


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def ints(high, *shape, seed=0, low=0):
    return np.random.RandomState(seed).randint(low, high, shape)


def to_jax_np(tree):
    """A port tree → numpy leaves in the JAX package's classes."""
    if isinstance(tree, dict):
        return {k: to_jax_np(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return _JAX_NAMED[tuple(tree._fields)](*(to_jax_np(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return [to_jax_np(v) for v in tree]
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


def shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: torch.is_tensor(x))[0]
    return [(jax.tree_util.keystr(path), tuple(np.shape(leaf)))
            for path, leaf in flat]


def shared(jinit, tinit):
    """The numpy tree both sides run (see the module docstring)."""
    tree = to_jax_np(tinit())
    assert shapes(tree) == shapes(jax.eval_shape(jinit))
    return tree


def port(tree, family="mmf_zoo"):
    return mmf_from_jax_numpy(tree, family, device="cpu")


def jax_run(fn, *args, **static):
    """``fn(*args, **static)`` jitted, the keyword arguments static."""
    args = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, args)
    return jax.jit(functools.partial(fn, **static))(*args)


def torch_args(tree):
    if isinstance(tree, dict):
        return {k: torch_args(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(torch_args(v) for v in tree)
    return torch.as_tensor(tree) if isinstance(tree, np.ndarray) else tree


def close(got, want, rel=REL):
    """max|Δ| ≤ rel · max|want| over the finite entries; the others
    equal. Trees of tensors against trees of arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), (set(got), set(want))
        for k in want:
            close(got[k], want[k], rel)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, rel)
        return
    w = np.asarray(want)
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    assert g.shape == w.shape, (g.shape, w.shape)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(g[~fin], w[~fin])
    if fin.any():
        scale = max(float(np.abs(w[fin]).max()), 1e-30)
        err = float(np.abs(g[fin] - w[fin]).max())
        assert err <= rel * scale, (err, scale)
