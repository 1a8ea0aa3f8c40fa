"""Shared inputs of the training-path tests (``tests/test_torch_train_*.py``):
numpy weights in the JAX package's trees, the tiny ViT of
``tests/test_parallel.py`` on both sides, and the comparison bars."""

import jax
import numpy as np
import torch

from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.utils import convert

VIT_KW = dict(image_size=32, patch_size=8, width=64, depth=2, num_heads=4,
              mlp_ratio=4, num_classes=16)
JVIT = jvit.ViTConfig(**VIT_KW)
TVIT = tvit.ViTConfig(**VIT_KW)

# a train step: the loss per step within rtol 1e-5; each parameter within
# 1e-5 of its max|p| after the updates, which must have moved it by at
# least 100 times that
LOSS_RTOL = 1e-5
PARAM_BAR = 1e-5


def numpy_tree(shapes, seed: int = 0, scale: float = 0.05):
    """A tree of ``jax.ShapeDtypeStruct`` (``jax.eval_shape`` of an init)
    filled with numpy draws: ``scale`` · N(0, 1), LayerNorm scales
    1 + 0.1 · N(0, 1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def vit_weights(seed: int = 0):
    """(JAX ViT tree of numpy arrays, the port's ViT on the CPU) with the
    same weights."""
    shapes = jax.eval_shape(lambda: jvit.init_params(jax.random.PRNGKey(0),
                                                     JVIT))
    tree = numpy_tree(shapes, seed)
    return tree, convert.vit_from_jax_numpy(tree, TVIT, device="cpu")


def vit_batch(B: int = 8, seed: int = 0):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(B, 32, 32, 3).astype(np.float32),
            "labels": rng.randint(0, 16, (B,)).astype(np.int32)}


def zero_gradients(grads, rel: float = 1e-6):
    """Per leaf, the elements whose gradient is below ``rel`` of the
    largest gradient of the tree: zero by construction, up to rounding (an
    attention's key bias adds the same logit to a whole softmax row). Adam
    divides a gradient by its own magnitude, so such an element takes
    steps of up to lr whose sign rounding decides, in either package."""
    grads = [np.abs(np.asarray(g)) for g in grads]
    top = max(float(g.max()) for g in grads)
    return [g <= rel * top for g in grads]


def assert_params_close(got, want, before, bar: float = PARAM_BAR,
                        skip=None, step_bound: float = 0.0,
                        scale: str = "leaf"):
    """Each pair of tensors within ``bar`` · max|want| (of the leaf, or
    with ``scale="tree"`` of the whole tree), and the updates moved the
    tree: some leaf by at least 100 × ``bar`` of its own max|p| (a leaf
    that the loss does not reach moves by its weight decay alone).
    Elements in ``skip`` (``zero_gradients``) are held to ``step_bound``
    instead (the most the updates can move them)."""
    skip = skip if skip is not None else [None] * len(want)
    arrays = [[np.asarray(torch.as_tensor(x).detach()) for x in xs]
              for xs in (got, want, before)]
    tree_top = max(float(np.abs(w).max()) for w in arrays[1])
    moved = 0.0
    for g, w, b, sk in zip(*arrays, skip):
        top = float(np.abs(w).max())
        assert top > 0
        keep = np.ones(w.shape, bool) if sk is None else ~sk
        err = float(np.abs(g - w)[keep].max(initial=0.0))
        ref = tree_top if scale == "tree" else top
        assert err <= bar * ref, (err, ref)
        moved = max(moved, float(np.abs(w - b)[keep].max(initial=0.0)) / top)
        if sk is not None and sk.any():
            assert float(np.abs(g - b)[sk].max()) <= step_bound
    assert moved >= 100 * bar, moved
