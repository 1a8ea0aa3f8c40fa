"""The port's relevancy chain (ops/relevancy_pallas.py) against the JAX
package's Pallas kernel.

On the CPU the wrapper and the dispatcher run the plain chain; both are
held to the JAX kernel in interpret mode at the shapes of
tests/test_pallas.py (S = 37 and 128, which JAX pads to 128 and the port
does not, and ``start_layer=2``). The CUDA kernels are held to the plain
chain on the card by tests/test_torch_kernels_cuda.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.ops import relevancy_pallas as jrp
from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import relevancy_pallas as trp
from test_torch_kernels_cuda import chain_inputs

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {"S37": ((2, 3, 4, 37), 0), "S128": ((2, 3, 4, 128), 0),
         "start2": ((1, 4, 2, 16), 2)}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(cams, grads, start_layer, the JAX kernel's [B, S, S])."""
    shape, start = CASES[name]
    cams, grads = chain_inputs(*shape)
    want = np.asarray(jrp.self_attention_relevancy_pallas(
        jnp.asarray(cams), jnp.asarray(grads), start_layer=start,
        interpret=True))
    return cams, grads, start, want


@pytest.mark.parametrize("fn", ["self_attention_relevancy_pallas",
                                "self_attention_relevancy_auto",
                                "self_attention_relevancy_pallas_plain"])
@pytest.mark.parametrize("case", list(CASES))
def test_chain_matches_pallas(case, fn):
    cams, grads, start, want = _case(case)
    got = getattr(trp, fn)(torch.from_numpy(cams), torch.from_numpy(grads),
                           start_layer=start)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("fn", ["self_attention_relevancy_pallas",
                                "self_attention_relevancy_auto",
                                "self_attention_relevancy_pallas_plain"])
def test_chain_past_last_layer_is_identity(fn):
    """start_layer = L folds no layer: R = I, as in the JAX chain."""
    cams, grads = chain_inputs(2, 3, 2, 9)
    want = np.asarray(jrp.self_attention_relevancy_auto(
        jnp.asarray(cams), jnp.asarray(grads), start_layer=3))
    np.testing.assert_array_equal(want, np.broadcast_to(np.eye(9), (2, 9, 9)))
    got = getattr(trp, fn)(torch.from_numpy(cams), torch.from_numpy(grads),
                           start_layer=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_chain_takes_plain_path_without_launch_or_build():
    trp.reset_launch_counts()
    cams, grads = map(torch.from_numpy, chain_inputs(1, 2, 2, 5))
    trp.self_attention_relevancy_auto(cams, grads)
    assert trp.launch_counts() == {"self_attention_relevancy_pallas": 0}
    assert "relevancy_chain" not in _build._loaded


def test_chain_other_devices_raise():
    t = torch.zeros((1, 2, 2, 5, 5), device="meta")
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        trp.self_attention_relevancy_pallas(t, t)
