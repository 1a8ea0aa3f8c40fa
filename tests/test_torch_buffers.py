"""The buffers that the attention and chain wrappers hand to their kernels,
and the tensors they return, are float32 whatever torch's default dtype.

The kernels write fp32 through ``data_ptr``: a buffer allocated in the
default dtype would, under ``torch.set_default_dtype(torch.float64)``, hold
fp32 bits read as float64, wrong values with nothing raised. The tests run
the wrappers' CUDA branches on CPU tensors against a stand-in library
(nothing is built, nothing is written), record every tensor the wrappers
allocate, and look up each pointer handed to the library among those
tensors and the inputs. Imports no JAX.
"""

import contextlib

import pytest
import torch

from transformer_mm_explainability_tpu_torch.ops import _build
from transformer_mm_explainability_tpu_torch.ops import flash_attention as tfa
from transformer_mm_explainability_tpu_torch.ops import relevancy_pallas as trp
from test_torch_kernels_cuda import chain_inputs, flash_inputs


class _StandIn:
    """Records each entry-point call; returns 0 (success), or what the size
    queries need."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        answers = {"tmx_max_dh": 128, "tmx_smem_optin": 232448,
                   "tmx_attn_smem": 1000, "tmx_attn_smem_bf16": 1000}

        def call(*args):
            self.calls.append((name, args))
            return answers.get(name, 0)
        return call


@pytest.fixture
def float64_default():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


@pytest.fixture
def stand_in(monkeypatch, float64_default):
    """The CUDA branch on CPU tensors, and every tensor that torch's
    factories make meanwhile (``made``)."""
    lib = _StandIn()
    monkeypatch.setattr(_build, "on_cpu", lambda x: False)
    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(_build, "stream", lambda dev: 0)
    monkeypatch.setattr(_build, "on_device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(tfa, "_libs", {})
    monkeypatch.setattr(tfa, "_accepted", set())
    lib.made = []
    for factory in ("empty", "zeros", "ones", "eye", "empty_like",
                    "zeros_like", "full"):
        real = getattr(torch, factory)

        def made(*args, _real=real, **kw):
            t = _real(*args, **kw)
            lib.made.append(t)
            return t
        monkeypatch.setattr(torch, factory, made)
    return lib


def _owner(ptr: int, tensors):
    for t in tensors:
        start = t.untyped_storage().data_ptr()
        if start <= ptr < start + t.untyped_storage().nbytes():
            return t
    return None


def _buffers(lib, inputs):
    """(name, dtype) of each tensor whose memory a library call received,
    found by the pointer's address among the inputs and the tensors made
    during the call."""
    seen = []
    for name, args in lib.calls:
        for arg in args:
            if isinstance(arg, int) and not isinstance(arg, bool):
                t = _owner(arg, list(inputs) + lib.made)
                if t is not None:
                    seen.append((name, t.dtype))
    return seen


FLASH_CASES = [("flash_bwd_ehat", False), ("flash_bwd_ehat", True),
               ("flash_bwd_ehat_qkv", False), ("flash_bwd_ehat_qkv", True),
               ("flash_fwd", False), ("flash_fwd", True)]


@pytest.mark.parametrize("wrapper,fast_dots", FLASH_CASES)
def test_flash_buffers_are_float32_under_a_float64_default(
        stand_in, wrapper, fast_dots):
    """The attention wrappers (#5, #6, #8; fp32 kernels and fast_dots) on
    float32 tensors: every buffer handed to the library is float32 (the
    bf16 forward's packed slots bfloat16), and so is every tensor
    returned."""
    f = {k: torch.from_numpy(v) for k, v in
         flash_inputs(2, 3, 17, 16).items()}
    if wrapper == "flash_bwd_ehat":
        out = tfa.flash_bwd_ehat(f["q"], f["k"], f["v"], f["dout"], f["r"],
                                 fast_dots=fast_dots)
    elif wrapper == "flash_bwd_ehat_qkv":
        out = tfa.flash_bwd_ehat_qkv(f["qkv"], f["dmerged"], f["r"], 3,
                                     fast_dots=fast_dots)
    else:
        out = (tfa.flash_fwd(f["q"], f["k"], f["v"], fast_dots=fast_dots),)
    assert all(t.dtype == torch.float32 for t in out)
    seen = _buffers(stand_in, f.values())
    packed = torch.bfloat16 if wrapper == "flash_fwd" and fast_dots else None
    assert {dt for _, dt in seen} <= {torch.float32, packed}, seen
    # q, k, v (and dout, r, the outputs and the scratch) all reached it
    assert len(seen) >= 4, seen


@pytest.mark.parametrize("start_layer", [0, 1, 3])
def test_chain_buffers_are_float32_under_a_float64_default(stand_in,
                                                           start_layer):
    """The chain (#9) on float32 captures: Ê and both R buffers handed to
    the library are float32, and so is the [B, S, S] result; past the last
    layer (``first == L``) nothing is launched and R = I comes back
    float32."""
    cams, grads = (torch.from_numpy(x) for x in chain_inputs(2, 3, 2, 9))
    got = trp.self_attention_relevancy_pallas(cams, grads, start_layer)
    assert got.dtype == torch.float32 and got.shape == (2, 9, 9)
    seen = _buffers(stand_in, (cams, grads))
    if start_layer == 3:
        assert not stand_in.calls
        assert torch.equal(got, torch.eye(9, dtype=torch.float32).expand(
            2, 9, 9))
        return
    (name, _), = stand_in.calls
    assert name == "tmx_relevancy_chain"
    assert [dt for _, dt in seen] == [torch.float32] * 5, seen


def test_stand_in_sees_a_default_dtype_buffer():
    """The check above can fail: a buffer allocated without a dtype under a
    float64 default is float64, and ``_buffers`` reports it."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        lib = _StandIn()
        lib.made = [torch.empty(8)]
        lib.calls.append(("tmx_x", (lib.made[0].data_ptr(), 3)))
        assert _buffers(lib, ()) == [("tmx_x", torch.float64)]
    finally:
        torch.set_default_dtype(old)
