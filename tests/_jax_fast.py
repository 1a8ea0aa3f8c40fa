"""The JAX package's Pallas kernels with ``fast=True``, run in interpret mode.

The JAX wrappers force ``fast = fast_dots and not interpret``, so on the
CPU they never run the bf16-operand arithmetic of the chip. These builders
make the same ``pallas_call``s from the JAX kernel bodies and BlockSpecs
(``attn_block_pallas._fwd_kernel``, ``_bwd_kernel``, ``_mlp_fwd_kernel``,
``_mlp_bwd_kernel``, ``_wspecs``; ``flash_attention._fwd_kernel``,
``_bwd_kernel``, ``_fwd_kernel2``, ``_bwd_kernel2``) with ``fast=True`` and
``interpret=True``, with the JAX wrappers' signatures, so that
``tests/test_torch_fast_dots.py`` holds the port's ``fast_dots`` mode to
the JAX package's own arithmetic. Nothing in the JAX package changes: the
whole-path tests monkeypatch these in for its wrappers (``vit`` imports
the kernel modules inside each function).

One difference from the chip stays: under ``fast`` the MLP bodies take
the rational erf (``attn_block_pallas._erf``, |error| < 1.5e-7) where the
port keeps ``erff``; the tests' bars cover it.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from transformer_mm_explainability_tpu.ops import attn_block_pallas as jab
from transformer_mm_explainability_tpu.ops import flash_attention as jfa


def _row(t):
    return t.reshape(1, -1)


def _as_wrapper(fn):
    """``fn`` called as the JAX wrapper it stands for: its ``interpret``
    and ``fast_dots`` keywords (fixed here) dropped."""
    @functools.wraps(fn)
    def call(*args, interpret=None, fast_dots=None, **kw):
        return fn(*args, **kw)
    return call


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("nheads", "eps"))
def attn_block_fwd(x, w_qkv, b_qkv, w_out, b_out, ln_scale, ln_bias,
                   nheads, eps=1e-6):
    B, S, D = x.shape
    blk = pl.BlockSpec((1, S, D), lambda b: (b, 0, 0))
    return pl.pallas_call(
        functools.partial(jab._fwd_kernel, nheads=nheads, eps=eps, fast=True),
        out_shape=jax.ShapeDtypeStruct((B, S, D), x.dtype), grid=(B,),
        in_specs=[blk] + jab._wspecs(D), out_specs=blk, interpret=True,
    )(x, w_qkv, _row(b_qkv), w_out, _row(b_out), _row(ln_scale),
      _row(ln_bias))


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("nheads", "eps"))
def attn_block_bwd(x, cot_mid, r, w_qkv, b_qkv, w_out, ln_scale, ln_bias,
                   nheads, eps=1e-6):
    B, S, D = x.shape
    blk = pl.BlockSpec((1, S, D), lambda b: (b, 0, 0))
    rblk = pl.BlockSpec((1, 1, S), lambda b: (b, 0, 0))
    wspecs = jab._wspecs(D)
    del wspecs[3]
    cot_x, e_row = pl.pallas_call(
        functools.partial(jab._bwd_kernel, nheads=nheads, eps=eps, fast=True),
        out_shape=(jax.ShapeDtypeStruct((B, S, D), x.dtype),
                   jax.ShapeDtypeStruct((B, 1, S), jnp.float32)),
        grid=(B,), in_specs=[blk, blk, rblk] + wspecs,
        out_specs=(blk, rblk), interpret=True,
    )(x, cot_mid, r[:, None, :], w_qkv, _row(b_qkv), w_out, _row(ln_scale),
      _row(ln_bias))
    return cot_x, e_row[:, 0]


def _mlp_call(kernel, args, x_mid, n_blk, eps, chunks):
    B, S, D = x_mid.shape
    I = args[n_blk].shape[1]
    blk = pl.BlockSpec((1, S, D), lambda b: (b, 0, 0))
    c = lambda b: (0, 0)
    w_specs = [pl.BlockSpec((D, I), c), pl.BlockSpec((1, I), c),
               pl.BlockSpec((I, D), c)]
    tail = [pl.BlockSpec((1, D), c)] * (len(args) - n_blk - 3)
    return pl.pallas_call(
        functools.partial(kernel, eps=eps, fast=True, chunks=chunks),
        out_shape=jax.ShapeDtypeStruct((B, S, D), x_mid.dtype), grid=(B,),
        in_specs=[blk] * n_blk + w_specs + tail, out_specs=blk,
        interpret=True)(*args)


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("eps", "chunks"))
def mlp_block_fwd(x_mid, w1, b1, w2, b2, ln_scale, ln_bias, eps=1e-6,
                  chunks=8):
    return _mlp_call(jab._mlp_fwd_kernel,
                     (x_mid, w1, _row(b1), w2, _row(b2), _row(ln_scale),
                      _row(ln_bias)), x_mid, 1, eps, chunks)


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("eps", "chunks"))
def mlp_block_bwd(x_mid, cot_out, w1, b1, w2, ln_scale, ln_bias, eps=1e-6,
                  chunks=8):
    return _mlp_call(jab._mlp_bwd_kernel,
                     (x_mid, cot_out, w1, _row(b1), w2, _row(ln_scale),
                      _row(ln_bias)), x_mid, 2, eps, chunks)


@_as_wrapper
@jax.jit
def flash_fwd(q, k, v):
    B, H, S, Dh = q.shape
    blk = pl.BlockSpec((1, 1, S, Dh), lambda b, h: (b, h, 0, 0))
    return pl.pallas_call(
        functools.partial(jfa._fwd_kernel, scale=1.0 / (Dh ** 0.5),
                          fast=True),
        out_shape=jax.ShapeDtypeStruct((B, H, S, Dh), q.dtype), grid=(B, H),
        in_specs=[blk, blk, blk], out_specs=blk, interpret=True)(q, k, v)


@_as_wrapper
@jax.jit
def flash_bwd_ehat(q, k, v, dout, r):
    B, H, S, Dh = q.shape
    blk = pl.BlockSpec((1, 1, S, Dh), lambda b, h: (b, h, 0, 0))
    rblk = pl.BlockSpec((1, 1, S), lambda b, h: (b, 0, 0))
    eblk = pl.BlockSpec((1, 1, 1, S), lambda b, h: (b, h, 0, 0))
    grad = jax.ShapeDtypeStruct((B, H, S, Dh), q.dtype)
    dq, dk, dv, e_head = pl.pallas_call(
        functools.partial(jfa._bwd_kernel, scale=1.0 / (Dh ** 0.5),
                          nheads=H, fast=True),
        out_shape=(grad, grad, grad,
                   jax.ShapeDtypeStruct((B, H, 1, S), jnp.float32)),
        grid=(B, H), in_specs=[blk, blk, blk, blk, rblk],
        out_specs=(blk, blk, blk, eblk), interpret=True,
    )(q, k, v, dout, r[:, None, :])
    return dq, dk, dv, e_head[:, :, 0].sum(axis=1)


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("nheads",))
def flash_fwd_qkv(qkv, nheads):
    B, S, D3 = qkv.shape
    D = D3 // 3
    Dh = D // nheads
    hpp = jfa._heads_per_program(nheads, Dh, True)
    return pl.pallas_call(
        functools.partial(jfa._fwd_kernel2, nheads=nheads, hpp=hpp,
                          scale=1.0 / (Dh ** 0.5), fast=True),
        out_shape=jax.ShapeDtypeStruct((B, S, D), qkv.dtype),
        grid=(B, nheads // hpp),
        in_specs=[pl.BlockSpec((1, S, D3), lambda b, h: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, S, D), lambda b, h: (b, 0, 0)),
        interpret=True)(qkv)


@_as_wrapper
@functools.partial(jax.jit, static_argnames=("nheads",))
def flash_bwd_ehat_qkv(qkv, dout, r, nheads):
    B, S, D3 = qkv.shape
    D = D3 // 3
    Dh = D // nheads
    hpp = jfa._heads_per_program(nheads, Dh, True)
    dqkv, e_head = pl.pallas_call(
        functools.partial(jfa._bwd_kernel2, nheads=nheads, hpp=hpp,
                          scale=1.0 / (Dh ** 0.5), fast=True),
        out_shape=(jax.ShapeDtypeStruct((B, S, D3), qkv.dtype),
                   jax.ShapeDtypeStruct((B, nheads // hpp, 1, S),
                                        jnp.float32)),
        grid=(B, nheads // hpp),
        in_specs=[pl.BlockSpec((1, S, D3), lambda b, h: (b, 0, 0)),
                  pl.BlockSpec((1, S, D), lambda b, h: (b, 0, 0)),
                  pl.BlockSpec((1, 1, S), lambda b, h: (b, 0, 0))],
        out_specs=(pl.BlockSpec((1, S, D3), lambda b, h: (b, 0, 0)),
                   pl.BlockSpec((1, 1, 1, S), lambda b, h: (b, h, 0, 0))),
        interpret=True)(qkv, dout, r[:, None, :])
    return dqkv, e_head[:, :, 0].sum(axis=1)
