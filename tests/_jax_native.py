"""The JAX package's native library, built into a private directory.

The JAX loader builds ``libtmmx_native.so`` beside its sources, and the
suite's worker processes would otherwise race to write that one file (one
could load it half-written). The port's tests that compare against the
JAX module build it once per test module into a directory of their own.
"""

import contextlib
import os

import pytest


@contextlib.contextmanager
def private_jax_native(directory):
    """The JAX ``native`` module with its library built in ``directory``,
    for the duration of the context."""
    from transformer_mm_explainability_tpu import native as jnative

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH",
                   os.path.join(str(directory), "libtmmx_native.so"))
        mp.setattr(jnative, "_lib", None)
        jnative.lib()
        yield jnative
