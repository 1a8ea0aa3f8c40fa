"""The port's helpers that keep the JAX package's public names, against
the JAX functions on the same inputs, on the CPU:
``utils/visualization.{make_grid, visualize_images, load_scalar_logs,
plot_logs}``, the thirteen ``utils/convert_mmf.*_from_sd`` layer
converters, ``utils/convert.stack`` and
``tools/bench_families.{pack_outputs, sustained_ms}``. (``native.build``'s
``force`` is in ``tests/test_torch_native.py``, ``parallel/mesh.make_mesh``'s
``devices`` in ``tests/test_torch_parallel.py``.)"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.tools import bench_families as jbench
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu.utils import convert_mmf as jmmf
from transformer_mm_explainability_tpu.utils import visualization as jvis
from transformer_mm_explainability_tpu_torch.tools import (
    bench_families as tbench)
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert
from transformer_mm_explainability_tpu_torch.utils import convert_mmf as tmmf
from transformer_mm_explainability_tpu_torch.utils import (
    visualization as tvis)


def _images(rng, n, h, w):
    return rng.rand(n, h, w, 3).astype(np.float32)


@pytest.mark.parametrize("n,nrow,padding,pad_value",
                         [(5, 2, 2, 0.0), (3, 8, 0, 1.0), (1, 1, 3, 0.5)])
def test_make_grid_equals_jax(n, nrow, padding, pad_value):
    images = _images(np.random.RandomState(n), n, 6, 7)
    got = tvis.make_grid(images, nrow, padding, pad_value)
    np.testing.assert_array_equal(
        got, jvis.make_grid(images, nrow, padding, pad_value))


def test_visualize_images_equals_jax():
    """Images at the target size tile exactly as in JAX (uint8 ones
    scaled by 1/255); one that the bicubic resize meets stays within 2e-2
    of JAX's (torch's antialiased bicubic against jax.image's cubic), with
    the grid's shape and padding equal."""
    rng = np.random.RandomState(0)
    same = [_images(rng, 1, 16, 16)[0],
            (rng.rand(16, 16, 3) * 255).astype(np.uint8)]
    np.testing.assert_allclose(tvis.visualize_images(same, (16, 16), 2),
                               jvis.visualize_images(same, (16, 16), 2),
                               rtol=0, atol=1e-7)
    smooth = np.broadcast_to(np.linspace(0, 1, 24, dtype=np.float32)
                             [None, :, None], (20, 24, 3)).copy()
    got = tvis.visualize_images(same + [smooth], (16, 16), 3)
    want = np.asarray(jvis.visualize_images(same + [smooth], (16, 16), 3))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    with pytest.raises(AssertionError):
        tvis.visualize_images(same, None)


def _logs(tmp_path):
    dirs = []
    for d, scale in (("a", 1.0), ("b", 2.0)):
        path = tmp_path / d
        path.mkdir()
        with open(path / "scalars.jsonl", "w") as f:
            for step in range(6):
                f.write(json.dumps({"step": step, "time": 1.5 * step,
                                    "loss": scale / (step + 1),
                                    "lr": 1e-3, "tag": "x"}) + "\n")
        dirs.append(str(path))
    return dirs


def test_load_scalar_logs_and_plot_logs_equal_jax(tmp_path):
    dirs = _logs(tmp_path)
    assert tvis.load_scalar_logs(dirs) == jvis.load_scalar_logs(dirs)
    assert tvis.load_scalar_logs(dirs[0]) == jvis.load_scalar_logs(dirs[0])
    for alpha in (0.0, 0.7):
        got = tvis.plot_logs(dirs, ("loss", "lr", "absent"), alpha)
        assert got == jvis.plot_logs(dirs, ("loss", "lr", "absent"), alpha)


def _wn(rng, sd, prefix, o, i, dim0=False):
    sd[f"{prefix}.weight_v"] = rng.randn(o, i)
    sd[f"{prefix}.weight_g"] = rng.randn(o, 1) if dim0 else rng.randn(1)[0]
    sd[f"{prefix}.bias"] = rng.randn(o)


def _lin(rng, sd, prefix, o, i):
    sd[f"{prefix}.weight"] = rng.randn(o, i)
    sd[f"{prefix}.bias"] = rng.randn(o)


def _cell(rng, sd, prefix, suffix, h, i, gates=4):
    for name, cols in (("weight_ih", i), ("weight_hh", h)):
        sd[f"{prefix}.{name}{suffix}"] = rng.randn(gates * h, cols)
    for name in ("bias_ih", "bias_hh"):
        sd[f"{prefix}.{name}{suffix}"] = rng.randn(gates * h)


def _bn(rng, sd, prefix, c):
    for name in ("weight", "bias", "running_mean"):
        sd[f"{prefix}.{name}"] = rng.randn(c)
    sd[f"{prefix}.running_var"] = rng.rand(c) + 0.5


def _state_dict():
    """One state dict holding every layer the converters read, under
    prefix "m" (float32 numpy)."""
    rng = np.random.RandomState(0)
    sd = {}
    _cell(rng, sd, "m.ate.recurrent_unit", "_l0", 4, 3)
    _cell(rng, sd, "m.ate.recurrent_unit", "_l0_reverse", 4, 3)
    for c in ("conv1", "conv2"):
        sd[f"m.ate.{c}.weight"] = rng.randn(5, 8, 1)
        sd[f"m.ate.{c}.bias"] = rng.randn(5)
    for fa in ("fa_image", "fa_txt", "fa_context"):
        _wn(rng, sd, f"m.nlem.{fa}.layers.0", 6, 4)
    for f in ("f_o_text", "f_o_image"):
        _wn(rng, sd, f"m.lc.{f}.layers.0", 6, 4)
    for f in ("linear_text", "linear_image"):
        _lin(rng, sd, f"m.lc.{f}", 3, 6)
    for i in (0, 2):
        _wn(rng, sd, f"m.fc.main.{i}", 5, 5, dim0=True)
    for net in ("v_net", "q_net"):
        _wn(rng, sd, f"m.bc.{net}.main.1", 6, 4, dim0=True)
        _wn(rng, sd, f"m.bia.logits.{net}.main.1", 6, 4, dim0=True)
    sd["m.bc.h_mat"] = rng.randn(1, 2, 1, 6)
    sd["m.bc.h_bias"] = rng.randn(1, 2, 1, 1)
    sd["m.bia.logits.h_mat_v"] = rng.randn(1, 2, 1, 6)
    sd["m.bia.logits.h_mat_g"] = rng.randn(1)
    sd["m.bia.logits.h_bias"] = rng.randn(1, 2, 1, 1)
    _wn(rng, sd, "m.wnc.main.0", 7, 5, dim0=True)
    _wn(rng, sd, "m.wnc.main.3", 3, 7, dim0=True)
    _lin(rng, sd, "m.mlp.layers.0", 6, 5)
    _bn(rng, sd, "m.mlp.layers.1", 6)
    _lin(rng, sd, "m.mlp.layers.4", 3, 6)
    sd["m.cn.conv.weight"] = rng.randn(4, 3, 3, 3)
    sd["m.cn.conv.bias"] = rng.randn(4)
    _bn(rng, sd, "m.cn.batch_norm_2d", 4)
    for f in ("fa_image", "fa_hidden"):
        _wn(rng, sd, f"m.td.{f}", 6, 5)
    _cell(rng, sd, "m.td.top_down_lstm", "", 5, 7)
    _wn(rng, sd, "m.ld.fc", 9, 5)
    _cell(rng, sd, "m.ld.language_lstm", "", 5, 8)
    for g in ("fa_image", "fa_txt"):
        _lin(rng, sd, f"m.pa.{g}.fc", 6, 4)
        _lin(rng, sd, f"m.pa.{g}.gate_fc", 6, 4)
    _lin(rng, sd, "m.pa.lc", 2, 6)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


CONVERTERS = {
    "attention_text_embedding_from_sd": (("m.ate",), {"bidirectional": True}),
    "nlem_from_sd": (("m.nlem",), {"has_context": True}),
    "logit_classifier_from_sd": (("m.lc",), {}),
    "fc_net_from_sd": (("m.fc", "ReLU"), {}),
    "bc_net_from_sd": (("m.bc", 3, 2), {}),
    "bi_attention_from_sd": (("m.bia", 2), {}),
    "weight_norm_classifier_from_sd": (("m.wnc",), {}),
    "mlp_classifier_from_sd": (("m.mlp",), {"num_layers": 1}),
    "conv_net_from_sd": (("m.cn",), {}),
    "top_down_attention_lstm_from_sd": (("m.td",), {}),
    "language_decoder_from_sd": (("m.ld",), {}),
    "gated_tanh_from_sd": (("m.pa.fa_image",), {}),
    "project_attention_from_sd": (("m.pa",), {}),
}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", list(CONVERTERS))
def test_layer_converters_equal_jax(name):
    """Each ``*_from_sd`` on one state dict: the same tree, the same
    values, float32 tensors on the device asked for."""
    args, kw = CONVERTERS[name]
    sd = _state_dict()
    want = dict(_leaves(getattr(jmmf, name)(sd, *args, **kw)))
    got = dict(_leaves(getattr(tmmf, name)(sd, *args, device="cpu", **kw)))
    assert got.keys() == want.keys(), name
    for k, t in got.items():
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[k]),
                                      err_msg=f"{name} {k}")


def test_stack_equals_jax():
    rng = np.random.RandomState(1)
    trees = [{"a": rng.randn(2, 3).astype(np.float32),
              "b": [rng.randn(4).astype(np.float32),
                    (rng.randn(1).astype(np.float32),)]} for _ in range(3)]
    want = dict(_leaves(jconvert.stack(trees)))
    got = dict(_leaves(tconvert.stack(trees)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    tensors = [{k: torch.from_numpy(v)} for t in trees
               for k, v in [("a", t["a"])]]
    np.testing.assert_array_equal(tconvert.stack(tensors)["a"],
                                  np.asarray(want[("a",)]))


def test_pack_outputs_equals_jax():
    """One flat float32 buffer, leaves in ``jax.tree.leaves``'s order
    (dict keys sorted; None no leaf)."""
    rng = np.random.RandomState(2)
    tree = {"z": rng.randn(2, 3).astype(np.float32),
            "a": [rng.randint(0, 9, (4,)).astype(np.int32), None,
                  (rng.randn(1).astype(np.float32), np.float32(2.5))],
            "m": rng.rand(2, 2) > 0.5}
    want = np.asarray(jbench.pack_outputs(jax.tree.map(jnp.asarray, tree)))
    got = tbench.pack_outputs({k: torch.as_tensor(v) if k == "z" else v
                               for k, v in tree.items()})
    assert got.dtype == torch.float32 and got.dim() == 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_sustained_ms_times_calls_as_jax():
    """The same calls as the JAX ``sustained_ms``: one warm call, then
    ``iters`` calls with every output read back; milliseconds a call."""
    calls = {"jax": 0, "port": 0}

    def fn(key, x):
        calls[key] += 1
        return x * 2

    j = jbench.sustained_ms(fn, ("jax", jnp.ones(3)), iters=5, depth=2)
    t = tbench.sustained_ms(fn, ("port", torch.ones(3)), iters=5, depth=2)
    assert calls == {"jax": 6, "port": 6}
    assert j > 0 and t > 0
