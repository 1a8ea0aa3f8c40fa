"""The port's semantic-validation tool (``tools/semantic_validation``)
against the JAX package's: the same task draws for a seed, the same check
logic, the same Adam step, and a cut-down sweep through the port's runners.

The port trains from the JAX tool's initial weights, shipped in
``data/assets/semantic_init.npz``; ``test_shipped_init_is_the_jax_tools_draw``
holds that file equal to the JAX tool's ``_vb_setup`` / ``_lx_setup``
draws, and running this file as a script rewrites it from them:

    python tests/test_torch_semantic_validation.py
"""

import jax
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.tools import semantic_validation as jsv
from transformer_mm_explainability_tpu_torch.tools import (
    semantic_validation as sv,
)
from transformer_mm_explainability_tpu_torch.utils import convert

JAX_SETUP = {"visual_bert": jsv._vb_setup, "lxmert": jsv._lx_setup}
PORT_SETUP = {"visual_bert": sv._vb_setup, "lxmert": sv._lx_setup}
FROM_JAX = {"visual_bert": convert.visual_bert_from_jax_numpy,
            "lxmert": convert.lxmert_from_jax_numpy}
# one Adam step: max|Δp| over max|p| of the whole tree (the LayerNorm
# scales, 1.0003) within 1e-5; measured 3.7e-6 (VisualBERT) and 1.0e-6
# (LXMERT). Per leaf it is not a bar: Adam's first step is lr·g/(|g| +
# 1e-8), so an element whose gradient is ~1e-8 moves by lr times a ratio
# that fp32 rounding of g shifts (a zero-initialised bias then differs by
# up to 1.6 of its own max). Every element that one step moves by more
# than lr/2 must move the same way in both.
STEP_BAR = 1e-5
LR = 3e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(params):
    """The JAX tree as ``{"a/b.field": array}`` (dict keys joined by "/",
    NamedTuple fields after a ".")."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = ""
        for p in path:
            if isinstance(p, jax.tree_util.DictKey):
                key += f"/{p.key}"
            else:
                assert isinstance(p, jax.tree_util.GetAttrKey), path
                key += f".{p.name}"
        out[key[1:]] = np.asarray(leaf)
    return out


def write_semantic_init(path=sv.INIT_PATH):
    arrays = {}
    for model, setup in JAX_SETUP.items():
        _, params, _, _ = setup()
        arrays.update({f"{model}/{k}": v for k, v in _flat(params).items()})
    np.savez_compressed(path, **arrays)


def _leaves(tree, path=""):
    """The port's tree as ``[(path, array)]`` in its order."""
    if torch.is_tensor(tree):
        return [(path, tree.detach().cpu().numpy())]
    items = (tree._asdict().items() if hasattr(tree, "_fields")
             else tree.items() if isinstance(tree, dict)
             else enumerate(tree))
    return [leaf for k, v in items for leaf in _leaves(v, f"{path}/{k}")]


@pytest.mark.parametrize("model", sorted(JAX_SETUP))
def test_shipped_init_is_the_jax_tools_draw(model):
    _, jparams, _, _ = JAX_SETUP[model]()
    want = _flat(jparams)
    got = _flat(sv.jax_init(model))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the setup trains from it
    cfg, params, _, _ = PORT_SETUP[model]("cpu")
    ref = FROM_JAX[model](sv.jax_init(model), cfg, "cpu")
    assert [k for k, _ in _leaves(params)] == [k for k, _ in _leaves(ref)]
    for (k, a), (_, b) in zip(_leaves(params), _leaves(ref)):
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("seed,n", [(0, 32), (5, 7)])
def test_task_batch_equals_jax(seed, n):
    ours, theirs = sv.CausalVQATask(seed=seed), jsv.CausalVQATask(seed=seed)
    np.testing.assert_array_equal(ours.color_vecs, theirs.color_vecs)
    np.testing.assert_array_equal(ours.marker_vecs, theirs.marker_vecs)
    a = ours.batch(np.random.RandomState(seed + 1), n)
    b = theirs.batch(np.random.RandomState(seed + 1), n)
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _sweep(method, positive, text, auc):
    return {"method": method, "positive": positive, "text_pert": text,
            "auc": auc}


@pytest.mark.parametrize("case", ["good", "flat", "no_control"])
def test_check_semantics_equals_jax(case):
    sweeps = []
    for text in (False, True):
        if case == "good":
            sweeps += [_sweep("ours_no_lrp", False, text, 0.9),
                       _sweep("ours_no_lrp", True, text, 0.2),
                       _sweep("random_control", False, text, 0.55),
                       _sweep("raw_attn", False, text, 0.85),
                       _sweep("rollout", False, text, 0.95)]
        elif case == "flat":
            sweeps += [_sweep("ours_no_lrp", False, text, 0.31),
                       _sweep("ours_no_lrp", True, text, 0.30),
                       _sweep("random_control", False, text, 0.305)]
        else:
            sweeps += [_sweep("ours_no_lrp", False, text, 0.8),
                       _sweep("ours_no_lrp", True, text, 0.6),
                       _sweep("attn_gradcam", False, text, 0.7)]
    got = sv.check_semantics(sweeps, "ours_no_lrp")
    assert got == jsv.check_semantics(sweeps, "ours_no_lrp")
    assert got["ok"] == (case == "good")


@pytest.mark.parametrize("model", sorted(JAX_SETUP))
def test_one_train_step_equals_optax(model):
    """One step of the port's ``train`` (torch.optim.Adam) from the JAX
    tool's initial weights equals one ``optax.adam`` step of the JAX
    tool's ``train`` on the same batch."""
    task = sv.CausalVQATask()
    jcfg, jparams, jscores, jto_mb = JAX_SETUP[model]()
    cfg, params, scores, to_mb = PORT_SETUP[model]("cpu")
    quiet = lambda *a: None
    jtrained, jinfo = jsv.train(task, jparams, jscores, jto_mb, max_steps=1,
                                printer=quiet)
    trained, info = sv.train(task, params, scores, to_mb, max_steps=1,
                             printer=quiet, device="cpu")
    assert info["train_steps"] == jinfo["train_steps"] == 1
    want = FROM_JAX[model](jax.tree.map(np.asarray, jtrained), cfg, "cpu")
    before = _leaves(FROM_JAX[model](sv.jax_init(model), cfg, "cpu"))
    got, want = _leaves(trained), _leaves(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    top = max(float(np.abs(ref).max()) for _, ref in want)
    moved = 0
    for (k, a), (_, ref), (_, old) in zip(got, want, before):
        assert float(np.abs(a - ref).max()) <= STEP_BAR * top, k
        step, ref_step = a - old, ref - old
        big = np.abs(ref_step) > LR / 2
        assert (np.sign(step[big]) == np.sign(ref_step[big])).all(), k
        moved += int(big.sum())
    assert moved > 0
    assert abs(info["eval_acc"] - jinfo["eval_acc"]) <= 2 / 512


@pytest.mark.parametrize("model", sorted(JAX_SETUP))
def test_run_sweeps_cut_down(model):
    """One method and 8 samples through the port's runners plus the
    random control: well-formed entries."""
    cfg, params, _, _ = PORT_SETUP[model]("cpu")
    sweeps = sv.run_sweeps(model, params, cfg, ["raw_attn"],
                           sv.CausalVQATask(), num_samples=8, batch_size=8,
                           printer=lambda *a: None, device="cpu")
    # 1 method x pos/neg x text/image + 2 controls
    assert len(sweeps) == 6
    assert [e["method"] for e in sweeps[-2:]] == ["random_control"] * 2
    for e in sweeps:
        assert len(e["step_accuracies"]) == len(e["steps"])
        assert all(0.0 <= a <= 1.0 for a in e["step_accuracies"])
        assert np.isfinite(e["auc"])
    assert sv.check_semantics(sweeps, "raw_attn")["checks"]


def test_entry_points_need_a_card_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sv.main(["--models", "visual_bert", "--max-train-steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        sv.run_family("lxmert", max_steps=1)


if __name__ == "__main__":
    write_semantic_init()
    print(f"wrote {sv.INIT_PATH}")
