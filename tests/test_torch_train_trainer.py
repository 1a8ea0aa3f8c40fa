"""The port's trainer, checkpoints, meters and loggers (``train/trainer``,
``train/checkpoint``, ``core/meter``, ``utils/logger``) against the JAX
package's, on the linear problem of ``tests/test_infra.py`` with a
different batch at every update.

Bars: the loss of every update within rtol 1e-5 of JAX's; the hooks, the
validation steps and the early stop identical; a run resumed from a
checkpoint equal to the uninterrupted one bit for bit; a save then restore
exact."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.core import meter as jmeter
from transformer_mm_explainability_tpu.train import checkpoint as jckpt
from transformer_mm_explainability_tpu.train import steps as jsteps
from transformer_mm_explainability_tpu.train import trainer as jtrainer
from transformer_mm_explainability_tpu.utils import logger as jlogger
from transformer_mm_explainability_tpu_torch.core import meter as tmeter
from transformer_mm_explainability_tpu_torch.ops.attention import (
    AttentionParams)
from transformer_mm_explainability_tpu_torch.train import checkpoint as tckpt
from transformer_mm_explainability_tpu_torch.train import steps as tsteps
from transformer_mm_explainability_tpu_torch.train import trainer as ttrainer
from transformer_mm_explainability_tpu_torch.utils import logger as tlogger

N_BATCHES = 16


def _problem():
    """(batches, initial params) of y = X·w_true + noise, numpy."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(3, 1).astype(np.float32)
    batches = []
    for _ in range(N_BATCHES):
        X = rng.randn(16, 3).astype(np.float32)
        y = X @ w_true + 0.1 * rng.randn(16, 1).astype(np.float32)
        batches.append({"x": X, "y": y})
    params = {"w": (0.1 * rng.randn(3, 1)).astype(np.float32),
              "b": np.zeros((1,), np.float32)}
    return batches, params


def _jax_loss(p, batch):
    return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()


def _port_loss(p, batch):
    return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()


class Recorder:
    """Both packages' hook surface, recording (hook, step, value)."""

    def __init__(self):
        self.events = []

    def on_train_start(self, trainer):
        self.events.append(("train_start", int(trainer.state.step), None))

    def on_train_end(self, trainer):
        self.events.append(("train_end", int(trainer.state.step), None))

    def on_update_start(self, trainer):
        self.events.append(("update_start", int(trainer.state.step), None))

    def on_update_end(self, trainer, loss):
        self.events.append(("update_end", int(trainer.state.step), loss))

    def on_validation_start(self, trainer):
        self.events.append(("validation_start", int(trainer.state.step),
                            None))

    def on_validation_end(self, trainer, metrics):
        self.events.append(("validation_end", int(trainer.state.step),
                            metrics["val/loss"]))

    def on_checkpoint(self, trainer, step):
        self.events.append(("checkpoint", step, None))


def _run(package, save_dir, batches, params, recorder, **cfg):
    """One trainer of ``package`` ("jax" or "torch") over the batches;
    validation on the first batch. Returns the trainer."""
    if package == "jax":
        mod, loss, to = jtrainer, _jax_loss, jnp.asarray
        tx = jsteps.make_adamw(5e-2, warmup_steps=3, total_steps=20)
        params = jax.tree.map(to, params)
        eval_fn = lambda p, val: {"val/loss": float(loss(p, val))}
    else:
        mod, loss, to = ttrainer, _port_loss, torch.tensor
        tx = tsteps.make_adamw(5e-2, warmup_steps=3, total_steps=20)
        params = {k: torch.tensor(v) for k, v in params.items()}

        def eval_fn(p, val):
            with torch.no_grad():
                return {"val/loss": float(loss(p, val))}

    cls = type(f"Rec{package}", (mod.Callback,), {
        k: getattr(Recorder, k) for k in dir(Recorder)
        if k.startswith("on_")})
    rec = cls()
    rec.events = recorder
    config = mod.TrainerConfig(save_dir=str(save_dir), **cfg)
    tr = mod.Trainer(loss, params, tx, config, eval_fn=eval_fn,
                     callbacks=[rec])
    tr.train(iter([{k: to(v) for k, v in b.items()} for b in batches]),
             {k: to(v) for k, v in batches[0].items()})
    return tr


CFG = dict(max_updates=12, evaluation_interval=3, checkpoint_interval=4,
           log_interval=5)


def _both(tmp_path, **cfg):
    batches, params = _problem()
    out = {}
    for package in ("jax", "torch"):
        events = []
        tr = _run(package, tmp_path / package, batches, params, events,
                  **cfg)
        out[package] = (tr, events)
    return out


def test_trainer_equals_jax_losses_and_hook_order(tmp_path):
    out = _both(tmp_path, **CFG)
    (jtr, jev), (ttr, tev) = out["jax"], out["torch"]
    assert [e[:2] for e in tev] == [e[:2] for e in jev]
    assert [e[0] for e in tev].count("update_end") == 12
    assert ("checkpoint", 8, None) in tev and tev[-1][0] == "train_end"
    jl = [e[2] for e in jev if e[0] in ("update_end", "validation_end")]
    tl = [e[2] for e in tev if e[0] in ("update_end", "validation_end")]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(ttr.state.params["w"].numpy(),
                               np.asarray(jtr.state.params["w"]), rtol=1e-5)
    # the same files: the meta json keys, ``latest``, the scalar lines
    for name in ("latest", "ckpt_12.meta.json"):
        assert os.path.exists(tmp_path / "torch" / name)
    jm = json.load(open(tmp_path / "jax" / "ckpt_12.meta.json"))
    tm = json.load(open(tmp_path / "torch" / "ckpt_12.meta.json"))
    assert set(tm) == set(jm) and tm["format"] == "npz"
    assert tm["step"] == 12 and tm["best_metric"] == pytest.approx(
        jm["best_metric"], rel=1e-5)
    lines = lambda p: [json.loads(x) for x in open(p / "scalars.jsonl")]
    jlines, tlines = lines(tmp_path / "jax"), lines(tmp_path / "torch")
    assert [sorted(x) for x in tlines] == [sorted(x) for x in jlines]
    assert [x["step"] for x in tlines] == [x["step"] for x in jlines]


def test_early_stopping_fires_at_the_same_update(tmp_path):
    """Watching the validation loss for a maximum while it falls: two bad
    evaluations after the first stop both trainers at the same update."""
    out = _both(tmp_path, max_updates=16, evaluation_interval=2,
                checkpoint_interval=100, log_interval=100,
                early_stop_patience=2, early_stop_minimize=False)
    (jtr, jev), (ttr, tev) = out["jax"], out["torch"]
    assert int(ttr.state.step) == int(jtr.state.step) == 6
    assert [e[:2] for e in tev] == [e[:2] for e in jev]
    assert ttr.early.best == pytest.approx(jtr.early.best, rel=1e-5)


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path):
    batches, params = _problem()
    cfg = dict(evaluation_interval=100, checkpoint_interval=100,
               log_interval=100)
    whole = _run("torch", tmp_path / "whole", batches, params, [],
                 max_updates=10, **cfg)
    _run("torch", tmp_path / "cut", batches[:4], params, [],
         max_updates=4, **cfg)
    resumed = ttrainer.Trainer(
        _port_loss, {k: torch.tensor(v) for k, v in params.items()},
        tsteps.make_adamw(5e-2, warmup_steps=3, total_steps=20),
        ttrainer.TrainerConfig(save_dir=str(tmp_path / "cut"),
                               max_updates=10, **cfg))
    assert resumed.resume() and resumed.state.step == 4
    assert resumed.state.opt_state.count == 4
    resumed.train(iter([{k: torch.tensor(v) for k, v in b.items()}
                        for b in batches[4:]]))
    assert resumed.state.step == whole.state.step == 10
    for k in ("w", "b"):
        assert torch.equal(resumed.state.params[k], whole.state.params[k])
    st_a = resumed.state.opt_state.state_dict()["state"]
    st_b = whole.state.opt_state.state_dict()["state"]
    for i in st_b:
        for name in ("mu", "nu"):
            assert torch.equal(st_a[i][name], st_b[i][name])


def test_non_finite_loss_raises(tmp_path):
    batches, params = _problem()
    params = dict(params, b=np.full((1,), np.inf, np.float32))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        _run("torch", tmp_path, batches, params, [], max_updates=3)


def _tree():
    rng = np.random.RandomState(5)
    r = lambda *s: rng.randn(*s).astype(np.float32)
    return {"enc": {"attn": AttentionParams(r(4, 12), r(12), r(4, 4), r(4)),
                    "layers": [{"w": r(3, 3)}, {"w": r(3, 3)}]},
            "head": {"w": r(4, 2), "b": r(2)}}


def _to_torch(tree):
    return jax.tree.map(torch.tensor, tree)


def test_save_restore_exact_and_read_by_jax(tmp_path):
    tree = _to_torch(_tree())
    tckpt.save(str(tmp_path), tree, step=7, metadata={"note": "x"},
               best_metric=0.5)
    assert tckpt.latest_step(str(tmp_path)) == 7
    zero = tsteps.tree_map(torch.zeros_like, tree)
    leaves_before = tsteps.tree_leaves(zero)
    got = tckpt.restore(str(tmp_path), zero)
    for a, b, c in zip(tsteps.tree_leaves(got), tsteps.tree_leaves(tree),
                       leaves_before):
        assert torch.equal(a, b) and a is c       # loaded in place
    meta = json.load(open(tmp_path / "ckpt_7.meta.json"))
    assert meta["note"] == "x" and meta["best_metric"] == 0.5
    # the same file layout as the JAX package's npz format: its restore
    # reads the port's checkpoint of the same tree
    jtree = jax.tree.map(jnp.asarray, _tree())
    back = jckpt.restore(str(tmp_path), jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(back), tsteps.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), tree)


def test_train_state_save_restore_exact(tmp_path):
    _, params = _problem()
    tx = tsteps.make_bert_adam(1e-2, warmup=0.1, total_steps=10)
    state = tsteps.init_state({k: torch.tensor(v) for k, v in
                               params.items()}, tx)
    step = tsteps.make_train_step(_port_loss, tx)
    batches, _ = _problem()
    for b in batches[:3]:
        step(state, {k: torch.tensor(v) for k, v in b.items()})
    tckpt.save(str(tmp_path), state, state.step)
    fresh = tsteps.init_state({k: torch.zeros(v.shape) for k, v in
                               params.items()}, tx)
    got = tckpt.restore(str(tmp_path), fresh)
    assert got.step == 3 and got.opt_state.count == 3
    for k in params:
        assert torch.equal(got.params[k], state.params[k])
    a, b = got.opt_state.state_dict(), state.opt_state.state_dict()
    for i in b["state"]:
        for name in ("m", "v"):
            assert torch.equal(a["state"][i][name], b["state"][i][name])


def test_load_with_mapping_equals_jax():
    tree = _tree()
    sd = {"['model']['w']": np.ones((4, 2), np.float32),
          "['model']['b']": np.full((2,), 3.0, np.float32),
          "['enc']['layers'][1]['w']": np.full((3, 3), 2.0, np.float32),
          "['other']": np.zeros(1, np.float32)}
    mapping = {"['model']": "['head']"}
    want = jckpt.load_with_mapping(sd, jax.tree.map(jnp.asarray, tree),
                                   mapping)
    target = _to_torch(tree)
    got = tckpt.load_with_mapping(sd, target, mapping)
    for a, b in zip(tsteps.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(got["head"]["b"][0]) == 3.0
    assert torch.equal(got["enc"]["layers"][0]["w"],
                       torch.tensor(tree["enc"]["layers"][0]["w"]))


def test_meter_and_metric_logger_equal_jax():
    for mod in (jmeter, tmeter):
        m = mod.Meter()
        for i in range(25):
            m.update(loss=float(i), acc=torch.tensor(i / 10.0))
        sv = mod.SmoothedValue(window_size=2)
        for v in (1.0, 3.0, 5.0):
            sv.update(v)
        sv.synchronize_between_processes()     # no group: unchanged
        lines = []
        ml = mod.MetricLogger()
        for _ in ml.log_every(range(5), 2, header="h", printer=lines.append):
            ml.update(x=1.0)
        yield_ = (str(m), m.loss.median, m.loss.global_avg, sv.avg,
                  sv.global_avg, sv.value, len(lines), lines[0][:20])
        if mod is jmeter:
            want = yield_
    assert yield_ == want


def test_scalar_logger_writes_the_jax_lines(tmp_path):
    for mod, d in ((jlogger, tmp_path / "j"), (tlogger, tmp_path / "t")):
        sl = mod.ScalarLogger(str(d))
        sl.log(3, {"train/loss": 0.5, "lr": 1e-3})
        sl.close()
    j = json.loads(open(tmp_path / "j" / "scalars.jsonl").read())
    t = json.loads(open(tmp_path / "t" / "scalars.jsonl").read())
    j.pop("time"), t.pop("time")
    assert t == j
    log = tlogger.setup_logger("tmmx_torch_test", output_dir=str(tmp_path))
    log.info("hello")
    assert "hello" in open(tmp_path / "train.log").read()
