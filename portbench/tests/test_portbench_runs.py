"""Whole runs of every cell at tiny widths on the CPU: the port agrees with
the reference; the control (the reference in TF32 in the program's place)
and the timed path broken underneath each come out not correct."""

import pytest
import torch

from portbench.core import spec
from portbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_port_is_correct(name, trace):
    r = tiny.run(name, trace=trace)
    assert r["correct"], r["compared"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    if trace:
        assert "breakdown" in r and "busy_s" in r["device"]
    else:
        assert "setup_s" in r["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = tiny.run(name, seed=5, control=True)
    assert not r["correct"], r["compared"]


def _vit_path():
    from transformer_mm_explainability_tpu_torch.models import vit
    return vit, "relevancy_fused_block2"


def _vb_explain_path():
    from transformer_mm_explainability_tpu_torch.models import visual_bert
    return visual_bert, "relevancy_row"


def _state_unchanged(monkeypatch, name):
    """The relevancy state r is never folded (every Ê reads 0)."""
    if name.startswith("vit"):
        from transformer_mm_explainability_tpu_torch.ops import attn_block
        bwd = attn_block.attn_block_bwd

        def frozen(*a, **k):
            cot, e_row = bwd(*a, **k)
            return cot, torch.zeros_like(e_row)

        monkeypatch.setattr(attn_block, "attn_block_bwd", frozen)
    else:
        from transformer_mm_explainability_tpu_torch.ops import relevancy
        avg = relevancy.avg_heads
        monkeypatch.setattr(relevancy, "avg_heads",
                            lambda c, g: torch.zeros_like(avg(c, g)))


def _half_batch(monkeypatch, name):
    """Half of the batch left out, the mean of the rest in its place."""
    def half(x):
        h = x.shape[0] // 2
        x[h:] = x[:h].float().mean(0).to(x.dtype)
        return x

    if spec.cell(name).mix["task"] == "perturb":
        from transformer_mm_explainability_tpu_torch.harness import (
            perturbation)
        run = perturbation.run_image_perturbation_batch
        monkeypatch.setattr(perturbation, "run_image_perturbation_batch",
                            lambda *a, **k: half(run(*a, **k)))
        return
    mod, fn = _vit_path() if name.startswith("vit") else _vb_explain_path()
    orig = getattr(mod, fn)

    def halved(*a, **k):
        out = orig(*a, **k)
        return half(out) if torch.is_tensor(out) else (out[0], half(out[1]))

    monkeypatch.setattr(mod, fn, halved)


def _altered(monkeypatch, name):
    """An answer altered where it is produced: a step's picked answer, a
    map's value, an answer's score."""
    if spec.cell(name).mix["task"] == "perturb":
        from transformer_mm_explainability_tpu_torch.harness import (
            perturbation)
        monkeypatch.setattr(
            perturbation, "_picked", lambda t, s: torch.gather(
                t, 1, (s.argmax(-1) + 1) % s.shape[-1]))
        return
    mod, fn = _vit_path() if name.startswith("vit") else _vb_explain_path()
    orig = getattr(mod, fn)

    def altered(*a, **k):
        out = orig(*a, **k)
        x = out if torch.is_tensor(out) else out[0]
        x[0, 1] += x.abs().max()
        return out

    monkeypatch.setattr(mod, fn, altered)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered])
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch, name)
    r = tiny.run(name, seed=11)
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("precision", [
    {"dtype": "bfloat16", "tf32": False, "fast_dots": False},
    {"dtype": "float32", "tf32": False, "fast_dots": True},
    {"dtype": "float32", "tf32": True, "fast_dots": False}])
def test_other_precision_raises(name, precision):
    """A configuration never claims a precision its run does not use."""
    c = tiny.cell_of(name)
    c.config["precision"] = precision
    with pytest.raises(ValueError, match="precision"):
        tiny.run_cell(c)


@pytest.mark.parametrize("key,value", [("modality", "text"),
                                       ("positive", True),
                                       ("method", "transformer_attribution")])
def test_other_protocol_raises(key, value):
    """A perturbation mix never asks for a protocol the reference does not
    compute."""
    name = next(n for n in CELLS if spec.cell(n).mix["task"] == "perturb")
    c = tiny.cell_of(name)
    c.mix[key] = value
    with pytest.raises(ValueError, match="protocol"):
        tiny.run_cell(c)
