"""The port's DETR hub constructors (``hub.py``) against the JAX package's:
the same variant configs and post-processors, a build that runs, a
``detr_to_state_dict`` → ``pretrained=path`` round trip, and the offline
gate."""

import dataclasses

import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu import hub as jhub
from transformer_mm_explainability_tpu_torch import hub
from transformer_mm_explainability_tpu_torch.harness import panoptic
from transformer_mm_explainability_tpu_torch.models import detr, matcher
from transformer_mm_explainability_tpu_torch.utils import convert

VARIANTS = ("detr_resnet50", "detr_resnet50_dc5", "detr_resnet101",
            "detr_resnet101_dc5", "detr_resnet50_panoptic",
            "detr_resnet50_dc5_panoptic", "detr_resnet101_panoptic")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_config_and_postprocessor_equal_jax(name, monkeypatch):
    # configs only: neither package draws the weights here
    monkeypatch.setattr(jhub.jdetr, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(hub.detr, "init_params", lambda *a, **k: None)
    jcfg, _, jpp = getattr(jhub, name)(return_postprocessor=True)
    cfg, params, pp = getattr(hub, name)(return_postprocessor=True,
                                         device="cpu")
    assert params is None
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    if name.endswith("panoptic"):
        assert pp.func is panoptic.post_process_panoptic
        assert pp.keywords == jpp.keywords
    else:
        assert pp is matcher.post_process
    cfg, _ = getattr(hub, name)(num_classes=7, device="cpu")
    assert cfg.num_classes == 7


def test_detr_resnet50_builds_and_runs():
    cfg, params, pp = hub.detr_resnet50(return_postprocessor=True,
                                        device="cpu")
    assert cfg.backbone_stages == (3, 4, 6, 3) and not cfg.dilation
    assert [len(s) for s in params["backbone"]["layers"]] == [3, 4, 6, 3]
    img = torch.as_tensor(np.random.RandomState(0).randn(1, 64, 64, 3)
                          .astype(np.float32))
    with torch.no_grad():
        out = detr.forward(params, img, cfg=cfg)
    assert out["pred_logits"].shape == (1, 100, 92)
    res = pp(out["pred_logits"], out["pred_boxes"], torch.tensor([[64, 64]]))
    assert res["boxes"].shape == (1, 100, 4)
    assert torch.isfinite(res["boxes"]).all()


def test_panoptic_postprocessor_equals_jax(monkeypatch):
    monkeypatch.setattr(jhub.jdetr, "init_params", lambda *a, **k: None)
    monkeypatch.setattr(hub.detr, "init_params", lambda *a, **k: None)
    _, _, jpp = jhub.detr_resnet50_panoptic(return_postprocessor=True,
                                            threshold=0.3)
    _, _, pp = hub.detr_resnet50_panoptic(return_postprocessor=True,
                                          threshold=0.3, device="cpu")
    rng = np.random.RandomState(2)
    logits = rng.randn(100, 251).astype(np.float32) * 3
    masks = rng.randn(100, 8, 8).astype(np.float32)
    got = pp(logits, masks, processed_size=(32, 32))
    want = jpp(logits, masks, processed_size=(32, 32))
    assert got["id_map"].shape == (32, 32)
    np.testing.assert_array_equal(got["id_map"], np.asarray(want["id_map"]))
    assert len(got["segments_info"]) == len(want["segments_info"]) > 0


def test_pretrained_path_round_trips(tmp_path):
    """A release-format ``.pth`` of seeded weights
    (``utils/convert.detr_to_state_dict``) loads back bit for bit through
    ``pretrained=path``."""
    _, params = hub.detr_resnet50(seed=3, device="cpu")
    want = convert.detr_to_state_dict(params)
    path = tmp_path / "detr.pth"
    torch.save({"model": want}, path)
    cfg, got = hub.detr_resnet50(pretrained=str(path), device="cpu")
    assert cfg.backbone_stages == (3, 4, 6, 3)
    got = convert.detr_to_state_dict(got)
    assert list(got) == list(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_pretrained_offline_gate():
    with pytest.raises(RuntimeError, match="offline"):
        hub.detr_resnet50(pretrained=True, device="cpu")


def test_constructors_need_a_card_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hub.detr_resnet50()
