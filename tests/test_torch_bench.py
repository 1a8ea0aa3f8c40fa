"""``bench.py`` (``cli bench``) and ``tools/bench_families`` of the port,
on the CPU at tiny configs: the JAX tools' record fields, family names,
units and counts (``tests/test_bench_families.py``)."""

import json

import pytest
import torch

from transformer_mm_explainability_tpu.tools import bench_families as jbf
from transformer_mm_explainability_tpu_torch import bench, cli
from transformer_mm_explainability_tpu_torch.models import vit
from transformer_mm_explainability_tpu_torch.tools import bench_families as bf


def test_cli_bench_prints_one_record_on_the_cpu(monkeypatch, capsys):
    """``cli bench --device cpu``: the plain ``relevancy`` at B = 4, one
    trial, as the JAX bench's CPU branch; no TPU comparison fields, bf16
    null (a tiny ViT keeps the test short)."""
    monkeypatch.setattr(bench, "CFG", vit.ViTConfig(
        image_size=32, patch_size=8, width=64, depth=2, num_heads=4,
        mlp_ratio=4, num_classes=16))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["value"] > 0 and rec["unit"] == "maps/sec"
    assert (rec["batch"], rec["trials"], rec["device"]) == (4, 1, "cpu")
    assert "relevancy, fp32" in rec["metric"]
    assert rec["bf16_maps_per_sec"] is None
    assert rec["spread"]["fp32"][0] <= rec["value"] <= rec["spread"]["fp32"][1]
    assert not {"vs_baseline", "vs_last_tpu", "regression"} & set(rec)


def test_families_equal_jax():
    assert bf.ALL_FAMILIES == jbf.ALL_FAMILIES
    assert set(bf.BENCHES) == set(jbf.BENCHES)


def test_tiny_benches_run(capsys):
    results = bf.run(["clip", "visual_bert"], tiny=True, iters=1,
                     device="cpu")
    assert [r["family"] for r in results] == ["clip", "visual_bert_pert"]
    for r in results:
        assert r["ms_per_call"] > 0
        assert r["ms_per_unit"] <= r["ms_per_call"]
    assert results[1]["unit"] == "sample (explain + 9-step image pert)"
    assert [r["n"] for r in results] == [4, 2]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 2
    for ln in lines:
        assert json.loads(ln)["ms_per_call"] > 0


@pytest.fixture
def one_thread():
    """The tiny FRCNN is many small operations, which eight threads per
    process slow down many times over on a loaded CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tiny_detr_lxmert_frcnn(one_thread):
    results = bf.run(["detr", "lxmert", "frcnn"], tiny=True, iters=1,
                     device="cpu")
    assert [r["family"] for r in results] == ["detr", "lxmert", "frcnn"]
    assert results[0]["n"] == 2  # K queries from one forward and backward
    assert [r["unit"] for r in results] == ["query", "sample", "image"]
    assert results[0]["hw"] == [64, 96] and results[2]["hw"] == [64, 96]


def test_bench_families_cli_rejects_unknown_families():
    with pytest.raises(SystemExit):
        bf.main(["--families", "vit", "--tiny", "--device", "cpu"])
