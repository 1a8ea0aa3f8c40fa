"""The port's examples (``transformer_mm_explainability_tpu_torch/examples``)
run as a user runs them: a fresh process, ``--device cpu``, the
checkpoint-free smoke mode; each exits 0 and writes what it advertises.
Each also fails, rather than moving to the CPU, when asked for a card that
is not there."""

import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = "transformer_mm_explainability_tpu_torch.examples"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs files in
    several worker processes at once, and torch's default of one thread
    per core in each of them oversubscribes the CPU many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def demo_image(tmp_path_factory):
    from PIL import Image

    path = tmp_path_factory.mktemp("img") / "demo.jpg"
    arr = (np.random.RandomState(0).rand(96, 128, 3) * 255).astype("uint8")
    Image.fromarray(arr).save(path)
    return str(path)


def run_example(name, args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PKG}.{name}", *args, "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, (
        f"{name} rc={proc.returncode}\nstdout:{proc.stdout[-2000:]}\n"
        f"stderr:{proc.stderr[-2000:]}")
    return proc.stdout


def test_vit_example(demo_image, tmp_path):
    out = tmp_path / "vit.png"
    stdout = run_example("vit_explainability",
                         [demo_image, "--output", str(out)], tmp_path)
    assert out.exists() and out.stat().st_size > 0
    assert '"class_index"' in stdout


def test_clip_example(demo_image, tmp_path):
    prefix = str(tmp_path / "clip")
    stdout = run_example("clip_explainability",
                         [demo_image, "a cat", "a dog", "--output-prefix",
                          prefix], tmp_path)
    for name in ("clip_0.png", "clip_1.png", "clip_text.html"):
        assert (tmp_path / name).stat().st_size > 0, name
    html = (tmp_path / "clip_text.html").read_text()
    assert "cat" in html and "dog" in html
    assert '"probs"' in stdout


def test_detr_example(demo_image, tmp_path):
    prefix = str(tmp_path / "detr")
    stdout = run_example("detr_explainability",
                         [demo_image, "--output-prefix", prefix], tmp_path)
    assert (tmp_path / "detr_masks.png").stat().st_size > 0
    assert "detections above threshold" in stdout


def test_lxmert_perturbation_example(tmp_path):
    stdout = run_example("lxmert_perturbation", ["--num-samples", "2"],
                         tmp_path)
    assert "step accuracies" in stdout and '"auc"' in stdout


@pytest.mark.parametrize("name,args", [
    ("vit_explainability", ["IMG"]),
    ("clip_explainability", ["IMG", "a cat"]),
    ("detr_explainability", ["IMG"]),
    ("lxmert_perturbation", ["--num-samples", "1"]),
])
def test_examples_need_a_card_when_asked(name, args, demo_image):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [demo_image if a == "IMG" else a for a in args]
    main = importlib.import_module(f"{PKG}.{name}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*args, "--device", "cuda"])
