"""The port's examples (``transformer_mm_explainability_tpu_torch/examples``)
run as a user runs them: a fresh process, ``--device cpu``, the
checkpoint-free smoke mode; each exits 0 and writes what it advertises.
Each also fails, rather than moving to the CPU, when asked for a card that
is not there."""

import importlib
import importlib.util
import os
import pathlib
import re
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
    ("mmf_zoo_vqa", []),
    ("visual_bert_pretraining", ["--steps", "1"]),
])
def test_examples_need_a_card_when_asked(name, args, demo_image):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = [demo_image if a == "IMG" else a for a in args]
    main = importlib.import_module(f"{PKG}.{name}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main([*args, "--device", "cuda"])


# --- the MMF examples against the JAX package's own scripts ----------------

NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")


def _jax_example(name):
    """The repo's JAX example script ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_cfg(cfg, tmod):
    """A JAX config dataclass → the port module's class of that name (a
    nested BERT config too)."""
    import dataclasses

    from transformer_mm_explainability_tpu_torch.models import bert

    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = (bert.BertConfig(**dataclasses.asdict(v))
                      if dataclasses.is_dataclass(v) else v)
    return getattr(tmod, type(cfg).__name__)(**kw)


def _shared_init(monkeypatch, jmod, tmod, name, into):
    """Replace the JAX example's ``jmod.name(key, cfg)`` by the port's
    seeded draw of the same tree (``tmod.name(0, cfg)``, numpy leaves in
    the JAX tree's classes), kept in ``into[name]`` for the port's run: a
    compiled JAX random init costs more than the whole example."""
    import jax
    import jax.numpy as jnp
    from _mmf_parity import to_jax_np

    def drawn(key, cfg):
        into[name] = to_jax_np(getattr(tmod, name)(0, _port_cfg(cfg, tmod),
                                                   device="cpu"))
        return jax.tree_util.tree_map(jnp.asarray, into[name])

    monkeypatch.setattr(jmod, name, drawn)


def same_printout(got: str, want: str, rel: float = 1e-4) -> None:
    """The same lines with the numbers taken out, and each number within
    ``rel`` (the printed losses carry four decimals)."""
    keep = lambda text: [ln for ln in text.splitlines()
                         if not ln.startswith("[synthetic")]
    got, want = keep(got), keep(want)
    assert [NUMBER.sub("#", ln) for ln in got] == \
        [NUMBER.sub("#", ln).replace("Array(#, dtype=float32)", "#")
         for ln in want]
    for g_ln, w_ln in zip(got, want):
        for g, w in zip(NUMBER.findall(g_ln), NUMBER.findall(w_ln)):
            assert abs(float(g) - float(w)) <= rel * max(1.0,
                                                         abs(float(w))), \
                (g_ln, w_ln)


def test_mmf_zoo_vqa_example_matches_jax(monkeypatch, capsys):
    """The port's zoo tour prints the JAX tour's shapes, loss, accuracy and
    model names from the same weights and inputs."""
    from transformer_mm_explainability_tpu.models import mmf_zoo as JZ
    from transformer_mm_explainability_tpu.models import movie_mcan as JMM

    from transformer_mm_explainability_tpu_torch.examples import mmf_zoo_vqa

    import jax

    from transformer_mm_explainability_tpu_torch.models import mmf_zoo as TZ
    from transformer_mm_explainability_tpu_torch.models import (
        movie_mcan as TMM)

    weights = {}
    _shared_init(monkeypatch, JZ, TZ, "init_pythia", weights)
    _shared_init(monkeypatch, JMM, TMM, "init_movie_mcan", weights)
    # the script calls the MoVie forward op by op; one program is faster
    monkeypatch.setattr(JMM, "movie_mcan_forward", jax.jit(
        JMM.movie_mcan_forward, static_argnums=1,
        static_argnames="training"))
    _jax_example("mmf_zoo_vqa").main()
    want = capsys.readouterr().out
    assert mmf_zoo_vqa.main(["--device", "cpu"], weights={
        "pythia": weights["init_pythia"],
        "movie_mcan": weights["init_movie_mcan"]}) == 0
    same_printout(capsys.readouterr().out, want)


def test_visual_bert_pretraining_example_matches_jax(monkeypatch, capsys):
    """Three AdamW steps of the port's pretraining example print the JAX
    example's dataset size and masked-LM losses from the same weights."""
    from transformer_mm_explainability_tpu.models import visual_bert as JVB

    from transformer_mm_explainability_tpu_torch.examples import (
        visual_bert_pretraining)

    from transformer_mm_explainability_tpu_torch.models import (
        visual_bert as TVB)

    weights = {}
    _shared_init(monkeypatch, JVB, TVB, "init_params", weights)
    _shared_init(monkeypatch, JVB, TVB, "init_pretrain_params", weights)
    monkeypatch.setattr(sys, "argv", ["visual_bert_pretraining",
                                      "--steps", "3"])
    _jax_example("visual_bert_pretraining").main()
    want = capsys.readouterr().out
    assert visual_bert_pretraining.main(
        ["--steps", "3", "--device", "cpu"],
        weights={"p": weights["init_params"],
                 "h": weights["init_pretrain_params"]}) == 0
    same_printout(capsys.readouterr().out, want)
