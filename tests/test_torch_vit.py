"""The port's ViT slice against the JAX package, end to end.

Weights are made by the JAX package's ``init_params`` and carried across
with ``vit_from_jax_numpy``; images with numpy from a seed. The slice bar
is the repo's parity target, max|Δ| < 1e-4 on the relevancy maps, and a
relative check on top (the maps of random weights are ~1e-2 in size).
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import vit as jexplain
from transformer_mm_explainability_tpu.models import vit as jvit
from transformer_mm_explainability_tpu.ops import image as jimage
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu.utils import visualization as jviz
from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.explain import vit as texplain
from transformer_mm_explainability_tpu_torch.models import vit as tvit
from transformer_mm_explainability_tpu_torch.ops import image as timage
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert
from transformer_mm_explainability_tpu_torch.utils import visualization as tviz

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "transformer_mm_explainability_tpu_torch"
SMALL = dict(image_size=64, patch_size=16, width=64, depth=3, num_heads=4,
             mlp_ratio=4, num_classes=10)
JCFG, TCFG = jvit.ViTConfig(**SMALL), tvit.ViTConfig(**SMALL)
BAR = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return jvit.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def model(jparams):
    return tconvert.vit_from_jax_numpy(jax.tree.map(np.asarray, jparams),
                                       TCFG, device="cpu")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    return (rng.randn(3, 64, 64, 3).astype(np.float32),
            np.array([1, 2, 3], np.int32))


KERNEL_PATHS = ["relevancy_fused", "relevancy_fused_block",
                "relevancy_fused_block2"]


@pytest.fixture(scope="module")
def jax_maps(jparams, batch):
    im, tg = map(jnp.asarray, batch)
    maps = {name: np.asarray(getattr(jvit, name)(jparams, im, tg, JCFG,
                                                 interpret=True))
            for name in KERNEL_PATHS}
    for name in ("relevancy", "relevancy_streamed", "relevancy_streamed_row"):
        maps[name] = np.asarray(getattr(jvit, name)(jparams, im, tg, JCFG))
    return maps


@pytest.fixture(scope="module")
def jax_captures(jparams, batch):
    im, tg = map(jnp.asarray, batch)
    logits, attn, grads = jvit.capture(jparams, im, tg, JCFG)
    return tuple(np.array(t) for t in (logits, attn, grads))


def _torch(batch):
    return torch.from_numpy(batch[0]), torch.from_numpy(batch[1])


@pytest.mark.parametrize("port_fn", ["relevancy_fused_block2",
                                     "relevancy_streamed_row", "relevancy",
                                     "relevancy_streamed", "relevancy_fused",
                                     "relevancy_fused_block"])
@pytest.mark.parametrize("jax_fn", ["relevancy_fused_block2", "relevancy"])
def test_slice_maps_match_jax(model, batch, jax_maps, port_fn, jax_fn):
    got = getattr(tvit, port_fn)(model, *_torch(batch)).numpy()
    want = jax_maps[jax_fn]
    assert got.shape == want.shape == (3, TCFG.seq_len - 1)
    assert np.abs(got - want).max() < BAR
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("fn", ["relevancy_streamed", "relevancy_fused",
                                "relevancy_fused_block"])
def test_path_matches_its_jax_counterpart(model, batch, jax_maps, fn):
    """Each path against the JAX function of the same name (its Pallas
    kernels in interpret mode)."""
    got = getattr(tvit, fn)(model, *_torch(batch)).numpy()
    want = jax_maps[fn]
    assert got.shape == want.shape == (3, TCFG.seq_len - 1)
    assert np.abs(got - want).max() < BAR
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("path", KERNEL_PATHS)
def test_forward_probe_matches_jax(jparams, model, batch, path):
    probe = f"{path}_forward_probe"
    want = np.asarray(getattr(jvit, probe)(jparams, jnp.asarray(batch[0]),
                                           JCFG, interpret=True))
    got = getattr(tvit, probe)(model, torch.from_numpy(batch[0]))
    assert got.shape == want.shape == (3, TCFG.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    logits, _ = tvit.forward(model, torch.from_numpy(batch[0]))
    torch.testing.assert_close(got, logits, rtol=1e-5, atol=1e-6)


def test_forward_and_capture_match_jax(model, batch, jax_captures):
    logits, attn, grads = tvit.capture(model, *_torch(batch))
    want_logits, want_attn, want_grads = jax_captures
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(attn.numpy(), want_attn, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grads.numpy(), want_grads, rtol=1e-3, atol=1e-6)
    fwd_logits, fwd_attn = model(torch.from_numpy(batch[0]))
    torch.testing.assert_close(fwd_logits, logits)
    torch.testing.assert_close(fwd_attn, attn)


@pytest.mark.parametrize("start_layer", [0, 1])
def test_generate_relevance_matches_jax(jparams, model, batch, start_layer):
    im, tg = batch
    want = np.asarray(jexplain.generate_relevance(
        jparams, jnp.asarray(im), jnp.asarray(tg), JCFG, start_layer))
    got = texplain.generate_relevance(model, *_torch(batch), start_layer)
    assert np.abs(got.numpy() - want).max() < BAR


@pytest.mark.parametrize("method,args", [
    ("generate_rollout", ("attn",)), ("generate_rollout", ("attn", 1)),
    ("generate_raw_attn", ("attn",)),
    ("generate_attn_gradcam", ("attn", "grads"))])
def test_explain_baselines_match_jax(jax_captures, method, args):
    """The three baselines on one set of (JAX) captures."""
    _, attn, grads = jax_captures
    caps = {"attn": attn, "grads": grads}
    jargs = [jnp.asarray(caps[a]) if isinstance(a, str) else a for a in args]
    targs = [torch.from_numpy(caps[a]) if isinstance(a, str) else a
             for a in args]
    want = np.asarray(getattr(jexplain, method)(*jargs))
    got = getattr(texplain, method)(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert set(texplain.METHODS) == set(jexplain.METHODS)


def _timm_state_dict(cfg, seed=0):
    """A timm vit_base_patch16_224-layout state dict built with numpy."""
    rng = np.random.RandomState(seed)
    D, P, I = cfg.width, cfg.patch_size, cfg.mlp_ratio * cfg.width
    t = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))
    sd = {"cls_token": t(1, 1, D), "pos_embed": t(1, cfg.seq_len, D),
          "patch_embed.proj.weight": t(D, 3, P, P),
          "patch_embed.proj.bias": t(D), "norm.weight": 1 + t(D),
          "norm.bias": t(D), "head.weight": t(cfg.num_classes, D),
          "head.bias": t(cfg.num_classes)}
    for i in range(cfg.depth):
        p = f"blocks.{i}"
        for name, shape in [("norm1", (D,)), ("norm2", (D,))]:
            sd[f"{p}.{name}.weight"] = 1 + t(*shape)
            sd[f"{p}.{name}.bias"] = t(*shape)
        for name, (o, n) in [("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                             ("mlp.fc1", (I, D)), ("mlp.fc2", (D, I))]:
            sd[f"{p}.{name}.weight"] = t(o, n)
            sd[f"{p}.{name}.bias"] = t(o)
    return sd


def test_vit_from_state_dict_matches_jax_converter():
    cfg = tvit.ViTConfig(image_size=32, patch_size=8, width=128, depth=2,
                         num_heads=2, num_classes=7)
    sd = _timm_state_dict(cfg)
    jp, jcfg = jconvert.vit_from_state_dict(sd)
    model, tcfg = tconvert.vit_from_state_dict(sd, device="cpu")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    rebuilt = tconvert.vit_from_jax_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                          device="cpu")
    for (name, a), (_, b) in zip(model.named_parameters(),
                                 rebuilt.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    im = np.random.RandomState(1).randn(2, 32, 32, 3).astype(np.float32)
    want, _ = jvit.forward(jp, jnp.asarray(im), jcfg)
    got, _ = tvit.forward(model, torch.from_numpy(im))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_vit_from_jax_numpy_accepts_dict_attention(jparams, model):
    tree = jax.tree.map(np.asarray, jparams)
    tree["blocks"]["attn"] = tree["blocks"]["attn"]._asdict()
    other = tconvert.vit_from_jax_numpy(tree, TCFG, device="cpu")
    for a, b in zip(model.parameters(), other.parameters()):
        assert torch.equal(a, b)
    tree["head"]["w"] = tree["head"]["w"][:, :3]
    with pytest.raises(ValueError, match="does not fit"):
        tconvert.vit_from_jax_numpy(tree, TCFG, device="cpu")


def test_init_params_is_seeded_and_patchify_matches_jax():
    a = tvit.init_params(3, TCFG, device="cpu")
    b = tvit.init_params(torch.Generator().manual_seed(3), TCFG, device="cpu")
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)
    assert not any(p.requires_grad for p in a.parameters())
    im = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(im), 16).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(im), 16)))


def test_cuda_default_raises_without_cuda(monkeypatch, tmp_path):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tvit.init_params(0, TCFG)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["explain-vit", str(tmp_path / "missing.png")])


# ---------------------------------------------------------------------------
# image ops and the figure
# ---------------------------------------------------------------------------

# jax.image.resize and antialiased F.interpolate build the same Keys
# (a=-0.5) / triangle filters; their fp32 filter weights differ in the
# last bits, measured ≤ 3.4e-6 on [0, 1] images
IMG_TOL = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src,dst", [((300, 400), (150, 200)),
                                     ((97, 130), (224, 300)),
                                     ((50, 60), (37, 23))])
def test_resize_matches_jax(method, src, dst):
    im = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    want = np.asarray(jimage.resize(jnp.asarray(im), dst, method))
    got = timage.resize(torch.from_numpy(im), dst, method).numpy()
    np.testing.assert_allclose(got, want, **IMG_TOL)


def test_preprocess_chain_matches_jax():
    """The CLI's timm transform: shortest edge → crop → 0.5/0.5 norm."""
    im = np.random.RandomState(1).rand(180, 250, 3).astype(np.float32)
    j = jimage.normalize(jimage.center_crop(jimage.resize_shortest_edge(
        jnp.asarray(im), 64, method="bicubic"), 64), (0.5,) * 3, (0.5,) * 3)
    t = timage.normalize(timage.center_crop(timage.resize_shortest_edge(
        torch.from_numpy(im), 64, method="bicubic"), 64), (0.5,) * 3,
        (0.5,) * 3)
    assert t.shape == (64, 64, 3)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=3e-5)
    j2 = jimage.resize_shortest_edge(jnp.asarray(im), 100, longest_cap=120)
    t2 = timage.resize_shortest_edge(torch.from_numpy(im), 100, longest_cap=120)
    assert t2.shape == j2.shape
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), **IMG_TOL)


def test_relevancy_figure_matches_jax():
    rng = np.random.RandomState(2)
    image = rng.randn(64, 64, 3).astype(np.float32)
    rel = rng.rand(16).astype(np.float32)
    want = jviz.relevancy_figure(image, rel, (4, 4))
    got = tviz.relevancy_figure(image, rel, (4, 4))
    assert got.dtype == np.uint8 and got.shape == want.shape
    # uint8 truncation of values equal to 1e-5: at most one level apart
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# the CLI and the package boundary
# ---------------------------------------------------------------------------

def _png(path, h=40, w=56):
    from PIL import Image
    arr = (np.random.RandomState(3).rand(h, w, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return path


def test_cli_explain_vit_checkpoint_on_cpu(tmp_path, capsys):
    cfg = tvit.ViTConfig(image_size=32, patch_size=8, width=64, depth=2,
                         num_heads=1, num_classes=5)
    torch.save(_timm_state_dict(cfg, seed=4), tmp_path / "vit.pt")
    out = tmp_path / "rel.png"
    rc = cli.main(["explain-vit", str(_png(tmp_path / "in.png")),
                   "--checkpoint", str(tmp_path / "vit.pt"), "--class-index",
                   "2", "--output", str(out), "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result == {"class_index": 2, "output": str(out)}
    from PIL import Image
    fig = np.asarray(Image.open(out))
    assert fig.shape == (32, 32, 3) and fig.dtype == np.uint8


def test_cli_explain_vit_random_weights_on_cpu(tmp_path, capsys):
    """Default ViT-B/16 at random weights through relevancy_fused_block2's
    plain path; the chosen class is the argmax."""
    out = tmp_path / "rel.png"
    rc = cli.main(["explain-vit", str(_png(tmp_path / "in.png")),
                   "--output", str(out), "--seed", "1", "--device", "cpu"])
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 <= result["class_index"] < 1000
    from PIL import Image
    assert np.asarray(Image.open(out)).shape == (224, 224, 3)


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX and the JAX package
    out of sys.modules (fresh interpreter)."""
    mods = sorted(
        "transformer_mm_explainability_tpu_torch."
        + str(p.relative_to(PORT).with_suffix("")).replace(os.sep, ".")
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'transformer_mm_explainability_tpu'"
        " or m.startswith('transformer_mm_explainability_tpu.')]\n"
        "print(len(bad), bad[:5])\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "0 []"
    assert len(mods) >= 10
    # the FRCNN → LXMERT, VisualBERT, CLIP, DETR, LRP and MMF core/data
    # slices are among them
    for name in ("models.frcnn", "models.resnet", "models.bert",
                 "models.lxmert", "explain.lxmert", "ops.roi_pool_pallas",
                 "harness.perturbation", "harness.pert_runner",
                 "data.vqa", "data.tokenization",
                 "examples.lxmert_explainability",
                 "models.visual_bert", "explain.visual_bert",
                 "utils.mmf_loader", "models.clip", "models.clip_resnet",
                 "explain.clip", "utils.clip_loader", "data.bpe",
                 "models.detr", "explain.detr", "harness.detr_segm",
                 "harness.detr_eval", "harness.coco_eval",
                 "harness.panoptic", "data.coco", "ops.otsu",
                 "models.matcher", "models.detr_segm_heads",
                 "utils.box_ops", "ops.lrp", "ops.rap", "models.bert_lrp",
                 "models.lxmert_lrp", "models.detr_lrp", "core.losses",
                 "core.metrics", "core.env", "core.build",
                 "data.processors", "data.builders",
                 "data.lxmert_pretrain_data", "harness.predict",
                 "utils.m4c_evaluators"):
        assert f"transformer_mm_explainability_tpu_torch.{name}" in mods


@pytest.mark.parametrize("path", ["package", "chip_smoke.py"])
def test_port_sources_import_no_jax(path):
    forbidden = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|transformer_mm_explainability_tpu)\b")
    files = (list(PORT.rglob("*.py")) if path == "package"
             else [REPO / "chip_smoke.py"])
    for f in files:
        for line in f.read_text().splitlines():
            assert not forbidden.match(line), (f, line)
