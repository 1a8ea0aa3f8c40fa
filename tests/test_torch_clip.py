"""The port's CLIP slice against the JAX package: both towers, ``interpret``
and ``text_token_relevance``, the ModifiedResNet tower, the state-dict
converters of both tower kinds, the BPE tokenizer, ``clip_preprocess`` and
``cli explain-clip``, at tiny configs.

Weights are numpy draws in the JAX package's tree (the structure of its
``init_params``, from ``jax.eval_shape``) carried across with
``clip_from_jax_numpy``, or state dicts the tests build, converted by both
packages; inputs are numpy from a seed. Stated tolerances, those of the
LXMERT slice: rtol 1e-4 / atol 1e-5 for features and logits, atol 1e-5 for
every relevancy map, the converters' parameters and the tokens exactly;
the random ModifiedResNet tower's features (which amplify fp32 rounding
in both packages) as close to float64 as the JAX package's, within 3×; ``clip_preprocess`` within 1e-5 (both resize with the a = -0.5 Keys cubic,
antialiased, in other summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.data import bpe as jbpe
from transformer_mm_explainability_tpu.explain import clip as jexplain
from transformer_mm_explainability_tpu.models import clip as jclip
from transformer_mm_explainability_tpu.models import clip_resnet as jrn
from transformer_mm_explainability_tpu.ops import image as jimage
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.data import bpe as tbpe
from transformer_mm_explainability_tpu_torch.explain import clip as texplain
from transformer_mm_explainability_tpu_torch.models import clip as tclip
from transformer_mm_explainability_tpu_torch.models import clip_resnet as trn
from transformer_mm_explainability_tpu_torch.ops import image as timage
from transformer_mm_explainability_tpu_torch.utils import clip_loader
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

from test_torch_visual_bert import flat, numpy_params

TINY = dict(embed_dim=24, image_resolution=32, vision_layers=3,
            vision_width=128, vision_patch_size=16, context_length=13,
            vocab_size=100, transformer_width=64, transformer_heads=2,
            transformer_layers=3)
JCFG, TCFG = jclip.CLIPConfig(**TINY), tclip.CLIPConfig(**TINY)
TOL = dict(rtol=1e-4, atol=1e-5)
MAP_TOL = dict(rtol=0, atol=1e-5)
NT = 4


def tokens(seed=0, n=NT, S=13):
    """SOT (98), a few words, EOT (99, the largest id), zero padding."""
    rng = np.random.RandomState(seed)
    t = np.zeros((n, S), np.int32)
    for b in range(n):
        k = 2 + b % 5
        t[b, 0] = 98
        t[b, 1:1 + k] = rng.randint(1, 98, k)
        t[b, 1 + k] = 99
    return t


def image(seed=0, size=32):
    return np.random.RandomState(seed).randn(size, size, 3).astype(
        np.float32)


@pytest.fixture(scope="module")
def jparams():
    return numpy_params(lambda: jclip.init_params(jax.random.PRNGKey(0),
                                                  JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return tconvert.clip_from_jax_numpy(jparams, TCFG, device="cpu")


def test_towers_and_forward_equal_jax(jparams, tparams):
    ims = np.stack([image(0), image(1)])
    tok = tokens()
    ji, ja = jax.jit(jclip.encode_image, static_argnums=2)(
        jparams, jnp.asarray(ims), JCFG)
    jt, jta = jax.jit(jclip.encode_text, static_argnums=2)(
        jparams, jnp.asarray(tok), JCFG)
    with torch.no_grad():
        ti, ta = tclip.encode_image(tparams, torch.from_numpy(ims), TCFG)
        tt, tta = tclip.encode_text(tparams, torch.from_numpy(tok), TCFG)
        lpi, lpt, _ = tclip.forward(tparams, torch.from_numpy(ims),
                                    torch.from_numpy(tok), TCFG)
    assert ta.shape == (3, 2, 2, 5, 5) and tta.shape == (3, NT, 2, 13, 13)
    for got, want in ((ti, ji), (ta, ja), (tt, jt), (tta, jta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jl, jlt, _ = jax.jit(jclip.forward, static_argnums=3)(
        jparams, jnp.asarray(ims), jnp.asarray(tok), JCFG)
    np.testing.assert_allclose(lpi.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(lpt.numpy(), np.asarray(jlt), **TOL)


@pytest.mark.parametrize("start,start_text", [(-1, -1), (0, 0), (1, -1)])
def test_interpret_equals_jax(jparams, tparams, start, start_text):
    im, tok = image(2), tokens(3)
    jt, ji, jl = jax.jit(jexplain.interpret, static_argnums=(3, 4, 5))(
        jparams, jnp.asarray(im), jnp.asarray(tok), JCFG, start, start_text)
    tt, ti, tl = texplain.interpret(tparams, torch.from_numpy(im),
                                    torch.from_numpy(tok), TCFG, start,
                                    start_text)
    assert tt.shape == (NT, 13, 13) and ti.shape == (NT, 4)
    assert tl.shape == (NT, NT)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **MAP_TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **MAP_TOL)
    # each text's image map comes from its own logit
    assert np.abs(np.asarray(ji) - np.asarray(ji)[:1]).max() > 0
    assert np.abs(np.asarray(jt) - np.eye(13)).max() > 0


def test_text_token_relevance_equals_jax():
    """Row EOT, columns 1..EOT-1, zeros elsewhere: the JAX function is the
    oracle."""
    rng = np.random.RandomState(4)
    R = rng.rand(NT, 13, 13).astype(np.float32)
    tok = tokens(5)
    want = np.asarray(jexplain.text_token_relevance(jnp.asarray(R),
                                                    jnp.asarray(tok)))
    got = texplain.text_token_relevance(torch.from_numpy(R),
                                        torch.from_numpy(tok)).numpy()
    np.testing.assert_array_equal(got, want)
    eot = tok.argmax(-1)
    for b in range(NT):
        assert (got[b, eot[b]:] == 0).all() and got[b, 0] == 0
        np.testing.assert_array_equal(got[b, 1:eot[b]], R[b, eot[b],
                                                          1:eot[b]])


# ---------------------------------------------------------------------------
# state dicts and the ResNet tower
# ---------------------------------------------------------------------------

def clip_state_dict(resnet: bool, seed=0, width=16, stages=(1, 1, 1, 1),
                    res=64):
    """An OpenAI-CLIP state dict: a ViT (TINY's widths) or a ModifiedResNet
    vision tower, TINY's text tower."""
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05).astype(
        np.float32))
    sd = {}

    def lin(p, din, dout):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(dout, din), t(dout)

    def ln(p, n):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = 1 + t(n), t(n)

    def bn(p, n):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = 1 + t(n), t(n)
        sd[f"{p}.running_mean"] = t(n)
        sd[f"{p}.running_var"] = torch.from_numpy(
            (0.5 + rng.rand(n)).astype(np.float32))
        sd[f"{p}.num_batches_tracked"] = torch.tensor(0)

    def tower(prefix, D, L):
        for i in range(L):
            p = f"{prefix}.resblocks.{i}"
            ln(f"{p}.ln_1", D)
            sd[f"{p}.attn.in_proj_weight"] = t(3 * D, D)
            sd[f"{p}.attn.in_proj_bias"] = t(3 * D)
            lin(f"{p}.attn.out_proj", D, D)
            ln(f"{p}.ln_2", D)
            lin(f"{p}.mlp.c_fc", D, 4 * D)
            lin(f"{p}.mlp.c_proj", 4 * D, D)

    E, Dt = TINY["embed_dim"], TINY["transformer_width"]
    if resnet:
        # He-scaled convs, as trained ones are: activations stay O(1)
        conv = lambda name, o, i, k: sd.__setitem__(
            f"visual.{name}.weight", t(o, i, k, k) * (2 / (i * k * k)) ** 0.5
            / 0.05)
        conv("conv1", width // 2, 3, 3)
        bn("visual.bn1", width // 2)
        conv("conv2", width // 2, width // 2, 3)
        bn("visual.bn2", width // 2)
        conv("conv3", width, width // 2, 3)
        bn("visual.bn3", width)
        inplanes = width
        for si, n in enumerate(stages):
            planes = width * 2 ** si
            for bi in range(n):
                p = f"layer{si + 1}.{bi}"
                conv(f"{p}.conv1", planes, inplanes, 1)
                bn(f"visual.{p}.bn1", planes)
                conv(f"{p}.conv2", planes, planes, 3)
                bn(f"visual.{p}.bn2", planes)
                conv(f"{p}.conv3", planes * 4, planes, 1)
                bn(f"visual.{p}.bn3", planes * 4)
                if bi == 0:
                    conv(f"{p}.downsample.0", planes * 4, inplanes, 1)
                    bn(f"visual.{p}.downsample.1", planes * 4)
                inplanes = planes * 4
        C = width * 32
        sd["visual.attnpool.positional_embedding"] = t((res // 32) ** 2 + 1,
                                                       C)
        for name in ("q", "k", "v"):
            lin(f"visual.attnpool.{name}_proj", C, C)
        lin("visual.attnpool.c_proj", C, E)
    else:
        Dv, P = TINY["vision_width"], TINY["vision_patch_size"]
        sd["visual.conv1.weight"] = t(Dv, 3, P, P)
        sd["visual.class_embedding"] = t(Dv)
        sd["visual.positional_embedding"] = t(
            (TINY["image_resolution"] // P) ** 2 + 1, Dv)
        ln("visual.ln_pre", Dv)
        tower("visual.transformer", Dv, TINY["vision_layers"])
        ln("visual.ln_post", Dv)
        sd["visual.proj"] = t(Dv, E)
    sd["token_embedding.weight"] = t(TINY["vocab_size"], Dt)
    sd["positional_embedding"] = t(TINY["context_length"], Dt)
    tower("transformer", Dt, TINY["transformer_layers"])
    ln("ln_final", Dt)
    sd["text_projection"] = t(Dt, E)
    sd["logit_scale"] = torch.tensor(np.log(1 / 0.07), dtype=torch.float32)
    return sd


@pytest.mark.parametrize("tower", ["vit", "resnet"])
def test_clip_from_state_dict_equals_jax(tmp_path, tower):
    """Both converters on the same built state dict: the same config, the
    same parameters; ``load_clip`` reads it back from a file; the forward
    agrees with the JAX package's on the converted weights."""
    sd = clip_state_dict(tower == "resnet")
    heads = dict(transformer_heads=TINY["transformer_heads"])
    jp, jcfg = jconvert.clip_from_state_dict(sd, **heads)
    tp, tcfg = tconvert.clip_from_state_dict(sd, "cpu", **heads)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.is_resnet == (tower == "resnet")
    g, w = flat(tp), flat(jp)
    assert g.keys() == w.keys()
    for k in w:
        want = w[k]
        if want.ndim == 4:                      # HWIO → OIHW
            want = want.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(g[k], want, err_msg=k)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    lp, lcfg = clip_loader.load_clip(str(path), device="cpu")
    assert lcfg == dataclasses.replace(tcfg, transformer_heads=1)
    assert all(np.array_equal(a, b) for a, b in zip(
        flat(lp).values(), g.values()))
    res = tcfg.image_resolution
    ims = np.stack([image(6, res), image(7, res)])
    tok = tokens(8, n=2)
    jl, _, _ = jax.jit(jclip.forward, static_argnums=3)(
        jp, jnp.asarray(ims), jnp.asarray(tok), jcfg)
    with torch.no_grad():
        tl, _, _ = tclip.forward(tp, torch.from_numpy(ims),
                                 torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("stages", [(1, 1, 1, 1), (2, 1, 2, 1)])
def test_clip_resnet_forward_equals_jax(stages):
    sd = clip_state_dict(True, seed=1, stages=stages)
    jp = jrn.from_state_dict(sd)
    tp = trn.from_state_dict(sd, device="cpu")
    x = np.stack([image(9, 64), image(10, 64)])
    want = jax.jit(jrn.forward, static_argnums=2)(jp, jnp.asarray(x), 8)
    with torch.no_grad():
        got = trn.forward(tp, torch.from_numpy(x), num_heads=8)
    assert got.shape == (2, TINY["embed_dim"])
    # this random tower amplifies fp32 rounding: its features (scale ~50)
    # lie up to ~1e-3 from float64 in BOTH packages, past an elementwise
    # rtol 1e-4 between them. The bar is float64: the port's max|Δ| from it
    # within 3× the JAX package's (+1e-6 of the scale)
    want, got = np.asarray(want), got.numpy()
    scale = np.abs(want).max()
    f64 = lambda t: ([f64(v) for v in t] if isinstance(t, list) else
                     {k: f64(v) for k, v in t.items()}
                     if isinstance(t, dict) else t.double())
    with torch.no_grad():
        ref = trn.forward(f64(tp), torch.from_numpy(x).double(),
                          num_heads=8).numpy()
    assert np.abs(got - ref).max() <= 3 * np.abs(want - ref).max() \
        + 1e-6 * scale


def test_init_params_have_the_jax_trees(tparams):
    got = flat(tclip.init_params(0, TCFG, "cpu"))
    want = flat(tparams)
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    rn = tclip.CLIPConfig(**dict(TINY, vision_layers=(1, 2, 1, 1),
                                 vision_width=16, image_resolution=64))
    got = flat(tclip.init_params(0, rn, "cpu")["visual"])
    want = flat(trn.from_state_dict(clip_state_dict(
        True, stages=(1, 2, 1, 1)), device="cpu"))
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
    taps = tclip.zero_taps(rn, 1, 2)
    assert taps.visual.shape == (0,) and taps.text.shape == (3, 2, 2, 13, 13)


# ---------------------------------------------------------------------------
# tokenizer, preprocessing, loaders, CLI
# ---------------------------------------------------------------------------

TEXTS = ["a photo of a cat", "A DOG, running!", "two   birds & 3 trees",
         "it's the man's hat", "x_!y 12 dogs", "<|startoftext|>hi"]


def test_bpe_tokenize_equals_jax():
    assert tbpe.VOCAB_PATH.startswith(
        str(tbpe.__file__).rsplit("/", 1)[0]) and "_torch" in tbpe.VOCAB_PATH
    np.testing.assert_array_equal(tbpe.tokenize(TEXTS), jbpe.tokenize(TEXTS))
    np.testing.assert_array_equal(tbpe.tokenize("short", 10),
                                  jbpe.tokenize("short", 10))
    np.testing.assert_array_equal(
        tbpe.tokenize(["word " * 30], 16, truncate=True),
        jbpe.tokenize(["word " * 30], 16, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        tbpe.tokenize(["word " * 30], 16)
    tok = tbpe.ClipTokenizer()
    assert tok.decode(tok.encode("a photo of a cat")).strip() == \
        "a photo of a cat"


def test_bpe_word_pattern_without_regex_gives_the_same_pieces():
    """``re`` lacks \\p{..}: its pattern splits ASCII text into the same
    pieces as the ``regex`` pattern."""
    import re

    regex = pytest.importorskip("regex")
    a = regex.compile(tbpe._WORD_PATTERN, regex.IGNORECASE)
    b = re.compile(tbpe._WORD_PATTERN_RE, re.IGNORECASE)
    rng = np.random.RandomState(12)
    chars = np.array(list("abcXYZ019 _-!?.,'&<|>sdtlmrve\t"))
    for text in TEXTS + ["".join(rng.choice(chars, 24)) for _ in range(300)]:
        text = text.lower()
        assert a.findall(text) == b.findall(text), text


@pytest.mark.parametrize("kind", ["uint8", "float255", "float01"])
def test_clip_preprocess_equals_jax(kind):
    rng = np.random.RandomState(13)
    raw = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    x = {"uint8": raw, "float255": raw.astype(np.float32),
         "float01": raw.astype(np.float32) / 255}[kind]
    want = np.asarray(jimage.clip_preprocess(jnp.asarray(x), 32))
    got = timage.clip_preprocess(torch.from_numpy(x), 32).numpy()
    assert got.shape == (32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_loaders_without_their_model_raise(tmp_path):
    """Every loader has its model now: ``load_detr``, which raised until
    the DETR slice, loads a release checkpoint (here of the tiny DETR of
    tests/test_torch_detr.py) into the port's tree."""
    from test_torch_detr import (JCFG as DETR_J, TCFG as DETR_T,
                                 detr_numpy_params, release_state_dict)

    tree = detr_numpy_params(DETR_J)
    path = tmp_path / "detr.pth"
    torch.save({"model": release_state_dict(tree)}, path)
    params, cfg = clip_loader.load_detr(str(path), DETR_T, device="cpu")
    assert cfg is DETR_T
    np.testing.assert_array_equal(params["query_embed"].numpy(),
                                  tree["query_embed"])
    np.testing.assert_array_equal(
        params["encoder"]["self_attn"].w_k.numpy(),
        tree["encoder"]["self_attn"].w_k)


def test_cli_explain_clip_on_cpu(monkeypatch, tmp_path, capsys):
    """``explain-clip`` writes one figure per text and prints the softmax;
    the tiny config stands in for ViT-B/32 to keep the test short."""
    from PIL import Image

    monkeypatch.setattr(tclip, "CLIP_VIT_B_32", dataclasses.replace(
        TCFG, vocab_size=49408, context_length=77))
    arr = (np.random.RandomState(14).rand(40, 60, 3) * 255).astype(np.uint8)
    Image.fromarray(arr).save(tmp_path / "in.png")
    prefix = str(tmp_path / "rel")
    assert cli.main(["explain-clip", str(tmp_path / "in.png"), "a dog",
                     "a cat", "a tree", "--device", "cpu", "--start-layer",
                     "0", "--output-prefix", prefix]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    got = json.loads(out)
    assert len(got["probs"]) == 3 and abs(sum(got["probs"]) - 1) < 1e-5
    assert got["outputs"] == [f"{prefix}_{i}.png" for i in range(3)]
    for path in got["outputs"]:
        assert np.asarray(Image.open(path)).shape == (32, 32, 3)


def test_cli_explain_clip_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        cli.main(["explain-clip", str(tmp_path / "missing.png"), "a dog"])
