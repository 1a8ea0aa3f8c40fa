"""The port's DETR model and explanation methods against the JAX package:
``forward`` on plain and padded images, ``capture_multi`` (against JAX and
against the port's own ``capture`` of the image replicated K times), the
seven non-LRP method names through ``generate``, the three LRP names
(relprop with the forward's key-padding bias), the padded-token rule of
the relevancy chain, the R50 backbone, and the release state-dict
converter.

The transformer is the JAX tests' tiny one (D 32, 4 heads, 2 + 2 layers,
6 queries, 7 classes; tests/test_detr.py:24-32) on 64×96 images. Its
backbone is cut to one bottleneck per stage (width 64, 2048 channels out)
to keep the JAX references' compile time small; the R50 backbone is held
on its own. Weights are numpy draws in the JAX package's tree (the
structure of its ``init_params``, from ``jax.eval_shape``) carried across
with ``detr_from_jax_numpy``; inputs are numpy from a seed. Each JAX
reference is computed once per module, in one jitted call.

Stated tolerances: rtol 1e-4 / atol 1e-5 for logits, boxes, captured
probabilities and gradients and relevancy rows; the converters' parameters
exactly. The LRP methods' rows against JAX's relprop with ``mask=bias``:
1e-4 · max|row| for ``transformer_att`` and ``partial_lrp`` (measured
3.1e-5), 1e-3 · max|row| for ``ours_with_lrp`` (measured 2.5e-4 in fp32):
its chain normalises rows of signed LRP cams, and the elementwise cams
already differ by up to 2.1e-3 of their size between two fp32
implementations (``tests/test_torch_lrp.py``). A float64 comparison does
not help there: JAX's chain takes Ê in fp32 and its LayerNorm keeps fp32
statistics under x64 (measured 8.0e-4). The port's chain on JAX's cams is
held to rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import detr as jexpl
from transformer_mm_explainability_tpu.models import detr as jdetr
from transformer_mm_explainability_tpu.models import detr_lrp as jdetr_lrp
from transformer_mm_explainability_tpu.models import resnet as jresnet
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu_torch.explain import detr as texpl
from transformer_mm_explainability_tpu_torch.models import detr as tdetr
from transformer_mm_explainability_tpu_torch.models import resnet as tresnet
from transformer_mm_explainability_tpu_torch.ops import relevancy as trl
from transformer_mm_explainability_tpu_torch.utils import clip_loader
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

from test_torch_visual_bert import flat

TINY = dict(num_classes=7, num_queries=6, d_model=32, nheads=4,
            num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=64,
            backbone_stages=(1, 1, 1, 1))
JCFG, TCFG = jdetr.DETRConfig(**TINY), tdetr.DETRConfig(**TINY)
TOL = dict(rtol=1e-4, atol=1e-5)
METHODS = ("ours_no_lrp", "ours_no_lrp_no_norm", "ablation_no_self_in_10",
           "ablation_no_aggregation", "raw_attn", "attn_gradcam", "rollout")
TQ = np.array([0, 3, 5, 1])      # explained queries
TC = np.array([1, 2, 6, 0])      # and their classes


def detr_numpy_params(cfg, seed=0):
    """``jdetr.init_params``'s tree for ``cfg`` filled with numpy draws:
    He-scaled convs, 1/√fan_in matrices, BN / LN scales and variances near
    1, small nonzero biases (zero biases zero the first decoder layer's
    values, and with them most of the tiny model's relevancy)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        key = path[-1]
        key = getattr(key, "key", getattr(key, "name", None))
        shape = s.shape
        r = rng.randn(*shape)
        if key == "var":
            x = 1 + 0.1 * np.abs(r)
        elif key in ("weight", "scale"):
            x = 1 + 0.1 * r
        elif len(shape) == 4:                        # HWIO conv
            x = r * np.sqrt(2.0 / np.prod(shape[:3]))
        elif key == "query_embed":
            x = r
        elif len(shape) >= 2:                        # [.., in, out]
            x = r / np.sqrt(shape[-2])
        else:
            x = 0.1 * r
        return np.asarray(x, np.float32)

    shapes = jax.eval_shape(lambda: jdetr.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def image_and_valid(h=64, w=96, seed=0):
    """A normalised-scale image and a pad mask whose valid block covers
    the top-left 40×60: on the 2×3 feature grid (the strided pick of
    pixels 0 and 32, 0, 32 and 64) the last column is padded."""
    img = np.random.RandomState(seed).randn(h, w, 3).astype(np.float32)
    valid = np.zeros((h, w), np.float32)
    valid[:40, :60] = 1.0
    return img, valid


def jax_relprop_cams(params, image, oh, cfg, pad_valid, masked=True):
    """JAX ``explain/detr._relprop_cams`` with ``mask=bias`` passed on to
    ``detr_lrp.relprop`` when ``masked`` (JAX's own omits it, so its
    relprop recomputes unmasked probabilities)."""
    feats = jresnet.forward(params["backbone"], image[None],
                            dilation_last=cfg.dilation)
    _, Hf, Wf, C = feats.shape
    src = (feats.reshape(1, Hf * Wf, C) @ params["input_proj"]["w"]
           + params["input_proj"]["b"])
    valid = pad_valid[None][:, ::image.shape[0] // Hf,
                            ::image.shape[1] // Wf][:, :Hf, :Wf]
    pos = jdetr.sine_position_encoding(valid, cfg.d_model // 2).reshape(
        1, Hf * Wf, cfg.d_model)
    bias = ((1.0 - valid.reshape(1, Hf * Wf)) * -1e9)[:, None, None, :]
    hs, _, _, tape = jdetr.transformer_forward(
        params, src, pos, bias, cfg, jdetr.zero_taps(cfg, 1, Hf * Wf),
        return_tape=True)
    cams = jax.vmap(lambda o: jdetr_lrp.relprop(
        params, tape, hs, o[None], cfg,
        mask=bias if masked else None)[1])(oh)
    return jdetr.DETRTaps(*(jnp.moveaxis(c[:, :, 0], 0, 1) for c in cams))


@pytest.fixture(scope="module")
def jparams():
    return detr_numpy_params(JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tconvert.detr_from_jax_numpy(jparams, TCFG, device="cpu")


@pytest.fixture(scope="module")
def jref(jparams):
    """Every JAX reference of this module from one jitted call: one
    ``capture_multi`` per image (with and without the pad mask), its
    forward's outputs, and each method's rows as ``jexpl.generate``
    computes them from that capture (its dispatch, without a capture per
    method)."""
    img, valid = image_and_valid()
    tq, tc = jnp.asarray(TQ), jnp.asarray(TC)
    oh = jexpl._one_hots(tq, tc, JCFG)
    take = lambda R: jnp.take_along_axis(R, tq[:, None, None], axis=1)[:, 0]

    def refs(p, im, v):
        out, attn, grads = jdetr.capture_multi(p, im, oh, v, JCFG)
        tv = jexpl._token_valid(im, v, JCFG)

        def ours(a=attn, g=grads, tv=tv, **kw):
            return take(jexpl._per_example(
                a, g, lambda x, y: jexpl.relevancy_from_capture(
                    x, y, token_valid=tv, **kw)))

        plain, p_attn, p_grads = jdetr.capture_multi(p, im, oh, None, JCFG)
        return {
            "plain": (plain["pred_logits"], plain["pred_boxes"]),
            "padded": (out["pred_logits"], out["pred_boxes"]),
            "attn": attn, "grads": grads,
            "rows": {
                "ours_no_lrp": ours(),
                "ours_no_lrp_no_norm": ours(normalize_self_attention=False),
                "ablation_no_self_in_10": ours(apply_self_in_rule_10=False),
                "ablation_no_aggregation": ours(
                    normalize_self_attention=False, aggregate=False),
                "raw_attn": jexpl.generate_raw_attn(attn, tq),
                "attn_gradcam": jexpl.generate_attn_gradcam(attn, grads, tq),
                "rollout": jexpl.generate_rollout(attn, tq),
            },
            "rows_plain": ours(p_attn, p_grads, None),
        }

    out = jax.jit(refs)(jparams, jnp.asarray(img), jnp.asarray(valid))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("padded", [False, True])
def test_forward_equals_jax(tparams, jref, padded):
    img, valid = image_and_valid()
    mask = torch.tensor(valid)[None] if padded else None
    with torch.no_grad():
        out = tdetr.forward(tparams, torch.tensor(img)[None], mask, TCFG)
    want_logits, want_boxes = jref["padded" if padded else "plain"]
    assert out["feat_hw"] == (2, 3)
    np.testing.assert_allclose(out["pred_logits"].numpy(), want_logits, **TOL)
    np.testing.assert_allclose(out["pred_boxes"].numpy(), want_boxes, **TOL)


def test_capture_multi_equals_jax_and_replicated_capture(tparams, jref):
    """One forward + one K-batched backward gives JAX's vmapped-VJP
    gradients, and the port's own ``capture`` of the image replicated K
    times (each copy's one-hot in its batch row)."""
    img, valid = image_and_valid()
    oh = texpl._one_hots(torch.tensor(TQ), torch.tensor(TC), TCFG)
    out, attn, grads = tdetr.capture_multi(tparams, torch.tensor(img), oh,
                                           torch.tensor(valid), TCFG)
    assert out["pred_logits"].shape == (1, 6, 8)
    K = len(TQ)
    for fam in tdetr.DETRTaps._fields:
        a, g = getattr(attn, fam), getattr(grads, fam)
        assert a.shape == g.shape and a.shape[1] == K
        assert a.stride(1) == 0                  # a view, not K copies
        np.testing.assert_allclose(a.numpy(), getattr(jref["attn"], fam),
                                   **TOL)
        np.testing.assert_allclose(g.numpy(), getattr(jref["grads"], fam),
                                   **TOL)
    images = torch.tensor(img)[None].expand(K, -1, -1, -1)
    _, r_attn, r_grads = tdetr.capture(
        tparams, images, oh, torch.tensor(valid)[None].expand(K, -1, -1),
        TCFG)
    for fam in tdetr.DETRTaps._fields:
        np.testing.assert_allclose(getattr(grads, fam).numpy(),
                                   getattr(r_grads, fam).numpy(), **TOL)
        np.testing.assert_allclose(getattr(attn, fam).numpy(),
                                   getattr(r_attn, fam).numpy(), **TOL)


@pytest.mark.parametrize("method", METHODS)
def test_generate_equals_jax(tparams, jref, method):
    img, valid = image_and_valid()
    rows = texpl.generate(method, tparams, torch.tensor(img), TQ, TC, TCFG,
                          torch.tensor(valid)).numpy()
    want = jref["rows"][method]
    assert rows.shape == (4, 6) and not np.isnan(rows).any()
    top = np.abs(want).max()
    if method == "ablation_no_aggregation":
        # a product of every layer's Ê with no identity: its rows are
        # ~1e-11 here, so the absolute bar scales with them
        assert top > 0
        np.testing.assert_allclose(rows, want, rtol=1e-4, atol=1e-5 * top)
    else:
        assert top > 1e-3
        np.testing.assert_allclose(rows, want, **TOL)
    # padded tokens (the last column of the 2×3 grid) get nothing from the
    # encoder chain's rule-10 product
    if method.startswith("ours") or method == "ablation_no_self_in_10":
        assert np.abs(rows.reshape(4, 2, 3)[:, :, 2]).max() == 0.0


@pytest.mark.parametrize("method", ["ours_no_lrp",
                                    "ablation_no_aggregation"])
def test_float64_capture_gives_float64_rows(jref, method):
    """The chains keep a float64 capture's precision (the full-width
    no-aggregation rows lie below fp32's range, and only a float64 chain
    shows their size); its rows equal the fp32 ones within TOL of their
    size."""
    attn, grads = (tdetr.DETRTaps(*(torch.tensor(x) for x in t))
                   for t in (jref["attn"], jref["grads"]))
    img, valid = image_and_valid()
    tv = texpl._token_valid(torch.tensor(img), torch.tensor(valid), TCFG)
    tq = torch.tensor(TQ)
    got = texpl.rows_from_capture(method, tdetr.DETRTaps(*(
        x.double() for x in attn)), tdetr.DETRTaps(*(
            x.double() for x in grads)), tq, tv)
    want = texpl.rows_from_capture(method, attn, grads, tq, tv).numpy()
    top = np.abs(want).max()
    assert got.dtype == torch.float64 and top > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * top)


def test_generate_unpadded_equals_jax(tparams, jref):
    """Without a pad mask; ``generate_ours`` and ``generate_ours_no_agg``
    are the dispatch's "ours" rows."""
    img, valid = image_and_valid()
    img, valid = torch.tensor(img), torch.tensor(valid)
    rows = texpl.generate("ours_no_lrp", tparams, img, TQ, TC, TCFG)
    np.testing.assert_allclose(rows.numpy(), jref["rows_plain"], **TOL)
    torch.testing.assert_close(
        texpl.generate_ours(tparams, img, TQ, TC, TCFG), rows)
    torch.testing.assert_close(
        texpl.generate_ours_no_agg(tparams, img, TQ, TC, TCFG, valid),
        texpl.generate("ablation_no_aggregation", tparams, img, TQ, TC, TCFG,
                       valid))


@pytest.fixture(scope="module")
def jlrp(jparams):
    """JAX's rows of the three LRP methods on the padded image, from its
    relprop with the key-padding bias (one jitted call), and its cams."""
    img, valid = image_and_valid()
    tq, tc = jnp.asarray(TQ), jnp.asarray(TC)
    oh = jexpl._one_hots(tq, tc, JCFG)

    def refs(p, im, v):
        cams = jax_relprop_cams(p, im, oh, JCFG, v)
        _, _, grads = jdetr.capture_multi(p, im, oh, v, JCFG)
        tv = jexpl._token_valid(im, v, JCFG)
        R = jexpl._per_example(cams, grads, lambda a, g:
                               jexpl.relevancy_from_capture(
                                   a, g, token_valid=tv))
        return {"cams": cams, "grads": grads,
                "ours_with_lrp": jnp.take_along_axis(
                    R, tq[:, None, None], axis=1)[:, 0],
                "transformer_att": jexpl.generate_transformer_att(
                    cams, grads, tq),
                "partial_lrp": jexpl.generate_partial_lrp(cams, tq)}

    return jax.jit(refs)(jparams, jnp.asarray(img), jnp.asarray(valid))


@pytest.mark.parametrize("method", ["ours_with_lrp", "transformer_att",
                                    "partial_lrp"])
def test_lrp_methods_raise_naming_a4(tparams, jlrp, method):
    """The three LRP methods (which raised before the LRP engine was
    ported) through ``generate`` on the padded image, against JAX's
    relprop with the key-padding bias; the ours chain also on JAX's own
    cams and gradients."""
    assert method in texpl.DETR_METHODS and method in jexpl.DETR_METHODS
    img, valid = image_and_valid()
    rows = texpl.generate(method, tparams, torch.tensor(img), TQ, TC, TCFG,
                          torch.tensor(valid)).numpy()
    want = np.asarray(jlrp[method])
    top = np.abs(want).max()
    bar = 1e-3 if method == "ours_with_lrp" else 1e-4
    assert rows.shape == (4, 6) and top > 0 and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, want, rtol=0, atol=bar * top)
    if method == "ours_with_lrp":
        taps = lambda t: tdetr.DETRTaps(*(torch.tensor(np.asarray(x))
                                          for x in t))
        tv = texpl._token_valid(torch.tensor(img), torch.tensor(valid), TCFG)
        chain = texpl.relevancy_from_capture(taps(jlrp["cams"]),
                                             taps(jlrp["grads"]),
                                             token_valid=tv)
        np.testing.assert_allclose(texpl._rows(chain, torch.tensor(TQ)),
                                   want, **TOL)


def test_unknown_method_lists_the_valid_ones(tparams):
    assert texpl.DETR_METHODS == jexpl.DETR_METHODS
    with pytest.raises(ValueError, match="valid: .*rollout"):
        texpl.generate("bogus", tparams, torch.zeros(64, 96, 3), TQ, TC,
                       TCFG)


def test_padded_tokens_keep_identity_rows_and_no_nan():
    """Synthetic positive taps on 6 real tokens, zero-padded to 9: the
    padded tokens' R_ii rows stay identity rows through the encoder chain
    and ``handle_residual(valid=…)``; with ``token_valid`` the rows are
    NaN-free, their padded columns exactly 0 and the rest equal to the
    unpadded chain (and to the JAX package's); without it one padded
    token NaN-poisons rule 10 (tests/test_detr.py:291-336)."""
    rng = np.random.RandomState(5)
    L, H, Sr, Sp, Qn = 2, 3, 6, 9, 4
    pos = lambda *s: rng.rand(*s).astype(np.float32)
    tight = [pos(L, H, Sr, Sr), pos(L, H, Qn, Qn), pos(L, H, Qn, Sr)]
    tight_g = [pos(L, H, Sr, Sr), pos(L, H, Qn, Qn), pos(L, H, Qn, Sr)]

    def pad(x):
        out = np.zeros(x.shape[:-2] + (x.shape[-2], Sp), np.float32)
        if x.shape[-2] == Sr:
            out = np.zeros(x.shape[:-2] + (Sp, Sp), np.float32)
            out[..., :Sr, :Sr] = x
        else:
            out[..., :Sr] = x
        return out

    padded = [pad(tight[0]), tight[1], pad(tight[2])]
    padded_g = [pad(tight_g[0]), tight_g[1], pad(tight_g[2])]
    taps = lambda xs: tdetr.DETRTaps(*(torch.tensor(x) for x in xs))
    tv = torch.tensor((np.arange(Sp) < Sr).astype(np.float32))

    R_ii = torch.eye(Sp)
    for c, g in zip(taps(padded).enc_self, taps(padded_g).enc_self):
        R_ii = R_ii + trl.avg_heads(c, g) @ R_ii
    norm = trl.handle_residual(R_ii, tv)
    assert torch.equal(norm[Sr:], torch.eye(Sp)[Sr:])
    assert not torch.isnan(norm).any()

    want = texpl.relevancy_from_capture(taps(tight), taps(tight_g)).numpy()
    got = texpl.relevancy_from_capture(taps(padded), taps(padded_g),
                                       token_valid=tv).numpy()
    ref = np.asarray(jexpl.relevancy_from_capture(
        jdetr.DETRTaps(*map(jnp.asarray, tight)),
        jdetr.DETRTaps(*map(jnp.asarray, tight_g))))
    assert not np.isnan(got).any() and np.abs(want).sum() > 0
    np.testing.assert_allclose(got[:, :Sr], want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[:, Sr:], 0.0)
    np.testing.assert_allclose(want, ref, **TOL)
    unmasked = texpl.relevancy_from_capture(taps(padded), taps(padded_g))
    assert not np.allclose(unmasked[:, :Sr].numpy(), want, atol=1e-5)


def test_token_valid_is_the_strided_pick():
    img = torch.zeros(64, 64, 3)
    pv = torch.tensor((np.arange(64) < 32)[:, None] * np.ones((1, 64)),
                      dtype=torch.float32)
    tv = texpl._token_valid(img, pv, TCFG)
    want = np.asarray(jexpl._token_valid(jnp.asarray(img.numpy()),
                                         jnp.asarray(pv.numpy()), JCFG))
    np.testing.assert_array_equal(tv.numpy(), want)
    np.testing.assert_array_equal(tv.numpy(), [1.0, 1.0, 0.0, 0.0])


# --- the R50 backbone and the release converter -----------------------------

R50 = dataclasses.replace(JCFG, backbone_stages=(3, 4, 6, 3))
TR50 = dataclasses.replace(TCFG, backbone_stages=(3, 4, 6, 3))


@pytest.fixture(scope="module")
def jparams_r50():
    return detr_numpy_params(R50, seed=1)


def test_resnet50_backbone_equals_jax(jparams_r50):
    """DETR's backbone: the port's ``resnet.forward`` (torchvision stem,
    stride in the 3×3) against the JAX ``resnet.forward`` on R50, on a
    64×96 image (features [1, 2, 3, 2048])."""
    img, _ = image_and_valid()
    want = np.asarray(jax.jit(jresnet.forward)(jparams_r50["backbone"],
                                               jnp.asarray(img)[None]))
    tparams = tconvert.detr_from_jax_numpy(jparams_r50, TR50, device="cpu")
    with torch.no_grad():
        got = tresnet.forward(tparams["backbone"], torch.tensor(img)[None])
    assert got.shape == (1, 2, 3, 2048)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * scale)


def release_state_dict(tree):
    """The facebook DETR release layout (torchvision ResNet under
    ``backbone.0.body.``, torch-MHA fused ``in_proj``) built from a JAX
    numpy tree."""
    sd = {}
    t = lambda x: torch.tensor(np.ascontiguousarray(x))
    oihw = lambda w: t(np.transpose(w, (3, 2, 0, 1)))

    def bn(prefix, p):
        for ours, theirs in (("weight", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.{theirs}"] = t(p[ours])

    bb, pre = tree["backbone"], "backbone.0.body."
    sd[f"{pre}conv1.weight"] = oihw(bb["conv1"]["w"])
    bn(f"{pre}bn1", bb["bn1"])
    for si, blocks in enumerate(bb["layers"]):
        for bi, blk in enumerate(blocks):
            p = f"{pre}layer{si + 1}.{bi}"
            for c in ("1", "2", "3"):
                sd[f"{p}.conv{c}.weight"] = oihw(blk[f"conv{c}"]["w"])
                bn(f"{p}.bn{c}", blk[f"bn{c}"])
            if "downsample" in blk:
                sd[f"{p}.downsample.0.weight"] = oihw(blk["downsample"]["w"])
                bn(f"{p}.downsample.1", blk["downsample_bn"])
    sd["input_proj.weight"] = t(tree["input_proj"]["w"].T[:, :, None, None])
    sd["input_proj.bias"] = t(tree["input_proj"]["b"])
    sd["query_embed.weight"] = t(tree["query_embed"])

    def mha(prefix, a, i):
        sd[f"{prefix}.in_proj_weight"] = t(np.concatenate(
            [a.w_q[i].T, a.w_k[i].T, a.w_v[i].T]))
        sd[f"{prefix}.in_proj_bias"] = t(np.concatenate(
            [a.b_q[i], a.b_k[i], a.b_v[i]]))
        sd[f"{prefix}.out_proj.weight"] = t(a.w_out[i].T)
        sd[f"{prefix}.out_proj.bias"] = t(a.b_out[i])

    def common(prefix, layers, i, norms):
        sd[f"{prefix}.linear1.weight"] = t(layers["ffn"]["w1"][i].T)
        sd[f"{prefix}.linear1.bias"] = t(layers["ffn"]["b1"][i])
        sd[f"{prefix}.linear2.weight"] = t(layers["ffn"]["w2"][i].T)
        sd[f"{prefix}.linear2.bias"] = t(layers["ffn"]["b2"][i])
        for n in norms:
            sd[f"{prefix}.{n}.weight"] = t(layers[n]["scale"][i])
            sd[f"{prefix}.{n}.bias"] = t(layers[n]["bias"][i])

    enc, dec = tree["encoder"], tree["decoder"]
    for i in range(len(enc["norm1"]["scale"])):
        p = f"transformer.encoder.layers.{i}"
        mha(f"{p}.self_attn", enc["self_attn"], i)
        common(p, enc, i, ("norm1", "norm2"))
    for i in range(len(dec["norm1"]["scale"])):
        p = f"transformer.decoder.layers.{i}"
        mha(f"{p}.self_attn", dec["self_attn"], i)
        mha(f"{p}.multihead_attn", dec["cross_attn"], i)
        common(p, dec, i, ("norm1", "norm2", "norm3"))
    sd["transformer.decoder.norm.weight"] = t(tree["decoder_norm"]["scale"])
    sd["transformer.decoder.norm.bias"] = t(tree["decoder_norm"]["bias"])
    sd["class_embed.weight"] = t(tree["class_embed"]["w"].T)
    sd["class_embed.bias"] = t(tree["class_embed"]["b"])
    for i, lp in enumerate(tree["bbox_embed"]):
        sd[f"bbox_embed.layers.{i}.weight"] = t(lp["w"].T)
        sd[f"bbox_embed.layers.{i}.bias"] = t(lp["b"])
    return sd


def test_detr_to_state_dict_round_trips(tparams):
    """``detr_to_state_dict`` is the inverse of ``detr_from_state_dict``
    (the smoke writes its DETR checkpoint with it)."""
    sd = tconvert.detr_to_state_dict(tparams)
    assert sd.keys() == release_state_dict(detr_numpy_params(JCFG)).keys()
    back = tconvert.detr_from_state_dict(sd, TCFG, device="cpu")
    got, want = flat(back), flat(tparams)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_release_converters_equal_jax(jparams_r50, tmp_path):
    """``detr_from_state_dict`` (fused in_proj split, torchvision ResNet)
    and ``load_detr`` give the JAX converter's parameters exactly, in the
    port's layout (OIHW convs), and the numpy tree itself."""
    sd = release_state_dict(jparams_r50)
    want = jax.tree.map(np.asarray, jconvert.detr_from_state_dict(sd, R50))
    got = tconvert.detr_from_state_dict(sd, TR50, device="cpu")
    path = tmp_path / "detr.pth"
    torch.save({"model": sd}, path)
    loaded, cfg = clip_loader.load_detr(str(path), TR50, device="cpu")
    assert cfg is TR50
    hwio = lambda k, v: v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
    for tree in (got, loaded):
        ours = {k: hwio(k, v) for k, v in flat(tree).items()}
        theirs = flat(want)
        assert ours.keys() == theirs.keys()
        for k in theirs:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
            np.testing.assert_array_equal(ours[k], flat(jparams_r50)[k],
                                          err_msg=k)
    bb = tconvert.resnet_from_state_dict(sd, "backbone.0.body.",
                                         device="cpu")
    assert bb["conv1"]["w"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(bb["layers"][3][2]["conv3"]["w"].numpy(),
                                  got["backbone"]["layers"][3][2]["conv3"]
                                  ["w"].numpy())
