"""The port's LXMERT slice against the JAX package: BERT encoder, LXMERT
forward and capture, every ``explain/lxmert`` function, the runner's
eleven methods (the four LRP ones through ``models/lxmert_lrp``) and the
converters, at the tiny LXMERT of ``cli perturbation``'s synthetic run.

Weights are numpy draws in the JAX package's tree (the structure of its
``init_params``, from ``jax.eval_shape``), carried across with
``lxmert_from_jax_numpy``; inputs are numpy from a seed, with padded tokens
and boxes. Stated tolerances: rtol 1e-4 / atol 1e-5 for ``qa_scores`` and
``capture``'s probabilities and gradients (fp32 on both sides, in other
summation orders); atol 1e-5 for every explanation map; 1e-4 · max|map|
for the LRP methods' maps, each example against JAX run on that example
alone (the port's LRP sums are per example, ``ops/lrp``; measured ≤ 1.1e-5
in fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import lxmert as jexplain
from transformer_mm_explainability_tpu.harness import pert_runner as jrunner
from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.utils import convert as jconvert
from transformer_mm_explainability_tpu_torch._device import params_to
from transformer_mm_explainability_tpu_torch.explain import lxmert as texplain
from transformer_mm_explainability_tpu_torch.harness import pert_runner
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

JCFG = jlx.LxmertConfig(**pert_runner.SMOKE_LXMERT)
TCFG = tlx.LxmertConfig(**pert_runner.SMOKE_LXMERT)
TOL = dict(rtol=1e-4, atol=1e-5)
MAP_TOL = dict(rtol=0, atol=1e-5)
B, ST, SV = 3, 12, 9
FAMILIES = jlx.LxmertTaps._fields


def lxmert_numpy_params(cfg, seed=0):
    """The JAX ``init_params`` tree for ``cfg``, filled with numpy draws:
    weights std 0.02, biases std 0.02, LN scales near 1."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.randn(*s.shape) * 0.02).astype(np.float32)

    shapes = jax.eval_shape(lambda: jlx.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def lxmert_batch(seed=0, padded=True):
    """Token ids, masks (rows of 12, 8 and 5 real tokens; 6 of 9 boxes in
    the first row) and visual inputs."""
    rng = np.random.RandomState(seed)
    am = np.ones((B, ST), np.int32)
    vm = np.ones((B, SV), np.int32)
    if padded:
        am[1, 8:] = 0
        am[2, 5:] = 0
        vm[0, 6:] = 0
    return {"input_ids": rng.randint(1, 99, (B, ST)).astype(np.int32),
            "attention_mask": am,
            "visual_feats": rng.randn(B, SV, 32).astype(np.float32),
            "visual_pos": rng.rand(B, SV, 4).astype(np.float32),
            "visual_mask": vm}


@pytest.fixture(scope="module")
def jparams():
    return lxmert_numpy_params(JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tconvert.lxmert_from_jax_numpy(jparams, TCFG, device="cpu")


@pytest.fixture(scope="module")
def captures(jparams, tparams):
    """(JAX, port) captures of the padded batch, numpy."""
    batch = lxmert_batch()
    js, ja, jg = jax.jit(jlx.capture, static_argnums=3)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, None, JCFG)
    ts, ta, tg = tlx.capture(tparams, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, None, TCFG)
    jnp_ = lambda taps: jlx.LxmertTaps(*(np.asarray(t) for t in taps))
    tnp = lambda taps: tlx.LxmertTaps(*(t.numpy() for t in taps))
    return (np.asarray(js), jnp_(ja), jnp_(jg)), (ts.numpy(), tnp(ta),
                                                  tnp(tg))


@pytest.mark.parametrize("visual_mask", [True, False])
def test_forward_qa_scores_equal_jax(jparams, tparams, visual_mask):
    batch = lxmert_batch(seed=1)
    if not visual_mask:
        del batch["visual_mask"]
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jax.jit(jlx.forward, static_argnames="cfg")(
        jparams, j["input_ids"], j["attention_mask"], j["visual_feats"],
        j["visual_pos"], visual_mask=j.get("visual_mask"), cfg=JCFG)
    with torch.no_grad():
        got = tlx.forward(tparams, t["input_ids"], t["attention_mask"],
                          t["visual_feats"], t["visual_pos"],
                          visual_mask=t.get("visual_mask"), cfg=TCFG)
    for k in ("qa_scores", "pooled", "lang_output", "visn_output"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_capture_equals_jax(captures, family):
    (js, ja, jg), (ts, ta, tg) = captures
    np.testing.assert_allclose(ts, js, **TOL)
    np.testing.assert_allclose(getattr(ta, family), getattr(ja, family),
                               **TOL)
    np.testing.assert_allclose(getattr(tg, family), getattr(jg, family),
                               **TOL)
    assert np.abs(getattr(jg, family)).max() > 0


def test_capture_given_targets_and_tape(tparams):
    batch = {k: torch.from_numpy(v) for k, v in lxmert_batch(2).items()}
    scores, attn, grads = tlx.capture(tparams, batch, None, TCFG)
    s2, _, g2 = tlx.capture(tparams, batch, scores.argmax(-1), TCFG)
    assert torch.equal(scores, s2)
    for a, b in zip(grads, g2):
        assert torch.equal(a, b)
    out = tlx.forward(tparams, batch["input_ids"], batch["attention_mask"],
                      batch["visual_feats"], batch["visual_pos"], cfg=TCFG,
                      return_tape=True)
    assert out["tape"]["lang"].shape == (TCFG.l_layers, B, ST, 64)
    assert out["tape"]["x"][1].shape == (TCFG.x_layers, B, SV, 64)


def test_bert_encoder_and_mask_equal_jax(jparams, tparams):
    rng = np.random.RandomState(3)
    h = rng.randn(2, 7, 64).astype(np.float32)
    m = np.ones((2, 7), np.int32)
    m[1, 4:] = 0
    jm = jbert.extended_attention_mask(jnp.asarray(m))
    tm = tbert.extended_attention_mask(torch.from_numpy(m))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jbert.encoder(jparams["lang_layers"], jnp.asarray(h), JCFG.bert,
                         jm, return_tape=True)
    got = tbert.encoder(tparams["lang_layers"], torch.from_numpy(h),
                        TCFG.bert, tm, return_tape=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# ---------------------------------------------------------------------------
# explain/lxmert on the same (JAX) captures
# ---------------------------------------------------------------------------

def _both(captures, names, lrp=False):
    """The JAX capture tensors as JAX and as torch arguments; with ``lrp``
    the cams are random, the gradients the captured ones."""
    (_, ja, jg), _ = captures
    caps = {"attn": ja, "grads": jg}
    if lrp:
        rng = np.random.RandomState(4)
        caps["cams"] = jlx.LxmertTaps(*(rng.rand(*a.shape).astype(np.float32)
                                        for a in ja))
    j = [jlx.LxmertTaps(*(jnp.asarray(a) for a in caps[n])) for n in names]
    t = [tlx.LxmertTaps(*(torch.from_numpy(np.array(a)) for a in caps[n]))
         for n in names]
    return j, t


EXPLAIN = [  # (function, captures it takes, keyword arguments, masks)
    ("generate_ours", ("attn", "grads"), {}, True),
    ("generate_ours", ("attn", "grads"), {}, False),
    ("generate_ours", ("attn", "grads"),
     {"normalize_self_attention": False}, True),
    ("generate_ours", ("attn", "grads"), {"apply_self_in_rule_10": False},
     True),
    ("generate_ours_no_agg", ("attn", "grads"),
     {"normalize_self_attention": False}, True),
    ("generate_raw_attn", ("attn",), {}, False),
    ("generate_attn_gradcam", ("attn", "grads"), {}, False),
    ("generate_rollout", ("attn",), {}, False),
]


@pytest.mark.parametrize("fn,args,kw,masks", EXPLAIN)
def test_explain_equals_jax(captures, fn, args, kw, masks):
    """With the padding masks, or without them (the padded rows then give
    NaN in both packages, in the same places)."""
    j, t = _both(captures, args)
    if masks:
        b = lxmert_batch()
        kw = dict(kw, text_valid=b["attention_mask"],
                  visual_valid=b["visual_mask"])
    want = getattr(jexplain, fn)(*j, **{k: jnp.asarray(v) if
                                        isinstance(v, np.ndarray) else v
                                        for k, v in kw.items()})
    got = getattr(texplain, fn)(*t, **{k: torch.from_numpy(v) if
                                       isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()})
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)
    if masks:
        assert all(np.isfinite(g.numpy()).all() for g in got)


@pytest.mark.parametrize("fn,kw", [
    ("generate_ours_lrp", {}),
    ("generate_ours_lrp", {"normalize_self_attention": False}),
    ("generate_partial_lrp", None), ("generate_transformer_att", {})])
def test_cam_explainers_equal_jax(captures, fn, kw):
    """The LRP-cam consumers are pure functions of given cams: random ones
    here."""
    args = ("cams",) if kw is None else ("cams", "grads")
    j, t = _both(captures, args, lrp=True)
    kw = kw or {}
    if fn == "generate_ours_lrp":
        b = lxmert_batch()
        jv = dict(text_valid=jnp.asarray(b["attention_mask"]),
                  visual_valid=jnp.asarray(b["visual_mask"]))
        tv = dict(text_valid=torch.from_numpy(b["attention_mask"]),
                  visual_valid=torch.from_numpy(b["visual_mask"]))
    else:
        jv = tv = {}
    want = getattr(jexplain, fn)(*j, **kw, **jv)
    got = getattr(texplain, fn)(*t, **kw, **tv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MAP_TOL)


# ---------------------------------------------------------------------------
# the runner's seven methods, end to end
# ---------------------------------------------------------------------------

RUNNER = {  # method: (JAX function, keyword arguments, takes the masks)
    "ours_no_lrp": ("generate_ours", {}, True),
    "ours_no_lrp_no_norm": ("generate_ours",
                            {"normalize_self_attention": False}, True),
    "ablation_no_self_in_10": ("generate_ours",
                               {"apply_self_in_rule_10": False}, True),
    "ablation_no_aggregation": ("generate_ours_no_agg",
                                {"normalize_self_attention": False}, True),
    "raw_attn": ("generate_raw_attn", {}, False),
    "rollout": ("generate_rollout", {}, False),
    "attn_gradcam": ("generate_attn_gradcam", {}, False),
}


@pytest.mark.parametrize("method", sorted(RUNNER))
def test_runner_methods_equal_jax(tparams, captures, method):
    """explain_batched of each non-LRP method == the JAX runner's explain
    (the JAX function of that method on the JAX capture, CLS rows)."""
    (js, ja, jg), _ = captures
    b = lxmert_batch()
    fn, kw, masks = RUNNER[method]
    j = [jlx.LxmertTaps(*(jnp.asarray(a) for a in caps))
         for caps in ((ja, jg) if fn not in ("generate_raw_attn",
                                             "generate_rollout") else (ja,))]
    if masks:
        kw = dict(kw, text_valid=jnp.asarray(b["attention_mask"]),
                  visual_valid=jnp.asarray(b["visual_mask"]))
    tt, ti = getattr(jexplain, fn)(*j, **kw)
    runner = pert_runner.LxmertPerturbationRunner(tparams, TCFG, method,
                                                  device="cpu")
    scores, cam_text, cam_image = runner.explain_batched(b)
    np.testing.assert_allclose(scores, js, **TOL)
    np.testing.assert_allclose(cam_text, np.asarray(tt)[:, 0], **MAP_TOL)
    np.testing.assert_allclose(cam_image, np.asarray(ti)[:, 0], **MAP_TOL)
    assert np.isfinite(cam_text).all() and np.isfinite(cam_image).all()


@pytest.fixture(scope="module")
def lrp_refs(jparams):
    """What the JAX runner's explain computes for each example alone: the
    capture, and the relprop cams of the predicted answer."""
    from transformer_mm_explainability_tpu.models import lxmert_lrp

    def one(p, bb):
        scores, attn, grads = jlx.capture(p, bb, None, JCFG)
        out = jlx.forward(p, bb["input_ids"], bb["attention_mask"],
                          bb["visual_feats"], bb["visual_pos"],
                          visual_mask=bb["visual_mask"], cfg=JCFG,
                          return_tape=True)
        oh = jax.nn.one_hot(jnp.argmax(scores, -1), JCFG.num_qa_labels)
        _, _, cams = lxmert_lrp.relprop(p, out["tape"], oh,
                                        out["tape"]["lang_mask"],
                                        out["tape"]["visn_mask"], JCFG)
        return scores, grads, cams

    b = lxmert_batch()
    run = jax.jit(one)
    return [(run(jparams, {k: jnp.asarray(v[i:i + 1])
                           for k, v in b.items()}),
             {k: jnp.asarray(b[k][i:i + 1])
              for k in ("attention_mask", "visual_mask")})
            for i in range(B)]


LRP_RUNNER = {  # method (or alias): the JAX runner's generator and kwargs
    "ours_with_lrp": ("generate_ours_lrp", {}, True),
    "ours_with_lrp_no_normalization": (
        "generate_ours_lrp", {"normalize_self_attention": False}, True),
    "transformer_att": ("generate_transformer_att", {}, False),
    "transformer_attribution": ("generate_transformer_att", {}, False),
    "partial_lrp": ("generate_partial_lrp", {}, False),
}


@pytest.mark.parametrize("method", ["ours_with_lrp", "partial_lrp",
                                    "transformer_att", "transformer_attribution",
                                    "ours_with_lrp_no_normalization"])
def test_lrp_methods_raise_not_implemented(tparams, lrp_refs, method):
    """The four LRP methods (and the alias), which raised before the LRP
    engine was ported: the port's runner at B=3 against the JAX runner's
    explain of each example alone."""
    runner = pert_runner.LxmertPerturbationRunner(tparams, TCFG, method,
                                                  device="cpu")
    scores, cam_text, cam_image = runner.explain_batched(lxmert_batch())
    fn, kw, masks = LRP_RUNNER[method]
    for i, ((js, jg, jcams), m) in enumerate(lrp_refs):
        args = (jcams,) if fn == "generate_partial_lrp" else (jcams, jg)
        if masks:
            kw = dict(kw, text_valid=m["attention_mask"],
                      visual_valid=m["visual_mask"])
        tt, ti = getattr(jexplain, fn)(*args, **kw)
        np.testing.assert_allclose(scores[i], np.asarray(js)[0], **TOL)
        for got, want in ((cam_text[i], np.asarray(tt)[0, 0]),
                          (cam_image[i], np.asarray(ti)[0, 0])):
            top = np.abs(want).max()
            assert top > 0 and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * top)


def test_unknown_method_and_visual_bert_runner_raise(tparams):
    with pytest.raises(ValueError, match="unknown lxmert"):
        pert_runner.LxmertPerturbationRunner(tparams, TCFG, "grad_x_input",
                                             device="cpu")
    with pytest.raises(ValueError, match="unknown visual_bert"):
        pert_runner.VisualBertPerturbationRunner(None, None, "grad_x_input",
                                                 device="cpu")
    # every LRP method of both tables resolves (VisualBERT's alias too)
    for method in ("partial_lrp", "transformer_att", "ours_with_lrp"):
        assert pert_runner._resolve(
            method, pert_runner.VISUALBERT_METHODS + ("ours_with_lrp",),
            pert_runner._VISUALBERT_ALIASES, "visual_bert") \
            in pert_runner._VB_NEEDS_LRP
    for method in pert_runner._LX_NEEDS_LRP:
        assert pert_runner.LxmertPerturbationRunner(
            tparams, TCFG, method, device="cpu").method == method
    assert pert_runner.LXMERT_METHODS == jrunner.LXMERT_METHODS
    assert pert_runner._LX_NEEDS_LRP == jrunner._LX_NEEDS_LRP
    assert pert_runner.VISUALBERT_METHODS == jrunner.VISUALBERT_METHODS
    assert pert_runner._VB_NEEDS_LRP == jrunner._VB_NEEDS_LRP
    assert pert_runner._VISUALBERT_ALIASES == jrunner._VISUALBERT_ALIASES


# ---------------------------------------------------------------------------
# converters and init
# ---------------------------------------------------------------------------

def _hf_lxmert_state_dict(cfg, seed=0):
    """An HF-layout LXMERT state dict (``lxmert.`` prefix) for ``cfg``."""
    rng = np.random.RandomState(seed)
    D, Dm = cfg.hidden_size, cfg.intermediate_size
    sd = {}

    def lin(p, din, dout):
        sd[f"{p}.weight"] = torch.from_numpy(
            (rng.randn(dout, din) * 0.05).astype(np.float32))
        sd[f"{p}.bias"] = torch.from_numpy(
            (rng.randn(dout) * 0.02).astype(np.float32))

    def ln(p, n):
        sd[f"{p}.weight"] = torch.from_numpy(
            (1 + 0.1 * rng.randn(n)).astype(np.float32))
        sd[f"{p}.bias"] = torch.from_numpy(
            (0.02 * rng.randn(n)).astype(np.float32))

    def bert_layer(p):
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", D, D)
        lin(f"{p}.attention.output.dense", D, D)
        ln(f"{p}.attention.output.LayerNorm", D)
        lin(f"{p}.intermediate.dense", D, Dm)
        lin(f"{p}.output.dense", Dm, D)
        ln(f"{p}.output.LayerNorm", D)

    def att(p_att, p_out):
        for n in ("query", "key", "value"):
            lin(f"{p_att}.{n}", D, D)
        lin(f"{p_out}.dense", D, D)
        ln(f"{p_out}.LayerNorm", D)

    for name, n in (("word", cfg.vocab_size),
                    ("position", cfg.max_position_embeddings),
                    ("token_type", cfg.type_vocab_size)):
        sd[f"embeddings.{name}_embeddings.weight"] = torch.from_numpy(
            (rng.randn(n, D) * 0.05).astype(np.float32))
    ln("embeddings.LayerNorm", D)
    lin("encoder.visn_fc.visn_fc", cfg.visual_feat_dim, D)
    ln("encoder.visn_fc.visn_layer_norm", D)
    lin("encoder.visn_fc.box_fc", cfg.visual_pos_dim, D)
    ln("encoder.visn_fc.box_layer_norm", D)
    for i in range(cfg.l_layers):
        bert_layer(f"encoder.layer.{i}")
    for i in range(cfg.r_layers):
        bert_layer(f"encoder.r_layers.{i}")
    for i in range(cfg.x_layers):
        p = f"encoder.x_layers.{i}"
        att(f"{p}.visual_attention.att", f"{p}.visual_attention.output")
        att(f"{p}.lang_self_att.self", f"{p}.lang_self_att.output")
        att(f"{p}.visn_self_att.self", f"{p}.visn_self_att.output")
        for side in ("lang", "visn"):
            lin(f"{p}.{side}_inter.dense", D, Dm)
            lin(f"{p}.{side}_output.dense", Dm, D)
            ln(f"{p}.{side}_output.LayerNorm", D)
    lin("pooler.dense", D, D)
    lin("answer_head.logit_fc.0", D, 2 * D)
    ln("answer_head.logit_fc.2", 2 * D)
    lin("answer_head.logit_fc.3", 2 * D, cfg.num_qa_labels)
    return {f"lxmert.{k}": v for k, v in sd.items()}


def test_lxmert_from_state_dict_equals_jax_converter():
    sd = _hf_lxmert_state_dict(TCFG)
    jp = jconvert.lxmert_from_state_dict(sd, JCFG)
    tp = tconvert.lxmert_from_state_dict(sd, TCFG, device="cpu")
    rebuilt = tconvert.lxmert_from_jax_numpy(jax.tree.map(np.asarray, jp),
                                             TCFG, device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(rebuilt)):
        assert torch.equal(a, b)
    # both cross directions share the visual_attention output LN
    assert torch.equal(tp["x_layers"]["cross_ln_lang"]["scale"],
                       tp["x_layers"]["cross_ln_visn"]["scale"])
    b = lxmert_batch(5)
    want = jax.jit(jlx.forward, static_argnames="cfg")(
        jp, *(jnp.asarray(b[k]) for k in ("input_ids", "attention_mask",
                                          "visual_feats", "visual_pos")),
        visual_mask=jnp.asarray(b["visual_mask"]), cfg=JCFG)["qa_scores"]
    with torch.no_grad():
        got = tlx.forward(tp, *(torch.from_numpy(b[k]) for k in (
            "input_ids", "attention_mask", "visual_feats", "visual_pos")),
            visual_mask=torch.from_numpy(b["visual_mask"]),
            cfg=TCFG)["qa_scores"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    enc = tconvert.bert_encoder_from_state_dict(
        {k[len("lxmert."):]: v for k, v in sd.items()}, TCFG.l_layers,
        "encoder.layer", device="cpu")
    for a, b_ in zip(enc["attn"], tp["lang_layers"]["attn"]):
        assert torch.equal(a, b_)
    with pytest.raises(ValueError, match="layer counts"):
        tconvert.lxmert_from_jax_numpy(jax.tree.map(np.asarray, jp),
                                       dataclasses.replace(TCFG, x_layers=3),
                                       device="cpu")


def test_init_params_seeded_and_moved():
    a = tlx.init_params(7, TCFG, device="cpu")
    b = tlx.init_params(torch.Generator().manual_seed(7), TCFG, device="cpu")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    moved = params_to(a, "cpu")
    assert all(x is y for x, y in zip(jax.tree.leaves(a),
                                      jax.tree.leaves(moved)))
    shapes = jax.eval_shape(lambda: jlx.init_params(jax.random.PRNGKey(0),
                                                    JCFG))
    assert [tuple(t.shape) for t in jax.tree.leaves(a)] == [
        s.shape for s in jax.tree.leaves(shapes)]
