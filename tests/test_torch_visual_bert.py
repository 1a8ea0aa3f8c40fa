"""The port's VisualBERT against the JAX package: embeddings (with and
without image-text alignment), the forward with both poolers, ``capture``,
the streamed ``relevancy_row``, the four capture methods, the two LRP-cam
generators and the runner's three LRP methods end to end, and the MMF
checkpoint loader, at the tiny VisualBERT of ``cli perturbation``'s
synthetic run.

Weights are numpy draws in the JAX package's tree (the structure of its
``init_params``, from ``jax.eval_shape``), carried across with
``visual_bert_from_jax_numpy``; inputs are numpy from a seed, with padded
tokens and boxes. Stated tolerances, those of the LXMERT slice: rtol 1e-4
/ atol 1e-5 for scores, embeddings, attention and its gradients (fp32 on
both sides, in other summation orders); atol 1e-5 for every relevancy row;
1e-4 · max|row| for the LRP methods' rows, each example against the JAX
runner run on that example alone (the port's LRP sums are per example,
``ops/lrp``; measured ≤ 7.3e-5); the loaders' parameters exactly.
"""

import dataclasses
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import visual_bert as jexplain
from transformer_mm_explainability_tpu.harness import pert_runner as jrunner
from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import visual_bert as jvb
from transformer_mm_explainability_tpu.utils import mmf_loader as jmmf
from transformer_mm_explainability_tpu_torch.explain import (
    visual_bert as texplain)
from transformer_mm_explainability_tpu_torch.harness import pert_runner
from transformer_mm_explainability_tpu_torch.models import visual_bert as tvb
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert
from transformer_mm_explainability_tpu_torch.utils import mmf_loader as tmmf

TCFG = pert_runner.SMOKE_VISUAL_BERT
JCFG = jvb.VisualBERTConfig(bert=jbert.BertConfig(**pert_runner.SMOKE_BERT),
                            visual_embedding_dim=32, num_labels=13)
TOL = dict(rtol=1e-4, atol=1e-5)
MAP_TOL = dict(rtol=0, atol=1e-5)
B, ST, NV = 3, 12, 9
METHODS = ("ours_no_lrp", "raw_attn", "rollout", "attn_gradcam")


def numpy_params(init, seed=0):
    """``init()``'s JAX tree filled with numpy draws: std 0.02, LN scales
    near 1."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if getattr(path[-1], "key", None) == "scale":
            return np.asarray(1 + 0.1 * rng.randn(*s.shape), np.float32)
        return np.asarray(rng.randn(*s.shape) * 0.02, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


def vb_batch(seed=0, alignment=False):
    """Text rows of 12, 8 and 5 real tokens, 6 of 9 boxes in the first
    row; with ``alignment``, per-box word positions (−1 = pad)."""
    rng = np.random.RandomState(seed)
    im = np.ones((B, ST), np.int32)
    im[1, 8:] = 0
    im[2, 5:] = 0
    vm = np.ones((B, NV), np.int32)
    vm[0, 6:] = 0
    b = {"input_ids": rng.randint(1, 99, (B, ST)).astype(np.int32),
         "input_mask": im,
         "visual_embeddings": rng.randn(B, NV, 32).astype(np.float32),
         "visual_mask": vm}
    if alignment:
        ita = rng.randint(0, ST, (B, NV, 3)).astype(np.int32)
        ita[rng.rand(B, NV, 3) < 0.4] = -1
        ita[0, 0] = -1                      # a box with no aligned word
        b["image_text_alignment"] = ita
    return b


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tt(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jparams():
    return numpy_params(lambda: jvb.init_params(jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def tparams(jparams):
    return tconvert.visual_bert_from_jax_numpy(jparams, TCFG, device="cpu")


@pytest.fixture(scope="module")
def captures(jparams, tparams):
    """(JAX, port) ``capture`` of the padded batch for the predicted
    answers, numpy."""
    b = vb_batch()
    j = jax.jit(jvb.capture, static_argnums=3)(jparams, jx(b), None, JCFG)
    t = tvb.capture(tparams, tt(b), None, TCFG)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("alignment", [False, True])
def test_embed_equals_jax(jparams, tparams, alignment):
    b = vb_batch(1, alignment)
    j, t = jx(b), tt(b)
    want = jvb.embed(jparams, j["input_ids"], None, j["visual_embeddings"],
                     None, JCFG, image_text_alignment=j.get(
                         "image_text_alignment"))
    got = tvb.embed(tparams, t["input_ids"], None, t["visual_embeddings"],
                    None, TCFG, t.get("image_text_alignment"))
    assert got.shape == (B, ST + NV, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pooler", ["vqa", "default"])
def test_forward_equals_jax(jparams, tparams, pooler):
    b = vb_batch(2, alignment=pooler == "default")
    jcfg = dataclasses.replace(JCFG, pooler_strategy=pooler)
    tcfg = dataclasses.replace(TCFG, pooler_strategy=pooler)
    j, t = jx(b), tt(b)
    want = jvb.forward(jparams, j["input_ids"], j["input_mask"],
                       j["visual_embeddings"], visual_mask=j["visual_mask"],
                       image_text_alignment=j.get("image_text_alignment"),
                       cfg=jcfg, return_tape=True)
    with torch.no_grad():
        got = tvb.forward(tparams, t["input_ids"], t["input_mask"],
                          t["visual_embeddings"], visual_mask=t["visual_mask"],
                          image_text_alignment=t.get("image_text_alignment"),
                          cfg=tcfg, return_tape=True)
    for k in ("scores", "attn", "sequence_output"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(got["tape"]["pooled"].numpy(),
                               np.asarray(want["tape"]["pooled"]), **TOL)
    if pooler == "vqa":
        np.testing.assert_array_equal(got["tape"]["cls_index"].numpy(),
                                      [10, 6, 3])


def test_forward_visual_mask_defaults_to_ones(tparams):
    b = tt(vb_batch(3))
    with torch.no_grad():
        a = tvb.forward(tparams, b["input_ids"], b["input_mask"],
                        b["visual_embeddings"], cfg=TCFG)["scores"]
        c = tvb.forward(tparams, b["input_ids"], b["input_mask"],
                        b["visual_embeddings"],
                        visual_mask=torch.ones(B, NV, dtype=torch.int32),
                        cfg=TCFG)["scores"]
    assert torch.equal(a, c)


@pytest.mark.parametrize("i,name", [(0, "scores"), (1, "attn"), (2, "grads")])
def test_capture_predicted_equals_jax(captures, i, name):
    (j, t) = captures
    np.testing.assert_allclose(t[i], j[i], err_msg=name, **TOL)
    assert np.abs(j[i]).max() > 0


def test_capture_given_targets_equals_jax(jparams, tparams):
    b = vb_batch(4)
    targets = np.array([1, 7, 12], np.int32)
    js, ja, jg = jax.jit(jvb.capture, static_argnums=3)(
        jparams, jx(b), jnp.asarray(targets), JCFG)
    ts, ta, tg = tvb.capture(tparams, tt(b), torch.from_numpy(targets), TCFG)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    # the predicted-answer capture equals the capture of the argmax
    s2, _, g2 = tvb.capture(tparams, tt(b), ts.argmax(-1), TCFG)
    _, _, g0 = tvb.capture(tparams, tt(b), None, TCFG)
    assert torch.equal(g2, g0)


@pytest.mark.parametrize("targets", [None, [1, 7, 12]])
def test_relevancy_row_equals_jax_and_capture_chain(jparams, tparams,
                                                     targets):
    b = vb_batch(5)
    jt = None if targets is None else jnp.asarray(targets, jnp.int32)
    tgt = None if targets is None else torch.tensor(targets)
    js, jr = jax.jit(jvb.relevancy_row, static_argnums=3)(
        jparams, jx(b), jt, JCFG)
    ts, tr = tvb.relevancy_row(tparams, tt(b), tgt, TCFG)
    assert tr.shape == (B, ST + NV)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **MAP_TOL)
    _, attn, grads = tvb.capture(tparams, tt(b), tgt, TCFG)
    want = texplain.generate_ours(attn, grads,
                                  tvb.cls_index(torch.from_numpy(
                                      b["input_mask"])))
    np.testing.assert_allclose(tr.numpy(), want.numpy(), **MAP_TOL)
    assert np.abs(jr).max() > 0


def test_relevancy_row_starts_and_zeroes_at_the_question_mark(tparams):
    """The row is that of token ``input_mask.sum(1) - 2`` (not token 0) and
    that position reads 0 (the reference's CLS-row read)."""
    b = vb_batch(6)
    _, r = tvb.relevancy_row(tparams, tt(b), None, TCFG)
    ci = b["input_mask"].sum(1) - 2
    _, attn, grads = tvb.capture(tparams, tt(b), None, TCFG)
    from transformer_mm_explainability_tpu_torch.ops import relevancy as rl
    R = rl.self_attention_relevancy(attn.movedim(1, 0),
                                    grads.movedim(1, 0)).numpy()
    for i in range(B):
        assert r[i, ci[i]] == 0.0
        want = R[i, ci[i]].copy()
        want[ci[i]] = 0.0
        np.testing.assert_allclose(r[i].numpy(), want, **MAP_TOL)
        assert np.abs(r[i].numpy() - R[i, 0]).max() > 1e-4


@pytest.mark.parametrize("source", ["model", "synthetic"])
@pytest.mark.parametrize("method", METHODS)
def test_capture_methods_equal_jax(captures, method, source):
    """On the tiny model's capture (whose last-layer GradCAM is constant,
    so min-max gives NaN but 0 at the CLS position, in both packages) and
    on synthetic captures with random positive attention."""
    (_, ja, jg), (_, ta, tg) = captures
    ci = vb_batch()["input_mask"].sum(1) - 2
    if source == "synthetic":
        rng = np.random.RandomState(9)
        ja = ta = np.abs(rng.randn(*ta.shape)).astype(np.float32)
        jg = tg = rng.randn(*tg.shape).astype(np.float32)
    want = jexplain.METHODS_FROM_CAPTURE[method](
        jnp.asarray(ja), jnp.asarray(jg), jnp.asarray(ci))
    got = texplain.METHODS_FROM_CAPTURE[method](
        torch.from_numpy(ta), torch.from_numpy(tg), torch.from_numpy(ci))
    assert got.shape == (B, ST + NV)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MAP_TOL)
    assert (got.numpy()[np.arange(B), ci] == 0).all()
    if source == "synthetic":
        assert np.isfinite(got.numpy()).all()


def test_masking_a_box_equals_removing_it(tparams):
    """visual_mask 0 on box j gives the scores of the batch without box j
    (the perturbation protocol's premise)."""
    b = tt(vb_batch(7))
    vm = torch.ones(B, NV, dtype=torch.int32)
    vm[:, 4] = 0
    keep = [j for j in range(NV) if j != 4]
    with torch.no_grad():
        masked = tvb.forward(tparams, b["input_ids"], b["input_mask"],
                             b["visual_embeddings"], visual_mask=vm,
                             cfg=TCFG)["scores"]
        removed = tvb.forward(tparams, b["input_ids"], b["input_mask"],
                              b["visual_embeddings"][:, keep],
                              cfg=TCFG)["scores"]
    np.testing.assert_allclose(masked.numpy(), removed.numpy(), **TOL)


@pytest.mark.parametrize("fn,args", [
    ("generate_transformer_att", ("cams", "grads", "cls")),
    ("generate_partial_lrp", ("cams", "cls"))])
def test_lrp_methods_raise(captures, fn, args):
    """The LRP-cam generators (which raised before the LRP engine was
    ported) equal JAX's on the same cams: random signed ones, with the
    captured gradients."""
    (_, ja, jg), _ = captures
    rng = np.random.RandomState(8)
    cams = rng.randn(*ja.shape).astype(np.float32)
    cls = np.asarray([10, 6, 3], np.int32)
    vals = {"cams": cams, "grads": jg, "cls": cls}
    want = getattr(jexplain, fn)(*(jnp.asarray(vals[a]) for a in args))
    got = getattr(texplain, fn)(*(torch.from_numpy(np.array(vals[a]))
                                  for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MAP_TOL)
    assert np.abs(np.asarray(want)).max() > 0


LRP_METHODS = ("transformer_attribution", "partial_lrp", "ours_with_lrp")


@pytest.fixture(scope="module")
def lrp_rows(jparams):
    """The JAX runner's explain of each LRP method, one example at a
    time."""
    b = vb_batch()
    out = {}
    for method in LRP_METHODS:
        runner = jrunner.VisualBertPerturbationRunner(jparams, JCFG, method)
        out[method] = [runner.explain_batched(
            {k: v[i:i + 1] for k, v in b.items()}) for i in range(B)]
    return out


@pytest.mark.parametrize("method", LRP_METHODS)
def test_runner_lrp_methods_equal_jax_per_example(tparams, lrp_rows,
                                                  method):
    """The port's runner at B=3 against JAX's at B=1 per example."""
    runner = pert_runner.VisualBertPerturbationRunner(tparams, TCFG, method,
                                                      device="cpu")
    scores, cam = runner.explain_batched(vb_batch())
    for i, (js, jc) in enumerate(lrp_rows[method]):
        np.testing.assert_allclose(scores[i], js[0], **TOL)
        top = np.abs(jc[0]).max()
        assert top > 0 and np.isfinite(cam[i]).all()
        np.testing.assert_allclose(cam[i], jc[0], rtol=0, atol=1e-4 * top)


# ---------------------------------------------------------------------------
# the MMF checkpoint loader
# ---------------------------------------------------------------------------

def mmf_state_dict(cfg, seed=0):
    """An MMF visual_bert state dict (``model.`` prefix) for ``cfg``."""
    rng = np.random.RandomState(seed)
    D, Dm, bc = cfg.bert.hidden_size, cfg.bert.intermediate_size, cfg.bert
    sd = {}
    t = lambda *shape: torch.from_numpy(
        (rng.randn(*shape) * 0.02).astype(np.float32))

    def lin(p, din, dout):
        sd[f"{p}.weight"], sd[f"{p}.bias"] = t(dout, din), t(dout)

    def ln(p, n):
        sd[f"{p}.weight"] = 1 + t(n)
        sd[f"{p}.bias"] = t(n)

    e = "model.bert.embeddings"
    sd[f"{e}.word_embeddings.weight"] = t(bc.vocab_size, D)
    sd[f"{e}.position_embeddings.weight"] = t(bc.max_position_embeddings, D)
    sd[f"{e}.token_type_embeddings.weight"] = t(bc.type_vocab_size, D)
    ln(f"{e}.LayerNorm", D)
    lin(f"{e}.projection", cfg.visual_embedding_dim, D)
    sd[f"{e}.token_type_embeddings_visual.weight"] = t(bc.type_vocab_size, D)
    sd[f"{e}.position_embeddings_visual.weight"] = t(
        bc.max_position_embeddings, D)
    for i in range(bc.num_hidden_layers):
        p = f"model.bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", D, D)
        lin(f"{p}.attention.output.dense", D, D)
        ln(f"{p}.attention.output.LayerNorm", D)
        lin(f"{p}.intermediate.dense", D, Dm)
        lin(f"{p}.output.dense", Dm, D)
        ln(f"{p}.output.LayerNorm", D)
    lin("model.bert.pooler.dense", D, D)
    lin("model.classifier.0.dense", D, D)
    ln("model.classifier.0.LayerNorm", D)
    lin("model.classifier.1", D, cfg.num_labels)
    return sd


def flat(tree, prefix=""):
    """{path: numpy} over dicts, NamedTuples and lists of JAX or torch
    leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        leaf = tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)
        return {prefix: leaf}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("container", ["ckpt", "tar.gz"])
def test_mmf_loader_equals_jax(tmp_path, container):
    sd = mmf_state_dict(TCFG)
    path = tmp_path / "model.ckpt"
    torch.save({"model": sd}, path)
    if container == "tar.gz":
        tar = tmp_path / "visual_bert.tar.gz"
        with tarfile.open(tar, "w:gz") as tf:
            tf.add(path, arcname="visual_bert/model.ckpt")
        path = tar
    got, cfg = tmmf.load_visual_bert(str(path), TCFG, device="cpu")
    assert cfg is TCFG
    want, _ = jmmf.load_visual_bert(str(path), JCFG)
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys() and len(g) == 29
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # the loaded weights run and agree with the JAX package's forward
    b = vb_batch(8)
    with torch.no_grad():
        ts = tvb.forward(got, *(torch.from_numpy(b[k]) for k in (
            "input_ids", "input_mask", "visual_embeddings")), cfg=TCFG)
    js = jvb.forward(want, *(jnp.asarray(b[k]) for k in (
        "input_ids", "input_mask", "visual_embeddings")), cfg=JCFG)
    np.testing.assert_allclose(ts["scores"].numpy(), np.asarray(js["scores"]),
                               **TOL)


def test_loader_and_converter_reject_other_shapes(jparams):
    bigger = dataclasses.replace(TCFG, num_labels=14)
    with pytest.raises(ValueError, match="do not fit"):
        tconvert.visual_bert_from_jax_numpy(jparams, bigger, device="cpu")
    keys = {"model.module.x": 1, "module.y": 2, "model.z": 3, "w": 4}
    assert tmmf._strip_prefixes(keys) == jmmf._strip_prefixes(keys)


def test_init_params_has_the_jax_tree(tparams):
    got = flat(tvb.init_params(0, TCFG, "cpu"))
    want = flat(tparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
