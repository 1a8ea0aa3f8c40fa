"""The port's LRP engine against the JAX package: every rule of
``ops/lrp.py`` and ``ops/rap.py``, ``models/bert_lrp``,
``models/visual_bert.relprop`` (both variants), ``models/lxmert_lrp`` (all
six cam families) and ``models/detr_lrp`` (the K-batched relprop, the
value-collapse branch, the key-padding bias).

Inputs are numpy from a seed; model weights are the JAX trees of the
other port tests (numpy draws) carried across with the ``*_from_jax_numpy``
converters, at their tiny configs (2 layers, D ≤ 64).

**Per-example semantics.** The port reduces every whole-tensor sum of the
rules per example (``ops/lrp.example_sum``), the reference's one-sample
protocol; the JAX package sums over the batch too. So the port at B > 1
is held to JAX run one example at a time, and JAX's own B > 1 run is shown
to differ from that (ROADMAP §C, intended departures).

Stated tolerances:
  * op rules: rtol 1e-5, atol 1e-6 · max|want| (fp32; the same formulas);
  * relprop cams: 5e-3 · max|family| per family (fp32). Elementwise LRP
    cams are ill-conditioned: ``safe_divide`` of a near-cancelling sum (a
    residual add, ``probs @ v``, ``q @ kᵀ``) turns an fp32 rounding step
    into a large relative change where the sum nears 0, so two correct
    implementations with other summation orders differ there. Measured
    (fp32): VisualBERT ≤ 6.9e-5, LXMERT ≤ 5.9e-4, DETR ≤ 2.1e-3. A float64
    comparison does not remove it: the JAX package's LayerNorm keeps fp32
    statistics under x64 (its ``ops/attention.layer_norm`` casts), and
    measured LXMERT float64 cams still differ by 6.1e-4, DETR's by
    1.1e-4. JAX's batch coupling moves the cams by 2.7e-3 to 2.0 of
    max|family|;
  * the methods' maps, which the generators build from the cams, meet the
    repo's target 1e-4 · max|want| in fp32 (see the per-family test files).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import detr as jexpl_detr
from transformer_mm_explainability_tpu.models import bert as jbert
from transformer_mm_explainability_tpu.models import bert_lrp as jbert_lrp
from transformer_mm_explainability_tpu.models import detr_lrp as jdetr_lrp
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import lxmert_lrp as jlx_lrp
from transformer_mm_explainability_tpu.models import visual_bert as jvb
from transformer_mm_explainability_tpu.ops import lrp as jlrp
from transformer_mm_explainability_tpu.ops import rap as jrap
from transformer_mm_explainability_tpu_torch.explain import detr as texpl_detr
from transformer_mm_explainability_tpu_torch.harness import pert_runner
from transformer_mm_explainability_tpu_torch.models import bert as tbert
from transformer_mm_explainability_tpu_torch.models import bert_lrp as tbert_lrp
from transformer_mm_explainability_tpu_torch.models import detr as tdetr
from transformer_mm_explainability_tpu_torch.models import detr_lrp as tdetr_lrp
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.models import lxmert_lrp as tlx_lrp
from transformer_mm_explainability_tpu_torch.models import visual_bert as tvb
from transformer_mm_explainability_tpu_torch.ops import lrp as tlrp
from transformer_mm_explainability_tpu_torch.ops import rap as trap
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

import test_torch_detr as tdetr_tests
import test_torch_lxmert as tlx_tests
import test_torch_visual_bert as tvb_tests

CAM_BAR = 5e-3


def close(got, want, rtol=1e-5, atol=1e-6):
    """``got`` within rtol and atol · max|want| of ``want``."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def cam_close(got, want, bar=CAM_BAR):
    """max|Δ| ≤ bar · max|want| (the relprop cams' stated bar)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    top = np.abs(want).max()
    assert got.shape == want.shape and top > 0
    err = np.abs(got - want).max()
    assert err <= bar * top, f"{err:.3e} > {bar:g} · {top:.3e}"


def rel_dist(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def draws(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


T = lambda a: torch.from_numpy(np.array(a))
J = jnp.asarray


# ---------------------------------------------------------------------------
# ops/lrp.py
# ---------------------------------------------------------------------------

def test_safe_divide_pins_the_reference_guard():
    """den = clamp(b, min=1e-9) + clamp(b, max=1e-9) (= b + 1e-9); +1e-9
    where that is 0 (b = -1e-9); the result 0 where b == 0."""
    b = np.array([0.0, 1e-9, -1e-9, 2.0, -3.0, 1e-12, -5e-10], np.float32)
    a = np.array([1.0, 2.0, 3.0, 4.0, -5.0, 6.0, 7.0], np.float32)
    got = tlrp.safe_divide(T(a), T(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jlrp.safe_divide(J(a),
                                                                   J(b))))
    assert got[0] == 0.0                                     # b == 0
    np.testing.assert_allclose(got[2], 3.0 / 1e-9, rtol=1e-6)  # den 0
    np.testing.assert_allclose(got[1], 2.0 / np.float32(2e-9), rtol=1e-6)
    np.testing.assert_allclose(got[3], 4.0 / (2.0 + 1e-9), rtol=1e-6)


@pytest.mark.parametrize("halve", [True, False])
def test_matmul_relprop_equals_jax_and_halves(halve):
    a, b, R = draws(1, (2, 3, 5, 4), (2, 3, 4, 6), (2, 3, 5, 6))
    got = tlrp.matmul_relprop(T(a), T(b), T(R), halve)
    want = jlrp.matmul_relprop(J(a), J(b), J(R), halve)
    for g, w in zip(got, want):
        close(g, w)
    if halve:
        full = tlrp.matmul_relprop(T(a), T(b), T(R), False)
        for g, f in zip(got, full):
            torch.testing.assert_close(g, f / 2, rtol=0, atol=0)


def test_add_relprop_simple_and_clone_equal_jax():
    x1, x2, R, r2 = draws(2, (2, 4, 6), (2, 4, 6), (2, 4, 6), (2, 4, 6))
    for g, w in zip(tlrp.add_relprop_simple(T(x1), T(x2), T(R)),
                    jlrp.add_relprop_simple(J(x1), J(x2), J(R))):
        close(g, w)
    close(tlrp.clone_relprop(T(x1), [T(R), T(r2)]),
          jlrp.clone_relprop(J(x1), [J(R), J(r2)]))


def test_add_relprop_is_per_example_with_a_broadcast_mask():
    """The masked attention's split: scores ``[B, H, S, S]`` + mask
    ``[B, 1, 1, S]``. At B=2 each example equals JAX's B=1 run of it (the
    mask's cotangent summed over the broadcast axes), and JAX's B=2 run
    (whole-tensor sums) differs."""
    scores, R = draws(3, (2, 3, 5, 5), (2, 3, 5, 5))
    mask = np.zeros((2, 1, 1, 5), np.float32)
    mask[1, ..., 3:] = -10000.0
    got = tlrp.add_relprop(T(scores), T(mask), T(R))
    assert got[1].shape == (2, 1, 1, 5)
    for i in range(2):
        one = jlrp.add_relprop(J(scores[i:i + 1]), J(mask[i:i + 1]),
                               J(R[i:i + 1]))
        for g, w in zip(got, one):
            close(g[i:i + 1], w)
        # the totals split R's total of this example alone
        np.testing.assert_allclose(
            float(got[0][i].sum() + got[1][i].sum()), float(R[i].sum()),
            rtol=1e-4)
    # JAX's whole-batch totals: exact for the first branch here (example
    # 0's mask is 0, and its branch takes all of its total either way),
    # but not for two live branches
    x1, x2, R2 = draws(17, (2, 4, 6), (2, 4, 6), (2, 4, 6))
    got = tlrp.add_relprop(T(x1), T(x2), T(R2))
    joint = jlrp.add_relprop(J(x1), J(x2), J(R2))
    one = jlrp.add_relprop(J(x1[:1]), J(x2[:1]), J(R2[:1]))
    close(got[0][:1], one[0])
    assert rel_dist(joint[0][:1], one[0]) > 1e-2


def test_rules_broadcast_a_shared_operand_per_example():
    """An operand with a leading axis of 1 against a relevance batched over
    K (DETR's tape against K queries) gives each k what JAX gives that k's
    relevance alone: no sum over K."""
    x1, x2, R = draws(4, (1, 4, 6), (1, 4, 6), (3, 4, 6))
    a, b, Rm = draws(5, (1, 2, 4, 5), (1, 2, 5, 3), (3, 2, 4, 3))
    got_add = tlrp.add_relprop(T(x1), T(x2), T(R))
    got_mm = tlrp.matmul_relprop(T(a), T(b), T(Rm))
    for k in range(3):
        for g, w in zip(got_add, jlrp.add_relprop(J(x1), J(x2),
                                                  J(R[k:k + 1]))):
            close(g[k:k + 1], w)
        for g, w in zip(got_mm, jlrp.matmul_relprop(J(a), J(b),
                                                    J(Rm[k:k + 1]))):
            close(g[k:k + 1], w)


@pytest.mark.parametrize("uniform,alpha", [(True, 1.0), (False, 1.0),
                                           (True, 2.0), (False, 2.0)])
def test_linear_alpha_beta_equals_jax(uniform, alpha):
    R, x, w = draws(6, (2, 5, 7), (2, 5, 6), (6, 7))
    got = tlrp.linear_alpha_beta(T(R), T(x), T(w), alpha, uniform)
    close(got, jlrp.linear_alpha_beta(J(R), J(x), J(w), alpha, uniform))


def test_linear_alpha_beta_uniform_false_splits_per_branch():
    """BERT_orig_lrp's variant: S1 = R/Z1 and S2 = R/Z2 (one shared
    S = R/(Z1+Z2) in the uniform rule)."""
    R, x, w = draws(7, (3, 7), (3, 6), (6, 7))
    R, x, w = T(R), T(x), T(w)
    px, nx, pw, nw = (x.clamp(min=0), x.clamp(max=0), w.clamp(min=0),
                      w.clamp(max=0))
    want = (px * (tlrp.safe_divide(R, px @ pw) @ pw.T)
            + nx * (tlrp.safe_divide(R, nx @ nw) @ nw.T))
    torch.testing.assert_close(tlrp.linear_alpha_beta(R, x, w,
                                                      uniform=False), want)
    assert rel_dist(tlrp.linear_alpha_beta(R, x, w).numpy(),
                    want.numpy()) > 1e-2


def test_index_select_and_cat_relprop_equal_jax():
    x, R, y, Rc = draws(8, (2, 5, 3), (2, 2, 3), (2, 4, 3), (2, 9, 3))
    idx = np.array([4, 1])
    close(tlrp.index_select_relprop(T(x), 1, T(idx), T(R)),
          jlrp.index_select_relprop(J(x), 1, J(idx), J(R)))
    for g, w in zip(tlrp.cat_relprop([T(x), T(y)], 1, T(Rc)),
                    jlrp.cat_relprop([J(x), J(y)], 1, J(Rc))):
        close(g, w)
    f = lambda a, b: a * b
    for g, w in zip(tlrp.relprop_simple(f, [T(x), T(x[::-1])], T(x)),
                    jlrp.relprop_simple(f, [J(x), J(x[::-1])], J(x))):
        close(g, w)


# ---------------------------------------------------------------------------
# ops/rap.py
# ---------------------------------------------------------------------------

def test_rap_simple_add_cat_equal_jax():
    x1, x2, R, Rc = draws(9, (2, 4, 3), (2, 4, 3), (2, 4, 3), (2, 8, 3))
    for g, w in zip(trap.rap_add(T(x1), T(x2), T(R)),
                    jrap.rap_add(J(x1), J(x2), J(R))):
        close(g, w)
    f = lambda a, b: a * b
    for g, w in zip(trap.rap_simple(f, [T(x1), T(x2)], T(R)),
                    jrap.rap_simple(f, [J(x1), J(x2)], J(R))):
        close(g, w)
    for g, w in zip(trap.rap_cat([T(x1), T(x2)], 1, T(Rc)),
                    jrap.rap_cat([J(x1), J(x2)], 1, J(Rc))):
        close(g, w)


def test_rap_clone_takes_the_product_of_the_cotangents():
    x, r1, r2 = draws(10, (2, 5), (2, 5), (2, 5))
    got = trap.rap_clone(T(x), [T(r1), T(r2)])
    close(got, jrap.rap_clone(J(x), [J(r1), J(r2)]))
    sd = tlrp.safe_divide
    cpp = sd(T(r1).clamp(min=0), T(x)) + sd(T(r2).clamp(min=0), T(x))
    cpn = sd(T(r1).clamp(max=0), T(x)) + sd(T(r2).clamp(max=0), T(x))
    torch.testing.assert_close(got, T(x) * (cpp * cpn))


@pytest.mark.parametrize("bias", [False, True])
def test_rap_batchnorm2d_equals_jax(bias):
    R, x, wt, var, b = draws(11, (2, 4, 5, 3), (2, 4, 5, 3), (3,), (3,),
                             (3,))
    R[0, :2] = 0.0                   # some zero support for the bias peel
    var = np.abs(var) + 0.5
    kw = {"bias": b} if bias else {}
    close(trap.rap_batchnorm2d(T(R), T(x), T(wt), T(var), 1e-5,
                               **{k: T(v) for k, v in kw.items()}),
          jrap.rap_batchnorm2d(J(R), J(x), J(wt), J(var), 1e-5,
                               **{k: J(v) for k, v in kw.items()}))


@pytest.mark.parametrize("first", [False, True])
def test_rap_linear_equals_jax(first):
    R, x, w, b = draws(12, (3, 4), (3, 6), (6, 4), (4,))
    R[0, 1] = 0.0
    close(trap.rap_linear(T(R), T(x), T(w), T(b), first=first),
          jrap.rap_linear(J(R), J(x), J(w), J(b), first=first),
          rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["first", "1x1", "3x3"])
def test_rap_conv2d_equals_jax(kind):
    """The zB input rule (3 channels), the |x|·|w| rule (kernel height 1)
    and the dual pos_prop flows (3×3, stride 2, padding 1)."""
    cin = 3 if kind == "first" else 4
    k = 1 if kind == "1x1" else 3
    x, w = draws(13, (2, 6, 6, cin), (k, k, cin, 5))
    stride, pad = (1, 0) if kind == "1x1" else (2, 1)
    out = (6 + 2 * pad - k) // stride + 1
    (R,) = draws(14, (2, out, out, 5))
    R[1, 0] = 0.0
    close(trap.rap_conv2d(T(R), T(x), T(w), stride, pad),
          jrap.rap_conv2d(J(R), J(x), J(w), stride, pad),
          rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# models/bert_lrp.py and models/visual_bert.relprop
# ---------------------------------------------------------------------------

BERT = jbert.BertConfig(**pert_runner.SMOKE_BERT)


@pytest.fixture(scope="module")
def encoder_case():
    """2-layer encoder (D 64, 4 heads), B=2 with one padded row: the port
    at B=2, JAX per example and at B=2."""
    jp = tvb_tests.numpy_params(
        lambda: jbert.init_encoder_params(jax.random.PRNGKey(0), BERT), 3)
    h, R = draws(15, (2, 7, 64), (2, 7, 64))
    m = np.ones((2, 7), np.int32)
    m[1, 4:] = 0
    run = jax.jit(lambda p, h, m, R: jbert_lrp.bert_encoder_relprop(
        p, jbert.encoder(p, h, BERT, m, return_tape=True)[2], m, R, BERT))
    jm = jbert.extended_attention_mask(J(m))
    one = [run(jp, J(h[i:i + 1]), jm[i:i + 1], J(R[i:i + 1]))
           for i in range(2)]
    joint = run(jp, J(h), jm, J(R))
    tp = tconvert._to_torch(jp, "cpu")
    tm = tbert.extended_attention_mask(T(m))
    tape = tbert.encoder(tp, T(h), tbert.BertConfig(**pert_runner.SMOKE_BERT),
                         tm, return_tape=True)[2]
    got = tbert_lrp.bert_encoder_relprop(
        tp, tape, tm, T(R), tbert.BertConfig(**pert_runner.SMOKE_BERT))
    return got, one, joint


def test_bert_encoder_relprop_per_example_equals_jax(encoder_case):
    (R_in, cams), one, _ = encoder_case
    assert cams.shape == (2, 2, 4, 7, 7)
    for i in range(2):
        cam_close(cams[:, i], one[i][1][:, 0])
        cam_close(R_in[i], one[i][0][0])


def test_bert_encoder_relprop_jax_couples_the_batch(encoder_case):
    """Departure 1 of ROADMAP §C: JAX's B=2 run moves each example's cams
    away from its B=1 run; the port's do not move."""
    (_, cams), one, joint = encoder_case
    for i in range(2):
        assert rel_dist(joint[1][:, i], one[i][1][:, 0]) > 10 * CAM_BAR
        assert rel_dist(cams[:, i].numpy(), one[i][1][:, 0]) <= CAM_BAR


@pytest.fixture(scope="module")
def visual_bert_case():
    jp = tvb_tests.numpy_params(
        lambda: jvb.init_params(jax.random.PRNGKey(0), tvb_tests.JCFG))
    tp = tconvert.visual_bert_from_jax_numpy(jp, tvb_tests.TCFG,
                                             device="cpu")
    b = tvb_tests.vb_batch()

    def jrun(p, bb, uniform):
        out = jvb.forward(p, bb["input_ids"], bb["input_mask"],
                          bb["visual_embeddings"],
                          visual_mask=bb["visual_mask"], cfg=tvb_tests.JCFG,
                          return_tape=True)
        oh = jax.nn.one_hot(jnp.argmax(out["scores"], -1),
                            tvb_tests.JCFG.num_labels)
        return jvb.relprop(p, out["tape"], oh, tvb_tests.JCFG,
                           uniform=uniform)

    jf = jax.jit(jrun, static_argnums=2)
    want = {u: [jf(jp, tvb_tests.jx({k: v[i:i + 1] for k, v in b.items()}),
                   u) for i in range(3)] for u in (True, False)}
    return jp, tp, b, want


@pytest.mark.parametrize("uniform", [True, False])
def test_visual_bert_relprop_per_example_equals_jax(visual_bert_case,
                                                    uniform):
    _, tp, b, want = visual_bert_case
    t = tvb_tests.tt(b)
    out = tvb.forward(tp, t["input_ids"], t["input_mask"],
                      t["visual_embeddings"], visual_mask=t["visual_mask"],
                      cfg=tvb_tests.TCFG, return_tape=True)
    oh = torch.nn.functional.one_hot(out["scores"].argmax(-1), 13)
    R, cams = tvb.relprop(tp, out["tape"], oh, tvb_tests.TCFG,
                          uniform=uniform)
    for i in range(3):
        cam_close(cams[:, i], np.asarray(want[uniform][i][1])[:, 0])
        cam_close(R[i], np.asarray(want[uniform][i][0])[0])
    # the two variants differ (the per-branch split is not the uniform one)
    other = np.asarray(want[not uniform][0][1])[:, 0]
    assert rel_dist(cams[:, 0].numpy(), other) > 10 * CAM_BAR


def test_visual_bert_capture_tape_is_the_forward_tape(visual_bert_case):
    _, tp, b, _ = visual_bert_case
    t = tvb_tests.tt(b)
    scores, _, _, tape = tvb.capture(tp, t, None, tvb_tests.TCFG,
                                     return_tape=True)
    out = tvb.forward(tp, t["input_ids"], t["input_mask"],
                      t["visual_embeddings"], visual_mask=t["visual_mask"],
                      cfg=tvb_tests.TCFG, return_tape=True)
    torch.testing.assert_close(scores, out["scores"].detach())
    for k in ("encoder", "mask", "pooled", "cls_index"):
        torch.testing.assert_close(tape[k], out["tape"][k].detach())
        assert not tape[k].requires_grad


# ---------------------------------------------------------------------------
# models/lxmert_lrp.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lxmert_case():
    jcfg, tcfg = tlx_tests.JCFG, tlx_tests.TCFG
    jp = tlx_tests.lxmert_numpy_params(jcfg)
    tp = tconvert.lxmert_from_jax_numpy(jp, tcfg, device="cpu")
    b = tlx_tests.lxmert_batch()

    def jrun(p, bb):
        out = jlx.forward(p, bb["input_ids"], bb["attention_mask"],
                          bb["visual_feats"], bb["visual_pos"],
                          visual_mask=bb["visual_mask"], cfg=jcfg,
                          return_tape=True)
        oh = jax.nn.one_hot(jnp.argmax(out["qa_scores"], -1),
                            jcfg.num_qa_labels)
        return jlx_lrp.relprop(p, out["tape"], oh, out["tape"]["lang_mask"],
                               out["tape"]["visn_mask"], jcfg)

    jf = jax.jit(jrun)
    want = [jf(jp, {k: J(v[i:i + 1]) for k, v in b.items()})
            for i in range(3)]
    tb = {k: T(v) for k, v in b.items()}
    scores, _, _, tape = tlx.capture(tp, tb, None, tcfg, return_tape=True)
    oh = torch.nn.functional.one_hot(scores.argmax(-1), tcfg.num_qa_labels)
    got = tlx_lrp.relprop(tp, tape, oh, tape["lang_mask"],
                          tape["visn_mask"], tcfg)
    return got, want


@pytest.mark.parametrize("family", tlx.LxmertTaps._fields)
def test_lxmert_relprop_per_example_equals_jax(lxmert_case, family):
    (cam_lang, cam_vis, cams), want = lxmert_case
    for i in range(3):
        cam_close(getattr(cams, family)[:, i],
                  np.asarray(getattr(want[i][2], family))[:, 0])
    if family == "lang":
        for i in range(3):
            cam_close(cam_lang[i], np.asarray(want[i][0])[0])
            cam_close(cam_vis[i], np.asarray(want[i][1])[0])


# ---------------------------------------------------------------------------
# models/detr_lrp.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def detr_case():
    """The tiny DETR of ``test_torch_detr`` on its padded image: JAX's cams
    with the key-padding bias and without it (JAX ``_relprop_cams``), and
    the port's from its own taped forward."""
    jcfg, tcfg = tdetr_tests.JCFG, tdetr_tests.TCFG
    jp = tdetr_tests.detr_numpy_params(jcfg)
    tp = tconvert.detr_from_jax_numpy(jp, tcfg, device="cpu")
    img, valid = tdetr_tests.image_and_valid()
    tq, tc = J(tdetr_tests.TQ), J(tdetr_tests.TC)
    oh = jexpl_detr._one_hots(tq, tc, jcfg)
    want = jax.jit(lambda p, im, v: {
        "masked": tdetr_tests.jax_relprop_cams(p, im, oh, jcfg, v),
        "unmasked": jexpl_detr._relprop_cams(p, im, oh, jcfg, v)})(
            jp, J(img), J(valid))
    out = tdetr.forward(tp, T(img)[None], T(valid)[None], tcfg,
                        return_tape=True)
    toh = texpl_detr._one_hots(T(tdetr_tests.TQ), T(tdetr_tests.TC), tcfg)
    cams = texpl_detr._relprop_cams(tp, out["tape"], toh, tcfg)
    return jp, tp, out["tape"], toh, cams, want


@pytest.mark.parametrize("family", tdetr.DETRTaps._fields)
def test_detr_relprop_with_the_padding_bias_equals_jax(detr_case, family):
    """K = 4 queries in one batched relprop on the B=1 tape, against JAX's
    relprop vmapped over the queries with ``mask=bias``."""
    *_, cams, want = detr_case
    got = getattr(cams, family)
    assert got.shape[1] == 4
    for k in range(4):
        cam_close(got[:, k], np.asarray(getattr(want["masked"], family))[:, k])


def test_detr_jax_relprop_cams_drop_the_padding_bias(detr_case):
    """Departure 2 of ROADMAP §C: JAX ``_relprop_cams`` recomputes
    unmasked probabilities, so its cams differ from the masked relprop's
    (and give the padded keys relevance); the port's follow the mask."""
    *_, cams, want = detr_case
    m, u = want["masked"].dec_cross, want["unmasked"].dec_cross
    assert rel_dist(u, m) > 10 * CAM_BAR
    # the padded column (the last of the 2×3 grid) of the cross cams:
    # 0 under the bias, not 0 without it
    pad = np.asarray(u).reshape(u.shape[:-1] + (2, 3))[..., 2]
    assert np.abs(pad).max() > 0
    got_pad = cams.dec_cross.numpy().reshape(cams.dec_cross.shape[:-1]
                                             + (2, 3))[..., 2]
    assert np.abs(got_pad).max() <= 1e-6 * np.abs(m).max()


def test_detr_last_cross_cam_is_the_relprop_one(detr_case):
    jp, tp, tape, oh, cams, _ = detr_case
    last = tdetr_lrp.last_cross_cam(tp, tape, tape["hs"], oh,
                                    tdetr_tests.TCFG,
                                    tape["key_padding_bias"])
    torch.testing.assert_close(last, cams.dec_cross[-1], rtol=0, atol=0)


def test_detr_mha_relprop_value_collapse_equals_jax(detr_case):
    """The first decoder layer's self-attention reads values of a zero
    tgt: the value cam collapses to 0 in its projection and the output's
    relevance is renormalised onto q and k, per query."""
    jp, tp, *_ = detr_case
    p_j = jax.tree_util.tree_map(lambda a: a[0],
                                 jp["decoder"]["self_attn"])
    p_t = tdetr._layer(tp["decoder"]["self_attn"], 0)
    xq, R = draws(16, (1, 6, 32), (3, 6, 32))
    xv = np.zeros((1, 6, 32), np.float32)
    got = tdetr_lrp.mha_relprop(p_t, T(xq), T(xq), T(xv), 4, None, T(R))
    assert float(got[2].abs().max()) == 0.0          # the collapse
    for k in range(3):
        want = jdetr_lrp.mha_relprop(p_j, J(xq), J(xq), J(xv), 4, None,
                                     J(R[k:k + 1]))
        for g, w in zip(got, want):
            close(g[k:k + 1], w, rtol=1e-4, atol=1e-5)
        # q and k carry the output's relevance total of this query
        np.testing.assert_allclose(float(got[0][k].sum() + got[1][k].sum()),
                                   float(np.asarray(want[0]).sum()
                                         + np.asarray(want[1]).sum()),
                                   rtol=1e-4)
