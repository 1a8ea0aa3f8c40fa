"""``tools/protocol_rehearsal`` of the port against the JAX tool.

The per-sample LXMERT program (FRCNN → LXMERT explain pass → 9 steps of
FRCNN + LXMERT) and one VisualBERT sweep run at tiny configs with the JAX
package's weights carried across (``utils/convert``), against the same
composition of JAX functions built here on the same numpy draws: step
accuracies exactly equal (0/1 picks of the answers), AUC within 1e-6.
The bookkeeping helpers equal the JAX tool's; the LXMERT resume sidecar
gives the uninterrupted curve; a DETR rehearsal runs through COCOeval.
The full-width rehearsals are marked slow, as the JAX suite marks its
own."""

import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_mm_explainability_tpu.explain import lxmert as jelx
from transformer_mm_explainability_tpu.harness import pert_runner as jrunner
from transformer_mm_explainability_tpu.harness import perturbation as jpert
from transformer_mm_explainability_tpu.models import frcnn as jfrcnn
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import visual_bert as jvb
from transformer_mm_explainability_tpu.tools import protocol_rehearsal as jpr
from transformer_mm_explainability_tpu_torch import cli
from transformer_mm_explainability_tpu_torch.harness import pert_runner
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.tools import protocol_rehearsal as pr
from transformer_mm_explainability_tpu_torch.utils import convert as tconvert

import test_torch_visual_bert as tvbt
from test_torch_frcnn import JTINY, TTINY
from test_torch_frcnn import numpy_params as frcnn_numpy_params
from test_torch_lxmert import lxmert_numpy_params

QUIET = dict(printer=lambda *a: None)
AUC_TOL = 1e-6
# the tiny LXMERT reads the tiny FRCNN's 2048-d RoI features; both models
# answer from 2 labels, so that a random one-hot target matches the
# predicted answer at about half the steps (13 labels leave the curves 0)
LX_TINY = {**pert_runner.SMOKE_LXMERT, "visual_feat_dim": 2048,
           "num_qa_labels": 2}
JLX, TLX = jlx.LxmertConfig(**LX_TINY), tlx.LxmertConfig(**LX_TINY)
JVB = dataclasses.replace(tvbt.JCFG, num_labels=2)
TVB = dataclasses.replace(tvbt.TCFG, num_labels=2)
IMAGE_HW, TEXT_LEN = (128, 160), 8


# ---------------------------------------------------------------------------
# Bookkeeping
# ---------------------------------------------------------------------------

def test_prior_phases_merge_equals_jax(tmp_path):
    """Re-running one phase with --out keeps phases recorded by earlier
    invocations; a phase without provenance is tagged; anything else is
    dropped (the JAX tool's cases)."""
    art = tmp_path / "proto.json"
    cases = [
        '{"artifact": "protocol_rehearsal", "visualbert": {"auc": 1.0},'
        ' "wall_s_total": 3.0, "junk": 7}',
        '{"artifact": "protocol_rehearsal",'
        ' "lxmert": {"auc": 0.5, "backend": "cuda", "devices": ["d0"]}}',
        "not json at all",
        '{"visualbert": {"auc": 9.0}}',
    ]
    for text in cases:
        art.write_text(text)
        assert pr._prior_phases(str(art)) == jpr._prior_phases(str(art))
    art.write_text(cases[0])
    assert pr._prior_phases(str(art)) == {
        "visualbert": {"auc": 1.0, "backend": "unknown", "devices": None}}
    assert pr._prior_phases(str(tmp_path / "missing.json")) == {}


def test_wall_s_total_equals_jax():
    for results in ({"visualbert": {"wall_s_total": 2853.27},
                     "lxmert": {"wall_s": 279.02},
                     "detr": {"wall_s": 300.0, "datagen_s": 12.0}},
                    {"lxmert": {"wall_s": 5.0}}, {}):
        assert pr._wall_s_total(results) == jpr._wall_s_total(results)
    assert pr._wall_s_total({"visualbert": {"wall_s_total": 2853.27},
                             "lxmert": {"wall_s": 279.02},
                             "detr": {"wall_s": 300.0,
                                      "datagen_s": 12.0}}) == 3444.29


def test_cli_writes_after_each_protocol_and_merges(tmp_path, monkeypatch):
    """``cli protocol-rehearsal``: the artifact keeps an earlier
    invocation's phase, gains this one's with its device, sums the walls,
    and LXMERT gets the sidecar path beside ``--out``."""
    out = tmp_path / "p.json"
    out.write_text(json.dumps({"artifact": "protocol_rehearsal",
                               "visualbert": {"wall_s_total": 10.0,
                                              "backend": "cuda",
                                              "devices": ["d"]}}))
    seen = {}

    def fake_lxmert(**kw):
        seen.update(kw)
        return {"wall_s": 2.5, "auc": 0.5}

    monkeypatch.setattr(pr, "rehearse_lxmert", fake_lxmert)
    assert cli.main(["protocol-rehearsal", "--protocol", "lxmert",
                     "--lx-samples", "3", "--out", str(out),
                     "--device", "cpu"]) == 0
    got = json.loads(out.read_text())
    assert got["visualbert"]["backend"] == "cuda"
    assert got["lxmert"] == {"wall_s": 2.5, "auc": 0.5, "backend": "cpu",
                             "devices": ["cpu"]}
    assert got["wall_s_total"] == 12.5
    assert seen["num_samples"] == 3
    assert seen["resume_path"] == str(out) + ".lxmert_resume.json"


# ---------------------------------------------------------------------------
# VisualBERT: one sweep
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _vb_params():
    jp = tvbt.numpy_params(lambda: jvb.init_params(jax.random.PRNGKey(0),
                                                   JVB))
    return jp, tconvert.visual_bert_from_jax_numpy(jp, TVB, device="cpu")


def _jax_sweep(jparams, seed, positive, text_pert, num_samples, batch_size,
               text_len, num_boxes):
    """The JAX tool's sweep loop at a tiny config: the same draws, the JAX
    runner."""
    cfg = JVB
    rng = np.random.RandomState(seed)
    runner = jrunner.VisualBertPerturbationRunner(
        jparams, cfg, "ours_no_lrp", positive=positive, text_pert=text_pert)
    accs_sum, n_done = np.zeros(len(runner.steps)), 0
    for _ in range(math.ceil(num_samples / batch_size)):
        n = min(batch_size, num_samples - n_done)
        lens = rng.randint(8, text_len + 1, size=batch_size)
        ids = rng.randint(1, min(30000, cfg.bert.vocab_size),
                          size=(batch_size, text_len))
        mask = (np.arange(text_len)[None] < lens[:, None]).astype(np.int32)
        batch = {"input_ids": jnp.asarray(ids * mask),
                 "input_mask": jnp.asarray(mask),
                 "visual_embeddings": jnp.asarray(rng.randn(
                     batch_size, num_boxes, cfg.visual_embedding_dim)
                     .astype(np.float32))}
        soft = np.zeros((batch_size, cfg.num_labels), np.float32)
        soft[np.arange(batch_size),
             rng.randint(0, cfg.num_labels, batch_size)] = 1.0
        accs = runner.run_samples_batched(batch, soft)
        accs_sum += np.asarray(accs)[:n].sum(axis=0)
        n_done += n
    curve = accs_sum / n_done
    return curve, jpert.auc(curve, runner.steps)


@pytest.mark.parametrize("positive,text_pert", [(False, False),
                                                (True, True)])
def test_visualbert_sweep_equals_jax(positive, text_pert):
    jp, tp = _vb_params()
    got = pr.visualbert_sweep(tp, TVB, np.random.RandomState(3),
                              positive, text_pert, num_samples=7,
                              batch_size=3, text_len=12, num_boxes=9,
                              device="cpu")
    curve, auc = _jax_sweep(jp, 3, positive, text_pert, 7, 3, 12, 9)
    assert got["num_samples"] == 7
    assert got["step_accuracies"] == [round(float(a), 6) for a in curve]
    assert abs(got["auc"] - auc) < AUC_TOL
    assert 0 < np.mean(curve) < 1, "vacuous: every step scores alike"


# ---------------------------------------------------------------------------
# LXMERT: the per-sample program and the resume sidecar
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    """The LXMERT program is many small operations (FRCNN's NMS loop): on a
    loaded CPU, eight threads per process run it about 60 times slower than
    one (two samples: 117.7 s against 2.0 s beside five busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _lx_models():
    jf = frcnn_numpy_params(
        lambda: jfrcnn.init_params(jax.random.PRNGKey(0), JTINY), 0)
    jl = lxmert_numpy_params(JLX)
    tf = tconvert.frcnn_from_jax_numpy(jax.tree.map(np.asarray, jf), TTINY,
                                       device="cpu")
    tl = tconvert.lxmert_from_jax_numpy(jl, TLX, device="cpu")
    return (jf, jl), (tf, tl)


_jdet = jax.jit(jfrcnn.forward, static_argnums=2)
_jcap = jax.jit(jlx.capture, static_argnums=3)
_jscores = jax.jit(lambda p, ids, m, f, b, vm: jlx.forward(
    p, ids, m, f, b, visual_mask=vm, cfg=JLX)["qa_scores"])
_jcam = jax.jit(lambda attn, grads, tv, vv: jelx.generate_ours(
    attn, grads, text_valid=tv, visual_valid=vv)[1][0, 0])
_jkeep = jax.jit(jpert.topk_keep_mask)


def _jax_sample(jf, jl, image, ids, mask, soft, positive):
    """The JAX tool's per-sample program (``program`` in
    ``rehearse_lxmert``) at the tiny configs, its ``lax.map`` over the 9
    steps as a loop of the same jitted functions."""
    image, ids, mask = map(jnp.asarray, (image, ids, mask))
    det = _jdet(jf, image, JTINY)
    batch = {"input_ids": ids[None], "attention_mask": mask[None],
             "visual_feats": det["roi_features"][None],
             "visual_pos": det["normalized_boxes"][None],
             "visual_mask": det["valid"].astype(jnp.int32)[None]}
    _, attn, grads = _jcap(jl, batch, None, JLX)
    cam = _jcam(attn, grads, batch["attention_mask"], batch["visual_mask"])
    cam = -cam if positive else cam
    num_keep = jpert._num_keep_table(jpert.LXMERT_STEPS, JTINY.max_detections
                                     )[:, det["valid"].sum()]
    accs = []
    for k in num_keep:
        det_k = _jdet(jf, image, JTINY)
        keep = _jkeep(cam, k, det_k["valid"])
        scores = _jscores(jl, ids[None], mask[None],
                          det_k["roi_features"][None],
                          det_k["normalized_boxes"][None],
                          keep.astype(jnp.int32)[None])
        accs.append(soft[int(jnp.argmax(scores[0]))])
    return np.asarray(accs), det


def test_lxmert_sample_equals_jax(one_thread):
    """Two samples of the seeded stream (negative, then positive
    perturbation): the port's program against the JAX composition."""
    (jf, jl), (tf, tl) = _lx_models()
    rng = np.random.RandomState(1234)
    curves = []
    for positive in (False, True):
        image, ids, mask, soft = pr.lxmert_inputs(rng, IMAGE_HW, TEXT_LEN,
                                                  TLX)
        want, det = _jax_sample(jf, jl, image, ids, mask, soft, positive)
        assert int(det["valid"].sum()) > 1, "vacuous: no boxes to rank"
        got = pr.lxmert_sample(tf, tl, TTINY, TLX, torch.from_numpy(image),
                               torch.from_numpy(ids), torch.from_numpy(mask),
                               torch.from_numpy(soft),
                               positive=positive).numpy()
        np.testing.assert_array_equal(got, want)
        curves.append(got)
    curve = np.mean(curves, axis=0)
    assert 0 < curve.mean() < 1, "vacuous: every step scores alike"
    assert abs(pr.pert.auc(curve, pr.pert.LXMERT_STEPS)
               - jpert.auc(curve, jpert.LXMERT_STEPS)) < AUC_TOL


def test_lxmert_inputs_follow_the_jax_tools_draws():
    """The JAX tool's per-sample draws, in its order (its loop body)."""
    rng, ref = np.random.RandomState(9), np.random.RandomState(9)
    for _ in range(3):
        image, ids, mask, soft = pr.lxmert_inputs(rng, (4, 5), 20,
                                                  tlx.LXMERT_VQA)
        np.testing.assert_array_equal(image,
                                      ref.rand(4, 5, 3).astype(np.float32))
        tl = ref.randint(6, 21)
        want_ids = np.zeros(20, np.int32)
        want_ids[:tl] = ref.randint(1, 30000, size=tl)
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, np.arange(20) < tl)
        assert soft.argmax() == ref.randint(0, 3129) and soft.sum() == 1


class _Cut(Exception):
    pass


def test_lxmert_resume_equals_uninterrupted(tmp_path, monkeypatch,
                                           one_thread):
    """A run cut after its first sample leaves a sidecar at i = 1; the next
    invocation resumes there, and its curve is the uninterrupted one."""
    _, (tf, tl) = _lx_models()
    kw = dict(image_hw=IMAGE_HW, text_len=TEXT_LEN, seed=5, device="cpu",
              **QUIET)
    full = pr.lxmert_loop(tf, tl, TTINY, TLX, 2, **kw)
    side = tmp_path / "resume.json"
    real, done = pr.lxmert_sample, []

    def cut_after_one(*a, **k):
        if done:
            raise _Cut
        done.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pr, "lxmert_sample", cut_after_one)
    with pytest.raises(_Cut):
        pr.lxmert_loop(tf, tl, TTINY, TLX, 2, resume_path=str(side),
                       save_every=1, **kw)
    assert json.loads(side.read_text())["i"] == 1
    monkeypatch.setattr(pr, "lxmert_sample", real)
    resumed = pr.lxmert_loop(tf, tl, TTINY, TLX, 2, resume_path=str(side),
                             save_every=1, **kw)
    assert resumed["resumed_at"] == 1 and full["resumed_at"] is None
    assert resumed["step_accuracies"] == full["step_accuracies"]
    assert resumed["auc"] == full["auc"]
    assert 0 < np.mean(full["step_accuracies"]) < 1
    assert not side.exists()


# ---------------------------------------------------------------------------
# DETR, and the full-width rehearsals
# ---------------------------------------------------------------------------

def test_detr_rehearsal_tiny(tmp_path):
    """Full-width DETR-R50 on a small synthetic COCO image (128 px):
    detect → one pass of every kept query → Otsu masks → COCOeval."""
    out = pr.rehearse_detr(num_images=1, confidence_threshold=0.005,
                           max_queries_per_pass=100, shortest=128,
                           source_hw=(96, 128), tmpdir=str(tmp_path),
                           device="cpu", **QUIET)
    assert out["num_images"] == 1
    assert set(out["stats"]) >= {"AP", "AP50", "AP75", "AR_100"}
    assert np.isfinite(out["stats"]["AP"])
    assert out["memory"] is None     # measured on a CUDA device only
    images = json.loads((tmp_path / "instances_synth.json").read_text())
    assert len(images["images"]) == 1 and images["annotations"]


@pytest.mark.slow
def test_visualbert_rehearsal_full_width():
    out = pr.rehearse_visualbert(
        num_samples=3, batch_size=3,
        sweeps=[{"positive": False, "text_pert": False}], device="cpu",
        **QUIET)
    sweep = out["sweeps"][0]
    assert sweep["num_samples"] == 3
    assert len(sweep["step_accuracies"]) == 9
    assert np.isfinite(sweep["auc"]) and sweep["wall_s"] > 0


@pytest.mark.slow
def test_lxmert_rehearsal_full_width():
    out = pr.rehearse_lxmert(num_samples=2, image_hw=(128, 160), text_len=8,
                             device="cpu", **QUIET)
    assert out["num_samples"] == 2
    assert len(out["step_accuracies"]) == 9
    assert np.isfinite(out["auc"])
