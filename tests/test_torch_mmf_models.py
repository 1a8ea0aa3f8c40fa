"""The port's MMF transformer-family models against the JAX package's: the
fusions (concat_bert, concat_bow, late_fusion, unimodal_text,
unimodal_image), mmf_bert's three heads, MMBT (classification, pretraining
losses), MMF-Transformer, ViLBERT (VQA2, NLVR2, dynamic attention and
fixed layers, the attention stacks, the pretraining losses under both
visual targets), M4C (teacher forcing, greedy decoding, m4c_captioner's
unk masking), MoVie+MCAN (eval and training, compressed or not) and
lxmert-old (its four heads and the pretraining losses); then the
encoders, ``adaptive_pool_2d`` against torch's adaptive pools, the
``core/build`` builders, ``MMBTGridHMInterface.classify`` on the CPU and
the registry after ``setup_imports``.

Tiny widths (one or two layers, hidden ≤ 32, a few boxes), inputs from
numpy seeds and one weight tree for both sides (``tests/_mmf_parity``).
Bar: max|Δ| ≤ 1e-5 · max|JAX output| per output (fp32 on both sides);
decoded indices exactly equal; losses within 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from _mmf_parity import (K, close, ints, jax_run, port, rand, shared,
                         torch_args)
from transformer_mm_explainability_tpu.models import fusions as JF
from transformer_mm_explainability_tpu.models import lxmert as jlx
from transformer_mm_explainability_tpu.models import lxmert_mmf as JLO
from transformer_mm_explainability_tpu.models import m4c as JM4C
from transformer_mm_explainability_tpu.models import mmbt as JMMBT
from transformer_mm_explainability_tpu.models import mmf_bert as JMB
from transformer_mm_explainability_tpu.models import mmf_transformer as JMT
from transformer_mm_explainability_tpu.models import movie_mcan as JMM
from transformer_mm_explainability_tpu.models import vilbert as JV
from transformer_mm_explainability_tpu_torch.models import fusions as TF
from transformer_mm_explainability_tpu_torch.models import lxmert as tlx
from transformer_mm_explainability_tpu_torch.models import lxmert_mmf as TLO
from transformer_mm_explainability_tpu_torch.models import m4c as TM4C
from transformer_mm_explainability_tpu_torch.models import mmbt as TMMBT
from transformer_mm_explainability_tpu_torch.models import mmf_bert as TMB
from transformer_mm_explainability_tpu_torch.models import (
    mmf_transformer as TMT)
from transformer_mm_explainability_tpu_torch.models import movie_mcan as TMM
from transformer_mm_explainability_tpu_torch.models import vilbert as TV


def both(jmod, tmod, init, fwd, cfgs, args, family, **static):
    """The shared tree of ``init``, both forwards, held at the bar; returns
    the port's output."""
    jcfg, tcfg = cfgs
    tree = shared(lambda: getattr(jmod, init)(K(0), jcfg),
                  lambda: getattr(tmod, init)(0, tcfg, device="cpu"))
    want = jax_run(lambda p, *a: getattr(jmod, fwd)(p, jcfg, *a, **static),
                   tree, *args)
    got = getattr(tmod, fwd)(port(tree, family), tcfg, *torch_args(args),
                             **static)
    close(got, want)
    return got


# ---------------------------------------------------------------------------
# fusions
# ---------------------------------------------------------------------------

FUSION = dict(vocab_size=40, text_hidden_size=16, num_hidden_layers=1,
              num_attention_heads=2, modal_hidden_size=12, num_features=2,
              num_labels=3, classifier_hidden_dim=8, classifier_num_layers=1)
FUSIONS = {
    "concat_bert": ("init_concat", "concat_forward", "transformer", "sum"),
    "concat_bow": ("init_concat", "concat_forward", "embedding", "sum"),
    "concat_bow_mul": ("init_concat", "concat_forward", "embedding", "mul"),
    "late_fusion": ("init_late_fusion", "late_fusion_forward",
                    "transformer", "sum"),
    "unimodal_text": ("init_unimodal_text", "unimodal_text_forward",
                      "transformer", "sum"),
    "unimodal_image": ("init_unimodal_image", "unimodal_image_forward",
                       "transformer", "sum"),
}


@pytest.mark.parametrize("name", sorted(FUSIONS))
def test_fusion(name):
    init, fwd, text_encoder, op = FUSIONS[name]
    kw = dict(FUSION, text_encoder=text_encoder, bow_operator=op)
    if name == "unimodal_image":
        kw["num_features"] = 1      # direct features are mean-pooled first
    cfgs = (JF.FusionConfig(**kw), TF.FusionConfig(**kw))
    text = ints(40, 2, 6, seed=1, low=1)
    mask = np.ones((2, 6), np.int32)
    mask[1, 4:] = 0
    modal = rand(2, 2, 12, seed=2, scale=0.5 if op == "sum" else 1.0)
    if name == "unimodal_image":
        args = (modal,)
    elif name == "unimodal_text":
        args = (text, mask)
    else:
        args = (text, modal, mask)
    both(JF, TF, init, fwd, cfgs, args, "fusions")


# ---------------------------------------------------------------------------
# mmf_bert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head,intra,combine", [
    ("vqa2", False, True), ("nlvr2", True, True),
    ("pretraining", False, False)])
def test_mmf_bert(head, intra, combine):
    # the combine multiplies the text by the concatenated image streams,
    # so it runs with one stream; two streams run without it
    n_feats = 1 if combine else 2
    kw = dict(vocab_size=40, hidden_size=16, num_attention_heads=2,
              max_position_embeddings=16, image_feature_dim=12,
              num_image_features=n_feats, image_intra_attention=intra,
              combine_embeddings=combine, combine_hidden_dim=16,
              training_head_type=head, answer_space_size=5)
    mask = np.ones((2, 7), np.int32)
    mask[0, 5:] = 0                      # pads: −inf key bias
    args = (ints(40, 2, 7, seed=3), mask, np.zeros((2, 7), np.int64),
            [rand(2, 3, 12, seed=4), rand(2, 4, 12, seed=5)][:n_feats])
    both(JMB, TMB, "init_mmf_bert", "mmf_bert_forward",
         (JMB.MMFBertConfig(**kw), TMB.MMFBertConfig(**kw)), args,
         "mmf_bert")


# ---------------------------------------------------------------------------
# MMBT and MMF-Transformer
# ---------------------------------------------------------------------------

MMBT = dict(vocab_size=40, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, modal_hidden_size=12, num_labels=2,
            max_position_embeddings=32)


def _mmbt_inputs(seed=6, start_end=True):
    mask = np.ones((2, 6), np.int32)
    mask[1, 3:] = 0
    inputs = {"input_modal": rand(2, 4, 12, seed=seed),
              "input_ids": ints(40, 2, 6, seed=seed + 1),
              "attention_mask": mask,
              "token_type_ids": np.ones((2, 6), np.int64)}
    if start_end:
        inputs["modal_start_token"] = np.array([2, 2])
        inputs["modal_end_token"] = np.array([3, 3])
    return inputs


@pytest.mark.parametrize("start_end", [False, True])
def test_mmbt_classification(start_end):
    cfgs = (JMMBT.MMBTConfig(**MMBT), TMMBT.MMBTConfig(**MMBT))
    inputs = _mmbt_inputs(start_end=start_end)
    tree = shared(lambda: JMMBT.init_mmbt(K(0), cfgs[0]),
                  lambda: TMMBT.init_mmbt(0, cfgs[1], device="cpu"))
    want = jax_run(lambda p, i: JMMBT.mmbt_for_classification(p, cfgs[0],
                                                              **i),
                   tree, inputs)
    got = TMMBT.mmbt_for_classification(port(tree, "mmbt"), cfgs[1],
                                        **torch_args(inputs))
    close(got, want)


def test_mmbt_pretrain_losses():
    cfgs = (JMMBT.MMBTConfig(**MMBT), TMMBT.MMBTConfig(**MMBT))
    inputs = _mmbt_inputs(seed=8)
    labels = ints(40, 2, 6, seed=9)
    labels[:, ::2] = -1
    extra = {"lm_label_ids": labels,
             "image_text_alignment": np.array([0, 1])}
    tree = shared(lambda: JMMBT.init_mmbt(K(0), cfgs[0]),
                  lambda: TMMBT.init_mmbt(0, cfgs[1], device="cpu"))
    want = jax_run(lambda p, i: JMMBT.mmbt_pretrain_losses(p, cfgs[0], **i),
                   tree, {**inputs, **extra})
    got = TMMBT.mmbt_pretrain_losses(port(tree, "mmbt"), cfgs[1],
                                     **torch_args({**inputs, **extra}))
    assert set(got) == {"masked_lm_loss", "alignment_loss"}
    close(got, want)


def test_mmf_transformer():
    def cfg(mod):
        return mod.MMFTransformerConfig(
            vocab_size=40, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, num_labels=3, modalities=(
                mod.Modality("text", "text", 0, position_dim=16),
                mod.Modality("image", "image", 1, embedding_dim=12,
                             position_dim=16),
                mod.Modality("ocr", "ocr", -1, embedding_dim=5,
                             position_dim=16)))
    mask = np.ones((2, 6), np.float32)
    mask[0, 4:] = 0
    args = ([ints(40, 2, 6, seed=10), rand(2, 3, 12, seed=11),
             rand(2, 2, 5, seed=12)], [mask, None, None])
    both(JMT, TMT, "init_mmf_transformer", "mmf_transformer_forward",
         (cfg(JMT), cfg(TMT)), args, "mmf_transformer")


# ---------------------------------------------------------------------------
# ViLBERT
# ---------------------------------------------------------------------------

VILBERT = dict(vocab_size=40, hidden_size=16, num_hidden_layers=3,
               num_attention_heads=2, intermediate_size=32,
               max_position_embeddings=16, v_feature_size=12,
               v_target_size=7, v_hidden_size=8, v_num_hidden_layers=2,
               v_num_attention_heads=2, v_intermediate_size=16,
               bi_hidden_size=8, bi_num_attention_heads=2,
               v_biattention_id=(0, 1), t_biattention_id=(1, 2),
               num_labels=5)


def _vilbert_args(B=2):
    tmask = np.ones((B, 6), np.float32)
    tmask[0, 4:] = 0
    vmask = np.ones((B, 4), np.float32)
    vmask[1, 3:] = 0
    return ((ints(40, B, 6, seed=13), rand(B, 4, 12, seed=14),
             rand(B, 4, 5, seed=15)),
            {"attention_mask": tmask, "image_attention_mask": vmask})


_JAX_CACHE = {}


def cached(key, make):
    """One JAX program for the cases that share its inputs (a compile costs
    more than the forward): ``make()`` runs once per ``key``."""
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = make()
    return _JAX_CACHE[key]


@pytest.mark.parametrize("variant", ["vqa2", "nlvr2", "dynamic_fixed"])
def test_vilbert_classification(variant):
    kw = dict(VILBERT, training_head_type=variant
              if variant != "dynamic_fixed" else "vqa2")
    if variant == "dynamic_fixed":
        kw.update(dynamic_attention=True, fixed_t_layer=1, fixed_v_layer=1,
                  fusion_method="sum")
    if variant == "nlvr2":
        # the pooled pair [B/2, 2·bi] feeds a head of that width
        kw.update(bi_hidden_size=4, bi_num_attention_heads=2)
    cfgs = (JV.ViLBERTConfig(**kw), TV.ViLBERTConfig(**kw))
    args, masks = _vilbert_args(B=4 if variant == "nlvr2" else 2)
    tree = shared(lambda: JV.init_vilbert(K(0), cfgs[0]),
                  lambda: TV.init_vilbert(0, cfgs[1], device="cpu"))
    if variant == "nlvr2":
        # the reference's NLVR2 classifier takes the paired width
        rs = np.random.RandomState(0)
        tr = tree["classifier"]["transform"]
        tr["w"] = rs.randn(8, 8).astype(np.float32) * 0.1
        tr["b"] = np.zeros(8, np.float32)
        tr["ln"] = {"scale": np.ones(8, np.float32),
                    "bias": np.zeros(8, np.float32)}
        tree["classifier"]["out"] = {
            "w": rs.randn(5, 8).astype(np.float32) * 0.1,
            "b": np.zeros(5, np.float32)}
    want = cached(("vilbert", variant), lambda: jax_run(
        lambda p, a, m: (JV.vilbert_for_classification(p, cfgs[0], *a, **m),
                         JV.vilbert_base(p, cfgs[0], *a, collect_attn=True,
                                         **m)), tree, args, masks))
    tp = port(tree, "vilbert")
    close(TV.vilbert_for_classification(tp, cfgs[1], *torch_args(args),
                                        **torch_args(masks)), want[0])
    if variant == "vqa2":   # the sequences, pooled vectors and attentions
        got = TV.vilbert_base(tp, cfgs[1], *torch_args(args),
                              collect_attn=True, **torch_args(masks))
        assert [len(s) for s in got[4]] == [3, 2, 2]
        close(got, want[1])


def _vilbert_targets():
    labels = ints(40, 2, 6, seed=16)
    labels[:, 1::2] = -1
    image_label = np.array([[1, 0, 1, 0], [0, 1, 1, 1]])
    target = np.abs(rand(2, 4, 7, seed=17))
    target[0, 0, :3] = 0.0               # 0·log 0 = 0
    soft = target / target.sum(-1, keepdims=True)
    return [(labels, image_label, soft), (labels, image_label, target)]


@pytest.mark.parametrize("visual_target", [0, 1])
def test_vilbert_pretrain_losses(visual_target):
    """KL divergence to a soft class target (0), MSE to a feature target
    (1); both targets' JAX losses come from one program."""
    cfgs = (JV.ViLBERTConfig(**VILBERT), TV.ViLBERTConfig(**VILBERT))
    args, masks = _vilbert_args()
    extras = _vilbert_targets()
    tree = shared(lambda: JV.init_vilbert(K(0), cfgs[0]),
                  lambda: TV.init_vilbert(0, cfgs[1], device="cpu"))
    want = cached("vilbert_losses", lambda: jax_run(
        lambda p, a, es, m: [JV.vilbert_pretrain_losses(
            p, cfgs[0], *a, *e, visual_target=vt, **m)
            for vt, e in enumerate(es)], tree, args, extras, masks))
    got = TV.vilbert_pretrain_losses(
        port(tree, "vilbert"), cfgs[1], *torch_args(args),
        *torch_args(extras[visual_target]), visual_target=visual_target,
        **torch_args(masks))
    assert set(got) == {"masked_lm_loss", "masked_img_loss"}
    close(got, want[visual_target])


# ---------------------------------------------------------------------------
# M4C
# ---------------------------------------------------------------------------

M4C = dict(vocab_size=30, num_fixed_answers=6, hidden_size=16, num_heads=2,
           text_bert_layers=1, mmt_layers=2, obj_in_dim=12, ocr_in_dim=22,
           ocr_fc7_dim=12, max_dec_length=8)


def _m4c_args():
    B, T, NO, NR = 2, 5, 4, 3
    return (ints(30, B, T, seed=18), np.array([5, 3]),
            rand(B, NO, 12, seed=19), np.abs(rand(B, NO, 4, seed=20)),
            np.array([4, 2]), rand(B, NR, 4, seed=21),
            rand(B, NR, 4, seed=22), rand(B, NR, 12, seed=23),
            rand(B, NR, 2, seed=24), np.abs(rand(B, NR, 4, seed=25)),
            np.array([2, 3]))


@pytest.mark.parametrize("mode", ["teacher", "greedy", "captioner"])
def test_m4c(mode):
    cfgs = (JM4C.M4CConfig(**M4C), TM4C.M4CConfig(**M4C))
    static = {}
    args = _m4c_args()
    if mode == "teacher":
        args = args + (ints(6 + 3, 2, 4, seed=26),)
    else:
        static["dec_steps"] = 4
        if mode == "captioner":
            static["remove_unk_idx"] = 1
    tree = shared(lambda: JM4C.init_m4c(K(0), cfgs[0]),
                  lambda: TM4C.init_m4c(0, cfgs[1], device="cpu"))
    if mode == "teacher":
        want = jax_run(lambda p, a: JM4C.m4c_forward(
            p, cfgs[0], *a[:-1], prev_inds=a[-1]), tree, args)
        got = TM4C.m4c_forward(port(tree, "m4c"), cfgs[1],
                               *torch_args(args[:-1]),
                               prev_inds=torch.as_tensor(args[-1]))
    else:
        want = jax_run(lambda p, a: JM4C.m4c_forward(p, cfgs[0], *a,
                                                     **static), tree, args)
        got = TM4C.m4c_forward(port(tree, "m4c"), cfgs[1],
                               *torch_args(args), **static)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))
        if mode == "captioner":
            assert torch.all(got[..., 1] == -1e10)
            assert not torch.any(got.argmax(-1) == 1)
    close(got, want)


# ---------------------------------------------------------------------------
# MoVie+MCAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training,compressed", [(False, True),
                                                 (True, False)])
def test_movie_mcan(training, compressed):
    kw = dict(vocab_size=30, num_answers=5, embedding_dim=8, hidden_dim=16,
              num_attn=2, num_layers=1, cbn_num_layers=2,
              image_feature_dim=12, compressed=compressed, cbn_out_dim=16)
    tokens = ints(30, 2, 6, seed=27, low=1)
    tokens[1, 4:] = 0                     # pads mask the text attention
    args = (tokens, rand(2, 12, 3, 3, seed=28))
    both(JMM, TMM, "init_movie_mcan", "movie_mcan_forward",
         (JMM.MovieMcanConfig(**kw), TMM.MovieMcanConfig(**kw)), args,
         "movie_mcan", training=training)


# ---------------------------------------------------------------------------
# lxmert-old
# ---------------------------------------------------------------------------

LX = dict(vocab_size=30, hidden_size=16, num_attention_heads=2,
          intermediate_size=32, max_position_embeddings=16, l_layers=1,
          x_layers=1, r_layers=1, visual_feat_dim=8, num_qa_labels=6)


def _lx_batch(B=2, pretraining=False):
    batch = {"input_ids": ints(30, B, 5, seed=29),
             "input_mask": np.ones((B, 5), np.int32),
             "segment_ids": np.zeros((B, 5), np.int64),
             "image_feature_0": rand(B, 3, 8, seed=30),
             "bbox": np.abs(rand(B, 3, 4, seed=31))}
    batch["input_mask"][0, 4:] = 0
    if pretraining:
        lm = ints(30, B, 5, seed=32)
        lm[:, ::2] = -1
        mil = np.array([[1, 0, 1], [0, 0, 1]])
        batch.update(masked_lm_labels=lm, matched_label=np.array([1, 0]),
                     obj_labels=np.abs(rand(B, 3, 9, seed=33)),
                     masked_image_labels=mil,
                     ans=np.abs(rand(B, 7, seed=34)))
    return batch


@pytest.mark.parametrize("head", ["pretraining", "pretraining_gqa", "vqa2",
                                  "gqa", "nlvr2"])
def test_lxmert_old(head):
    kind = "pretraining" if head.startswith("pretraining") else head
    jcfg = JLO.LxmertOldConfig(lxmert=jlx.LxmertConfig(**LX),
                               training_head_type=kind, num_labels=7,
                               gqa_labels=4, num_object_labels=9)
    tcfg = TLO.LxmertOldConfig(lxmert=tlx.LxmertConfig(**LX),
                               training_head_type=kind, num_labels=7,
                               gqa_labels=4, num_object_labels=9)
    name = "gqa" if head == "pretraining_gqa" else None
    batch = _lx_batch(B=4 if head == "nlvr2" else 2,
                      pretraining=kind == "pretraining")
    tree = shared(lambda: JLO.init_params(K(0), jcfg),
                  lambda: TLO.init_params(0, tcfg, device="cpu"))
    if kind == "pretraining":
        want = cached("lxmert_pretraining", lambda: jax_run(
            lambda p, b: [JLO.forward(p, b, jcfg, name=n)
                          for n in (None, "gqa")], tree, batch))[
            name is not None]
    else:
        want = jax_run(lambda p, b: JLO.forward(p, b, jcfg), tree, batch)
    got = TLO.forward(port(tree, "lxmert_mmf"), torch_args(batch), tcfg,
                      name=name)
    if kind == "pretraining":
        assert set(got) == {"answer_loss", "masked_lm_loss", "matched_loss",
                            "visn_loss"}
    close(got, want)
