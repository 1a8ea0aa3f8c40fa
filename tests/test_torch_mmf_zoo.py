"""The port's MMF zoo against the JAX package's: Pythia and its question-
only, image-only and multi-head variants, LoRRA, BAN (GRU and LSTM), BUTD
(teacher forcing and greedy decoding), ``butd_decode`` under beam search
and nucleus sampling, CNN-LSTM, TopDownBottomUp and visual_dialog's
discriminator; ``utils/convert_mmf`` for pythia, pythia_multihead, ban,
butd, m4c, mmbt, vilbert and cnn_lstm (the same numpy state dict, under the
MMF key names, through both converters: equal trees, agreeing forwards);
the encoders with ``adaptive_pool_2d``, the ``core/build`` builders,
``MMBTGridHMInterface.classify`` on the CPU, and the registry: after the
port's ``setup_imports`` its model, explainer, trainer and encoder names
equal JAX ``zoo.registry``'s, and each MMF model name has a case here or in
``test_torch_mmf_models``.

Tiny widths, numpy-seeded inputs, one weight tree for both sides
(``tests/_mmf_parity``). Bar: max|Δ| ≤ 1e-5 · max|JAX output|; decoded
indices and ``butd_decode`` tokens exactly equal; converted trees exactly
equal.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mmf_parity import (K, close, ints, jax_run, port, rand, shared,
                         to_jax_np, torch_args)
from transformer_mm_explainability_tpu.core import build as JB
from transformer_mm_explainability_tpu.data import text_utils as JT
from transformer_mm_explainability_tpu.models import encoders as JE
from transformer_mm_explainability_tpu.models import interfaces as JI
from transformer_mm_explainability_tpu.models import m4c as JM4C
from transformer_mm_explainability_tpu.models import mmbt as JMMBT
from transformer_mm_explainability_tpu.models import mmf_layers as JL
from transformer_mm_explainability_tpu.models import mmf_zoo as JZ
from transformer_mm_explainability_tpu.models import resnet as jresnet
from transformer_mm_explainability_tpu.models import vilbert as JV
from transformer_mm_explainability_tpu.utils import convert_mmf as JC
from transformer_mm_explainability_tpu_torch.core import build as TB
from transformer_mm_explainability_tpu_torch.core import env as tenv
from transformer_mm_explainability_tpu_torch.core.registry import registry
from transformer_mm_explainability_tpu_torch.data import text_utils as TT
from transformer_mm_explainability_tpu_torch.models import encoders as TE
from transformer_mm_explainability_tpu_torch.models import interfaces as TI
from transformer_mm_explainability_tpu_torch.models import m4c as TM4C
from transformer_mm_explainability_tpu_torch.models import mmbt as TMMBT
from transformer_mm_explainability_tpu_torch.models import mmf_layers as TL
from transformer_mm_explainability_tpu_torch.models import mmf_zoo as TZ
from transformer_mm_explainability_tpu_torch.models import resnet as tresnet
from transformer_mm_explainability_tpu_torch.models import vilbert as TV
from transformer_mm_explainability_tpu_torch.utils import convert_mmf as TC

PYTHIA = dict(vocab_size=30, num_answers=7, embedding_dim=8,
              text_hidden_dim=8, conv1_out=6, conv2_out=2,
              image_feature_dim=10, combine_hidden_dim=12,
              classifier_text_hidden=5, classifier_img_hidden=6)
MULTIHEAD = dict(PYTHIA, projection_dim=8, num_attention_heads=2,
                 embeddings_per_stream=2)
LORRA = dict(PYTHIA, context_feature_dim=6, order_vector_dim=3)
BAN = dict(vocab_size=25, num_answers=6, embedding_dim=8, num_hidden=8,
           visual_feat_dim=10, gamma=2, bc_k=1)
BUTD = dict(vocab_size=12, embedding_dim=6, image_feature_dim=10,
            hidden_dim=8, attention_dim=7, max_length=5, sos_index=1)
CNN_LSTM = dict(vocab_size=12, num_answers=3, embedding_dim=5, lstm_hidden=6,
                cnn_input_dims=(3, 4), cnn_output_dims=(4, 5),
                cnn_kernel_sizes=(3, 1), classifier_in_dim=32)
TDBU = dict(vocab_size=18, num_answers=5, embedding_dim=6, text_hidden_dim=8,
            conv1_out=4, conv2_out=2, image_feature_dim=10,
            attention_hidden=6, joint_dim=7, classifier_hidden=9)

TOKENS = ints(30, 2, 6, seed=1)
FEATS = [rand(2, 5, 10, seed=2), rand(2, 4, 10, seed=3)]
LOCS = [np.array([3, 5]), np.array([4, 0])]


def tree_of(init, cfg_name, kw):
    return shared(lambda: getattr(JZ, init)(K(0), getattr(JZ, cfg_name)(**kw)),
                  lambda: getattr(TZ, init)(0, getattr(TZ, cfg_name)(**kw),
                                            device="cpu"))


# name: (init, config class, config kwargs, forward, inputs)
ZOO = {
    "pythia": ("init_pythia", "PythiaConfig", PYTHIA, "pythia_forward",
               (TOKENS, FEATS, LOCS)),
    "pythia_question_only": ("init_pythia", "PythiaConfig", PYTHIA,
                             "pythia_question_only_forward", (TOKENS,)),
    "pythia_image_only": ("init_pythia", "PythiaConfig", PYTHIA,
                          "pythia_image_only_forward",
                          (TOKENS, FEATS, LOCS)),
    "multihead": ("init_pythia_multihead", "PythiaMultiHeadConfig",
                  MULTIHEAD, "pythia_multihead_forward", (TOKENS, FEATS)),
    "lorra": ("init_lorra", "LorraConfig", LORRA, "lorra_forward",
              (TOKENS, FEATS, rand(2, 4, 6, seed=4), rand(2, 4, 3, seed=5),
               LOCS, np.array([2, 4]))),
    "ban": ("init_ban", "BanConfig", BAN, "ban_forward",
            (ints(25, 2, 6, seed=6), rand(2, 5, 10, seed=7))),
    "ban_lstm": ("init_ban", "BanConfig", dict(BAN, rnn_type="LSTM"),
                 "ban_forward", (ints(25, 2, 6, seed=8),
                                 rand(2, 5, 10, seed=9))),
    "cnn_lstm": ("init_cnn_lstm", "CnnLstmConfig", CNN_LSTM,
                 "cnn_lstm_forward", (ints(12, 2, 6, seed=10),
                                      rand(2, 3, 8, 8, seed=11))),
    "top_down_bottom_up": ("init_tdbu", "TdbuConfig", TDBU, "tdbu_forward",
                           (ints(18, 2, 6, seed=12),
                            rand(2, 5, 10, seed=13))),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model(name):
    init, cfg_name, kw, fwd, args = ZOO[name]
    tree = tree_of(init, cfg_name, kw)
    jcfg, tcfg = getattr(JZ, cfg_name)(**kw), getattr(TZ, cfg_name)(**kw)
    want = jax_run(lambda p, *a: getattr(JZ, fwd)(p, jcfg, *a), tree, *args)
    got = getattr(TZ, fwd)(port(tree), tcfg, *torch_args(args))
    close(got, want)


def test_visual_dialog_discriminator():
    """visual_dialog (visdial_multi_modal.py:7): Pythia's text embedding of
    the answer options, scored by the VisDial discriminator against the
    encoder output."""
    tree = tree_of("init_pythia", "PythiaConfig", PYTHIA)
    disc = shared(lambda: JL.init_visdial_discriminator(K(0), 16, 12),
                  lambda: TL.init_visdial_discriminator(0, 16, 12, "cpu"))
    options, enc = ints(30, 6, 4, seed=14), rand(2, 12, seed=15)

    def jfwd(p, d, o, e):
        emb = JZ.pythia_process_text(p, o).reshape(2, 3, -1)
        return JL.visdial_discriminator_fwd(d, emb, e)

    want = jax_run(jfwd, tree, disc, options, enc)
    emb = TZ.pythia_process_text(port(tree), torch.as_tensor(options))
    close(TL.visdial_discriminator_fwd(port(disc), emb.reshape(2, 3, -1),
                                       torch.as_tensor(enc)), want)


@pytest.mark.parametrize("teacher", [True, False])
def test_butd(teacher):
    """Teacher forcing, and greedy decoding from SOS whose fed-back tokens
    are exactly JAX's."""
    jcfg, tcfg = JZ.ButdConfig(**BUTD), TZ.ButdConfig(**BUTD)
    tree = tree_of("init_butd", "ButdConfig", BUTD)
    feat = rand(2, 4, 10, seed=16)
    tokens = ints(12, 2, 5, seed=17) if teacher else None
    want = jax_run(lambda p, f, t: JZ.butd_forward(p, jcfg, f, t), tree,
                   feat, tokens)
    got = TZ.butd_forward(port(tree), tcfg, torch.as_tensor(feat),
                          None if tokens is None else torch.as_tensor(tokens))
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    close(got, want)


def _vocab(mod, eos):
    v = mod.VocabFromText([], only_unk_extra=False)
    v.itos = [f"t{i}" for i in range(12)]
    v.stoi = {w: i for i, w in enumerate(v.itos)}
    v.PAD_INDEX, v.SOS_INDEX, v.EOS_INDEX = 0, 1, eos
    v.UNK_INDEX = 5
    return v


@pytest.mark.parametrize("decoder", ["beam_search", "nucleus_sampling"])
def test_butd_decode(decoder):
    """The same tokens from both packages' decoders driving BUTD."""
    jcfg, tcfg = JZ.ButdConfig(**BUTD), TZ.ButdConfig(**BUTD)
    tree = tree_of("init_butd", "ButdConfig", BUTD)
    feats = rand(1, 4, 10, seed=18)

    # EOS is a token these weights' decoders reach within the 5 steps
    # (else both return the empty result, zeros)
    eos = 2 if decoder == "beam_search" else 3

    def make(mod):
        if decoder == "beam_search":
            return mod.BeamSearch(_vocab(mod, eos), 3)
        return mod.NucleusSampling(_vocab(mod, eos), 0.9,
                                   np.random.RandomState(3))

    want = JT.butd_decode(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                          feats, make(JT), max_steps=5)
    got = TT.butd_decode(port(tree), tcfg, feats, make(TT), max_steps=5)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0, 0] == 1 and got[0, -1] == eos    # SOS ... EOS


# ---------------------------------------------------------------------------
# convert_mmf: one MMF state dict (built from a tree under the key names
# the JAX converter reads), both converters
# ---------------------------------------------------------------------------

class SD(dict):
    """An MMF state dict written from a tree in the shared layout."""

    def lin(self, prefix, p):
        self[f"{prefix}.weight"] = p["w"]
        self[f"{prefix}.bias"] = p["b"]

    def ln(self, prefix, p):
        self[f"{prefix}.weight"] = p["scale"]
        self[f"{prefix}.bias"] = p["bias"]

    def bn(self, prefix, p):
        self.ln(prefix, p)
        self[f"{prefix}.running_mean"] = p["mean"]
        self[f"{prefix}.running_var"] = p["var"]

    def wn(self, prefix, p):
        g = np.asarray(p["g"])
        self[f"{prefix}.weight_v"] = p["v"]
        self[f"{prefix}.weight_g"] = g if g.ndim == 0 else g[:, None]
        if "b" in p:
            self[f"{prefix}.bias"] = p["b"]

    def rnn(self, prefix, p, sfx="_l0"):
        for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                        ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            self[f"{prefix}.{name}{sfx}"] = p[k]

    def fc_net(self, prefix, p):
        for i, layer in enumerate(p["layers"]):
            self.wn(f"{prefix}.main.{2 * i}", layer)

    def nlem(self, prefix, p):
        for k, v in p.items():
            self.wn(f"{prefix}.{k}.layers.0", v)

    def bert(self, prefix, enc, layers, emb=None):
        """A stacked encoder (fused ``[in, 3D]`` qkv) at
        ``prefix.encoder.layer`` and HF BertEmbeddings at
        ``prefix.embeddings``."""
        if emb is not None:
            for k in ("word", "position", "token_type"):
                self[f"{prefix}embeddings.{k}_embeddings.weight"] = emb[k]
            self.ln(f"{prefix}embeddings.LayerNorm", emb["ln"])
        a = enc["attn"]
        D = a.w_out.shape[1]
        for i in range(layers):
            p = f"{prefix}encoder.layer.{i}"
            for j, n in enumerate(("query", "key", "value")):
                self.lin(f"{p}.attention.self.{n}",
                         {"w": a.w_qkv[i][:, j * D:(j + 1) * D].T,
                          "b": a.b_qkv[i][j * D:(j + 1) * D]})
            self.lin(f"{p}.attention.output.dense",
                     {"w": a.w_out[i].T, "b": a.b_out[i]})
            self.ln(f"{p}.attention.output.LayerNorm",
                    {k: v[i] for k, v in enc["attn_ln"].items()})
            m = enc["mlp"]
            self.lin(f"{p}.intermediate.dense", {"w": m["w1"][i].T,
                                                 "b": m["b1"][i]})
            self.lin(f"{p}.output.dense", {"w": m["w2"][i].T,
                                           "b": m["b2"][i]})
            self.ln(f"{p}.output.LayerNorm",
                    {k: v[i] for k, v in enc["mlp_ln"].items()})


def _conv1d(p):
    return {"w": p["w"][:, :, None], "b": p["b"]}


def _pythia_sd(t, cfg, wrapped=True):
    sd = SD()
    sd["word_embedding.weight"] = t["word_embedding"]
    te = t["text_embedding"]
    sd.rnn("text_embeddings.0.recurrent_unit", te["lstm"]["fwd"])
    sd.lin("text_embeddings.0.conv1", _conv1d(te["conv1"]))
    sd.lin("text_embeddings.0.conv2", _conv1d(te["conv2"]))
    for i, enc in enumerate(t["image_encoders"]):
        if enc:   # stream 0 in Pythia's wrapped checkpoint form
            sd.lin("image_feature_encoders.0.module.lc" if i == 0 and wrapped
                   else f"image_feature_encoders.{i}.lc", enc["lc"])
    for i, st in enumerate(t.get("image_streams", [])):
        base = (f"image_feature_embeddings_list.{i}.0."
                "image_attention_model.module")
        sd.nlem(f"{base}.combination_layer.module", st["combine"])
        sd.wn(f"{base}.transform.module.lc", st["transform"])
    sd.nlem("image_text_multi_modal_combine_layer.module", t["combine"])
    c = t["classifier"]
    sd.wn("classifier.module.f_o_text.layers.0", c["f_o_text"])
    sd.wn("classifier.module.f_o_image.layers.0", c["f_o_image"])
    sd.lin("classifier.module.linear_text", c["linear_text"])
    sd.lin("classifier.module.linear_image", c["linear_image"])
    return sd


def _multihead_sd(t, cfg):
    sd = _pythia_sd(t, cfg, wrapped=False)
    for i, proj in enumerate(t["image_projectors"]):
        sd.lin(f"image_feature_projectors.{i}.module.layers", proj["lc"])
        for j, e in enumerate(t["image_embeddings"][i]):
            p = f"image_feature_embeddings_list.{i}.{j}.module"
            for n in "qkv":
                sd[f"{p}.{n}_proj_weight"] = e[n]["w"]
            sd[f"{p}.in_proj_bias"] = np.concatenate(
                [e[n]["b"] for n in "qkv"])
            sd.lin(f"{p}.out_proj", e["out"])
    return sd


def _ban_sd(t, cfg):
    sd = SD()
    sd["word_embedding.weight"] = t["word_embedding"]
    sd.rnn("q_emb.recurrent_encoder", t["q_emb"]["rnn"]["fwd"])
    bc = t["v_att"]["logits"]
    sd.fc_net("v_att.logits.v_net", bc["v_net"])
    sd.fc_net("v_att.logits.q_net", bc["q_net"])
    sd["v_att.logits.h_mat_v"] = bc["h_mat_v"]
    sd["v_att.logits.h_mat_g"] = bc["h_mat_g"]
    sd["v_att.logits.h_bias"] = bc["h_bias"]
    for g in range(cfg.gamma):
        sd.fc_net(f"b_net.{g}.v_net", t["b_net"][g]["v_net"])
        sd.fc_net(f"b_net.{g}.q_net", t["b_net"][g]["q_net"])
        sd.fc_net(f"q_prj.{g}", t["q_prj"][g])
    sd.wn("classifier.main.0", t["classifier"]["fc1"])
    sd.wn("classifier.main.3", t["classifier"]["fc2"])
    return sd


def _butd_sd(t, cfg):
    sd = SD()
    sd["word_embedding.weight"] = t["word_embedding"]
    sd.lin("image_feature_encoders.0.module.lc", t["encoder"]["lc"])
    base = "image_feature_embeddings_list.0.0.image_attention_model.module"
    comb = f"{base}.combination_layer.module"
    sd.wn(f"{comb}.fa_image", t["td_attn"]["fa_image"])
    sd.wn(f"{comb}.fa_hidden", t["td_attn"]["fa_hidden"])
    sd.rnn(f"{comb}.top_down_lstm", t["td_attn"]["td_lstm"], sfx="")
    sd.wn(f"{base}.transform.module.lc", t["transform"])
    sd.wn("classifier.module.fc", t["decoder"]["fc"])
    sd.rnn("classifier.module.language_lstm", t["decoder"]["lm_lstm"],
           sfx="")
    return sd


def _cnn_lstm_sd(t, cfg):
    sd = SD()
    sd["text_embedding.weight"] = t["word_embedding"]
    sd.rnn("lstm", t["lstm"]["fwd"])
    sd.rnn("lstm", t["lstm"]["bwd"], sfx="_l0_reverse")
    for i, c in enumerate(t["cnn"]):
        sd[f"cnn.{i}.conv.weight"], sd[f"cnn.{i}.conv.bias"] = c["w"], c["b"]
        sd.bn(f"cnn.{i}.batch_norm_2d", c["bn"])
    sd.lin("classifier.module.layers.0", t["classifier"]["out"])
    return sd


def _m4c_sd(t, cfg):
    sd = SD()
    sd.bert("text_bert.", t["text_bert"]["encoder"], cfg.text_bert_layers,
            t["text_bert"]["embeddings"])
    for name in ("obj", "ocr"):
        m = t[name]
        sd.lin(f"{name}_faster_rcnn_fc7.module.lc", m["fc7"])
        sd.lin(f"linear_{name}_feat_to_mmt_in", m["feat"])
        sd.lin(f"linear_{name}_bbox_to_mmt_in", m["bbox"])
        sd.ln(f"{name}_feat_layer_norm", m["feat_ln"])
        sd.ln(f"{name}_bbox_layer_norm", m["bbox_ln"])
    mmt = t["mmt"]
    sd.bert("mmt.", mmt["encoder"], cfg.mmt_layers)
    pp = "mmt.prev_pred_embeddings"
    pr = mmt["prev_pred"]
    sd[f"{pp}.position_embeddings.weight"] = pr["position"]
    sd[f"{pp}.token_type_embeddings.weight"] = pr["token_type"]
    for k in ("ans", "ocr", "emb"):
        sd.ln(f"{pp}.{k}_layer_norm", pr[f"{k}_ln"])
    sd.lin("classifier.module", t["classifier"])
    sd.lin("ocr_ptr_net.query", t["ocr_ptr_net"]["query"])
    sd.lin("ocr_ptr_net.key", t["ocr_ptr_net"]["key"])
    return sd


def _transform(sd, prefix, p):
    sd.lin(f"{prefix}.dense", p)
    sd.ln(f"{prefix}.LayerNorm", p["ln"])


def _mmbt_sd(t, cfg):
    sd = SD()
    sd.bert("transformer.", t["encoder"], cfg.num_hidden_layers,
            t["embeddings"])
    sd.lin("transformer.pooler.dense", t["pooler"])
    sd.lin("modal_encoder.proj_embeddings", t["modal_proj"])
    _transform(sd, "classifier.0", t["classifier"]["transform"])
    sd.lin("classifier.1", t["classifier"]["out"])
    _transform(sd, "cls.predictions.transform", t["cls"]["transform"])
    sd["cls.predictions.bias"] = t["cls"]["decoder_bias"]
    sd.lin("cls.seq_relationship", t["cls"]["seq_relationship"])
    # MMF's full-model prefix, which both converters strip
    return SD({f"model.bert.mmbt.{k}": v for k, v in sd.items()})


def _vilbert_sd(t, cfg):
    sd = SD()
    emb = t["embeddings"]
    for k in ("word", "position", "token_type"):
        sd[f"embeddings.{k}_embeddings.weight"] = emb[k]
    sd.ln("embeddings.LayerNorm", emb["ln"])
    ve = t["v_embeddings"]
    sd.lin("v_embeddings.image_embeddings", ve["image"])
    sd.lin("v_embeddings.image_location_embeddings", ve["loc"])
    sd.ln("v_embeddings.LayerNorm", ve["ln"])
    for stream, layers in (("layer", t["t_layers"]),
                           ("v_layer", t["v_layers"])):
        for i, b in enumerate(layers):
            p = f"encoder.{stream}.{i}"
            for k, n in (("q", "query"), ("k", "key"), ("v", "value")):
                sd.lin(f"{p}.attention.self.{n}", b[k])
            sd.lin(f"{p}.attention.output.dense", b["out"])
            sd.ln(f"{p}.attention.output.LayerNorm", b["out_ln"])
            sd.lin(f"{p}.intermediate.dense", b["inter"])
            sd.lin(f"{p}.output.dense", b["ffn_out"])
            sd.ln(f"{p}.output.LayerNorm", b["ffn_ln"])
            if "dy_q" in b:
                sd.lin(f"{p}.attention.self.dyLinear_q", b["dy_q"])
                sd.lin(f"{p}.attention.self.dyLinear_k", b["dy_k"])
    for i, c in enumerate(t["c_layers"]):
        p = f"encoder.c_layer.{i}"
        for k, n in (("q1", "query1"), ("k1", "key1"), ("v1", "value1"),
                     ("q2", "query2"), ("k2", "key2"), ("v2", "value2")):
            sd.lin(f"{p}.biattention.{n}", c[k])
        sd.lin(f"{p}.biOutput.dense1", c["dense1"])
        sd.ln(f"{p}.biOutput.LayerNorm1", c["ln1"])
        sd.lin(f"{p}.biOutput.dense2", c["dense2"])
        sd.ln(f"{p}.biOutput.LayerNorm2", c["ln2"])
        for s in ("v", "t"):
            sd.lin(f"{p}.{s}_intermediate.dense", c[f"{s}_inter"])
            sd.lin(f"{p}.{s}_output.dense", c[f"{s}_out"])
            sd.ln(f"{p}.{s}_output.LayerNorm", c[f"{s}_ln"])
    sd.lin("t_pooler.dense", t["t_pooler"])
    sd.lin("v_pooler.dense", t["v_pooler"])
    _transform(sd, "classifier.0", t["classifier"]["transform"])
    sd.lin("classifier.1", t["classifier"]["out"])
    cls = t["cls"]
    _transform(sd, "cls.predictions.transform", cls["lm_transform"])
    sd["cls.predictions.bias"] = cls["lm_bias"]
    sd.lin("cls.bi_seq_relationship", cls["bi_seq_relationship"])
    _transform(sd, "cls.imagePredictions.transform", cls["img_transform"])
    sd.lin("cls.imagePredictions.decoder", cls["img_decoder"])
    return SD({f"model.bert.{k}": v for k, v in sd.items()})


M4C = dict(vocab_size=30, num_fixed_answers=6, hidden_size=16, num_heads=2,
           text_bert_layers=1, mmt_layers=1, obj_in_dim=12, ocr_in_dim=22,
           ocr_fc7_dim=12, max_dec_length=8)
MMBT = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1,
            num_attention_heads=2, modal_hidden_size=12)
VILBERT = dict(vocab_size=40, hidden_size=16, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=32,
               max_position_embeddings=16, v_feature_size=12,
               v_target_size=7, v_hidden_size=8, v_num_hidden_layers=1,
               v_num_attention_heads=2, v_intermediate_size=16,
               bi_hidden_size=8, bi_num_attention_heads=2,
               v_biattention_id=(1,), t_biattention_id=(1,), num_labels=5,
               dynamic_attention=True)


def _m4c_run(mod):
    cfg = mod.M4CConfig(**M4C)
    args = (ints(30, 2, 5, seed=19), np.array([5, 3]), rand(2, 4, 12),
            np.abs(rand(2, 4, 4)), np.array([4, 2]), rand(2, 3, 4),
            rand(2, 3, 4), rand(2, 3, 12), rand(2, 3, 2),
            np.abs(rand(2, 3, 4)), np.array([2, 3]), ints(9, 2, 3))
    return cfg, args, (lambda p, *a: mod.m4c_forward(
        p, cfg, *a[:-1], prev_inds=a[-1]))


def _mmbt_run(mod):
    cfg = mod.MMBTConfig(**MMBT)
    inputs = {"input_modal": rand(2, 3, 12), "input_ids": ints(40, 2, 5),
              "attention_mask": np.ones((2, 5), np.int32),
              "token_type_ids": np.zeros((2, 5), np.int64)}
    return cfg, (inputs,), (lambda p, i: mod.mmbt_for_classification(
        p, cfg, **i))


def _vilbert_run(mod):
    cfg = mod.ViLBERTConfig(**VILBERT)
    return cfg, (ints(40, 2, 6), rand(2, 4, 12), rand(2, 4, 5)), (
        lambda p, *a: mod.vilbert_for_classification(p, cfg, *a))


def _zoo_run(cfg_name, kw, fwd, args):
    def make(mod):
        cfg = getattr(mod, cfg_name)(**kw)
        return cfg, args, (lambda p, *a: getattr(mod, fwd)(p, cfg, *a))
    return make


# family: (state-dict writer, jax init, port init, runner of either side)
CONVERTERS = {
    "pythia": (_pythia_sd, ("init_pythia", "PythiaConfig", PYTHIA),
               _zoo_run("PythiaConfig", PYTHIA, "pythia_forward",
                        (TOKENS, FEATS))),
    "pythia_multihead": (
        _multihead_sd, ("init_pythia_multihead", "PythiaMultiHeadConfig",
                        MULTIHEAD),
        _zoo_run("PythiaMultiHeadConfig", MULTIHEAD,
                 "pythia_multihead_forward", (TOKENS, FEATS))),
    "ban": (_ban_sd, ("init_ban", "BanConfig", BAN),
            _zoo_run("BanConfig", BAN, "ban_forward",
                     (ints(25, 2, 6), rand(2, 5, 10)))),
    "butd": (_butd_sd, ("init_butd", "ButdConfig", BUTD),
             _zoo_run("ButdConfig", BUTD, "butd_forward",
                      (rand(2, 4, 10), ints(12, 2, 3)))),
    "cnn_lstm": (_cnn_lstm_sd, ("init_cnn_lstm", "CnnLstmConfig", CNN_LSTM),
                 _zoo_run("CnnLstmConfig", CNN_LSTM, "cnn_lstm_forward",
                          (ints(12, 2, 6), rand(2, 3, 8, 8)))),
    "m4c": (_m4c_sd, (JM4C, TM4C, "init_m4c", "M4CConfig", M4C), _m4c_run),
    "mmbt": (_mmbt_sd, (JMMBT, TMMBT, "init_mmbt", "MMBTConfig", MMBT),
             _mmbt_run),
    "vilbert": (_vilbert_sd, (JV, TV, "init_vilbert", "ViLBERTConfig",
                              VILBERT), _vilbert_run),
}


def _listify(tree):
    """The JAX converter's tree as the port's shape of containers."""
    return to_jax_np(jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.array(a)), tree))


@pytest.mark.parametrize("family", sorted(CONVERTERS))
def test_convert_mmf(family):
    writer, init, runner = CONVERTERS[family]
    if len(init) == 3:
        init = (JZ, TZ) + init
    jmod, tmod, init_name, cfg_name, kw = init
    jcfg, tcfg = getattr(jmod, cfg_name)(**kw), getattr(tmod, cfg_name)(**kw)
    tree = shared(lambda: getattr(jmod, init_name)(K(0), jcfg),
                  lambda: getattr(tmod, init_name)(0, tcfg, device="cpu"))
    sd = writer(tree, jcfg)
    conv = f"{family}_from_state_dict"
    want = _listify(getattr(JC, conv)(sd, jcfg))
    got = getattr(TC, conv)(sd, tcfg, device="cpu")
    # the trees are equal, leaf for leaf, and equal to the written tree
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(
        to_jax_np(got))[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == \
        [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(
            path))
    flat_o = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat_o) == len(flat_w)
    for (_, w), (_, o) in zip(flat_w, flat_o):
        np.testing.assert_array_equal(w, o)
    _, jargs, jfwd = runner(jmod)
    _, targs, tfwd = runner(tmod)
    close(tfwd(got, *torch_args(targs)),
          jax_run(jfwd, jax.tree_util.tree_map(jnp.asarray, want), *jargs))


# ---------------------------------------------------------------------------
# encoders, builders, the interface, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (3, 2), (3, 3), (5, 1)])
def test_adaptive_pool_2d(grid):
    """torch's adaptive pools give the JAX package's hand-made cell
    bounds, avg and max, on a map that does not divide evenly."""
    x = rand(2, 7, 5, 3, seed=20)
    for mode in ("avg", "max"):
        close(TE.adaptive_pool_2d(torch.as_tensor(x), grid, mode),
              JE.adaptive_pool_2d(jnp.asarray(x), grid, mode), rel=1e-6)


def _resnet_tree(stages=(1, 1, 1, 1)):
    """A small-stage ResNet trunk (ResNet-152's widths) as the JAX HWIO
    tree, from the port's OIHW init."""
    t = tresnet.init_params(0, stages=stages, device="cpu")
    tree = jax.tree_util.tree_map(
        lambda a: a.permute(2, 3, 1, 0).numpy() if a.dim() == 4
        else a.numpy(), t)
    assert [np.shape(a) for a in jax.tree_util.tree_leaves(tree)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jax.eval_shape(
            lambda: jresnet.init_params(K(0), stages=stages)))]
    return tree


@pytest.mark.parametrize("n", [1, 4, -1])
def test_resnet152_grid_encoder(n):
    tree = _resnet_tree()
    jenc = JE.ResNet152ImageEncoder({"num_output_features": n,
                                     "pool_type": "avg" if n != 4
                                     else "max"})
    tenc = TE.ResNet152ImageEncoder({"num_output_features": n,
                                     "pool_type": "avg" if n != 4
                                     else "max"})
    x = rand(1, 3, 64, 64, seed=21)
    close(tenc.apply(port(tree, "resnet"), torch.as_tensor(x)),
          jax_run(jenc.apply, tree, x))


def test_feature_and_text_encoders(tmp_path):
    feat = rand(2, 3, 6, seed=22)
    w, b = rand(5, 6, seed=23), rand(5, seed=24)
    with open(tmp_path / "w.pkl", "wb") as f:
        pickle.dump(w, f)
    with open(tmp_path / "b.pkl", "wb") as f:
        pickle.dump(b, f)
    for cfg in ({"in_dim": 6, "weights": w, "bias": b},
                {"in_dim": 6, "weights_file": str(tmp_path / "w.pkl"),
                 "bias_file": str(tmp_path / "b.pkl")}):
        je = JE.build_image_feature_encoder("finetune_faster_rcnn_fpn_fc7",
                                            cfg)
        te = TE.build_image_feature_encoder("finetune_faster_rcnn_fpn_fc7",
                                            cfg)
        assert te.out_dim == je.out_dim == 5
        close(te.apply(te.init(device="cpu"), torch.as_tensor(feat)),
              je.apply(je.init(K(0)), jnp.asarray(feat)))
    for enc_type, cfg in (("identity", {"in_dim": 6}),
                          ("projection", {"in_dim": 6, "out_dim": 4})):
        je = JE.build_image_feature_encoder(enc_type, cfg)
        te = TE.build_image_feature_encoder(enc_type, cfg)
        tree = shared(lambda: je.init(K(0)),
                      lambda: te.init(0, device="cpu"))
        close(te.apply(port(tree), torch.as_tensor(feat)),
              je.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                       jnp.asarray(feat)))
    cfg = {"num_segments": 4, "vocab_size": 30, "hidden_size": 16,
           "num_hidden_layers": 1, "num_attention_heads": 2}
    je, te = JE.TransformerEncoder(cfg), TE.TransformerEncoder(cfg)
    tp = te.init(0, device="cpu")
    assert tp["embeddings"]["token_type"].shape == (4, 16)
    tree = shared(lambda: je.init(K(0)), lambda: tp)
    ids, seg = ints(30, 2, 5, seed=25), ints(4, 2, 5, seed=26)
    mask = np.ones((2, 5), np.int32)
    mask[0, 3:] = 0
    close(te.apply(port(tree), *torch_args((ids, mask, seg))),
          jax_run(je.apply, tree, ids, mask, seg))
    for op in ("sum", "concat", "mul"):
        cfg = {"operator": op, "embedding_params": {
            "type": "attention", "params": {
                "hidden_dim": 6, "embedding_dim": 5, "conv1_out": 4,
                "conv2_out": 2}}}
        je, te = JE.TextEmbeddingEncoder(cfg), TE.TextEmbeddingEncoder(cfg)
        tree = shared(lambda: je.init(K(0)), lambda: te.init(0, "cpu"))
        x = rand(2, 4, 5, seed=27)
        close(te.apply(port(tree), torch.as_tensor(x)),
              jax_run(je.apply, tree, x))


@pytest.mark.parametrize("ctype,params", [
    ("weight_norm", {"hidden_dim": 6}),
    ("logit", {"text_hidden_dim": 5, "img_hidden_dim": 4}),
    ("mlp", {"hidden_dim": 6, "num_layers": 1}),
    ("language_decoder", {"hidden_dim": 5, "fc_bias_init": 0.1}),
    ("triple_linear", {}),
    ("linear", {})])
def test_build_classifier_layer(ctype, params):
    config = {"type": ctype, "params": params}
    box = []

    def jinit():
        p, fwd = JB.build_classifier_layer(config, 7, 4, key=K(0))
        box.append(fwd)
        return p

    tp, tfwd = TB.build_classifier_layer(config, 7, 4, seed=0, device="cpu")
    tree = shared(jinit, lambda: tp)
    if ctype == "language_decoder":
        args = (rand(2, 7, seed=28), rand(2, 5, seed=29),
                rand(2, 5, seed=30), rand(2, 5, seed=31))
    elif ctype == "triple_linear":
        args = (rand(2, 3, 7, seed=32),)
    else:
        args = (rand(2, 7, seed=33),)
    close(tfwd(port(tree), *torch_args(args)), jax_run(box[0], tree, *args))
    if ctype == "triple_linear":
        close(tfwd(port(tree), torch.as_tensor(args[0][:, 1])),
              jax_run(box[0], tree, args[0][:, 1]))


def test_build_encoders():
    assert isinstance(TB.build_text_encoder({"type": "transformer",
                                             "params": {}}),
                      TE.TransformerEncoder)
    assert isinstance(TB.build_image_encoder({"type": "resnet152"}),
                      TE.ResNet152ImageEncoder)
    assert isinstance(TB.build_image_encoder(
        {"type": "projection", "params": {"in_dim": 4, "out_dim": 2}},
        direct_features=True), TE.ProjectionEncoder)
    enc = TB.build_encoder({"type": "identity", "params": {"in_dim": 3}})
    assert isinstance(enc, TE.IdentityEncoder) and enc.out_dim == 3
    enc = TB.build_encoder({"name": "resnet152", "num_output_features": 4})
    assert enc.num_output_features == 4
    with pytest.raises(NotImplementedError):
        TB.build_classifier_layer({"type": "nope"}, 2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TB.build_classifier_layer({"type": "linear"}, 2, 2)


VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4,
         "a": 5, "meme": 6, "text": 7}


def test_mmbt_interface_classify(tmp_path):
    """``classify`` on the CPU equals the JAX interface's verdict on the
    same weights, for an array and for a file; a URL raises."""
    from PIL import Image

    from transformer_mm_explainability_tpu.data import processors as JP
    from transformer_mm_explainability_tpu_torch.data import processors as TP

    kw = dict(vocab_size=len(VOCAB), hidden_size=16, num_hidden_layers=1,
              num_attention_heads=2, modal_hidden_size=2048)
    jcfg, tcfg = JMMBT.MMBTConfig(**kw), TMMBT.MMBTConfig(**kw)
    mm = shared(lambda: JMMBT.init_mmbt(K(0), jcfg),
                lambda: TMMBT.init_mmbt(0, tcfg, device="cpu"))
    res = _resnet_tree()
    enc_cfg = {"num_output_features": 1}
    proc_cfg = {"tokenizer_config": {"vocab": VOCAB}, "max_seq_length": 8}
    jif = JI.MMBTGridHMInterface(
        {"mmbt": mm, "image_encoder": res}, jcfg,
        JP.BertTokenizerProcessor(proc_cfg),
        image_encoder=JE.ResNet152ImageEncoder(enc_cfg))
    tif = TI.MMBTGridHMInterface(
        {"mmbt": port(mm, "mmbt"), "image_encoder": port(res, "resnet")},
        tcfg, TP.BertTokenizerProcessor(proc_cfg),
        image_encoder=TE.ResNet152ImageEncoder(enc_cfg), device="cpu")
    img = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    path = tmp_path / "meme.png"
    Image.fromarray(img).save(path)
    for image, text in ((img, "a meme text"), (str(path), "a meme")):
        want, got = jif.classify(image, text), tif.classify(image, text)
        assert got["label"] == want["label"]
        assert abs(got["confidence"] - want["confidence"]) <= 1e-5
    with pytest.raises(RuntimeError, match="offline"):
        tif.classify("http://example.com/x.png", "a meme")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TI.MMBTGridHMInterface({}, tcfg, None)


def test_registry_equals_jax_zoo():
    """After ``setup_imports`` the port registers JAX ``zoo``'s 29 model
    and 5 explainer names, its trainers and its encoders."""
    from transformer_mm_explainability_tpu.zoo import registry as jreg

    tenv.setup_imports()
    for ns in ("model", "explainer", "trainer", "encoder", "scheduler",
               "optimizer", "decoder"):
        assert sorted(registry.list(ns)) == sorted(jreg.list(ns)), ns
    assert len(registry.list("model")) == 29
    assert len(registry.list("explainer")) == 5
    from transformer_mm_explainability_tpu_torch.models import mmf_zoo
    assert registry.get("model", "visual_dialog") is mmf_zoo


# every MMF model name and the case that holds it to JAX
CASES = {
    "pythia": "test_zoo_model[pythia]",
    "pythia_image_only": "test_zoo_model[pythia_image_only]",
    "pythia_question_only": "test_zoo_model[pythia_question_only]",
    "multihead": "test_zoo_model[multihead]",
    "lxmert-old": "test_torch_mmf_models.py::test_lxmert_old",
    "lorra": "test_zoo_model[lorra]",
    "ban": "test_zoo_model[ban]",
    "butd": "test_butd",
    "cnn_lstm": "test_zoo_model[cnn_lstm]",
    "top_down_bottom_up": "test_zoo_model[top_down_bottom_up]",
    "m4c": "test_torch_mmf_models.py::test_m4c",
    "m4c_captioner": "test_torch_mmf_models.py::test_m4c[captioner]",
    "mmbt": "test_torch_mmf_models.py::test_mmbt_classification",
    "concat_bert": "test_torch_mmf_models.py::test_fusion[concat_bert]",
    "concat_bow": "test_torch_mmf_models.py::test_fusion[concat_bow]",
    "late_fusion": "test_torch_mmf_models.py::test_fusion[late_fusion]",
    "unimodal_text": "test_torch_mmf_models.py::test_fusion[unimodal_text]",
    "unimodal_image":
        "test_torch_mmf_models.py::test_fusion[unimodal_image]",
    "mmf_transformer": "test_torch_mmf_models.py::test_mmf_transformer",
    "vilbert": "test_torch_mmf_models.py::test_vilbert_classification",
    "mmf_bert": "test_torch_mmf_models.py::test_mmf_bert",
    "movie_mcan": "test_torch_mmf_models.py::test_movie_mcan",
    "visual_dialog": "test_visual_dialog_discriminator",
}
# the six models of earlier slices, held by their own test files
EARLIER = {"vit", "clip", "visual_bert", "lxmert", "detr", "frcnn"}


def test_every_model_name_has_a_case():
    tenv.setup_imports()
    assert set(registry.list("model")) == set(CASES) | EARLIER
