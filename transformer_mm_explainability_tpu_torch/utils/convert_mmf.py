"""MMF model-zoo state dicts → the port's ``mmf_layers`` / ``mmf_zoo``
trees (and M4C, MMBT, ViLBERT), in PyTorch.

Counterpart of ``transformer_mm_explainability_tpu/utils/convert_mmf.py``:
the same key names of the reference modules (``mmf/modules/{layers,
attention,embeddings}.py``, ``mmf/models/{pythia,lorra,ban,butd,cnn_lstm,
m4c,mmbt,vilbert}.py``) onto the same tree layout, built in numpy and
moved to ``device`` at the end. Weight-norm layers keep torch's (v, g):
``weight_g`` is 0-dim for a ``dim=None`` wrap and ``[out, 1]`` for the
default ``dim=0``, and becomes a scalar or ``[out]``. The JAX module's
thirteen layer converters (``*_from_sd``) keep its names and parameters
and return float32 tensors on ``device``; the model converters compose
their numpy builders (``_nlem`` and the like).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from transformer_mm_explainability_tpu_torch.utils.convert import (
    _bert_embeddings_np,
    _bert_encoder_np,
    _np,
    _to_torch,
)


def _lin(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """torch Linear, kept ``[out, in]``."""
    return {"w": _np(sd[f"{prefix}.weight"]), "b": _np(sd[f"{prefix}.bias"])}


def _ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _bn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]),
            "var": _np(sd[f"{prefix}.running_var"])}


def _wn(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """A weight-norm linear: dim=None → scalar g, dim=0 → g ``[out]``."""
    g = _np(sd[f"{prefix}.weight_g"])
    out = {"v": _np(sd[f"{prefix}.weight_v"]),
           "g": g.reshape(()) if g.size == 1 else g.reshape(-1)}
    if f"{prefix}.bias" in sd:
        out["b"] = _np(sd[f"{prefix}.bias"])
    return out


def _dot(prefix: str) -> str:
    return prefix + "." if prefix else ""


def _rnn(sd: Mapping[str, Any], prefix: str, layer: int = 0,
         reverse: bool = False, suffix: Optional[str] = None):
    sfx = (f"_l{layer}" + ("_reverse" if reverse else "")) \
        if suffix is None else suffix
    return {k: _np(sd[f"{prefix}.{name}{sfx}"])
            for k, name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                            ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))}


def _birnn(sd: Mapping[str, Any], prefix: str, bidirectional: bool):
    p = {"fwd": _rnn(sd, prefix)}
    if bidirectional:
        p["bwd"] = _rnn(sd, prefix, reverse=True)
    return p


def _conv1d_k1(sd: Mapping[str, Any], prefix: str):
    """A k=1 Conv1d ``[out, in, 1]`` → the ``[out, in]`` linear."""
    return {"w": _np(sd[f"{prefix}.weight"])[:, :, 0],
            "b": _np(sd[f"{prefix}.bias"])}


def _attention_text_embedding(sd, prefix: str = "",
                              bidirectional: bool = False):
    p = _dot(prefix)
    return {"lstm": _birnn(sd, f"{p}recurrent_unit", bidirectional),
            "conv1": _conv1d_k1(sd, f"{p}conv1"),
            "conv2": _conv1d_k1(sd, f"{p}conv2")}


def _nlem(sd, prefix: str = "", has_context: bool = False):
    """NonLinearElementMultiply: ReLUWithWeightNormFC at ``.layers.0``."""
    p = _dot(prefix)
    out = {"fa_image": _wn(sd, f"{p}fa_image.layers.0"),
           "fa_txt": _wn(sd, f"{p}fa_txt.layers.0")}
    if has_context:
        out["fa_context"] = _wn(sd, f"{p}fa_context.layers.0")
    return out


def _logit_classifier(sd, prefix: str = ""):
    p = _dot(prefix)
    return {"f_o_text": _wn(sd, f"{p}f_o_text.layers.0"),
            "f_o_image": _wn(sd, f"{p}f_o_image.layers.0"),
            "linear_text": _lin(sd, f"{p}linear_text"),
            "linear_image": _lin(sd, f"{p}linear_image")}


def _fc_net(sd, prefix: str):
    """FCNet: weight-norm linears at whatever Sequential indices the act /
    dropout layout gave them, found by scanning the keys."""
    base = _dot(prefix) + "main."
    idxs = sorted({int(k[len(base):].split(".")[0]) for k in sd
                   if k.startswith(base) and k.endswith("weight_v")})
    return {"layers": [_wn(sd, f"{base}{i}") for i in idxs]}


def _bc_net(sd, prefix: str):
    """BCNet: the layout (h_mat or h_net, FCNet depths) read from the
    keys."""
    p0 = _dot(prefix)
    p: Dict[str, Any] = {"v_net": _fc_net(sd, f"{p0}v_net"),
                         "q_net": _fc_net(sd, f"{p0}q_net")}
    if f"{p0}h_mat" in sd:
        p["h_mat"] = _np(sd[f"{p0}h_mat"])
        p["h_bias"] = _np(sd[f"{p0}h_bias"])
    if f"{p0}h_net.weight_v" in sd:
        p["h_net"] = _wn(sd, f"{p0}h_net")
    return p


def _bi_attention(sd, prefix: str):
    """BiAttention: a BCNet whose h_mat is weight-normed outside
    (``h_mat_g`` 0-dim, ``h_mat_v`` the raw tensor)."""
    base = _dot(prefix) + "logits"
    bc = _bc_net(sd, base)
    bc.pop("h_mat", None)
    bc["h_mat_v"] = _np(sd[f"{base}.h_mat_v"])
    bc["h_mat_g"] = _np(sd[f"{base}.h_mat_g"]).reshape(())
    bc["h_bias"] = _np(sd[f"{base}.h_bias"])
    return {"logits": bc}


def _weight_norm_classifier(sd, prefix: str = ""):
    """WeightNormClassifier's Sequential: [wn, ReLU, Dropout, wn]."""
    p = _dot(prefix)
    return {"fc1": _wn(sd, f"{p}main.0"), "fc2": _wn(sd, f"{p}main.3")}


def _mlp_classifier(sd, prefix: str = "", num_layers: int = 0):
    """MLPClassifer's ModuleList: [Linear, BN, act, Dropout]* + Linear."""
    p = _dot(prefix)
    return {"hidden": [{"lin": _lin(sd, f"{p}layers.{4 * i}"),
                        "bn": _bn(sd, f"{p}layers.{4 * i + 1}")}
                       for i in range(num_layers)],
            "out": _lin(sd, f"{p}layers.{4 * num_layers}")}


def _conv_net(sd, prefix: str):
    p = _dot(prefix)
    return {"w": _np(sd[f"{p}conv.weight"]), "b": _np(sd[f"{p}conv.bias"]),
            "bn": _bn(sd, f"{p}batch_norm_2d")}


def _rnn_cell(sd, prefix: str):
    """An LSTMCell / GRUCell: its keys carry no layer suffix."""
    return _rnn(sd, prefix, suffix="")


def _top_down_attention_lstm(sd, prefix: str = ""):
    p = _dot(prefix)
    return {"fa_image": _wn(sd, f"{p}fa_image"),
            "fa_hidden": _wn(sd, f"{p}fa_hidden"),
            "td_lstm": _rnn_cell(sd, f"{p}top_down_lstm")}


def _language_decoder(sd, prefix: str = ""):
    p = _dot(prefix)
    return {"fc": _wn(sd, f"{p}fc"),
            "lm_lstm": _rnn_cell(sd, f"{p}language_lstm")}


def _gated_tanh(sd, prefix: str):
    return {"fc": _lin(sd, f"{prefix}.fc"),
            "gate": _lin(sd, f"{prefix}.gate_fc")}


def _project_attention(sd, prefix: str = ""):
    p = _dot(prefix)
    return {"fa_image": _gated_tanh(sd, f"{p}fa_image"),
            "fa_txt": _gated_tanh(sd, f"{p}fa_txt"),
            "lc": _lin(sd, f"{p}lc")}


# ---------------------------------------------------------------------------
# the layer converters of the JAX module: its names and parameters, float32
# tensors on ``device``
# ---------------------------------------------------------------------------

def attention_text_embedding_from_sd(sd: Mapping[str, Any], prefix: str = "",
                                     bidirectional: bool = False,
                                     device="cuda"):
    """AttentionTextEmbedding: the LSTM (both directions where
    ``bidirectional``) and the two k=1 convolutions as linears."""
    return _to_torch(_attention_text_embedding(sd, prefix, bidirectional),
                     device)


def nlem_from_sd(sd: Mapping[str, Any], prefix: str = "",
                 has_context: bool = False, device="cuda"):
    """NonLinearElementMultiply."""
    return _to_torch(_nlem(sd, prefix, has_context), device)


def logit_classifier_from_sd(sd: Mapping[str, Any], prefix: str = "",
                             device="cuda"):
    return _to_torch(_logit_classifier(sd, prefix), device)


def fc_net_from_sd(sd: Mapping[str, Any], prefix: str,
                   act: Optional[str], device="cuda"):
    """FCNet; the layers are found by their keys, ``act`` (the JAX
    signature's) changes nothing."""
    return _to_torch(_fc_net(sd, prefix), device)


def bc_net_from_sd(sd: Mapping[str, Any], prefix: str, k: int,
                   h_out: Optional[int], act: str = "ReLU", device="cuda"):
    """BCNet; its layout comes from the keys, so ``k``, ``h_out`` and
    ``act`` (the JAX signature's) change nothing."""
    return _to_torch(_bc_net(sd, prefix), device)


def bi_attention_from_sd(sd: Mapping[str, Any], prefix: str, glimpse: int,
                         device="cuda"):
    """BiAttention (``glimpse``, the JAX signature's, is read from the
    keys)."""
    return _to_torch(_bi_attention(sd, prefix), device)


def weight_norm_classifier_from_sd(sd: Mapping[str, Any], prefix: str = "",
                                   device="cuda"):
    return _to_torch(_weight_norm_classifier(sd, prefix), device)


def mlp_classifier_from_sd(sd: Mapping[str, Any], prefix: str = "",
                           num_layers: int = 0, device="cuda"):
    return _to_torch(_mlp_classifier(sd, prefix, num_layers), device)


def conv_net_from_sd(sd: Mapping[str, Any], prefix: str, device="cuda"):
    return _to_torch(_conv_net(sd, prefix), device)


def top_down_attention_lstm_from_sd(sd: Mapping[str, Any], prefix: str = "",
                                    device="cuda"):
    """BUTD's TopDownAttentionLSTM: two weight-norm linears and the
    top-down LSTMCell."""
    return _to_torch(_top_down_attention_lstm(sd, prefix), device)


def language_decoder_from_sd(sd: Mapping[str, Any], prefix: str = "",
                             device="cuda"):
    """BUTD's LanguageDecoder: its weight-norm fc and language LSTMCell."""
    return _to_torch(_language_decoder(sd, prefix), device)


def gated_tanh_from_sd(sd: Mapping[str, Any], prefix: str, device="cuda"):
    """GatedTanh: ``fc`` and ``gate_fc``."""
    return _to_torch(_gated_tanh(sd, prefix), device)


def project_attention_from_sd(sd: Mapping[str, Any], prefix: str = "",
                              device="cuda"):
    """ProjectAttention: two GatedTanh and the output linear."""
    return _to_torch(_project_attention(sd, prefix), device)


def _image_encoders(sd, cfg):
    return [{"lc": _lin(sd, f"image_feature_encoders.{i}.lc")}
            if kind == "finetune" else {}
            for i, kind in enumerate(cfg.image_encoders)]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def pythia_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    """Pythia (pythia.py build():39-46) after format_state_key
    (pythia.py:31-37); also LoRRA's combine with its context branch."""
    sd = {k.replace("fa_history", "fa_context")
           .replace("image_feature_encoders.0.module.lc",
                    "image_feature_encoders.0.lc"): v
          for k, v in sd.items()}
    streams = []
    for i in range(len(cfg.image_encoders)):
        base = (f"image_feature_embeddings_list.{i}.0."
                "image_attention_model.module")
        streams.append({
            "combine": _nlem(sd, f"{base}.combination_layer.module"),
            "transform": _wn(sd, f"{base}.transform.module.lc")})
    comb = "image_text_multi_modal_combine_layer.module"
    return _to_torch({
        "word_embedding": _np(sd["word_embedding.weight"]),
        "text_embedding": _attention_text_embedding(sd, "text_embeddings.0"),
        "image_encoders": _image_encoders(sd, cfg),
        "image_streams": streams,
        "combine": _nlem(sd, comb, has_context=any(
            k.startswith(f"{comb}.fa_context") for k in sd)),
        "classifier": _logit_classifier(sd, "classifier.module"),
    }, device)


def _torch_mha_qkv(sd: Mapping[str, Any], prefix: str):
    """torch nn.MultiheadAttention with kdim != embed_dim: separate
    q / k / v projection weights and one fused ``in_proj_bias [3D]``."""
    bias = _np(sd[f"{prefix}.in_proj_bias"])
    D = bias.shape[0] // 3
    return {"q": {"w": _np(sd[f"{prefix}.q_proj_weight"]), "b": bias[:D]},
            "k": {"w": _np(sd[f"{prefix}.k_proj_weight"]),
                  "b": bias[D:2 * D]},
            "v": {"w": _np(sd[f"{prefix}.v_proj_weight"]), "b": bias[2 * D:]},
            "out": _lin(sd, f"{prefix}.out_proj")}


def pythia_multihead_from_state_dict(sd: Mapping[str, Any], cfg,
                                     device="cuda"):
    """PythiaMultiHead (pythia.py:375-433): encoders, ProjectionEmbedding
    projectors (``.module.layers``) and per-stream torch MHA embeddings."""
    n = len(cfg.image_encoders)
    return _to_torch({
        "word_embedding": _np(sd["word_embedding.weight"]),
        "text_embedding": _attention_text_embedding(sd, "text_embeddings.0"),
        "image_encoders": _image_encoders(sd, cfg),
        "image_projectors": [{"lc": _lin(
            sd, f"image_feature_projectors.{i}.module.layers")}
            for i in range(n)],
        "image_embeddings": [[_torch_mha_qkv(
            sd, f"image_feature_embeddings_list.{i}.{j}.module")
            for j in range(cfg.embeddings_per_stream)] for i in range(n)],
        "combine": _nlem(sd, "image_text_multi_modal_combine_layer.module"),
        "classifier": _logit_classifier(sd, "classifier.module"),
    }, device)


def ban_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    return _to_torch({
        "word_embedding": _np(sd["word_embedding.weight"]),
        "q_emb": {"rnn": _birnn(sd, "q_emb.recurrent_encoder",
                                cfg.bidirectional)},
        "v_att": _bi_attention(sd, "v_att"),
        "b_net": [_bc_net(sd, f"b_net.{g}") for g in range(cfg.gamma)],
        "q_prj": [_fc_net(sd, f"q_prj.{g}") for g in range(cfg.gamma)],
        "classifier": _weight_norm_classifier(sd, "classifier"),
    }, device)


def butd_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    sd = {k.replace("image_feature_encoders.0.module.lc",
                    "image_feature_encoders.0.lc"): v
          for k, v in sd.items()}
    base = "image_feature_embeddings_list.0.0.image_attention_model.module"
    return _to_torch({
        "word_embedding": _np(sd["word_embedding.weight"]),
        "encoder": {"lc": _lin(sd, "image_feature_encoders.0.lc")},
        "td_attn": _top_down_attention_lstm(
            sd, f"{base}.combination_layer.module"),
        "transform": _wn(sd, f"{base}.transform.module.lc"),
        "decoder": _language_decoder(sd, "classifier.module"),
    }, device)


def m4c_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    """M4C (m4c.py build():42-172) after format_state_key (m4c.py:36-39),
    with ``text_bert_out_linear`` the identity (MMT width 768 = TextBert's,
    the default config)."""
    sd = {k.replace("obj_faster_rcnn_fc7.module.lc", "obj_faster_rcnn_fc7.lc")
           .replace("ocr_faster_rcnn_fc7.module.lc",
                    "ocr_faster_rcnn_fc7.lc"): v
          for k, v in sd.items()}

    def modality(name):
        return {"fc7": _lin(sd, f"{name}_faster_rcnn_fc7.lc"),
                "feat": _lin(sd, f"linear_{name}_feat_to_mmt_in"),
                "bbox": _lin(sd, f"linear_{name}_bbox_to_mmt_in"),
                "feat_ln": _ln(sd, f"{name}_feat_layer_norm"),
                "bbox_ln": _ln(sd, f"{name}_bbox_layer_norm")}

    pp = "mmt.prev_pred_embeddings"
    return _to_torch({
        "text_bert": {
            "embeddings": _bert_embeddings_np(sd, "text_bert.embeddings"),
            "encoder": _bert_encoder_np(sd, cfg.text_bert_layers,
                                        "text_bert.encoder.layer")},
        "obj": modality("obj"),
        "ocr": modality("ocr"),
        "mmt": {
            "encoder": _bert_encoder_np(sd, cfg.mmt_layers,
                                        "mmt.encoder.layer"),
            "prev_pred": {
                "position": _np(sd[f"{pp}.position_embeddings.weight"]),
                "token_type": _np(sd[f"{pp}.token_type_embeddings.weight"]),
                "ans_ln": _ln(sd, f"{pp}.ans_layer_norm"),
                "ocr_ln": _ln(sd, f"{pp}.ocr_layer_norm"),
                "emb_ln": _ln(sd, f"{pp}.emb_layer_norm")}},
        "classifier": _lin(sd, "classifier.module"),
        "ocr_ptr_net": {"query": _lin(sd, "ocr_ptr_net.query"),
                        "key": _lin(sd, "ocr_ptr_net.key")},
    }, device)


def _transform(sd, prefix: str):
    return {"w": _np(sd[f"{prefix}.dense.weight"]),
            "b": _np(sd[f"{prefix}.dense.bias"]),
            "ln": _ln(sd, f"{prefix}.LayerNorm")}


def mmbt_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    """MMBT (mmbt.py): the ``transformer.*`` BertModel, the modal
    projection, and the classification head and / or the pretraining
    ``cls.*`` heads; MMF's full-model prefixes (``model.bert.mmbt.*``
    after format_state_key, mmbt.py:598-605) are accepted."""
    sd = {k.replace("base.bert", "model.bert"): v for k, v in sd.items()}
    sd = {k.removeprefix("model.bert.").removeprefix("bert.")
           .removeprefix("mmbt."): v for k, v in sd.items()}
    params: Dict[str, Any] = {
        "embeddings": _bert_embeddings_np(sd, "transformer.embeddings"),
        "encoder": _bert_encoder_np(sd, cfg.num_hidden_layers,
                                    "transformer.encoder.layer"),
        "pooler": _lin(sd, "transformer.pooler.dense"),
        "modal_proj": _lin(sd, "modal_encoder.proj_embeddings"),
    }
    if "classifier.0.dense.weight" in sd:
        params["classifier"] = {"transform": _transform(sd, "classifier.0"),
                                "out": _lin(sd, "classifier.1")}
    if "cls.predictions.transform.dense.weight" in sd:
        params["cls"] = {
            "transform": _transform(sd, "cls.predictions.transform"),
            "decoder_bias": _np(sd["cls.predictions.bias"]),
            "seq_relationship": _lin(sd, "cls.seq_relationship")}
    return _to_torch(params, device)


def vilbert_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    """ViLBERT (ViLBERTBase:982-1118, with the classifier and / or the
    pretraining heads); MMF's ``model.`` / ``bert.`` prefixes are
    accepted."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    if any(k.startswith("bert.") for k in sd):
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}

    def block(p):
        out = {"q": _lin(sd, f"{p}.attention.self.query"),
               "k": _lin(sd, f"{p}.attention.self.key"),
               "v": _lin(sd, f"{p}.attention.self.value"),
               "out": _lin(sd, f"{p}.attention.output.dense"),
               "out_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
               "inter": _lin(sd, f"{p}.intermediate.dense"),
               "ffn_out": _lin(sd, f"{p}.output.dense"),
               "ffn_ln": _ln(sd, f"{p}.output.LayerNorm")}
        if f"{p}.attention.self.dyLinear_q.weight" in sd:
            out["dy_q"] = _lin(sd, f"{p}.attention.self.dyLinear_q")
            out["dy_k"] = _lin(sd, f"{p}.attention.self.dyLinear_k")
        return out

    def c_block(p):
        ba, bo = f"{p}.biattention", f"{p}.biOutput"
        return {"q1": _lin(sd, f"{ba}.query1"), "k1": _lin(sd, f"{ba}.key1"),
                "v1": _lin(sd, f"{ba}.value1"),
                "q2": _lin(sd, f"{ba}.query2"), "k2": _lin(sd, f"{ba}.key2"),
                "v2": _lin(sd, f"{ba}.value2"),
                "dense1": _lin(sd, f"{bo}.dense1"),
                "ln1": _ln(sd, f"{bo}.LayerNorm1"),
                "dense2": _lin(sd, f"{bo}.dense2"),
                "ln2": _ln(sd, f"{bo}.LayerNorm2"),
                "v_inter": _lin(sd, f"{p}.v_intermediate.dense"),
                "v_out": _lin(sd, f"{p}.v_output.dense"),
                "v_ln": _ln(sd, f"{p}.v_output.LayerNorm"),
                "t_inter": _lin(sd, f"{p}.t_intermediate.dense"),
                "t_out": _lin(sd, f"{p}.t_output.dense"),
                "t_ln": _ln(sd, f"{p}.t_output.LayerNorm")}

    params: Dict[str, Any] = {
        "embeddings": _bert_embeddings_np(sd, "embeddings"),
        "v_embeddings": {
            "image": _lin(sd, "v_embeddings.image_embeddings"),
            "loc": _lin(sd, "v_embeddings.image_location_embeddings"),
            "ln": _ln(sd, "v_embeddings.LayerNorm")},
        "t_layers": [block(f"encoder.layer.{i}")
                     for i in range(cfg.num_hidden_layers)],
        "v_layers": [block(f"encoder.v_layer.{i}")
                     for i in range(cfg.v_num_hidden_layers)],
        "c_layers": [c_block(f"encoder.c_layer.{i}")
                     for i in range(len(cfg.v_biattention_id))],
        "t_pooler": _lin(sd, "t_pooler.dense"),
        "v_pooler": _lin(sd, "v_pooler.dense"),
    }
    if "classifier.0.dense.weight" in sd:
        params["classifier"] = {
            "transform": {"w": _np(sd["classifier.0.dense.weight"]),
                          "b": _np(sd["classifier.0.dense.bias"]),
                          "ln": _ln(sd, "classifier.0.LayerNorm")},
            "out": _lin(sd, "classifier.1")}
    if "cls.predictions.transform.dense.weight" in sd:
        params["cls"] = {
            "lm_transform": _transform(sd, "cls.predictions.transform"),
            "lm_bias": _np(sd["cls.predictions.bias"]),
            "bi_seq_relationship": _lin(sd, "cls.bi_seq_relationship"),
            "img_transform": _transform(sd,
                                        "cls.imagePredictions.transform"),
            "img_decoder": _lin(sd, "cls.imagePredictions.decoder")}
    return _to_torch(params, device)


def cnn_lstm_from_state_dict(sd: Mapping[str, Any], cfg, device="cuda"):
    return _to_torch({
        "word_embedding": _np(sd["text_embedding.weight"]),
        "lstm": _birnn(sd, "lstm", bidirectional=True),
        "cnn": [_conv_net(sd, f"cnn.{i}")
                for i in range(len(cfg.cnn_input_dims))],
        "classifier": _mlp_classifier(sd, "classifier.module"),
    }, device)
