"""The port's ``models/mmf_layers`` against the JAX package's, block by
block: linears and both weight norms, GatedTanh, LSTM and GRU (forward and
reversed, and the LSTM cell), the bidirectional wrapper, ``l2_norm`` of a
published weight against float64, the text embeddings (attention, BiLSTM
both ways, vocab, pre-extracted, the dispatcher's eight types), the
combine layers (NonLinearElementMultiply with context, the two-layer one,
MFB / MFH), top-down attention (softmax and sigmoid, with valid counts),
the classifiers (logit, weight-norm, MLP with eval batch norm), FCNet /
BCNet (all three branches and the weighted pooling) / BiAttention (an
empty box masked), the classic attentions, the BUTD blocks, the VisDial
discriminator and ConvNet.

Each case draws one weight tree for both sides (``tests/_mmf_parity``:
the port's init, its structure and shapes held to the JAX init's), runs
the JAX block jitted and the port's on the tree carried across
(``utils/convert.mmf_from_jax_numpy``). Inputs are numpy draws from a
seed. Bar: max|Δ| ≤ 1e-5 · max|JAX output| (fp32 on
both sides, products in other summation orders); −inf entries equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mmf_parity import K, close, jax_run, port, rand, shared, torch_args
from transformer_mm_explainability_tpu.models import mmf_layers as JL
from transformer_mm_explainability_tpu_torch.models import mmf_layers as TL


def W(name, *args, **kw):
    """The shared tree of ``mmf_layers.<name>(seed, *args)``."""
    return shared(lambda: getattr(JL, name)(K(0), *args, **kw),
                  lambda: getattr(TL, name)(0, *args, device="cpu", **kw))


def run(jfwd, tfwd, tree, *inputs, **kw):
    """Both forwards on the same weights and inputs (numpy arrays or
    None), the JAX one jitted (one compile instead of one per op)."""
    got = tfwd(port(tree, "mmf_layers"), *torch_args(inputs), **kw)
    close(got, jax_run(jfwd, tree, *inputs, **kw))
    return got


# ---------------------------------------------------------------------------
# one case per block: (name, jax init, jax fwd, torch fwd, inputs, kwargs)
# ---------------------------------------------------------------------------

B, T, E, H, NB = 2, 5, 6, 8, 4
FEAT = rand(B, NB, 7, seed=1)
TXT = rand(B, 9, seed=2)


def _cases():
    return {
        "linear": (lambda: W("init_linear", 7, 5), "linear_fwd",
                   [FEAT]),
        "weight_norm_fc": (lambda: W("init_weight_norm_fc", 7, 5),
                           "weight_norm_fc_fwd", [FEAT]),
        "weight_norm_fc_dim0": (
            lambda: W("init_weight_norm_fc_dim0", 7, 5),
            "weight_norm_fc_dim0_fwd", [FEAT]),
        "relu_weight_norm_fc": (
            lambda: W("init_relu_weight_norm_fc", 7, 5),
            "relu_weight_norm_fc_fwd", [FEAT]),
        "gated_tanh": (lambda: W("init_gated_tanh", 7, 5),
                       "gated_tanh_fwd", [FEAT]),
        "attention_text_embedding": (
            lambda: W("init_attention_text_embedding", H, E, 6, 2),
            "attention_text_embedding_fwd", [rand(B, T, E, seed=3)]),
        "attention_text_embedding_bidirectional": (
            lambda: W("init_attention_text_embedding", H, E, 6, 3,
                                                     bidirectional=True),
            "attention_text_embedding_fwd", [rand(B, T, E, seed=4)]),
        "multi_head_image_feature_embedding": (
            lambda: W("init_multi_head_image_feature_embedding", 7, 8,
                                                               2),
            "multi_head_image_feature_embedding_fwd", [FEAT, rand(B, 8)],
            {"num_heads": 2}),
        "non_linear_element_multiply": (
            lambda: W("init_non_linear_element_multiply", 7, 9, 6),
            "non_linear_element_multiply_fwd", [FEAT, TXT]),
        "non_linear_element_multiply_context": (
            lambda: W("init_non_linear_element_multiply", 7, 9, 6,
                                                        context_dim=5),
            "non_linear_element_multiply_fwd",
            [FEAT, TXT, rand(B, 3, 5, seed=5)]),
        "two_layer_element_multiply": (
            lambda: W("init_two_layer_element_multiply", 7, 9, 6),
            "two_layer_element_multiply_fwd", [FEAT, TXT]),
        "mfh_boxes": (lambda: W("init_mfh", 7, 9, (8, 8)), "mfh_fwd",
                      [FEAT, TXT], {"pool_size": 2}),
        "mfh_vector": (lambda: W("init_mfh", 7, 9, (6, 6, 6)),
                       "mfh_fwd", [rand(B, 7, seed=6), TXT],
                       {"pool_size": 3}),
        "logit_classifier": (
            lambda: W("init_logit_classifier", 7, 4, 5, 6),
            "logit_classifier_fwd", [rand(B, 7, seed=7)]),
        "weight_norm_classifier": (
            lambda: W("init_weight_norm_classifier", 7, 4, 6),
            "weight_norm_classifier_fwd", [rand(B, 7, seed=8)]),
        "fc_net_relu": (lambda: W("init_fc_net", [7, 6, 5]),
                        "fc_net_fwd", [FEAT], {"act": "ReLU"}),
        "fc_net_leaky": (lambda: W("init_fc_net", [7, 5]),
                         "fc_net_fwd", [FEAT], {"act": "LeakyReLU"}),
        "concatenation_attention": (
            lambda: W("init_concatenation_attention", 7, 9, 6),
            "concatenation_attention_fwd", [FEAT, TXT]),
        "project_attention": (
            lambda: W("init_project_attention", 7, 9, 6),
            "project_attention_fwd", [FEAT, TXT]),
        "double_project_attention": (
            lambda: W("init_double_project_attention", 7, 9, 6),
            "double_project_attention_fwd", [FEAT, TXT]),
        "visdial_discriminator": (
            lambda: W("init_visdial_discriminator", 6, 5),
            "visdial_discriminator_fwd", [rand(3, 4, 6), rand(3, 5)]),
        "conv_net": (lambda: W("init_conv_net", 3, 4, 5),
                     "conv_net_fwd", [rand(B, 3, 9, 8, seed=9)]),
        "vocab_embedding": (lambda: W("init_vocab_embedding", 11, 5),
                            "vocab_embedding_fwd",
                            [np.array([[1, 4, 10], [0, 2, 3]])]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_equals_jax(name):
    init, fwd, inputs, *kw = CASES[name]
    run(getattr(JL, fwd), getattr(TL, fwd), init(), *inputs,
        **(kw[0] if kw else {}))


def test_mlp_classifier_eval_batch_norm():
    p = W("init_mlp_classifier", 7, 3, hidden_dim=6, num_layers=2)
    rs = np.random.RandomState(0)
    for layer in p["hidden"]:
        layer["bn"] = {k: rs.rand(6).astype(np.float32) + 0.5
                       for k in ("scale", "bias", "mean", "var")}
    run(JL.mlp_classifier_fwd, TL.mlp_classifier_fwd, p, rand(B, 7))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
def test_recurrent_both_ways(cell, reverse):
    """torch's gate order, forward and reversed (outputs in input order)."""
    fwd = f"{cell}_fwd"
    run(getattr(JL, fwd), getattr(TL, fwd), W(f"init_{cell}", E, H),
        rand(B, T, E, seed=11), reverse=reverse)


def test_recurrent_nets_match_torch_nn():
    """``lstm_cell``, which BUTD's decoder steps, keeps the gate layout of
    the ``nn.LSTM`` that whole sequences run through: stepping it over a
    sequence gives ``lstm_fwd``'s outputs. One bidirectional call gives
    the two directions run one at a time."""
    x = torch.as_tensor(rand(B, T, E, seed=12))
    p = TL.init_lstm(0, E, H, device="cpu")
    h = c = x.new_zeros(B, H)
    steps = []
    for t in range(T):
        h, c = TL.lstm_cell_fwd(p, x[:, t], h, c)
        steps.append(h)
    torch.testing.assert_close(TL.lstm_fwd(p, x), torch.stack(steps, 1),
                               rtol=1e-5, atol=1e-6)
    for kind, init, fwd in (("lstm", TL.init_lstm, TL.lstm_fwd),
                            ("gru", TL.init_gru, TL.gru_fwd)):
        pb = TL.init_birnn(0, init, E, H, True, "cpu")
        torch.testing.assert_close(
            TL.birnn_fwd(pb, kind, x),
            torch.cat([fwd(pb["fwd"], x), fwd(pb["bwd"], x, reverse=True)],
                      dim=-1), rtol=1e-5, atol=1e-6)


def test_lstm_cell_and_birnn():
    p = W("init_lstm", E, H)
    x, h, c = rand(B, E, seed=1), rand(B, H, seed=2), rand(B, H, seed=3)
    run(JL.lstm_cell_fwd, TL.lstm_cell_fwd, p, x, h, c)
    pb = shared(lambda: JL.init_birnn(K(5), JL.init_gru, E, H, True),
                lambda: TL.init_birnn(0, TL.init_gru, E, H, True, "cpu"))
    run(lambda p, x: JL.birnn_fwd(p, JL.gru_fwd, x),
        lambda p, x: TL.birnn_fwd(p, "gru", x), pb, rand(B, T, E))


def test_l2_norm_of_a_published_weight():
    """``l2_norm`` of Pythia's 5,000 × 4,096 combine weight in fp32 on the
    CPU, whole and by rows, within 1e-6 relative of a float64 sum: the
    weight-norm layers divide by it, and ``jnp.linalg.norm`` keeps that
    bar. (``torch.linalg.norm``'s fp32 CPU reduction missed it by 6.8e-4
    on this weight with torch 2.13, enough to move Pythia's scores 2.6e-4;
    its error is in the message.)"""
    w = TL.init_linear(0, 4096, 5000, "cpu")["w"]
    exact = (w.double() ** 2).sum().sqrt()
    rel = lambda got, want: float(((got.double() - want).abs()
                                   / want).max())
    library = rel(torch.linalg.norm(w), exact)
    assert rel(TL.l2_norm(w), exact) <= 1e-6, library
    assert rel(TL.l2_norm(w, dim=1),
               (w.double() ** 2).sum(1).sqrt()) <= 1e-6


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_bilstm_text_embedding(rnn_type, bidirectional):
    p = W("init_bilstm_text_embedding", H, E, bidirectional, rnn_type)
    x = rand(B, T, E, seed=13)
    run(JL.bilstm_text_embedding_fwd, TL.bilstm_text_embedding_fwd, p, x,
        rnn_type=rnn_type, bidirectional=bidirectional)
    run(JL.bilstm_text_embedding_forward_all,
        TL.bilstm_text_embedding_forward_all, p, x, rnn_type=rnn_type)


@pytest.mark.parametrize("normalization", ["softmax", "sigmoid"])
@pytest.mark.parametrize("with_locs", [False, True])
def test_top_down_attention(normalization, with_locs):
    """TopDownAttention with the 1e-8 renormalisation and a sample whose
    valid count is 0 (its softmax row is all zero, no NaN)."""
    p = W("init_weight_norm_fc", 6, 2)
    comb = rand(3, NB, 6, seed=14)
    locs = np.array([2, 0, 4], np.int32) if with_locs else None
    got = run(lambda p, c, l: JL.top_down_attention_fwd(c, p, normalization,
                                                        l),
              lambda p, c, l: TL.top_down_attention_fwd(c, p, normalization,
                                                        l),
              p, comb, locs)
    if with_locs:
        assert torch.all(got[1] == 0) and torch.all(got[0, 2:] == 0)
    emb = run(lambda _, a, f, o: JL.image_feature_embedding_fwd(a, f, o)[0],
              lambda _, a, f, o: TL.image_feature_embedding_fwd(a, f, o)[0],
              {}, got.numpy(), rand(3, NB, 5), rand(3, NB, 2))
    assert emb.shape == (3, 2 * 7)


@pytest.mark.parametrize("h_out", [None, 3, 40])
def test_bc_net(h_out):
    """BCNet's three branches: the raw bilinear map, glimpse logits from
    h_mat (h_out ≤ 32) and the weight-norm h_net."""
    p = W("init_bc_net", 7, 5, 4, h_out, k=2)
    run(JL.bc_net_fwd, TL.bc_net_fwd, p, FEAT, rand(B, T, 5, seed=15),
        h_out=h_out)


def test_bc_net_with_weights_and_bi_attention():
    p = W("init_bc_net", 7, 5, 4, None, k=3)
    w = np.abs(rand(B, NB, T, seed=16))
    run(JL.bc_net_forward_with_weights, TL.bc_net_forward_with_weights, p,
        FEAT, rand(B, T, 5, seed=17), w, k=3)
    v = FEAT.copy()
    v[1, 2] = 0.0                       # an empty box, masked to −inf
    pa = W("init_bi_attention", 7, 5, 4, 2)
    for i in (0, 1):
        run(lambda p, v, q: JL.bi_attention_forward_all(p, v, q)[i],
            lambda p, v, q: TL.bi_attention_forward_all(p, v, q)[i],
            pa, v, rand(B, T, 5, seed=18))
    att = TL.bi_attention_forward_all(port(pa, "mmf_layers"),
                                      torch.as_tensor(v),
                                      torch.as_tensor(rand(B, T, 5)))[0]
    assert torch.all(att[1, :, 2] == 0)


def test_butd_blocks():
    p = W("init_top_down_attention_lstm", 7, E, H, 5)
    feat, emb = rand(B, NB, 7, seed=19), rand(B, E, seed=20)
    h1, c1, h2 = (rand(B, H, seed=s) for s in (21, 22, 23))
    for i in range(3):
        run(lambda *a: JL.top_down_attention_lstm_fwd(*a)[i],
            lambda *a: TL.top_down_attention_lstm_fwd(*a)[i],
            p, feat, emb, h1, c1, h2)
    d = W("init_language_decoder", 7, 11, H, fc_bias_init=0.5)
    for i in range(3):
        run(lambda *a: JL.language_decoder_fwd(*a)[i],
            lambda *a: TL.language_decoder_fwd(*a)[i],
            d, rand(B, 7, seed=24), h1, h2, c1)


def test_preextracted_embedding(tmp_path):
    for qid in (3, 7):
        np.save(tmp_path / f"{qid}.npy", rand(4, seed=qid))
    mod_j = JL.PreExtractedEmbedding(4, str(tmp_path))
    mod_t = TL.PreExtractedEmbedding(4, str(tmp_path), device="cpu")
    close(mod_t([7, 3, 7]), mod_j([7, 3, 7]), rel=0.0)


@pytest.mark.parametrize("emb_type", JL.TEXT_EMBEDDING_TYPES)
def test_text_embedding_dispatcher(emb_type, tmp_path):
    """Every TextEmbedding type builds and runs on both sides with the same
    tree structure; the weights are carried across for the forward."""
    np.save(tmp_path / "5.npy", rand(6))
    kwargs = {
        "identity": {}, "vocab": {"vocab_size": 11, "embedding_dim": E},
        "torch": {"vocab_size": 11, "embedding_dim": E},
        "projection": {"in_dim": E, "out_dim": 4},
        "preextracted": {"out_dim": 6, "base_path": str(tmp_path)},
        "bilstm": {"hidden_dim": H, "embedding_dim": E,
                   "bidirectional": True, "rnn_type": "LSTM"},
        "attention": {"hidden_dim": H, "embedding_dim": E, "conv1_out": 5,
                      "conv2_out": 2},
        "mcan": {"embedding_dim": E, "hidden_dim": H, "num_attn": 2,
                 "num_layers": 1, "num_feat": 2},
    }[emb_type]
    box = []

    def jinit():
        p, fwd = JL.init_text_embedding(K(13), emb_type, **kwargs)
        box.append(fwd)
        return p

    tp, tfwd = TL.init_text_embedding(0, emb_type, device="cpu", **kwargs)
    jp = shared(jinit, lambda: tp)
    jfwd = box[0]
    x = {"vocab": np.array([[1, 3], [5, 10]]),
         "torch": np.array([[2, 4]]),
         "preextracted": np.array([5, 5])}.get(emb_type, rand(B, T, E))
    want = jfwd(jp, jnp.asarray(x))
    got = tfwd(port(jp, "mmf_layers"), torch.as_tensor(x))
    close(got[1] if emb_type == "mcan" else got,
          want[1] if emb_type == "mcan" else want)


def test_mask_attentions():
    att = rand(3, NB, 2)
    locs = np.array([1, 4, 0])
    close(TL.mask_attentions(torch.as_tensor(att), torch.as_tensor(locs)),
          JL.mask_attentions(jnp.asarray(att), jnp.asarray(locs)), rel=0.0)
