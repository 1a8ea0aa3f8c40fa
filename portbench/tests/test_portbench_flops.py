"""The frozen work counts against a hand count and against PyTorch's own
count of the reference's products, at one small shape."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.flops import visual_bert as fvb
from portbench.flops import vit as fvit
from portbench.reference import visual_bert as rvb
from portbench.reference import vit as rvit
from portbench.tests import tiny

VIT = dict(tiny.VIT, layer_norm_eps=1e-6, init_std=0.02)   # S = 5, D = 64
VB = dict(tiny.VISUAL_BERT, type_vocab_size=2, layer_norm_eps=1e-12,
          init_std=0.02)


def test_vit_counts_by_hand():
    S, D, I, L, C, K = 5, 64, 128, 2, 10, 768
    layer = 2*S*D*3*D + 2*S*S*D + 2*S*S*D + 2*S*D*D + 2*S*D*I + 2*S*I*D
    fwd = 2*(S-1)*K*D + L*layer + 2*D*C
    assert fvit.forward_per_image(VIT) == fwd
    cot0 = 2*S*I*D + 2*S*D*I + 2*S*D*D + 2*S*S*D         # MLP, out, ∇A
    cot1 = cot0 + 3 * 2*S*S*D + 2*S*3*D*D                # dv, dq, dk, qkv
    assert fvit.explain_per_map(VIT) == fwd + 2*D*C + cot0 + cot1 + L*2*S*S
    work, launches = fvit.block_gemms(VIT, 3)
    M = 3 * S
    per = [(M, 3*D, D), (M, D, D), (M, I, D), (M, D, I),       # forward
           (M, I, D), (M, I, D), (M, D, I),                    # MLP bwd
           (M, 3*D, D), (M, D, D), (M, D, 3*D)]                # attn bwd
    assert work == L * sum(2*m*n*k for m, n, k in per)
    assert launches == L * len(per)
    fwd_call, bwd_call = fvit.attention_calls(VIT, 3)[:2]
    assert fwd_call == (4*3*S*S*D, 4*4*3*S*D)
    assert bwd_call == (10*3*S*S*D, 4*(7*3*S*D + 2*3*S))


def test_vit_forward_count_is_torchs():
    w = rvit.weights(VIT, 1, "cpu")
    B, S = 3, 5
    taps = torch.zeros((2, B, 4, S, S))
    with FlopCounterMode(display=False) as fc:
        rvit._forward(w, VIT, torch.randn(B, 32, 32, 3), taps, False)
    assert fc.get_total_flops() == B * fvit.forward_per_image(VIT)


def test_visual_bert_counts_by_hand():
    St, Nv, D, I, L, C, V = 16, 9, 64, 128, 2, 13, 32
    S = St + Nv
    layer = 2*S*D*3*D + 4*S*S*D + 2*S*D*D + 4*S*D*I

    def fwd(n):
        s = St + n
        return (2*n*V*D + L*(2*s*D*3*D + 4*s*s*D + 2*s*D*D + 4*s*D*I)
                + 2*D*D + 2*D*C)

    assert fvb.forward_per_sample(VB, Nv) == fwd(Nv)
    cot0 = 4*S*D*I + 2*S*D*D + 2*S*S*D
    cot1 = cot0 + 6*S*S*D + 6*S*D*D
    explain = fwd(Nv) + 2*D*C + 2*D*D + cot0 + cot1 + L*2*S*S
    assert fvb.explain_per_map(VB) == explain
    steps = (0.0, 0.5, 0.75, 0.95, 0.96, 0.97, 0.98, 0.99, 1.0)
    keeps = [9, 4, 2, 0, 0, 0, 0, 0, 0]                # int((1 - s) * 9)
    assert rvb.num_keep(steps, 9) == keeps
    assert rvb.num_keep(steps, 100) == [100, 50, 25, 5, 4, 3, 2, 1, 0]
    assert fvb.perturb_per_sample(VB, steps) == explain + sum(map(fwd, keeps))
    assert layer * L + 2*Nv*V*D + 2*D*D + 2*D*C == fwd(Nv)


def test_visual_bert_forward_count_is_torchs():
    w = rvb.weights(VB, 1, "cpu")
    batch = {"input_ids": torch.randint(1000, 3000, (2, 16)),
             "input_mask": torch.ones(2, 16, dtype=torch.int32),
             "visual_embeddings": torch.randn(2, 9, 32),
             "visual_mask": torch.ones(2, 9, dtype=torch.int32)}
    with FlopCounterMode(display=False) as fc:
        rvb._forward(w, VB, batch, None, False)
    assert fc.get_total_flops() == 2 * fvb.forward_per_sample(VB, 9)
