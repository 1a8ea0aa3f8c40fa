"""Hold the fp32 kernels of two checkouts of the port to the same bits.

    # in each checkout's root, on a CUDA card:
    python scripts/compare_kernel_bits.py save OUT.pt
    # anywhere:
    python scripts/compare_kernel_bits.py compare A.pt B.pt

``save`` builds the checkout's kernels (``ops/_build``) and runs its ten fp32
wrappers (the four block kernels, the four fused attention kernels, the
relevancy chain, RoIPool) on inputs drawn from a fixed seed at the ViT-B/16
widths (B=8, S=197, D=768, H=12, I=3072; the chain on [8, 12, 12, 197, 197]
captures; RoIPool on a [50, 76, 1024] map and 300 boxes), with the fp32
signatures every checkout since the kernels were ported takes, and saves the
outputs. ``compare`` prints, for each output, whether the two saves are
equal bit for bit (``torch.equal``) and exits 1 if any differs.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys

import torch


def _outputs(device) -> dict:
    from transformer_mm_explainability_tpu_torch.ops import (
        attn_block as ab, flash_attention as fa, relevancy_pallas as rp,
        roi_pool_pallas as rpool)

    B, S, D, H, I, eps = 8, 197, 768, 12, 3072, 1e-6
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s, scale=0.3: (torch.randn(s, generator=gen)
                                 * scale).to(device)
    wt = lambda *s: (torch.randn(s, generator=gen) / math.sqrt(D)).to(device)
    x, cot = rnd(B, S, D), rnd(B, S, D)
    r = torch.rand((B, S), generator=gen).to(device)
    wqkv, bqkv, wout, bout = wt(D, 3 * D), rnd(3 * D), wt(D, D), rnd(D)
    g1, b1 = 1.0 + rnd(D, scale=0.03), rnd(D, scale=0.03)
    w1, bi1, w2, bi2 = wt(D, I), rnd(I), wt(I, D), rnd(D)
    qkv, dm = rnd(B, S, 3 * D, scale=0.5), rnd(B, S, D, scale=0.5)
    q, k, v = (t.contiguous() for t in fa.qkv_heads(qkv, H))
    dout = fa.heads(dm, H).contiguous()
    cams = torch.rand((B, 12, H, S, S), generator=gen)
    cams = (cams / cams.sum(-1, keepdim=True)).to(device)
    grads = rnd(B, 12, H, S, S, scale=1.0)
    feats = torch.randn((50, 76, 1024), generator=gen).to(device)
    xy = torch.rand((300, 2), generator=gen) * torch.tensor([1100.0, 700.0])
    wh = torch.rand((300, 2), generator=gen) * 300.0
    boxes = torch.cat([xy, xy + wh], 1).to(device)
    out = {
        "attn_block_fwd": ab.attn_block_fwd(x, wqkv, bqkv, wout, bout, g1, b1,
                                            H, eps),
        "mlp_block_fwd": ab.mlp_block_fwd(x, w1, bi1, w2, bi2, g1, b1, eps),
        "mlp_block_bwd": ab.mlp_block_bwd(x, cot, w1, bi1, w2, g1, b1, eps),
        "attn_block_bwd": ab.attn_block_bwd(x, cot, r, wqkv, bqkv, wout, g1,
                                            b1, H, eps),
        "flash_fwd": fa.flash_fwd(q, k, v),
        "flash_bwd_ehat": fa.flash_bwd_ehat(q, k, v, dout, r),
        "flash_fwd_qkv": fa.flash_fwd_qkv(qkv, H),
        "flash_bwd_ehat_qkv": fa.flash_bwd_ehat_qkv(qkv, dm, r, H),
        "self_attention_relevancy_pallas":
            rp.self_attention_relevancy_pallas(cams, grads),
        "roi_pool_pallas": rpool.roi_pool_pallas(feats, boxes, 14, 1 / 16),
    }
    flat = {}
    for name, value in out.items():
        values = value if isinstance(value, tuple) else (value,)
        for i, t in enumerate(values):
            flat[f"{name}[{i}]"] = t.cpu()
    return flat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    save = sub.add_parser("save", help="run this checkout's kernels")
    save.add_argument("out")
    cmp = sub.add_parser("compare", help="compare two saves bit for bit")
    cmp.add_argument("a")
    cmp.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        if not torch.cuda.is_available():
            print("compare_kernel_bits: save needs a CUDA card",
                  file=sys.stderr)
            return 2
        sys.path.insert(0, str(pathlib.Path.cwd()))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.save(_outputs(torch.device("cuda")), args.out)
        return 0
    a, b = torch.load(args.a), torch.load(args.b)
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    differ = [name for name in a if not torch.equal(a[name], b[name])]
    for name in a:
        print(f"{name}: {tuple(a[name].shape)} "
              f"{'DIFFERS' if name in differ else 'bit-equal'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
