"""BERT [CLS] embedding extraction for imdb questions, on the PyTorch port.

Counterpart of
``transformer_mm_explainability_tpu/tools/extract_bert_embeddings.py`` (a
re-design of ``VisualBERT/tools/scripts/bert/extract_bert_embeddings.py``):
for each imdb entry, tokenize ``question_str`` ([CLS] q [SEP]), run the
BERT encoder (``models/bert``), and save the final-layer [CLS] vector as
``<out_path><question_id>.npy`` (:33-48), with the ``idx % n_groups ==
group_id`` worker sharding (:44-45).

The reference runs one question at a time; here questions are padded to a
shared length and batched, so the encoder sees one ``[B, L, H]`` workload
per chunk. No kernel of the port runs here (the JAX tool runs plain ``jnp``).

    python -m transformer_mm_explainability_tpu_torch.tools.extract_bert_embeddings \\
        --imdb_path imdb.npy --out_path DIR/prefix_ --vocab_file vocab.txt \\
        [--checkpoint bert.bin] [--seed 0] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from transformer_mm_explainability_tpu_torch._device import resolve_device
from transformer_mm_explainability_tpu_torch.models import bert
from transformer_mm_explainability_tpu_torch.ops.attention import layer_norm


def cls_embeddings(params, cfg: bert.BertConfig, ids: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` token ids and {0,1} mask → the final layer's ``[B, H]``
    [CLS] vectors (:30)."""
    h = bert.text_embeddings(params["emb"], ids)
    h = layer_norm(h, params["emb"]["ln"]["scale"], params["emb"]["ln"]["bias"],
                   cfg.layer_norm_eps)
    h, _ = bert.encoder(params["enc"], h, cfg,
                        mask=bert.extended_attention_mask(mask))
    return h[:, 0]


def extract_bert(params, cfg: bert.BertConfig, tokenizer, imdb,
                 out_path: str, group_id: int = 0, n_groups: int = 1,
                 max_seq_length: int = 64,
                 batch_size: int = 32) -> List[str]:
    """→ written paths. ``imdb`` rows need question_str/question_id (header
    row already stripped, like the reference's ``imdb[1:]``); the encoder
    runs on the weights' device."""
    device = params["emb"]["word"].device
    todo = [el for idx, el in enumerate(imdb)
            if idx % n_groups == group_id]
    written: List[str] = []
    for i in range(0, len(todo), batch_size):
        chunk = todo[i:i + batch_size]
        ids = np.zeros((len(chunk), max_seq_length), np.int32)
        mask = np.zeros((len(chunk), max_seq_length), np.int32)
        for j, el in enumerate(chunk):
            enc = tokenizer.encode_vqa(el["question_str"], max_seq_length)
            ids[j] = enc["input_ids"]
            mask[j] = enc["input_mask"]
        with torch.no_grad():
            cls = cls_embeddings(params, cfg,
                                 torch.from_numpy(ids).to(device),
                                 torch.from_numpy(mask).to(device))
        cls = cls.cpu().numpy()
        for j, el in enumerate(chunk):
            save_path = out_path + str(el["question_id"]) + ".npy"
            np.save(save_path, cls[j])
            written.append(save_path)
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--imdb_path", type=str, required=True)
    parser.add_argument("--out_path", type=str, required=True)
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="HF bert-base state dict; random weights "
                        "from --seed if omitted")
    parser.add_argument("--group_id", type=int, default=0)
    parser.add_argument("--n_groups", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from transformer_mm_explainability_tpu_torch.data.tokenization import (
        BertTokenizer)

    cfg = bert.BERT_BASE
    if args.checkpoint:
        from transformer_mm_explainability_tpu_torch.utils import convert

        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=False)
        # HF dumps carry a "bert." prefix; bare encoders do not
        root = "bert." if any(k.startswith("bert.") for k in sd) else ""
        params = {
            "emb": convert.bert_embeddings_from_state_dict(
                sd, prefix=root + "embeddings", device=device),
            "enc": convert.bert_encoder_from_state_dict(
                sd, cfg.num_hidden_layers, prefix=root + "encoder.layer",
                device=device),
        }
    else:
        gen = torch.Generator().manual_seed(args.seed)
        params = {"emb": bert.init_embedding_params(gen, cfg, device),
                  "enc": bert.init_encoder_params(gen, cfg, device)}
    tokenizer = BertTokenizer(args.vocab_file)
    imdb = np.load(args.imdb_path, allow_pickle=True)[1:]
    written = extract_bert(params, cfg, tokenizer, imdb, args.out_path,
                           args.group_id, args.n_groups)
    print(f"wrote {len(written)} embeddings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
