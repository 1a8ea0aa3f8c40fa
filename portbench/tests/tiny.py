"""Tiny widths of the benchmark's configurations, to drive whole runs on
the CPU (the port's kernels run their plain versions there)."""

import copy
import time

from portbench.core import cell, spec

VIT = dict(image_size=32, patch_size=16, hidden_size=64, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=128, num_classes=10)
VISUAL_BERT = dict(vocab_size=3000, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=40, visual_embedding_dim=32,
                   num_labels=13, max_seq_length=16, max_features=9,
                   tokens=dict(cls=101, sep=102, question_mark=1029,
                               first_word=1000))
MIX = dict(batch=4, pool_batches=2, pool_samples=16, judge_batches=3,
           question_tokens=[3, 8])


def cell_of(name: str) -> spec.Cell:
    c = copy.deepcopy(spec.cell(name))
    c.config.update(VIT if c.config["family"] == "vit" else VISUAL_BERT)
    c.mix.update(MIX)
    return c


def run_cell(c: spec.Cell, seed: int = 2 ** 40 + 7, seconds: float = 0.3,
             trace: bool = False, control: bool = False):
    return cell.run(c, seed, seconds, trace, "cpu", time.perf_counter(),
                    control=control)


def run(name: str, seed: int = 2 ** 40 + 7, seconds: float = 0.3,
        trace: bool = False, control: bool = False):
    return run_cell(cell_of(name), seed, seconds, trace, control)
