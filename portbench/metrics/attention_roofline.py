"""``attention_roofline``: the port's fp32 attention kernels on the ViT
block path (``csrc/attn_fp32.cuh`` forward and backward passes,
``csrc/attn_common.cuh`` ``e_row_kernel``): the least time of each call
(``flops/vit.attention_calls``: the larger of its FLOPs at 495 TFLOP/s and
its bytes at 3.35 TB/s) over the device time of those launches, in
percent."""

from portbench.flops import peaks
from portbench.flops import vit as flops
from portbench.metrics._shares import roofline

# a forward is one launch; a backward three (the q pass, the kv pass,
# the heads' e_row sum)
PATTERN = r"\b(attn_fwd_kernel|attn_bwd_q_kernel|attn_bwd_kv_kernel|e_row_kernel)\b"


def read(run):
    if run.config["family"] != "vit":
        return None
    calls = flops.attention_calls(run.config, run.mix["batch"])
    least = sum(max(f / peaks.FLOPS, b / peaks.BYTES) for f, b in calls)
    layers = run.config["num_hidden_layers"]
    return roofline(run, PATTERN, 4 * layers, least)
