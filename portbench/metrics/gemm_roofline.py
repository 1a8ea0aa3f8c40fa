"""``gemm_roofline``: the port's fp32 GEMM (``csrc/common.cuh``
``gemm_tc_kernel``) on the ViT block path: the least time of its products
(``flops/vit.block_gemms``, every product of every batch at 495 TFLOP/s)
over the profiler's device time of those launches, in percent."""

from portbench.flops import peaks
from portbench.flops import vit as flops
from portbench.metrics._shares import roofline


def read(run):
    if run.config["family"] != "vit":
        return None
    work, launches = flops.block_gemms(run.config, run.mix["batch"])
    return roofline(run, r"\bgemm_tc_kernel\b", launches, work / peaks.FLOPS)
