"""``mfu.samples``: the perturbation samples' work (one explanation and a
forward at each step's kept length, ``flops/visual_bert.py``) completed per
second in the traced window, as a percent of the 495 TFLOP/s peak."""

from portbench.metrics._shares import mfu


def read(run):
    return mfu(run, "samples")
