"""``mfu.maps``: the relevancy maps' work (``flops/<family>.py``
``explain_per_map``) completed per second in the traced window, as a
percent of the 495 TFLOP/s peak (``flops/peaks.py``)."""

from portbench.metrics._shares import mfu


def read(run):
    return mfu(run, "maps")
