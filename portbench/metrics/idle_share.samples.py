"""``idle_share.samples``: percent of the traced window of a perturbation
cell in which no operation ran on the device (``torch.profiler``)."""

from portbench.metrics._shares import idle


def read(run):
    return idle(run, "samples")
