"""What the readers share."""

from portbench.flops import peaks


def mfu(run, unit: str):
    """Percent of the peak: the frozen work of every unit completed in the
    window over the window's seconds."""
    if run.driver.unit != unit or run.window.seconds <= 0:
        return None
    rate = run.driver.flops_per_unit() * run.window.units / run.window.seconds
    return 100.0 * rate / peaks.FLOPS


def idle(run, unit: str):
    """Percent of the traced window in which no operation ran on the
    device."""
    if run.driver.unit != unit or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def roofline(run, pattern: str, calls_per_batch, least_s_per_batch):
    """Percent: the least time of the matching kernels' work at the peaks
    over their device time, or None where the trace does not hold the
    expected number of them (a change that takes them off the path)."""
    if run.trace is None:
        return None
    ks = run.trace.kernels(pattern)
    if not ks or len(ks) != calls_per_batch * run.window.batches:
        return None
    busy = sum(e - s for _, s, e, _ in ks) * 1e-9
    return 100.0 * least_s_per_batch * run.window.batches / busy
