"""The trace reduction and the loop's statistics on hand-made records."""

import numpy as np

from portbench.core import loop
from portbench.core.trace import Trace, short
from portbench.metrics import _shares


def _trace():
    ms = 1_000_000
    device = [("void gemm_tc_kernel<2>(GemmArgs)", 1 * ms, 4 * ms, 11),
              ("void attn_fwd_kernel<64, true, float>(...)", 4 * ms, 5 * ms,
               12),
              ("Memcpy DtoH (Device -> Pageable)", 7 * ms, 8 * ms, 13),
              ("void gemm_tc_kernel<2>(GemmArgs)", 9 * ms, 12 * ms, 14)]
    launches = {11: 0, 12: 1 * ms, 13: 6 * ms, 14: 8 * ms}
    ranges = [("portbench.explain", 0, 2 * ms),
              ("portbench.forward", 5 * ms, 9 * ms)]
    host = [("aten::copy_", 5 * ms + 1, 7 * ms + 5), ("aten::mm", 8 * ms, 9 * ms)]
    return Trace((0, 10 * ms), device, launches, ranges, host)


def test_busy_window_and_clipping():
    t = _trace()
    assert t.window_s == 0.010
    assert abs(t.busy_s() - 0.006) < 1e-12      # [1,5] + [7,8] + [9,10]
    assert [d[2] for d in t.in_window()][-1] == 10_000_000
    assert len(t.kernels(r"\bgemm_tc_kernel\b")) == 2


def test_ranges_and_breakdown():
    t = _trace()
    assert t.range_of_launch({"portbench.explain", "portbench.forward"}) == \
        {11: "portbench.explain", 12: "portbench.explain",
         13: "portbench.forward", 14: "portbench.forward"}
    b = t.breakdown()
    assert b["device_ops"][0][0] == "gemm_tc_kernel"
    assert abs(b["device_ops"][0][1] - 0.004) < 1e-12
    gaps = dict(b["idle_gaps"])
    assert abs(sum(gaps.values()) - 0.004) < 1e-12
    assert abs(gaps["aten::copy_"] - 0.002) < 1e-12   # the gap [5, 7]
    assert short("void attn_bwd_q_kernel<64, true, float>(float const*)") \
        == "attn_bwd_q_kernel"
    assert short("void (anonymous namespace)::gemm_tc_kernel<2>(GemmArgs)") \
        == "gemm_tc_kernel"


class _Run:
    def __init__(self, batches):
        self.trace = _trace()
        self.window = loop.Window(0.01, batches, batches, [], [])


def test_roofline_needs_the_expected_launches():
    # 3 ms and the 1 ms of the second launch inside the window
    assert _shares.roofline(_Run(1), r"gemm_tc", 2, 0.003) == 75.0
    assert _shares.roofline(_Run(2), r"gemm_tc", 2, 0.003) is None


class _Driver:
    batch_units = 2

    def __init__(self):
        self.settled = []

    def submit(self, i):
        return i

    def settle(self, h):
        self.settled.append(h)
        return h


def test_loop_settles_every_batch_in_order_and_samples_from_all():
    d = _Driver()
    w = loop.run(d, 0.05, 3, np.random.default_rng(0))
    assert d.settled == list(range(w.batches)) and w.units == 2 * w.batches
    assert len(w.batch_s) == w.batches and len(w.kept) == 3
    assert all(i == rec for i, rec in w.kept)
    assert loop.p95(list(range(101))) == 95.0
