"""The readers of the program's own spans and counters
(``host_loop_idle_pct``, ``lane_occupancy_pct``) on synthetic windows and
counters: their arithmetic, and None where the program has nothing for
them."""

import pytest
import torch

from libldpc_tpu_torch.utils import profiling
from portbench import spec
from portbench.trace import Window

host_loop_idle_pct = spec.metric_reader("host_loop_idle_pct")
lane_occupancy_pct = spec.metric_reader("lane_occupancy_pct")


def ctx_of(kernels, host_ops, start=0.0, end=100.0, **kw):
    w = Window(kernels=kernels, host_ops=host_ops, start_us=start, end_us=end)
    return {"trace": w, "window_s": (end - start) * 1e-6, **kw}


def test_host_loop_idle_is_the_idle_time_inside_loop_spans():
    # the card idle over [10, 20] and [30, 35]; the loop's spans cover [5, 33]
    kernels = [("k", 0.0, 10.0), ("k", 20.0, 30.0), ("k", 35.0, 100.0)]
    host = [("ldpc.loop.read", 5.0, 25.0), ("ldpc.loop.io", 25.0, 33.0),
            ("aten::item", 30.0, 40.0), ("ldpc.decode", 12.0, 18.0)]
    assert host_loop_idle_pct(ctx_of(kernels, host)) == pytest.approx(13.0)


def test_host_loop_idle_merges_nested_spans_and_overlapping_kernels():
    kernels = [("a", 0.0, 40.0), ("b", 10.0, 50.0), ("c", 70.0, 100.0)]
    host = [("ldpc.loop.dispatch", 45.0, 80.0), ("ldpc.loop.dispatch", 55.0, 60.0)]
    # idle [50, 70], inside the spans [50, 70]: 20 of 100
    assert host_loop_idle_pct(ctx_of(kernels, host)) == pytest.approx(20.0)


def test_host_loop_idle_clips_spans_to_the_window():
    kernels = [("k", 150.0, 160.0)]
    host = [("ldpc.loop.read", 50.0, 150.0), ("ldpc.loop.io", 190.0, 260.0)]
    # window [100, 200]: idle [100, 150] and [160, 200]; spans [100, 150], [190, 200]
    got = host_loop_idle_pct(ctx_of(kernels, host, start=100.0, end=200.0))
    assert got == pytest.approx(60.0)


@pytest.mark.parametrize("host", [[], [("aten::item", 0.0, 50.0), ("ldpc.decode", 10.0, 20.0)],
                                  [("ldpc.loop.read", 200.0, 300.0)]])
def test_host_loop_idle_is_none_without_a_loop_span_in_the_window(host):
    assert host_loop_idle_pct(ctx_of([("k", 0.0, 10.0)], host)) is None


def test_lane_occupancy_is_iterations_over_lane_passes():
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.count("stream.lane_passes", 600)
        profiling.count("stream.lane_passes", 400)
    try:
        assert lane_occupancy_pct({"iter_sum": 870}) == pytest.approx(87.0)
    finally:
        profiling.reset_counters()


def test_lane_occupancy_is_none_without_the_counter(monkeypatch):
    profiling.reset_counters()
    assert lane_occupancy_pct({"iter_sum": 870}) is None  # a batch-stepped sweep
    monkeypatch.delattr(profiling, "counters")  # a program without counters
    assert lane_occupancy_pct({"iter_sum": 870}) is None
