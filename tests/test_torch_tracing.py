"""The port's own tracing (``utils/profiling.py``: ``span``, ``count``,
``counters``) and where the sweep opens it: the host loop's phases in every
loop of ``sim/driver.py``, the decode, channel and counting spans of the
steps, and the streaming engines' ``stream.lane_passes``.  CPU sweeps of a
small code under ``torch.profiler``, each against the same sweep untraced,
and the ``--trace-dir`` switch of ``ldpcsim-torch``."""

import json

import numpy as np
import pytest
import torch

from libldpc_tpu_torch import cli
from libldpc_tpu_torch.models import make_benchmark_code, write_codefile
from libldpc_tpu_torch.parallel.mesh import FRAME_AXIS, POINT_AXIS, make_mesh
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils import profiling
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

BATCH, ITERS, MAX_FRAMES = 64, 10, 384
CPU = [torch.profiler.ProfilerActivity.CPU]
LOOP = ("ldpc.loop.dispatch", "ldpc.loop.read", "ldpc.loop.absorb", "ldpc.loop.io")
#: lane-passes of one super-step of 64 lanes at 10 iterations: the default
#: engine's 10 one-pass launches; the fused step's 3 chunks of 4 passes
PASSES = {"xla-superstep": 10 * BATCH, "fused-pool": 12 * BATCH}


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


def make_sim(code, streaming: bool, pallas: bool = False, x_range=(2.0, 2.5, 1.0)):
    return Simulator(code, DecoderParams(iterations=ITERS),
                     ChannelParams(seed=3, x_range=x_range),
                     SimulationParams(batch_size=BATCH, fec=10**9, max_frames=MAX_FRAMES,
                                      streaming=streaming),
                     device="cpu", verbose=False, use_pallas=pallas)


def counted_steps(sim) -> list:
    """Count the sweep's step calls (the warm-up step included)."""
    calls = []
    name = "_step" if sim.engine == "batch" else "_stream_step"
    step = getattr(sim, name)

    def wrapped(*a, **k):
        calls.append(1)
        return step(*a, **k)

    setattr(sim, name, wrapped)
    return calls


def run(sim, wide=None):
    return sim.start_wide(wide) if wide is not None else sim.start()


def spans(prof) -> list:
    """``(name, start_ns, end_ns)`` of the program's spans, by start (from
    the profiler's raw events: ``prof.events()`` builds every operation's
    tree, seconds for these sweeps)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("ldpc.")]
    return sorted(out, key=lambda s: s[1])


def test_span_is_the_shared_no_op_outside_a_profile():
    profiling.reset_counters()
    a, b = profiling.span("ldpc.loop.read"), profiling.span("ldpc.decode")
    assert a is b
    with a:
        pass
    profiling.count("stream.lane_passes", 5)
    assert profiling.counters() == {}


def test_counters_count_only_while_a_profile_records():
    profiling.reset_counters()
    with torch.profiler.profile(activities=CPU):
        profiling.count("stream.lane_passes", 3)
        profiling.count("stream.lane_passes", 4)
        got = profiling.counters()
        got["stream.lane_passes"] = 0  # a copy
    profiling.count("stream.lane_passes", 100)
    assert profiling.counters() == {"stream.lane_passes": 7}
    profiling.reset_counters()
    assert profiling.counters() == {}


def _wide_mesh():
    return make_mesh((2, 1), (POINT_AXIS, FRAME_AXIS), ["cpu"] * 2)


@pytest.mark.parametrize("kind", ["stream", "fused", "batch", "wide-stream", "wide-batch"])
def test_sweep_opens_every_loop_span_and_counts_as_untraced(code, kind):
    streaming = kind != "batch" and kind != "wide-batch"
    wide = _wide_mesh() if kind.startswith("wide") else None
    x_range = (2.0, 3.01, 1.0) if wide is not None else (2.0, 2.5, 1.0)

    plain = run(make_sim(code, streaming, kind == "fused", x_range), wide)

    sim = make_sim(code, streaming, kind == "fused", x_range)
    calls = counted_steps(sim) if wide is None else None
    profiling.reset_counters()
    with torch.profiler.profile(activities=CPU) as prof:
        traced = run(sim, wide)
    got = spans(prof)
    counters = profiling.counters()

    for field in ("frames", "fec", "ber", "fer", "avg_iter"):
        np.testing.assert_array_equal(getattr(traced, field), getattr(plain, field), field)

    names = [n for n, _, _ in got]
    assert names.count("ldpc.warmup") == 1
    for name in LOOP:
        assert name in names, name
    loop = [s for s in got if s[0] in LOOP]
    dispatched = [s for s in loop if s[0] == "ldpc.loop.dispatch"]
    if calls is not None:
        assert len(dispatched) == len(calls) - 1  # the warm-up step is not a dispatch
    # the loop's phases do not overlap, and a read is absorbed and then written
    for (_, _, e0), (_, s1, _) in zip(loop, loop[1:]):
        assert e0 <= s1
    rest = [n for n, _, _ in loop if n != "ldpc.loop.dispatch"]
    assert rest == ["ldpc.loop.read", "ldpc.loop.absorb", "ldpc.loop.io"] * (len(rest) // 3)
    # the k-th read follows at least k + 1 dispatches
    reads = [s for s in loop if s[0] == "ldpc.loop.read"]
    for k, (_, start, _) in enumerate(reads):
        assert sum(1 for _, _, e in dispatched if e <= start) >= k + 1

    if streaming and wide is None:
        assert counters == {"stream.lane_passes": len(calls) * PASSES[sim.engine]}
    elif streaming:
        # every super-step (the warm-up one too) runs each point's shard
        assert counters["stream.lane_passes"] % (2 * PASSES["xla-superstep"]) == 0
        assert counters["stream.lane_passes"] >= 2 * PASSES["xla-superstep"] * (
            len(dispatched) + 1)
    else:
        assert counters == {}
    if sim.engine != "xla-superstep":
        # the batch step and the fused step open the decode and channel spans
        assert "ldpc.decode" in names and "ldpc.channel" in names
    if sim.engine == "batch":
        assert names.count("ldpc.count") == names.count("ldpc.decode")


def test_device_trace_clears_and_writes_the_counters(tmp_path):
    with torch.profiler.profile(activities=CPU):
        profiling.count("stream.lane_passes", 9)
    with profiling.device_trace(str(tmp_path), torch.device("cpu")):
        profiling.count("stream.lane_passes", 2)
    assert json.loads((tmp_path / "counters.json").read_text()) == {"stream.lane_passes": 2}
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_cli_trace_dir_writes_the_trace_and_counters(code, tmp_path):
    write_codefile(str(tmp_path / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    out = tmp_path / "trace"
    rc = cli.main([str(tmp_path / "h.txt"), str(tmp_path / "res.txt"), "2.0", "2.4", "0.5",
                   "-i", "5", "--batch-size", "32", "--max-frames", "96",
                   "--device", "cpu", "--trace-dir", str(out)])
    assert rc == 0
    counters = json.loads((out / "counters.json").read_text())
    assert counters["stream.lane_passes"] > 0
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert set(LOOP) <= names and "ldpc.warmup" in names
