"""The port's profiling helpers (``utils/profiling.py``) against the JAX
package's: the ``[TIMEPROF]`` line, ``ThroughputMeter``'s arithmetic on the
same inputs, and ``device_trace``."""

import re

import pytest
import torch

from libldpc_tpu.utils import profiling as jprof
from libldpc_tpu_torch.utils import profiling


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns", "minutes"])
def test_time_prof_line(capsys, unit):
    for mod in (profiling, jprof):
        with mod.time_prof("decode", unit):
            pass
    got, want = capsys.readouterr().out.splitlines()
    pattern = r"\[TIMEPROF\]: decode: [0-9]+\.[0-9]{3} (\w+)"
    assert re.fullmatch(pattern, got) and re.fullmatch(pattern, want)
    assert re.fullmatch(pattern, got).group(1) == re.fullmatch(pattern, want).group(1)


def _fill(meter, frames, elapsed, overhead):
    meter.frames, meter.batches = sum(frames), len(frames)
    meter.elapsed, meter.const_overhead = elapsed, overhead
    return meter


@pytest.mark.parametrize("bits", [0, 576])
@pytest.mark.parametrize("frames,elapsed,overhead", [([16384] * 4, 0.25, 0.0),
                                                     ([100, 200], 0.01, 0.002),
                                                     ([5], 0.001, 1.0)])
def test_throughput_meter_arithmetic(bits, frames, elapsed, overhead):
    got = _fill(profiling.ThroughputMeter(bits), frames, elapsed, overhead)
    want = _fill(jprof.ThroughputMeter(bits), frames, elapsed, overhead)
    for name in ("net_elapsed", "frames_per_s", "mbits_per_s"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.summary() == want.summary()


def test_throughput_meter_counts_batches_and_overhead():
    calls = []
    meter = profiling.ThroughputMeter(bits_per_frame=8)
    assert meter.measure_overhead(lambda: calls.append(1), repeats=3) >= 0
    assert len(calls) == 4  # one warm call and three timed
    for n in (10, 20):
        with meter.batch(n):
            pass
    assert meter.frames == 30 and meter.batches == 2
    assert meter.net_elapsed >= 1e-12


def test_device_trace_none_is_a_no_op():
    with profiling.device_trace(None) as prof:
        x = torch.ones(3) + 1
    assert prof is None and x.sum().item() == 6


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path), torch.device("cpu")) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    assert (tmp_path / "trace.json").stat().st_size > 0
