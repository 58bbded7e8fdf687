"""The program's spans and counters on the card, over two traced sweeps at
B = 16384 of about a second each: the default command line on the 1152
(3,6) code at 2.0 dB (the XLA super-step: K2's one-pass launches, K8's
reload) and the ``--layer-file`` sweep of 802.11n n=1944 at 2.0 dB (batch
stepping: K8's channel batch, K5, the counting).

* Every decode-kernel launch (``bp_*_kernel``) falls inside an
  ``ldpc.decode`` range and every K8 launch inside an ``ldpc.channel``
  range: the host-side launch of each kernel, found by its correlation id
  in the Chrome trace, lies within the range.
* The spans add no device operation: the sweep traced with the spans
  forced off launches as many kernels, copies and fills, and counts the
  same frames.
* ``stream.lane_passes`` is 50 x 16,384 lane-passes a super-step (the
  point's warm-up super-step with them); ``exact.launches``,
  ``exact.staged_launches`` and ``exact.prior_staged_launches`` count each
  K5 launch of the ``--layer-file`` sweep (wifi 1944's float32 tile stages
  its tables and its frames' priors); none is counted with the tracing
  forced off.

Each sweep ends on its frame limit, so the traced runs repeat step for step.
"""

import collections
import json
import re

import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils import profiling
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

pytestmark = pytest.mark.cuda

B, ITERS = 16384, 50
DECODE = re.compile(r"\b(bp|bec)_\w*_kernel")
K8 = ("pool_draw_kernel", "pool_plan_kernel", "reload_plan_kernel")
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
#: (code, layered, frame limit: about a second of the sweep)
SWEEPS = {"default": ("bench", False, 1_000_000), "layer-file": ("wifi", True, 30 * B)}


@pytest.fixture(scope="module")
def codes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return {"bench": make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
            "wifi": wifi_code(1944)}


def traced_sweep(code, layered: bool, max_frames: int, path):
    sim = Simulator(code, DecoderParams(iterations=ITERS, layered=layered),
                    ChannelParams(seed=11, x_range=(2.0, 2.5, 1.0)),
                    SimulationParams(batch_size=B, fec=2**62, max_frames=max_frames),
                    device="cuda", verbose=False)
    sim.start()  # loads and warms every kernel of the path
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        res = sim.start()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return sim.engine, res, events, profiling.counters()


def launches_outside(events, match, span_name) -> list:
    """The kernels matching ``match`` whose host-side launch lies outside
    every ``span_name`` range."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] == span_name)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = []
    for e in events:
        if e.get("cat") != "kernel" or not match(e["name"]):
            continue
        t = launch.get(e["args"].get("correlation"))
        if t is None or not any(s <= t <= end for s, end in spans):
            out.append(e["name"][:80])
    return out


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_every_launch_inside_its_span_and_no_device_operation_added(codes, sweep, tmp_path,
                                                                     monkeypatch):
    name, layered, max_frames = SWEEPS[sweep]
    engine, res, events, counters = traced_sweep(codes[name], layered, max_frames,
                                                 tmp_path / "on.json")
    decode = [e for e in events if e.get("cat") == "kernel" and DECODE.search(e["name"])]
    k8 = [e for e in events if e.get("cat") == "kernel" and any(k in e["name"] for k in K8)]
    assert decode and k8
    assert launches_outside(events, lambda n: DECODE.search(n) is not None, "ldpc.decode") == []
    assert launches_outside(events, lambda n: any(k in n for k in K8), "ldpc.channel") == []

    dispatches = sum(1 for e in events if e["name"] == "ldpc.loop.dispatch"
                     and e.get("cat") == "user_annotation")  # the host's ranges
    if engine == "xla-superstep":
        assert counters == {"stream.lane_passes": (dispatches + 1) * ITERS * B}
    else:
        assert engine == "batch"
        assert counters == {"exact.launches": len(decode), "exact.staged_launches": len(decode),
                            "exact.prior_staged_launches": len(decode)}

    monkeypatch.setattr(profiling, "_tracing", lambda: False)
    _, res_off, events_off, counters_off = traced_sweep(codes[name], layered, max_frames,
                                                        tmp_path / "off.json")
    assert counters_off == {}
    assert not any(e["name"].startswith("ldpc.") for e in events_off)
    ops = [collections.Counter(e["name"][:60] for e in ev if e.get("cat") in DEVICE_OPS)
           for ev in (events, events_off)]
    print(f"{sweep}: engine {engine}, {dispatches} dispatches, {len(decode)} decode and "
          f"{len(k8)} K8 kernels, device operations on/off {sum(ops[0].values())} / "
          f"{sum(ops[1].values())}, counters {counters}")
    assert ops[0] == ops[1], (ops[0] - ops[1], ops[1] - ops[0])
    assert list(res.frames) == list(res_off.frames) and list(res.fec) == list(res_off.fec)
