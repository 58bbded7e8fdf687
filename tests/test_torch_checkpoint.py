"""Checkpoint and resume of the port's sweep on the CPU: the results'
JSON round trip (against the JAX package's ``SimResults``), a sweep
stopped and resumed against the same sweep uninterrupted, the experiment
identity a resume is refused under, and the exact start quota of a resumed
streaming point."""

import json
import warnings

import numpy as np
import pytest
import torch

from libldpc_tpu.sim.results import SimResults as JaxSimResults
from libldpc_tpu_torch.models import make_benchmark_code
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.sim.results import SimResults
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

#: sweeps of the 96-node (3,6) code: (decoder, channel, simulation)
#: settings, one per path a resume can take
SWEEPS = {
    "streaming": (dict(iterations=10, type="BP_MS"), dict(x_range=(1.0, 3.01, 1.0)),
                  dict(batch_size=48, fec=6, max_frames=3000)),
    "batches": (dict(iterations=8, early_term=False), dict(x_range=(1.0, 3.01, 1.0)),
                dict(batch_size=40, fec=6, max_frames=2000)),
    "bec": (dict(iterations=10), dict(x_range=(0.30, 0.451, 0.05), type="BEC"),
            dict(batch_size=40, fec=6, max_frames=2000)),
}


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


def _sim(code, name, dec=None, sim=None, use_pallas=False, **kw):
    d, ch, s = SWEEPS[name]
    return Simulator(
        code, DecoderParams(**{**d, **(dec or {})}), ChannelParams(seed=3, **ch),
        SimulationParams(**{**s, **(sim or {}), **kw}), device="cpu", verbose=False,
        use_pallas=use_pallas)


def _rows(res: SimResults) -> np.ndarray:
    """Each point's row, ``frame_time`` aside."""
    return np.stack([res.x_values, res.fer, res.ber, res.avg_iter, res.fec, res.frames], 1)


def test_results_json_round_trips_exactly():
    rng = np.random.default_rng(11)
    res = SimResults.empty(4, rng.normal(size=4))
    for f in ("fer", "ber", "avg_iter", "time"):
        getattr(res, f)[:] = rng.random(4) / 7.0
    res.fec[:] = rng.integers(0, 10**12, 4)
    res.frames[:] = rng.integers(0, 10**12, 4)
    for back in (SimResults.from_json(res.to_json()), JaxSimResults.from_json(res.to_json())):
        for f in ("x_values", "fer", "ber", "avg_iter", "time", "fec", "frames"):
            a, b = getattr(res, f), getattr(back, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the JAX package's JSON reads back the same
    jres = JaxSimResults.from_json(res.to_json())
    assert SimResults.from_json(jres.to_json()).to_json() == res.to_json()
    assert {k: v.tolist() for k, v in res.as_dict(trim=False).items()} == {
        k: v.tolist() for k, v in jres.as_dict(trim=False).items()}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_stop_after_point_then_resume_equals_uninterrupted(code, tmp_path, name):
    whole = _sim(code, name).start()
    ckpt = str(tmp_path / "c.json")
    sim = _sim(code, name, checkpoint_file=ckpt)
    fec = SWEEPS[name][2]["fec"]
    # true once point 0 met its rule: the point ends as it would have
    first = sim.start(stop_flag=lambda: sim.results.fec[0] >= fec or
                      sim.results.frames[0] >= SWEEPS[name][2]["max_frames"])
    assert first.frames[0] > 0 and first.frames[1] == 0
    state = json.loads(open(ckpt).read())
    assert state["point"] == 0 and state["counters"][2] == first.frames[0]
    resumed = _sim(code, name, checkpoint_file=ckpt).start(resume=True)
    np.testing.assert_array_equal(_rows(resumed), _rows(whole))
    assert json.loads(open(ckpt).read())["point"] == len(whole.frames)


def test_mid_point_batch_resume_equals_uninterrupted(code, tmp_path):
    """Batch-stepped at ``pipeline_depth=1``: no batch is in flight when the
    checkpoint is written, so the resumed point draws the batches the
    uninterrupted one drew."""
    opts = dict(pipeline_depth=1, fec=10**6, max_frames=600)
    whole = _sim(code, "batches", sim=opts).start()
    ckpt = str(tmp_path / "c.json")
    sim = _sim(code, "batches", sim=opts, checkpoint_file=ckpt)
    sim.start(stop_flag=lambda: sim.results.frames[1] >= 200)  # 5 of point 1's 15 batches
    state = json.loads(open(ckpt).read())
    assert state["point"] == 1 and state["counters"][2] == 200 and state["counters"][5] == 5
    resumed = _sim(code, "batches", sim=opts, checkpoint_file=ckpt).start(resume=True)
    np.testing.assert_array_equal(_rows(resumed), _rows(whole))


@pytest.mark.parametrize("change", [
    dict(dec=dict(iterations=12)), dict(dec=dict(type="BP")),
    dict(dec=dict(message_dtype="bfloat16")), dict(sim=dict(batch_size=32)),
], ids=["iterations", "cn_form", "message_dtype", "batch_size"])
def test_changed_experiment_warns_and_starts_fresh(code, tmp_path, change):
    ckpt = str(tmp_path / "c.json")
    first = _sim(code, "streaming", use_pallas=True, checkpoint_file=ckpt)
    first.start(stop_flag=lambda: first.results.frames[0] > 0)
    changed = _sim(code, "streaming", use_pallas=True, checkpoint_file=ckpt, **change)
    with pytest.warns(UserWarning, match="different experiment"):
        res = changed.start(resume=True)
    fresh = _sim(code, "streaming", use_pallas=True, **change).start()
    np.testing.assert_array_equal(_rows(res), _rows(fresh))


def test_raised_fec_resumes_silently(code, tmp_path):
    ckpt = str(tmp_path / "c.json")
    sim = _sim(code, "batches", checkpoint_file=ckpt)
    first = sim.start(stop_flag=lambda: sim.results.fec[0] >= 6)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        res = _sim(code, "batches", sim=dict(fec=12), checkpoint_file=ckpt).start(resume=True)
    np.testing.assert_array_equal(_rows(res)[0], _rows(first)[0])
    assert (res.fec[1:] >= 12).all()


def test_other_sweep_values_start_fresh(code, tmp_path):
    ckpt = str(tmp_path / "c.json")
    _sim(code, "batches", checkpoint_file=ckpt).start()
    d, _, s = SWEEPS["batches"]
    other = Simulator(code, DecoderParams(**d), ChannelParams(seed=4, x_range=(1.0, 3.01, 1.0)),
                      SimulationParams(**s, checkpoint_file=ckpt), device="cpu", verbose=False)
    fresh = Simulator(code, DecoderParams(**d), ChannelParams(seed=4, x_range=(1.0, 3.01, 1.0)),
                      SimulationParams(**s), device="cpu", verbose=False)
    np.testing.assert_array_equal(_rows(other.start(resume=True)), _rows(fresh.start()))


def test_resume_mid_point_streaming_counts_max_frames_exactly(code, tmp_path):
    """A checkpoint at 37 counted frames (not a multiple of the batch) with
    ``max_frames`` binding: the resumed point ends at exactly 64."""
    ckpt = tmp_path / "c.json"
    sim = Simulator(code, DecoderParams(iterations=10), ChannelParams(seed=1, x_range=(8.0, 9.0, 1.0)),
                    SimulationParams(batch_size=64, fec=10**9, max_frames=64,
                                     checkpoint_file=str(ckpt)),
                    device="cpu", verbose=False)
    assert "streaming=on" in sim.decode_path
    ckpt.write_text(json.dumps({
        "x_vals": [8.0], "point": 0, "counters": [0, 0, 37, 370, 0.5, 3],
        "seed": 1, "channel": "AWGN", "config": sim._checkpoint_config(),
        "results": json.loads(SimResults.empty(1, [8.0]).to_json()),
    }))
    calls = []
    res = sim.start(stop_flag=lambda: calls.append(1) or len(calls) > 10**4, resume=True)
    assert len(calls) <= 10**4, "resume livelocked"
    assert res.frames[0] == 64
