"""The mesh and the sharded steps (``libldpc_tpu_torch.parallel.mesh``,
``ops.streaming_fused`` over a mesh) on a mesh that repeats ``"cpu"``,
the counterpart of the JAX tests' virtual CPU devices.  The sharded
counters are held to the sum of each shard's one-device step on the same
generators, exactly; ``split_exact_multi`` to the JAX package's; and a
sweep without a mesh to the rows the port gave before meshes existed."""

import numpy as np
import pytest
import torch

from libldpc_tpu.ops.streaming import split_exact_multi as jax_split_exact_multi
from libldpc_tpu_torch.models import make_benchmark_code
from libldpc_tpu_torch.ops.channel import make_generator
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming import split_exact_multi
from libldpc_tpu_torch.ops.streaming_fused import (
    make_streaming_fused_multipoint_step, make_streaming_fused_step,
)
from libldpc_tpu_torch.parallel.mesh import (
    FRAME_AXIS, POINT_AXIS, Mesh, default_mesh, make_mesh, make_multipoint_sim_step,
    make_sim_step, shard_generators,
)
from libldpc_tpu_torch.sim.driver import Simulator
from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

torch.set_num_threads(2)

DEC = DecoderParams(iterations=8)


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


@pytest.fixture(scope="module")
def tables(code):
    return kernel_tables(to_sorted_device(code, "cpu"))


def mesh1(n=4):
    return Mesh(["cpu"] * n, (FRAME_AXIS,))


def mesh2(p=2, f=4):
    return make_mesh((p, f), (POINT_AXIS, FRAME_AXIS), ["cpu"] * (p * f))


@pytest.mark.parametrize("offsets,n", [([0, 5], 4), ([7, 3, 100], 3), ([2**33, 1], 4),
                                       ([123456789], 8), ([1, 1, 1, 1], 1)])
def test_split_exact_multi_matches_jax(offsets, n):
    got = split_exact_multi(offsets, n)
    want = jax_split_exact_multi(offsets, n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mesh_shape_and_shards():
    m = mesh2()
    assert m.shape == {POINT_AXIS: 2, FRAME_AXIS: 4} and m.size == 8
    assert [(s.point, s.frame) for s in m.local_shards()] == [(p, f) for p in range(2)
                                                              for f in range(4)]
    assert default_mesh(device="cpu").shape == {FRAME_AXIS: 1}  # the CPU counts once
    assert default_mesh(3, device="cpu").size == 1
    with pytest.raises(ValueError, match="last"):
        Mesh(np.array([["cpu"] * 2] * 2, dtype=object), (FRAME_AXIS, POINT_AXIS))


def test_shard_generators_append_the_coordinates():
    g1 = shard_generators(mesh1(3), 4, 5, 6)
    g2 = shard_generators(mesh2(2, 2), 4, 5, 6)
    draw = [torch.rand(4, generator=g) for g in g1 + g2]
    want = [torch.rand(4, generator=make_generator("cpu", 4, 5, 6, *k))
            for k in [(0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (1, 1)]]
    for a, b in zip(draw, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("channel,x,forensics", [("AWGN", 1.5, False), ("AWGN", 1.0, True),
                                                 ("BEC", 0.4, False), ("BSC", 0.05, True)])
def test_sharded_step_is_the_sum_of_its_shards(tables, channel, x, forensics):
    m = mesh1(4)
    step = make_sim_step(tables, channel, DEC, 16, "flooding", forensics=forensics, mesh=m)
    out = step(shard_generators(m, 1, 2, 3), x)
    one = make_sim_step(tables, channel, DEC, 16, "flooding", forensics=forensics)
    parts = [one(make_generator("cpu", 1, 2, 3, s), x) for s in range(4)]
    for k in range(4):
        assert out[k].dtype == torch.int64
        assert int(out[k]) == sum(int(p[k]) for p in parts)
    assert int(out.frames) == 64
    if forensics:
        # every shard's frames once, in frame order
        assert torch.equal(out.frame_bit_errors, torch.cat([p.frame_bit_errors for p in parts]))
        assert torch.equal(out.hard, torch.cat([p.hard for p in parts], dim=1))
        assert torch.equal(out.codeword, torch.cat([p.codeword for p in parts], dim=1))
        cols = {tuple(c) for c in out.codeword.t().tolist()}
        assert len(cols) == 64  # no frame repeated


def test_sharded_step_is_deterministic(tables):
    m = mesh1(4)
    step = make_sim_step(tables, "AWGN", DEC, 16, "flooding", forensics=True, mesh=m)
    a = step(shard_generators(m, 0, 1, 2), 1.0)
    b = step(shard_generators(m, 0, 1, 2), 1.0)
    c = step(shard_generators(m, 0, 1, 3), 1.0)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a.codeword, c.codeword)


def test_multipoint_step_counts_per_point(tables):
    m = mesh2(2, 4)
    step = make_multipoint_sim_step(tables, "AWGN", DEC, 8, "flooding", m, forensics=True)
    out = step(shard_generators(m, 9, 0, 0), [0.0, 4.0])
    one = make_sim_step(tables, "AWGN", DEC, 8, "flooding", forensics=True)
    for p, x in enumerate((0.0, 4.0)):
        parts = [one(make_generator("cpu", 9, 0, 0, p, f), x) for f in range(4)]
        for k in range(4):
            assert int(out[k][p]) == sum(int(q[k]) for q in parts)
        assert torch.equal(out.hard[p], torch.cat([q.hard for q in parts], dim=1))
    assert out.hard.shape == (2, 96, 32) and out.frame_bit_errors.shape == (2, 32)
    assert int(out.frame_errors[0]) > int(out.frame_errors[1])
    with pytest.raises(ValueError, match="x_values has 3 points, mesh expects 2"):
        step(shard_generators(m, 9, 0, 0), [0.0, 1.0, 2.0])


@pytest.mark.parametrize("layered", [False, True])
def test_sharded_stream_is_the_sum_of_its_shards(code, layered):
    """The streaming step over a 1-D mesh: each shard's deltas are those
    of a one-shard step with its quota (``max_frames`` split, remainder on
    the low shards) and its share of the resume offset, on the same
    generators; the quota lands exactly."""
    from libldpc_tpu_torch.models import wifi_code

    c = wifi_code(648) if layered else code
    tb = kernel_tables(to_sorted_device(c, "cpu", with_layers=layered))
    m = mesh1(3)
    max_frames, offset = 101, 10
    init, step = make_streaming_fused_step(tb, "AWGN", DEC, 8, max_frames=max_frames,
                                           layered=layered, mesh=m)
    states = init(offset)
    quotas, starts = [34, 34, 33], [4, 3, 3]  # 101 and 10 split over 3 shards
    singles = []
    for q, s0 in zip(quotas, starts):
        i1, s1 = make_streaming_fused_step(tb, "AWGN", DEC, 8, max_frames=q, layered=layered)
        singles.append((s1, i1(s0)))
    total = 0
    for b in range(40):
        states, acc = step(states, shard_generators(m, 5, b), 2.0, True)
        parts = [s1(st, make_generator("cpu", 5, b, f), 2.0, True)[1]
                 for f, (s1, st) in enumerate(singles)]
        for k in range(5):
            assert int(acc[k]) == sum(int(p[k]) for p in parts)
        total += int(acc.frames)
        if int(acc.n_active) == 0 and total >= max_frames - offset:
            break
    assert total == max_frames - offset


def test_multipoint_stream_gates_refill_per_point(tables):
    m = mesh2(2, 2)
    init, step = make_streaming_fused_multipoint_step(tables, "AWGN", DEC, 8, m, max_frames=150)
    states = init([0, 0])
    per_point = np.zeros(2, np.int64)
    for b in range(100):
        # point 1 drains from its second super-step on
        states, acc = step(states, shard_generators(m, 7, b), [0.0, 4.0], [True, b < 1])
        per_point += np.array(acc.frames.tolist())
        if (np.array(acc.n_active.tolist()) == 0).all() and b >= 1 and per_point[0] >= 150:
            break
    assert per_point[0] == 150 and 0 < per_point[1] < 150
    with pytest.raises(ValueError, match="mesh expects 2"):
        step(states, shard_generators(m, 7, 0), [0.0], [True])


#: Rows of a sweep without a mesh, from the port before meshes existed
#: (``Simulator.start`` on the CPU, the 96-node code of ``code``).  The
#: streaming rows are the fused step's, the engine of ``--pallas`` (the
#: default command line runs the XLA super-step since it was ported).
PARENT_ROWS = {
    "stream": {"frames": [128, 354, 504], "fec": [92, 101, 46],
               "avg_iter": [8.484375, 5.056497175141243, 2.8531746031746033]},
    "batch": {"frames": [128, 128, 256], "fec": [105, 43, 37],
              "avg_iter": [10.0, 10.0, 10.0]},
    "bec": {"frames": [128, 128, 128, 512], "fec": [113, 80, 46, 26],
            "avg_iter": [9.5625, 8.3125, 6.8046875, 4.076171875]},
}
PARENT_BER = {"stream": [0.07486979166666667, 0.0260710922787194, 0.007750496031746032],
              "batch": [0.11531575520833333, 0.038004557291666664, 0.010904947916666666],
              "bec": [0.2980143229166667, 0.16056315104166666, 0.06998697916666667,
                      0.0067138671875]}


@pytest.mark.parametrize("name", ["stream", "batch", "bec"])
def test_rows_without_a_mesh_are_unchanged(code, name):
    dec, ch = {
        "stream": (DecoderParams(iterations=10), ChannelParams(seed=5, x_range=(1.0, 3.01, 1.0))),
        "batch": (DecoderParams(iterations=10, early_term=False, type="BP_MS"),
                  ChannelParams(seed=5, x_range=(1.0, 3.01, 1.0))),
        "bec": (DecoderParams(iterations=10),
                ChannelParams(seed=5, x_range=(0.3, 0.451, 0.05), type="BEC")),
    }[name]
    r = Simulator(code, dec, ch, SimulationParams(batch_size=64, fec=20, max_frames=4000),
                  device="cpu", verbose=False, use_pallas=name == "stream").start()
    assert r.frames.tolist() == PARENT_ROWS[name]["frames"]
    assert r.fec.tolist() == PARENT_ROWS[name]["fec"]
    assert r.avg_iter.tolist() == PARENT_ROWS[name]["avg_iter"]
    assert r.ber.tolist() == PARENT_BER[name]


def test_simulator_refuses_an_indivisible_batch(code):
    with pytest.raises(ValueError, match="batch_size 30 not divisible by 4 mesh devices"):
        Simulator(code, DEC, ChannelParams(), SimulationParams(batch_size=30), device="cpu",
                  mesh=mesh1(4))
