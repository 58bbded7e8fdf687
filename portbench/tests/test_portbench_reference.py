"""The reference and the frozen yardstick agree with their sources on the
CPU: Philox's known answers, the codes and operation counts against the
program's own constructions and counts, and the reference's decoders
against the program's plain decoders on the same frames of tiny codes."""

import json

import numpy as np
import pytest
import torch

from portbench import roofline, spec
from portbench.codes import build_code, satisfies_checks, write_code_files
from portbench.reference.channel import FrameSource
from portbench.reference.decoders import (Graph, Lanes, Layered, StreamReference, decode_flooding,
                                          decode_layered)
from portbench.reference.philox import philox4x32_10

# Random123's known-answer vectors of Philox4x32-10
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    out = philox4x32_10(*[torch.tensor(c) for c in ctr], *key)
    assert tuple(int(o) for o in out) == want


@pytest.mark.parametrize("name", ["bench1152-bp", "wifi1944-bp"])
def test_codes_match_the_constructions_they_copy(name):
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.models.standards import wifi_code

    code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["code"])
    ref = make_benchmark_code(1152, 3, 6, seed=0, with_G=True) if name == "bench1152-bp" \
        else wifi_code(1944)
    assert np.array_equal(code.rows, ref.rows) and np.array_equal(code.cols, ref.cols)
    assert np.array_equal(code.G, ref.G)
    if ref.layers is not None:
        assert all(np.array_equal(a, b) for a, b in zip(code.layers, ref.layers))


def test_code_files_load_as_the_command_line_loads_them(tmp_path):
    from libldpc_tpu_torch.models import LDPCCode

    spec_ = {"construction": "qc", "Z": 27, "layers": "natural",
             "base_matrix": __import__("libldpc_tpu_torch.models.standards", fromlist=["x"])
             .WIFI_648_12.tolist()}
    code = build_code(spec_)
    files = write_code_files(code, tmp_path)
    loaded = LDPCCode.from_files(files["codefile"], files["genfile"], files["layerfile"])
    assert loaded.nc == code.nc and loaded.mc == code.mc
    assert np.array_equal(loaded.G, code.G)
    assert sorted(zip(loaded.rows.tolist(), loaded.cols.tolist())) == \
        list(zip(code.rows.tolist(), code.cols.tolist()))
    assert all(np.array_equal(a, b) for a, b in zip(loaded.layers, code.layers))


@pytest.mark.parametrize("name,minsum", [("bench1152-bp", False), ("wifi1944-bp", False),
                                         ("wifi1944-bp", True)])
def test_decode_cost_matches_the_frozen_source(name, minsum):
    from libldpc_tpu_torch.utils.roofline import decode_frame_cost

    code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["code"])
    cost = decode_frame_cost(nc=code.nc, nnz=code.nnz, cn_classes=code.cn_classes(),
                             iterations=4.5, minsum=minsum, channel=False)
    assert roofline.decode_frame_ops(code.nc, code.nnz, code.cn_classes(), 4.5, minsum) == \
        pytest.approx(cost.total_ops)
    assert roofline.draw_frame_ops(code.nc, 0) == 12 * code.nc


def _tiny(kind: str):
    if kind == "regular":
        return build_code({"construction": "regular", "nc": 96, "dv": 3, "dc": 6, "seed": 3})
    from libldpc_tpu_torch.models.standards import WIFI_648_12

    return build_code({"construction": "qc", "Z": 27, "layers": "natural",
                       "base_matrix": WIFI_648_12.tolist()})


def _program_code(code):
    from libldpc_tpu_torch.models import LDPCCode

    return LDPCCode(rows=code.rows.astype(np.int32), cols=code.cols.astype(np.int32),
                    nc=code.nc, mc=code.mc, G=code.G, layers=code.layers)


def test_frames_are_codewords_at_the_stated_noise():
    code = _tiny("regular")
    fs = FrameSource(code.G, 2.0, "cpu")
    llr, cw = fs.draw(123456789123, torch.arange(4000))
    H = np.zeros((code.mc, code.nc), np.int64)
    H[code.rows, code.cols] = 1
    assert not ((H @ cw.numpy().astype(np.int64)) % 2).any()
    assert 0.45 < cw.double().mean() < 0.55
    noise = llr * fs.sigma2 / 2.0 - (1.0 - 2.0 * cw.double())
    assert noise.std().item() == pytest.approx(fs.sigma, rel=0.02)
    again, _ = fs.draw(123456789123, torch.arange(10, 20))
    assert torch.equal(again, llr[:, 10:20])


@pytest.mark.parametrize("snr", [1.0, 2.5])
def test_layered_matches_the_programs_plain_decoder(snr):
    from libldpc_tpu_torch.ops.sorted import bp_decode_sorted, to_sorted_device

    code = _tiny("qc")
    llr, cw = FrameSource(code.G, snr, "cpu").draw(987654321, torch.arange(256))
    llr32 = llr.to(torch.float32)
    sdc = to_sorted_device(_program_code(code), "cpu", with_layers=True)
    inv = sdc.vn_inv.long()
    out = bp_decode_sorted(sdc, llr32[torch.argsort(inv)], 50, True, "BP", layered=True)
    hard = out.hard[inv]
    errs = (hard != cw).sum(0)
    ref = decode_layered(Graph(code.rows, code.cols, code.nc, code.mc, "cpu"), code.layers,
                         llr32.double(), cw, 50)
    assert ref["iter_sum"] == int(out.iterations.sum())
    assert ref["frame_errors"] == int((errs > 0).sum())
    assert ref["bit_errors"] == int(errs.sum())


def test_stream_matches_the_programs_plain_superstep(monkeypatch):
    from libldpc_tpu_torch.ops import streaming
    from libldpc_tpu_torch.ops.channel import ChannelOutput
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.utils.params import DecoderParams

    code = _tiny("regular")
    B, snr = 48, 1.5
    fs = FrameSource(code.G, snr, "cpu")
    sdc = to_sorted_device(_program_code(code), "cpu")
    perm = torch.argsort(sdc.vn_inv.long())  # sorted label -> original label
    key = [0]

    def draw(sdc_, channel_type, gen, batch, x_value, modulation=None, key_=None, pool=None,
             **kw):
        llr, cw = fs.draw(key[0], torch.arange(batch))
        return ChannelOutput(llr=llr.to(torch.float32)[perm], codeword=cw.to(torch.uint8)[perm])

    monkeypatch.setattr(streaming, "simulate_channel", draw)
    init, step = streaming.make_streaming_step(sdc, "AWGN", DecoderParams(iterations=20), B,
                                               chunk_iters=1, gen_threshold=4)
    ref = StreamReference(Graph(code.rows, code.cols, code.nc, code.mc, "cpu"), fs, B, 20, 4,
                          2**31 - 2**20)
    state = init()
    gen = torch.Generator()
    for p in range(120):
        key[0] = 1000 + p
        refill = p < 100
        state, acc = step(state, gen, snr, refill)
        want = [int(v) for v in acc]
        got = ref.superstep([key[0]], refill)
        assert got == want, (p, got, want)


def test_stream_restores_the_programs_lanes(monkeypatch):
    """The lanes in flight in the program's plain streaming state, started
    again from their draws (lane b of age a drawn a passes back), hold the
    program's iteration counts, and the reference followed from there
    gives the program's rows, refills and drain."""
    from libldpc_tpu_torch.ops import streaming
    from libldpc_tpu_torch.ops.channel import ChannelOutput
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.utils.params import DecoderParams

    code = _tiny("regular")
    B, snr, p0 = 48, 1.5, 70
    fs = FrameSource(code.G, snr, "cpu")
    sdc = to_sorted_device(_program_code(code), "cpu")
    perm = torch.argsort(sdc.vn_inv.long())
    key = [0]

    def draw(sdc_, channel_type, gen, batch, x_value, modulation=None, key_=None, pool=None,
             **kw):
        llr, cw = fs.draw(key[0], torch.arange(batch))
        return ChannelOutput(llr=llr.to(torch.float32)[perm], codeword=cw.to(torch.uint8)[perm])

    monkeypatch.setattr(streaming, "simulate_channel", draw)
    init, step = streaming.make_streaming_step(sdc, "AWGN", DecoderParams(iterations=20), B,
                                               chunk_iters=1, gen_threshold=4)
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu")
    ref = None
    state = init()
    for p in range(120):
        if p == p0:
            ref = StreamReference(graph, fs, B, 20, 4, 2**31 - 2**20)
            lanes = state.active.nonzero().flatten()
            drawn = p0 - state.age[lanes].to(torch.int64)
            assert 0 < lanes.numel() and int(drawn.min()) >= p0 - 21
            ref.restore({int(q): lanes[drawn == q] for q in torch.unique(drawn).tolist()}, p0,
                        lambda q: 1000 + q)
            assert torch.equal(ref.active, state.active)
            assert torch.equal(ref.iters[lanes], state.iters[lanes])
        key[0] = 1000 + p
        refill = p < 100
        state, acc = step(state, torch.Generator(), snr, refill)
        if ref is not None:
            assert ref.superstep([key[0]], refill) == [int(v) for v in acc], p
    assert not state.active.any() and torch.equal(ref.iters, state.iters)


def test_stream_numbers_are_nought_on_the_references_own_rows():
    from portbench.reference.channel import step_keys
    from portbench.reference.checks import stream_numbers, stream_start, stream_tail

    code = _tiny("regular")
    B, snr, its, passes, seed = 48, 1.5, 20, 5, 2**31 + 5
    fs = FrameSource(code.G, snr, "cpu")
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu")
    ref = StreamReference(graph, fs, B, its, 4, 2**31 - 2**20)
    refill = [True] * 9 + [False] * 6
    rows, snap = [], None
    for s, f in enumerate(refill):
        if s == 8:
            snap = (s, ref.active.clone(), ref.age.clone(), ref.iters.clone())
        rows.append(ref.superstep(step_keys(seed, 0, s, passes, "cpu"), f))
    assert rows[-1][4] == 0 and sum(r[2] for r in rows[8:]) > B
    end = (ref.active.clone(), ref.iters.clone())
    args = (code, snr, seed, B, its, passes, 4, 2**31 - 2**20)

    def numbers(rows, snap, end):
        start, _ = stream_start(rows, *args, 3, "cpu")
        tail, tail_numbers, _ = stream_tail(rows, refill, snap, end, *args, "cpu")
        return {**stream_numbers(start, tail, B), **tail_numbers}

    assert numbers(rows, snap, end) == {
        "frames_gap": 0.0, "iter_gap": 0.0, "frame_error_gap": 0.0, "frame_error_count_gap": 0,
        "bit_error_count_gap": 0, "active_gap": 0.0, "tail_state_gap": 0.0,
        "tail_lane_gap": 0.0, "in_flight_at_end": 0}
    for s in (1, 9):  # a super-step of the start, then of the end, counted wrong
        bad = [list(r) for r in rows]
        bad[s][3] += 3
        assert numbers(bad, snap, end)["iter_gap"] > 0
        bad[s][0] += 2
        bad[s][1] += 1
        got = numbers(bad, snap, end)
        assert (got["frame_error_count_gap"], got["bit_error_count_gap"]) == (1, 2)
    late = (8, snap[1], snap[2] + 1, snap[3])  # every lane drawn one pass earlier
    assert numbers(rows, late, end)["tail_state_gap"] > 0
    off = (end[0], end[1] + (torch.arange(B) % 7 == 0).to(end[1].dtype))
    assert numbers(rows, snap, off)["tail_lane_gap"] > 0.1
    assert numbers(rows, None, end)["frames_gap"] == 1.0


def _lanes_once(graph, step, llr, cw, iterations):
    """Every lane given one frame and never refilled, run to its end:
    ``(counts, lanes)``."""
    B = llr.shape[1]
    lanes = Lanes(graph, B, iterations, step)
    lanes._start(torch.arange(B), llr, cw)
    counts = np.zeros(4, dtype=np.int64)
    while bool(lanes.active.any()):
        counts += lanes._pass()
    return counts.tolist(), lanes


def test_layered_pass_is_decode_layereds_iteration_on_a_lane_never_refilled():
    """Where no frame stops (-2 dB, 6 iterations), the streaming pass and
    the exact schedule run the same layer steps: the same posteriors, so
    the same bit errors, bit for bit."""
    code = _tiny("qc")
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu")
    llr, cw = FrameSource(code.G, -2.0, "cpu").draw(987654321, torch.arange(256))
    counts, _ = _lanes_once(graph, Layered(graph, code.layers), llr, cw, 6)
    ref = decode_layered(graph, code.layers, llr, cw, 6)
    assert counts == [ref["bit_errors"], ref["frame_errors"], ref["frames"], ref["iter_sum"]]
    assert counts[1] == 256 and counts[3] == 6 * 256


@pytest.mark.parametrize("snr", [1.0, 2.5])
def test_layered_pass_matches_the_programs_plain_fast_decoder(snr):
    """A lane never refilled decodes its frame as the fast layered engine's
    batch decode does (``bp_decode_layered_fast_plain``: the whole
    iteration, then the check): each frame's iterations, the errors."""
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.layered import bp_decode_layered_fast_plain
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    code = _tiny("qc")
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu")
    llr, cw = FrameSource(code.G, snr, "cpu").draw(2**33 + 5, torch.arange(256))
    llr32 = llr.to(torch.float32)
    counts, lanes = _lanes_once(graph, Layered(graph, code.layers), llr32.double(), cw, 50)
    tables = kernel_tables(to_sorted_device(_program_code(code), "cpu", with_layers=True))
    inv = tables.code.vn_inv.long()
    out = bp_decode_layered_fast_plain(tables, llr32[torch.argsort(inv)], 50, True)
    errs = (out.hard[inv] != cw).sum(0)
    assert torch.equal(lanes.iters, out.iterations)
    assert counts == [int(errs.sum()), int((errs > 0).sum()), 256, int(out.iterations.sum())]
    assert counts[1] > 0 if snr < 2 else counts[1] == 0


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("snr", [1.0, 2.0])
def test_flooding_batch_matches_the_programs_plain_decoder(snr, early_term):
    """``decode_flooding`` against the K1 path's plain decoder
    (``bp_decode_fused_plain``) on the same frames, counted as the batch
    step counts: errors from its decisions, its iterations."""
    from libldpc_tpu_torch.ops.kernels.decode_fused import bp_decode_fused_plain
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    code = _tiny("regular")
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu")
    llr, cw = FrameSource(code.G, snr, "cpu").draw(2**45 + 3, torch.arange(512))
    llr32 = llr.to(torch.float32)
    tables = kernel_tables(to_sorted_device(_program_code(code), "cpu"))
    inv = tables.code.vn_inv.long()
    out = bp_decode_fused_plain(tables, llr32[torch.argsort(inv)], 30, early_term)
    errs = (out.hard[inv] != cw).sum(0)
    ref = decode_flooding(graph, llr32.double(), cw, 30, early_term)
    assert ref == {"bit_errors": int(errs.sum()), "frame_errors": int((errs > 0).sum()),
                   "frames": 512, "iter_sum": int(out.iterations.sum())}
    assert ref["frame_errors"] > 0
    if not early_term:
        assert ref["iter_sum"] == 30 * 512


def _nr_skeleton(Z: int):
    from libldpc_tpu_torch.models.construct import detect_qc
    from libldpc_tpu_torch.models.standards import make_nr_like_code

    base = detect_qc(make_nr_like_code(bg=1, Z=Z, seed=0, with_G=False), Z)
    return build_code({"construction": "qc", "base_matrix": base.tolist(), "Z": Z,
                       "layers": "natural", "puncture": [[0, 2 * Z]]})


@pytest.mark.parametrize("name", ["bench1152-bp", "wifi1944-bp", "nr-bg1-z16"])
def test_edge_check_accepts_the_generators_and_refuses_a_flipped_bit(name):
    """The generator check over H's edges passes the built G of both
    configurations and of a BG1 skeleton at Z = 16, and refuses each with
    one bit flipped (in an info column and in a parity column); it agrees
    with the dense ``H G^T``."""
    if name.startswith("nr"):
        code = _nr_skeleton(16)
    else:
        code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
                          ["code"])
    H = np.zeros((code.mc, code.nc), np.int64)
    H[code.rows, code.cols] = 1
    assert satisfies_checks(code.rows, code.cols, code.G)
    assert not ((H @ code.G.T.astype(np.int64)) % 2).any()
    rng = np.random.default_rng(7)
    unit = np.flatnonzero(code.G.sum(0) == 1)
    for col in (int(rng.choice(unit)), int(rng.choice(np.setdiff1d(np.arange(code.nc), unit)))):
        G = code.G.copy()
        row = int(rng.integers(code.kc))
        G[row, col] ^= 1
        assert not satisfies_checks(code.rows, code.cols, G)
        assert ((H @ G.T.astype(np.int64)) % 2).any()
    shuffled = rng.permutation(code.nnz)  # the edges in any order
    assert satisfies_checks(code.rows[shuffled], code.cols[shuffled], code.G)
