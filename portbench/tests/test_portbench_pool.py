"""The fused pool's reference and punctured codes, on the CPU against the
program's plain chunks, plain decoders and file loader, and (marked
``cuda``) against K8's draws on the card."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench import roofline, spec
from portbench.codes import Code, build_code, write_code_files
from portbench.reference import checks
from portbench.reference.channel import FrameSource, step_keys
from portbench.reference.decoders import Graph, Layered, decode_layered
from portbench.reference.pool import PoolReference, chunking, identify, info_columns


def _tiny():
    return build_code({"construction": "regular", "nc": 96, "dv": 3, "dc": 6, "seed": 3})


def _program_code(code):
    from libldpc_tpu_torch.models import LDPCCode

    return LDPCCode(rows=code.rows.astype(np.int32), cols=code.cols.astype(np.int32),
                    nc=code.nc, mc=code.mc, G=code.G, layers=code.layers,
                    puncture=code.puncture.astype(np.int32))


def _nr_like(bg: int, Z: int) -> Code:
    """``make_nr_like_code`` as the benchmark holds a code: edges sorted,
    its layers and its punctured variables."""
    from libldpc_tpu_torch.models.standards import make_nr_like_code

    c = make_nr_like_code(bg=bg, Z=Z, seed=0)
    rows, cols = c.rows.astype(np.int64), c.cols.astype(np.int64)
    order = np.lexsort((cols, rows))
    return Code(rows[order], cols[order], c.nc, c.mc, np.asarray(c.G, np.uint8),
                [np.asarray(l, np.int64) for l in c.layers], np.asarray(c.puncture, np.int64))


class FusedRun:
    """The program's plain fused pool (``make_streaming_fused_step(...,
    plain=True)``, with ``layered`` on the fast layered engine) on the
    CPU, its pool drawn by the reference's channel on the keys the card
    would use: chunk ``j`` of super-step ``s`` refills on
    ``step_keys(seed, 0, s, n_outer)[j]``."""

    def __init__(self, monkeypatch, code, B, its, snr, seed, layered=False):
        from libldpc_tpu_torch.ops import streaming_fused
        from libldpc_tpu_torch.ops.channel import ChannelOutput
        from libldpc_tpu_torch.ops.kernels import pool_refill as k8
        from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
        from libldpc_tpu_torch.ops.sorted import to_sorted_device
        from libldpc_tpu_torch.utils.params import DecoderParams

        self.fs = FrameSource(code.G, snr, "cpu", code.transmitted)
        sdc = to_sorted_device(_program_code(code), "cpu", with_layers=layered)
        self.inv = sdc.vn_inv.long()  # row inv[v] of a plane is the code's variable v
        perm = torch.argsort(self.inv)
        _, self.n_outer = chunking(its)
        self.snr = snr
        chunk = [0]

        def refill(*a, **kw):
            s, j = divmod(chunk[0], self.n_outer)
            self.key = step_keys(seed, 0, s, self.n_outer, "cpu")[j]
            chunk[0] += 1
            return k8.pool_refill_plain(*a)

        def draw(sdc_, channel_type, gen, batch, x_value, modulation=None, **kw):
            llr, cw = self.fs.draw(self.key, torch.arange(batch))
            return ChannelOutput(llr=llr.to(torch.float32)[perm],
                                 codeword=cw.to(torch.uint8)[perm])

        monkeypatch.setattr(streaming_fused, "pool_refill", refill)
        monkeypatch.setattr(k8, "simulate_channel", draw)
        init, self._step = streaming_fused.make_streaming_fused_step(
            kernel_tables(sdc), "AWGN", DecoderParams(iterations=its), B, layered=layered,
            plain=True)
        self.state = init()

    def step(self, refill: bool) -> list:
        self.state, acc = self._step(self.state, torch.Generator(), self.snr, refill)
        return [int(v) for v in acc]

    def lanes(self) -> tuple:
        """``(active, age, iters, avail, llr, cw, pool_llr, pool_cw,
        started)``, the planes in the code's labels, as the harness keeps
        them."""
        st, inv = self.state, self.inv
        return (st.done == 0, st.age.clone(), st.iters.clone(), st.avail != 0,
                st.llr_in[inv].double(), st.codeword[inv] != 0, st.fresh_llr[inv].double(),
                st.fresh_cw[inv] != 0, st.started.clone())


QUOTA = 2**31 - 2**20


@pytest.mark.parametrize("snr", [1.0, 2.0])
def test_pool_matches_the_programs_plain_fused_chunks(monkeypatch, snr):
    """Every super-step's row and the lanes' in-flight flags, ages,
    iteration counts and unused entries after it, refilling and draining."""
    code = _tiny()
    B, its, seed = 48, 20, 2**31 + 11
    run = FusedRun(monkeypatch, code, B, its, snr, seed)
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu", code.transmitted)
    ref = PoolReference(graph, run.fs, B, its, QUOTA)
    assert (ref.k, ref.n_outer) == (4, 5)
    refill = [True] * 12 + [False] * 4
    for s, f in enumerate(refill):
        want = run.step(f)
        got = ref.superstep(step_keys(seed, 0, s, run.n_outer, "cpu"), f)
        assert got == want, (s, got, want)
        st = run.state
        assert torch.equal(ref.active, st.done == 0), s
        assert torch.equal(ref.age, st.age) and torch.equal(ref.iters, st.iters), s
        assert torch.equal(ref.avail, st.avail != 0), s
    assert want[4] == 0


def _pool_numbers(code, rows, refill, snap, end, B, its, snr, seed, store=None, layered=False):
    traffic = {"snr_db": snr, "layer_file": layered, "qc": layered}
    start, _ = checks.pool_start(rows, code, traffic, seed, B, its, QUOTA, 3, "cpu", store)
    tail, numbers, _ = checks.pool_tail(rows, refill, snap, end, code, traffic, seed, B, its,
                                        QUOTA, "cpu", store)
    return {**checks.stream_numbers(start, tail, B), **numbers}


ZERO = {"frames_gap": 0.0, "iter_gap": 0.0, "frame_error_gap": 0.0, "frame_error_count_gap": 0,
        "bit_error_count_gap": 0, "active_gap": 0.0, "tail_state_gap": 0.0,
        "tail_lane_gap": 0.0, "in_flight_at_end": 0}


def test_pool_numbers_are_nought_on_the_programs_plain_run(monkeypatch):
    """The pool check on the program's own plain run: every number 0; then
    a row, a lane's age, an unused entry's frame and a lane's last count
    each put wrong are caught."""
    code = _tiny()
    B, its, snr, seed = 48, 20, 1.5, 977
    run = FusedRun(monkeypatch, code, B, its, snr, seed)
    refill = [True] * 10 + [False] * 5
    rows, snap = [], None
    for s, f in enumerate(refill):
        if s == 9:
            snap = (s, *run.lanes())
        rows.append(run.step(f))
    assert rows[-1][4] == 0 and int(snap[4].sum()) > 0 and int(snap[1].sum()) > 0
    end = (run.state.done == 0, run.state.iters.clone())
    args = (B, its, snr, seed)
    assert _pool_numbers(code, rows, refill, snap, end, *args) == ZERO
    for s in (1, 11):  # a super-step of the start, then of the end, counted wrong
        bad = [list(r) for r in rows]
        bad[s][3] += 3
        assert _pool_numbers(code, bad, refill, snap, end, *args)["iter_gap"] > 0
        bad[s][0] += 2
        bad[s][1] += 1
        got = _pool_numbers(code, bad, refill, snap, end, *args)
        assert (got["frame_error_count_gap"], got["bit_error_count_gap"]) == (1, 2)
    older = (*snap[:2], snap[2] + (snap[1] & (torch.arange(B) % 2 == 0)).to(snap[2].dtype),
             *snap[3:])
    assert _pool_numbers(code, rows, refill, older, end, *args)["tail_state_gap"] > 0
    e = int(snap[4].nonzero()[0])
    noisy = snap[7].clone()
    noisy[:, e] += 0.5
    other = (*snap[:7], noisy, *snap[8:])
    assert _pool_numbers(code, rows, refill, other, end, *args)["tail_state_gap"] >= 1 / B
    off = (end[0], end[1] + (torch.arange(B) % 7 == 0).to(end[1].dtype))
    assert _pool_numbers(code, rows, refill, snap, off, *args)["tail_lane_gap"] > 0.1
    assert _pool_numbers(code, rows, refill, None, end, *args)["frames_gap"] == 1.0


def _qc_tiny():
    from libldpc_tpu_torch.models.standards import WIFI_648_12

    return build_code({"construction": "qc", "Z": 27, "layers": "natural",
                       "base_matrix": WIFI_648_12.tolist()})


@pytest.mark.parametrize("snr", [0.5, 1.5])
def test_layered_pool_matches_the_programs_plain_fast_chunks(monkeypatch, snr):
    """The pool on the fast layered engine's pass against the program's
    plain chunks (``bp_stream_chunk_layered_fast_plain``): every
    super-step's row and the lanes' flags, ages, counts and entries."""
    code = _qc_tiny()
    B, its, seed = 40, 20, 2**31 + 29
    run = FusedRun(monkeypatch, code, B, its, snr, seed, layered=True)
    graph = Graph(code.rows, code.cols, code.nc, code.mc, "cpu", code.transmitted)
    ref = PoolReference(graph, run.fs, B, its, QUOTA, Layered(graph, code.layers))
    refill = [True] * 10 + [False] * 4
    for s, f in enumerate(refill):
        want = run.step(f)
        got = ref.superstep(step_keys(seed, 0, s, run.n_outer, "cpu"), f)
        assert got == want, (s, got, want)
        st = run.state
        assert torch.equal(ref.active, st.done == 0), s
        assert torch.equal(ref.age, st.age) and torch.equal(ref.iters, st.iters), s
        assert torch.equal(ref.avail, st.avail != 0), s
    assert want[4] == 0


def test_layered_pool_numbers_are_nought_on_the_programs_plain_run(monkeypatch):
    """The pool check with the layered pass on the program's plain fast
    engine: every number 0, though its lanes carry their APP and not their
    prior (found by their codewords); a lane's codeword, a lane's age and
    an unused entry's LLRs each put wrong are caught; and the flooding
    pass's check, which matches LLRs, loses every lane in flight."""
    code = _qc_tiny()
    B, its, snr, seed = 40, 20, 0.5, 2**33 + 1
    run = FusedRun(monkeypatch, code, B, its, snr, seed, layered=True)
    refill = [True] * 8 + [False] * 4
    rows, snap = [], None
    for s, f in enumerate(refill):
        if s == 7:
            snap = (s, *run.lanes())
        rows.append(run.step(f))
    active = snap[1]
    assert rows[-1][4] == 0 and int(active.sum()) > 0 and int(snap[4].sum()) > 0
    lane = int(active.nonzero()[0])
    end = (run.state.done == 0, run.state.iters.clone())
    args = (B, its, snr, seed)
    assert _pool_numbers(code, rows, refill, snap, end, *args, layered=True) == ZERO
    cw = snap[6].clone()
    cw[0, lane] = ~cw[0, lane]
    flipped = (*snap[:6], cw, *snap[7:])
    assert _pool_numbers(code, rows, refill, flipped, end, *args,
                         layered=True)["tail_state_gap"] >= 1 / B
    older = (*snap[:2], snap[2] + active.to(snap[2].dtype), *snap[3:])
    assert _pool_numbers(code, rows, refill, older, end, *args, layered=True)["tail_state_gap"] > 0
    e = int(snap[4].nonzero()[0])
    noisy = snap[7].clone()
    noisy[:, e] += 0.5
    other = (*snap[:7], noisy, *snap[8:])
    assert _pool_numbers(code, rows, refill, other, end, *args,
                         layered=True)["tail_state_gap"] >= 1 / B
    assert _pool_numbers(code, rows, refill, snap, end, *args)["tail_state_gap"] >= \
        int(active.sum()) / B


def test_identify_finds_each_frames_key():
    code = _tiny()
    fs = FrameSource(code.G, 2.0, "cpu")
    keys = [11, 2**40 + 3, 2**61 + 7]
    lanes = torch.arange(30)
    which = lanes % 3
    llr = torch.zeros((code.nc, 30), dtype=torch.float64)
    cw = torch.zeros((code.nc, 30), dtype=torch.bool)
    for i, k in enumerate(keys):
        sel = which == i
        llr[:, sel], cw[:, sel] = fs.draw(k, lanes[sel])
    cw[:, 5] = ~cw[:, 5]  # no key draws it
    llr32 = llr.to(torch.float32)
    found, ref_llr, ref_cw = identify(fs, keys, lanes, llr32, cw, info_columns(code.G))
    want = which.clone()
    want[5] = -1
    assert torch.equal(found, want)
    keep = found >= 0
    assert torch.equal(ref_llr[:, keep], llr[:, keep]) and torch.equal(ref_cw[:, keep], cw[:, keep])


# ---------------------------------------------------------------- puncturing

#: the parent's code files, before configurations could puncture
UNPUNCTURED_SHA256 = {
    "bench1152-bp": {
        "codefile": "436ff0cbb7150dd284fecd442dae3fdd24866b955b3167340516abfc36e5e720",
        "genfile": "3715f0b80782f0ee8a50ac1cb847779493124672e597016847557c56c7ebf64e"},
    "wifi1944-bp": {
        "codefile": "537c6e9e588a320e1587263ad9afbeb3f619179c8c090a9018b0055dabd20212",
        "genfile": "cd370cb90dd0d52b9aa9f6c254a341742d9c27ea698cd39697c7576d23acab13",
        "layerfile": "140697f48e9023b48e0cb9c8057402b44f34dc530cc4efee1b4e27c17f7ab996"},
}


@pytest.mark.parametrize("name", sorted(UNPUNCTURED_SHA256))
def test_unpunctured_code_files_are_unchanged(tmp_path, name):
    code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["code"])
    assert code.puncture.size == 0 and code.nct == code.nc
    files = write_code_files(code, tmp_path)
    got = {k: hashlib.sha256(open(v, "rb").read()).hexdigest() for k, v in files.items() if v}
    assert got == UNPUNCTURED_SHA256[name]


def test_punctured_code_files_load_as_the_command_line_loads_them(tmp_path):
    from libldpc_tpu_torch.models import LDPCCode
    from libldpc_tpu_torch.models.standards import WIFI_648_12

    code = build_code({"construction": "qc", "Z": 27, "layers": "natural",
                       "base_matrix": WIFI_648_12.tolist(), "puncture": [[0, 54], [100, 103]]})
    assert code.puncture.tolist() == list(range(54)) + [100, 101, 102]
    files = write_code_files(code, tmp_path)
    loaded = LDPCCode.from_files(files["codefile"], files["genfile"], files["layerfile"])
    assert loaded.puncture.tolist() == code.puncture.tolist()
    assert loaded.nct == code.nct == code.nc - 57
    assert np.array_equal(loaded.bit_pos, code.transmitted)
    assert np.array_equal(loaded.G, code.G)
    with pytest.raises(ValueError):
        build_code({"construction": "qc", "Z": 27, "base_matrix": WIFI_648_12.tolist(),
                    "puncture": [[600, 700]]})


def test_punctured_frames_draw_the_transmitted_bits():
    code = _nr_like(2, 16)
    assert code.puncture.tolist() == list(range(32))
    fs = FrameSource(code.G, 1.0, "cpu", code.transmitted)
    full = FrameSource(code.G, 1.0, "cpu")
    lanes = torch.arange(64)
    llr, cw = fs.draw(2**45 + 9, lanes)
    assert not llr[:32].any() and llr[32:].ne(0).all()
    # the bit of rank t takes the t-th normal of the unpunctured keying
    r = full.normals(2**45 + 9, lanes)[: code.nct]
    x = 1.0 - 2.0 * cw[32:].double()
    assert torch.allclose(llr[32:], 2.0 * (x + r * fs.sigma) / fs.sigma2, rtol=0, atol=0)
    _, cw_full = full.draw(2**45 + 9, lanes)
    assert torch.equal(cw, cw_full)


@pytest.mark.parametrize("snr", [-2.0, -1.0])
def test_punctured_layered_matches_the_programs_plain_decoder(snr):
    from libldpc_tpu_torch.ops.sorted import bp_decode_sorted, to_sorted_device

    code = _nr_like(2, 16)
    llr, cw = FrameSource(code.G, snr, "cpu", code.transmitted).draw(987654321,
                                                                      torch.arange(64))
    llr32 = llr.to(torch.float32)
    pcode = _program_code(code)
    sdc = to_sorted_device(pcode, "cpu", with_layers=True)
    inv = sdc.vn_inv.long()
    out = bp_decode_sorted(sdc, llr32[torch.argsort(inv)], 20, True, "BP", layered=True)
    errs = (out.hard[inv] != cw)[torch.as_tensor(pcode.bit_pos, dtype=torch.int64)].sum(0)
    ref = decode_layered(checks.graph_of(code, "cpu"), code.layers, llr32.double(), cw, 20)
    assert ref["iter_sum"] == int(out.iterations.sum())
    assert ref["frame_errors"] == int((errs > 0).sum()) > 0
    assert ref["bit_errors"] == int(errs.sum())


@pytest.mark.parametrize("name", ["bench1152-bp", "wifi1944-bp"])
def test_draw_counts_are_unchanged_without_puncturing(name):
    code = build_code(json.loads((spec.HERE / "configs" / f"{name}.json").read_text())["code"])
    assert roofline.draw_frame_ops(code.nc, code.kc, code.nct) == \
        12.0 * code.nc + 2.0 * (-(-code.kc // 32)) * (code.nc - code.kc)
    read = spec.metric_reader("channel_roofline")

    class W:
        @staticmethod
        def device_us_of(match):
            return 1000.0 if match("pool_draw_kernel") else 0.0

    ctx = {"trace": W(), "frames_drawn": 10**6, "code": code}
    least = max(1e6 * (12.0 * code.nc + 2.0 * (-(-code.kc // 32)) * (code.nc - code.kc))
                / roofline.OPS_S, 1e6 * 5.0 * code.nc / roofline.HBM_BYTES_S)
    assert read(ctx) == pytest.approx(100.0 * least / 1e-3, rel=1e-12)


def test_punctured_draw_counts_the_transmitted_bits():
    code = _nr_like(2, 16)
    assert roofline.draw_frame_ops(code.nc, code.kc, code.nct) == \
        roofline.draw_frame_ops(code.nc, code.kc) - 12.0 * code.puncture.size


# ---------------------------------------------------------------- on the card


def _k8_tables(code, device):
    from libldpc_tpu_torch.ops.kernels.pool_refill import pool_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    sdc = to_sorted_device(_program_code(code), device)
    return sdc, pool_tables(sdc, "AWGN")


@pytest.mark.cuda
def test_reference_pool_draw_is_k8s_refill(cuda_device):
    """K8's ``pool_refill`` at the watermark on a chunk's key: the entries
    it redraws hold the reference's draw of their own index, the others
    keep their frames, every entry is unused again."""
    from libldpc_tpu_torch.ops.kernels.pool_refill import pool_refill

    code = build_code(json.loads((spec.HERE / "configs" / "bench1152-bp.json").read_text())
                      ["code"])
    sdc, pt = _k8_tables(code, cuda_device)
    B, key = 16384, step_keys(2**31 + 3, 0, 7, 9, cuda_device)[4]
    avail = (torch.arange(B, device=cuda_device) % 5 == 0).to(torch.int32)  # 4/5 used
    fresh_llr = torch.full((code.nc, B), 7.0, device=cuda_device)
    fresh_cw = torch.zeros((code.nc, B), dtype=torch.uint8, device=cuda_device)
    ctr = torch.zeros((5, B), dtype=torch.int32, device=cuda_device)
    started = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    remaining = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    refill = torch.ones(1, dtype=torch.int32, device=cuda_device)
    used = (avail == 0).nonzero().flatten()
    pool_refill(pt, None, 2.0, refill, avail, fresh_llr, fresh_cw, ctr, started, QUOTA,
                remaining, key=torch.tensor([key], dtype=torch.int64, device=cuda_device))
    torch.cuda.synchronize()
    assert bool((avail == 1).all())
    inv = sdc.vn_inv.long()
    llr, cw = FrameSource(code.G, 2.0, cuda_device).draw(key, used)
    assert torch.equal(fresh_cw[inv][:, used].bool(), cw)
    assert (fresh_llr[inv][:, used].double() - llr).abs().max().item() < 1e-3
    kept = torch.arange(B, device=cuda_device) % 5 == 0
    assert bool((fresh_llr[:, kept] == 7.0).all())


@pytest.mark.cuda
def test_reference_punctured_draw_is_k8s_channel_batch(cuda_device):
    from libldpc_tpu_torch.ops.kernels.pool_refill import channel_batch

    code = _nr_like(2, 64)
    sdc, pt = _k8_tables(code, cuda_device)
    assert pt.item_src.shape[0] == code.nct
    B, key = 4096, 0x2545F4914F6CDD1D
    kt = torch.tensor([key], dtype=torch.int64, device=cuda_device)
    debug = torch.zeros((code.nct, B), dtype=torch.float32, device=cuda_device)
    ch = channel_batch(pt, None, B, 1.0, key=kt, debug=debug)
    inv = sdc.vn_inv.long()
    fs = FrameSource(code.G, 1.0, cuda_device, code.transmitted)
    lanes = torch.arange(B, device=cuda_device)
    assert (debug.double() - fs.normals(key, lanes)).abs().max().item() < 1e-4
    llr, cw = fs.draw(key, lanes)
    assert torch.equal(ch.codeword[inv].bool(), cw)
    got = ch.llr[inv].double()
    assert not got[torch.as_tensor(code.puncture, device=cuda_device)].any()
    assert (got - llr).abs().max().item() < 1e-3
