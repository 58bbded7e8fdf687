"""The layered CUDA decode kernels against their plain PyTorch versions, on
the card, on the same inputs, in each message form (float32, bfloat16, the
int8 lattice; int8 with the min-sum family only): the fast QC engine (batch
and streaming) and the exact layered schedule.  Min-sum forms are bit-exact
(the kernels are built with -fmad=false and follow the plain versions'
operation order); the other forms are held to identical decisions and
iteration counts on >= 99.9% of frames and, on their posteriors, 1e-4 in
float32, one bf16 step (2^-8) on the fast engine's float32 APP and eight
(2^-4) on the exact schedule's bf16 posterior, which is recomputed from
every stored message after each layer.

The exact schedule's every form is forced in turn on wifi 1944 and on the
1152 (3,6) code in four layers of uneven size (50, 150, 220 and 156
checks), at a batch that is no multiple of 4, 16 or 32: the tiles of 16, 8
and 4 frames a block (tables staged or not), and the plane form (its
messages, posterior and decisions in device memory).  A tile forced past a
block's shared memory raises; the tile's Python byte counts are held to
the library's.  On wifi 1944 and wifi 1296 the rule's tile with its 16-bit
tables staged is bit-identical to the same tile reading them from device
memory, in every message form and CN family, and counts its launches while
a profile records.  Where the rule keeps the frames' priors in shared
memory (wifi 1944 float32, wifi 648 bfloat16 and int8), the tile is
bit-identical to the same tile reading them from device memory."""

import dataclasses

import numpy as np
import pytest
import torch

from libldpc_tpu_torch.models import make_benchmark_code, make_qc_benchmark_code, qc_natural_layers, wifi_code
from libldpc_tpu_torch.ops.kernels import build
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.messages import TORCH_DTYPES
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state
from libldpc_tpu_torch.sim.driver import ChannelParams, DecoderParams, SimulationParams, Simulator

pytestmark = pytest.mark.cuda

MINSUM = ["BP_MS", ("BP_NMS", 0.75, 0.15), ("BP_OMS", 0.75, 0.15)]
FORMS = MINSUM + ["BP", "BP_PHI", "BP_TANH", "BP_LIN"]
#: (message dtype, CN form): every form in float32 and bfloat16, the
#: min-sum family on the int8 lattice
DTYPE_FORMS = ([("float32", f) for f in FORMS] + [("bfloat16", f) for f in FORMS]
               + [("int8", f) for f in MINSUM])


def _qc_code():
    code = make_qc_benchmark_code(8 * 128, 128, dv=3, dc=6, seed=5, with_G=True)
    qc_natural_layers(code)
    return code


def _two_layer_code():
    code = dataclasses.replace(make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True))
    code.layers = [np.arange(0, code.mc, 2, dtype=np.int32), np.arange(1, code.mc, 2, dtype=np.int32)]
    return code


def _uneven_layers():
    """The 1152 (3,6) code in four layers of 50, 150, 220 and 156 checks."""
    code = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    code.layers = [np.arange(a, b, dtype=np.int32) for a, b in ((0, 50), (50, 200), (200, 420),
                                                               (420, code.mc))]
    return code


CODES = {"wifi1944": lambda: wifi_code(1944), "qc1024": _qc_code, "wifi648": lambda: wifi_code(648),
         "two_layer96": _two_layer_code, "uneven": _uneven_layers,
         "wifi1296": lambda: wifi_code(1296)}


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def tables_of(built, cuda_device):
    """``tables_of(name) -> (code, KernelTables on the card)``, built once
    per module."""

    def get(name):
        if name not in built:
            code = CODES[name]()
            built[name] = (code, kernel_tables(to_sorted_device(code, cuda_device, with_layers=True)))
        return built[name]

    return get


def frames(code, vn_perm, B, snr_db, seed):
    """Random codewords and their AWGN LLRs, made with numpy (sorted labels)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(code.G.shape[0], B))
    cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    sigma2 = 10 ** (-snr_db / 10)
    llr = np.zeros((code.nc, B), np.float32)
    x = 1.0 - 2.0 * cw[code.bit_pos]
    llr[code.bit_pos] = 2.0 * (x + rng.normal(size=x.shape) * np.sqrt(sigma2)) / sigma2
    vn_perm = np.asarray(vn_perm)
    return np.ascontiguousarray(llr[vn_perm]), np.ascontiguousarray(cw[vn_perm])


def assert_matches(got, want, form, tol=1e-4):
    same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
    if form in MINSUM:
        assert same.all() and torch.equal(got.llr_out, want.llr_out)
        assert torch.equal(got.is_codeword, want.is_codeword)
    else:
        assert same.float().mean() >= 0.999
        torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same],
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B", [300, 64])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
def test_fast_kernel_matches_plain(tables_of, cuda_device, dtype, form, early_term, B):
    code, tables = tables_of("wifi1944" if B == 300 else "qc1024")
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B, 1.5, seed=9)
    x = torch.from_numpy(llr).to(cuda_device)
    launches = dl.bp_decode_layered_fast.launches[dtype]
    got = dl.bp_decode_layered_fast(tables, x, 12, early_term, form, dtype)
    want = dl.bp_decode_layered_fast_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert dl.bp_decode_layered_fast.launches[dtype] == launches + 1
    assert_matches(got, want, form, 1e-4 if dtype == "float32" else 2 ** -8)


@pytest.mark.parametrize("B", [300, 64])
@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
def test_exact_kernel_matches_plain(tables_of, cuda_device, dtype, form, early_term, B):
    code, tables = tables_of("wifi648" if B == 300 else "two_layer96")
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B, 1.5, seed=9)
    x = torch.from_numpy(llr).to(cuda_device)
    launches = dl.bp_decode_layered.launches[dtype]
    got = dl.bp_decode_layered(tables, x, 12, early_term, form, dtype)
    want = dl.bp_decode_layered_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert dl.bp_decode_layered.launches[dtype] == launches + 1
    assert dl.bp_decode_layered.last_form == dl.exact_form(tables, dtype)
    assert_matches(got, want, form, 1e-4 if dtype == "float32" else 2 ** -4)


def test_zero_iterations_launch_nothing(tables_of, cuda_device):
    code, tables = tables_of("wifi648")
    x = torch.ones(code.nc, 5, device=cuda_device)
    counts = (dict(dl.bp_decode_layered.launches), dict(dl.bp_decode_layered_fast.launches))
    for fn in (dl.bp_decode_layered, dl.bp_decode_layered_fast):
        assert not fn(tables, x, 0).is_codeword.any()
    assert (dl.bp_decode_layered.launches, dl.bp_decode_layered_fast.launches) == counts


def test_rejects_bad_input(tables_of, cuda_device):
    code, tables = tables_of("two_layer96")
    x = torch.zeros(code.nc, 4, device=cuda_device)
    with pytest.raises(ValueError, match="llr_in"):
        dl.bp_decode_layered(tables, x.double(), 5)
    with pytest.raises(ValueError, match="is on cpu"):
        dl.bp_decode_layered(tables, x.cpu(), 5)
    with pytest.raises(ValueError, match="at most once"):  # even/odd layers reuse variables
        dl.bp_decode_layered_fast(tables, x, 5)
    flat = kernel_tables(to_sorted_device(code, cuda_device))
    with pytest.raises(ValueError, match=">= 2 layers"):
        dl.bp_decode_layered(flat, x, 5)


def _chunk(fn, tables, st, refill, remaining, k, cap, form, dtype="float32"):
    fn(tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
       st.fresh_llr, st.fresh_cw, refill, remaining, k=k, cap=cap, minsum_mode=form,
       message_dtype=dtype)


@pytest.mark.parametrize("dtype,form", [("float32", "BP_MS"), ("float32", "BP"),
                                        ("bfloat16", "BP_MS"), ("bfloat16", "BP"),
                                        ("int8", "BP_MS"), ("int8", ("BP_OMS", 0.75, 0.15))])
@pytest.mark.parametrize("via_pool", [False, True])
def test_stream_kernel_drains_like_plain(tables_of, cuda_device, dtype, form, via_pool):
    """Frames injected (age 0: the engine starts from their prior) or
    started from a full pool by the kernel's reload; min-sum totals exact,
    BP's too at this seed."""
    code, tables = tables_of("wifi1944")
    B = 300
    llr, cw = frames(code, tables.code.vn_perm.cpu(), B, 1.0, seed=4)
    refill = torch.full((1,), int(via_pool), dtype=torch.int32, device=cuda_device)
    totals = []
    for fn in (dl.bp_stream_chunk_layered_fast, dl.bp_stream_chunk_layered_fast_plain):
        st = init_state(tables, B, message_dtype=dtype)
        if via_pool:
            st.fresh_llr.copy_(torch.from_numpy(llr))
            st.fresh_cw.copy_(torch.from_numpy(cw))
            st.avail.fill_(1)
        else:
            st.llr_in.copy_(torch.from_numpy(llr))
            st.codeword.copy_(torch.from_numpy(cw))
            st.done.zero_()
        remaining = torch.full((1,), B, dtype=torch.int32, device=cuda_device)
        for _ in range(6):
            _chunk(fn, tables, st, refill, remaining, 5, 12, form, dtype)
        totals.append(st.ctr.sum(1).tolist())
    assert totals[0] == totals[1] and totals[0][2] == B


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("quota", [0, 48, 299, 1000])
def test_stream_kernel_quota_exact(tables_of, cuda_device, quota, dtype):
    code, tables = tables_of("wifi1944")
    B = 300
    llr, cw = frames(code, tables.code.vn_perm.cpu(), B, 2.0, seed=1)
    st = init_state(tables, B, message_dtype=dtype)
    st.fresh_llr.copy_(torch.from_numpy(llr))
    st.fresh_cw.copy_(torch.from_numpy(cw))
    st.avail.fill_(1)
    remaining = torch.full((1,), quota, dtype=torch.int32, device=cuda_device)
    launches = dl.bp_stream_chunk_layered_fast.launches[dtype]
    _chunk(dl.bp_stream_chunk_layered_fast, tables, st,
           torch.ones(1, dtype=torch.int32, device=cuda_device), remaining, 3, 12, "BP_MS", dtype)
    assert dl.bp_stream_chunk_layered_fast.launches[dtype] == launches + 1
    assert int(st.ctr[4].sum()) == min(quota, B) == B - int(st.avail.sum())


@pytest.mark.parametrize("dtype,form", [("float32", "BP"), ("bfloat16", "BP"),
                                        ("int8", "BP_OMS")])
@pytest.mark.parametrize("name,schedule,streaming,kernel", [
    ("wifi1944", "layered-fast", True, "bp_stream_chunk_layered_fast"),
    ("wifi648", "layered", False, "bp_decode_layered"),
])
def test_simulator_on_card(tables_of, cuda_device, tmp_path, name, schedule, streaming, kernel,
                           dtype, form):
    code, _ = tables_of(name)
    sim = Simulator(
        code, DecoderParams(iterations=10, layered=True, type=form, message_dtype=dtype),
        ChannelParams(seed=3, x_range=(1.0, 3.01, 1.0)),
        SimulationParams(batch_size=512, fec=20, max_frames=50000,
                         result_file=str(tmp_path / "r.txt")),
        device=cuda_device, verbose=False, use_pallas=True,
    )
    assert sim.schedule == schedule and sim._streaming == streaming
    fn = getattr(dl, kernel)
    launches = fn.launches[dtype]
    res = sim.start()
    assert fn.launches[dtype] > launches
    assert res.fer[0] > res.fer[-1] and (res.frames > 0).all()
    assert (tmp_path / "r.txt").read_text().startswith(
        f"# kernel=cuda-fused dtype={dtype} cn={form} schedule={schedule}")


#: every form of the exact kernel: (label, EXACT_FORM_OVERRIDE); frames 0
#: is the plane form (lc2v, the posterior and the decisions in device
#: memory); "p": the tile's priors in shared memory
EXACT_FORMS = ([(f"tile{f}{'s' if s else ''}{'p' if p else ''}", (f, s, p)) for f in (16, 8, 4)
                for s in (True, False) for p in (False, True)] + [("plane", (0, False, False))])
B_RAGGED = 301  # no multiple of 4, 16 or 32


@pytest.fixture
def force_exact():
    def set_form(tile):
        dl.EXACT_FORM_OVERRIDE = tile

    yield set_form
    dl.EXACT_FORM_OVERRIDE = None


def _fits(tables, tile, dtype):
    return (tile[0] == 0
            or dl.exact_tile_bytes(tables, tile[0], dtype, tile[1], tile[2]) <= dl.SMEM_BLOCK_BYTES)


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("label,tile", EXACT_FORMS, ids=[f[0] for f in EXACT_FORMS])
@pytest.mark.parametrize("name", ["wifi1944", "uneven"])
def test_exact_kernel_every_form(tables_of, built, force_exact, name, label, tile, dtype, form,
                                 early_term):
    code, tables = tables_of(name)
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B_RAGGED, 1.5 if name == "uneven" else 1.8,
                    seed=21)
    x = torch.from_numpy(llr).to(tables.device)
    force_exact(tile)
    if not _fits(tables, tile, dtype):  # forced past shared memory: the launch raises
        with pytest.raises(RuntimeError, match="launch failed"):
            dl.bp_decode_layered(tables, x, 12, early_term, form, dtype)
        return
    launches = dl.bp_decode_layered.launches[dtype]
    got = dl.bp_decode_layered(tables, x, 12, early_term, form, dtype)
    assert dl.bp_decode_layered.launches[dtype] == launches + 1
    assert dl.bp_decode_layered.last_form == tile
    key = ("exact plain", name, dtype, str(form), early_term)
    if key not in built:
        built[key] = dl.bp_decode_layered_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert_matches(got, built[key], form, 1e-4 if dtype == "float32" else 2 ** -4)


def test_exact_rules_on_wifi1944(tables_of):
    _, tables = tables_of("wifi1944")
    dts = ("float32", "bfloat16", "int8")
    assert [dl.exact_form(tables, dt) for dt in dts] == [(4, True, True), (4, True, True),
                                                         (4, False, True)]


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("name", ["wifi1944", "wifi1296"])
def test_exact_staged_tables_bit_identical_to_unstaged(tables_of, built, force_exact, name, dtype,
                                                       form, early_term):
    """The rule's tile with its 16-bit tables staged in shared memory and the
    same tile reading them from device memory: the same ``llr_out``,
    ``iterations`` and ``is_codeword`` for every frame; both held to the
    plain version."""
    code, tables = tables_of(name)
    tile, _, priors = dl.exact_form(tables, dtype)
    assert tile and dl.exact_tile_bytes(tables, tile, dtype, True, priors) <= dl.SMEM_BLOCK_BYTES
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B_RAGGED, 1.8, seed=23)
    x = torch.from_numpy(llr).to(tables.device)
    outs = []
    for stage in (True, False):
        force_exact((tile, stage, priors))
        outs.append(dl.bp_decode_layered(tables, x, 12, early_term, form, dtype))
        assert dl.bp_decode_layered.last_form == (tile, stage, priors)
    staged, unstaged = outs
    key = ("exact plain staged", name, dtype, str(form), early_term)
    if key not in built:
        built[key] = dl.bp_decode_layered_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert torch.equal(staged.llr_out, unstaged.llr_out)
    assert torch.equal(staged.iterations, unstaged.iterations)
    assert torch.equal(staged.is_codeword, unstaged.is_codeword)
    for got in outs:
        assert_matches(got, built[key], form, 1e-4 if dtype == "float32" else 2 ** -4)


#: the codes and message forms whose rule's tile keeps its priors in shared memory
PRIOR_STAGED = ([("wifi1944", dt) for dt in ("float32", "bfloat16", "int8")]
                + [(n, dt) for n in ("wifi1296", "wifi648") for dt in ("bfloat16", "int8")])


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("name,dtype,form", [(n, dt, f) for n, dt in PRIOR_STAGED
                                             for d, f in DTYPE_FORMS if d == dt])
def test_exact_staged_priors_bit_identical_to_device_priors(tables_of, built, force_exact, name,
                                                            dtype, form, early_term):
    """The rule's tile with its frames' priors in shared memory and the same
    tile reading them from device memory at every variable phase: the same
    ``llr_out``, ``iterations`` and ``is_codeword`` for every frame; both
    held to the plain version."""
    code, tables = tables_of(name)
    tile, stage, priors = dl.exact_form(tables, dtype)
    assert tile and priors
    llr, _ = frames(code, tables.code.vn_perm.cpu(), B_RAGGED, 1.8, seed=29)
    x = torch.from_numpy(llr).to(tables.device)
    outs = []
    for priors in (True, False):
        force_exact((tile, stage, priors))
        outs.append(dl.bp_decode_layered(tables, x, 12, early_term, form, dtype))
        assert dl.bp_decode_layered.last_form == (tile, stage, priors)
    on_chip, in_memory = outs
    key = ("exact plain priors", name, dtype, str(form), early_term)
    if key not in built:
        built[key] = dl.bp_decode_layered_plain(tables, x, 12, early_term, form, dtype)
    torch.cuda.synchronize()
    assert torch.equal(on_chip.llr_out, in_memory.llr_out)
    assert torch.equal(on_chip.iterations, in_memory.iterations)
    assert torch.equal(on_chip.is_codeword, in_memory.is_codeword)
    for got in outs:
        assert_matches(got, built[key], form, 1e-4 if dtype == "float32" else 2 ** -4)


def test_exact_tile_forced_without_16_bit_tables_raises(cuda_device, force_exact):
    """A code whose layers repeat its checks past 65,535 layer entries has no
    16-bit tables: the rule keeps the plane form, which decodes it, and a
    tile forced on it raises before any launch."""
    code = _two_layer_code()
    code.layers = [np.arange(code.mc, dtype=np.int32)] * 1366 + [code.layers[0]]
    tables = kernel_tables(to_sorted_device(code, cuda_device, with_layers=True))
    assert tables.exact16 is None and dl.exact_form(tables) == (0, False, False)
    x = torch.randn(code.nc, 40, device=cuda_device) * 2 + 1.5
    assert dl.bp_decode_layered(tables, x, 1, False, "BP_MS").llr_out.shape == (code.nc, 40)
    assert dl.bp_decode_layered.last_form == (0, False, False)
    force_exact((16, True))
    with pytest.raises(ValueError, match="16-bit tables"):
        dl.bp_decode_layered(tables, x, 1, False, "BP_MS")


def test_exact_tile_launches_counted_while_profiling(tables_of):
    """``exact.launches``, ``exact.staged_launches`` and
    ``exact.prior_staged_launches`` count the tile launches while a profile
    records (the rule stages wifi 1944's float32 tables and priors), and
    nothing without one."""
    from libldpc_tpu_torch.utils import profiling

    code, tables = tables_of("wifi1944")
    x = torch.randn(code.nc, 64, device=tables.device) * 2 + 1.5
    profiling.reset_counters()
    dl.bp_decode_layered(tables, x, 2, False, "BP_MS")
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            dl.bp_decode_layered(tables, x, 2, False, "BP_MS")
        torch.cuda.synchronize()
    got = profiling.counters()
    profiling.reset_counters()
    assert got["exact.launches"] == got["exact.staged_launches"] == 3
    assert got["exact.prior_staged_launches"] == 3


@pytest.mark.parametrize("name", ["wifi1944", "uneven", "wifi648", "wifi1296"])
def test_exact_bytes_match_the_library(tables_of, name):
    """The tile form's shared memory, counted in Python as the launchers
    count it, in every message form, frames a block, staging of the tables
    and of the priors."""
    lib = build.load()
    _, t = tables_of(name)
    c = t.code
    shape = (c.nc, c.mc, c.nnz, t.n_layers, t.layer_checks.shape[0], t.layer_vars.shape[0])
    for dtype in ("float32", "bfloat16", "int8"):
        msg = TORCH_DTYPES[dtype].itemsize
        for stage in (True, False):
            for f in (16, 8, 4):
                for priors in (True, False):
                    assert dl.exact_tile_bytes(t, f, dtype, stage, priors) == \
                        lib.ldpc_exact_tile_bytes(*shape, f, msg, int(stage), int(priors))


def test_exact_plane_form_allocates_no_lv2c(tables_of, force_exact):
    """The plane form's device memory: the posterior out, ``lc2v`` and the
    packed decisions, no ``lv2c`` plane."""
    code, tables = tables_of("wifi1944")
    B = 4096
    x = torch.randn(code.nc, B, device=tables.device) * 2 + 1.5
    force_exact((0, False))
    dl.bp_decode_layered(tables, x, 2, False, "BP_MS")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dl.bp_decode_layered(tables, x, 2, False, "BP_MS")
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    # at most: post, lc2v, iters, iscw, a widened llr_out, the hard
    # decisions and the packed ones; an lv2c plane would add nnz * B * 4
    # bytes (114 MB)
    want = (code.nc + tables.code.nnz) * B * 4 + 2 * B * 4 + code.nc * B * 4 + B * code.nc
    assert grown <= want + (B + 15) // 16 * code.nc * 2 + (1 << 20)
