"""Card tests of the batch decodes' tile forms, K1 (flooding,
``csrc/flood_stream.cuh``) and K3 (the fast layered engine,
``csrc/layered_stream.cuh``), each form forced in turn through the
wrappers' ``BATCH_FORM_OVERRIDE`` and held against its plain version.

* K1: every form (16, 8 and 4 frames a block, tables staged or not, and
  the HBM-plane form) in every CN form and message form, early termination
  on and off, on the 1152 (3,6) code, wifi 1944 and the degree-36 code, at
  a batch that is not a multiple of the frames a block, one iteration too.
* K3: every form (16 and 8 frames a block, staged or not, the HBM-plane
  form) likewise on wifi 1944 and a QC code with checks of degree 36.
* The size rules at the smoke run's shapes, and the fast engine's tile
  bytes against the kernels' own count (``ldpc_fast_tile_bytes``).
* A form forced past shared memory raises, and the error does not reach
  the next launch, of another kernel: K1, K3 and K4 tiles, and K6 with its
  words in shared memory.

(K2 and K4, whose passes the batch tiles now share, are held against their
plain chunks in every form by ``test_torch_tile_kernels.py`` and
``test_torch_redesign_kernels.py``.)

Tolerances as in the other card tests: the min-sum family and the int8
lattice bit-exact in posteriors, iteration counts and codeword flags; the
other CN forms agree in decisions and iteration counts on >= 99.9 % of
frames and within 1e-4 (float32) or one bf16 step (bfloat16) on those
posteriors."""

import pytest
import torch

from libldpc_tpu_torch.models import make_qc_benchmark_code, qc_natural_layers
from libldpc_tpu_torch.ops.kernels import build
from libldpc_tpu_torch.ops.kernels import decode_bec as db
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.ops.streaming_fused import init_state

from test_torch_redesign_kernels import (
    CODES, DTYPE_FORMS, SNR_DB, assert_matches, bec_frames, frames, tol_of,
)

pytestmark = pytest.mark.cuda

#: (frames a block, tables staged); 0 frames is the HBM-plane form
K1_FORMS = [(16, True), (16, False), (8, True), (8, False), (4, True), (0, False)]
K3_FORMS = [(16, True), (16, False), (8, True), (8, False), (0, False)]
B_RAGGED = 301  # no multiple of 4, 8 or 16


def big_qc():
    """A natural-layer QC code of 8192 variables: no tile of K1, K3 or K4
    at 16 frames, and no word of K6, fits a block's shared memory."""
    code = make_qc_benchmark_code(8 * 1024, 1024, dv=3, dc=6, seed=2)
    qc_natural_layers(code)
    return code


BATCH_CODES = {**CODES, "big": big_qc}
BATCH_SNR = {**SNR_DB, "bench1152": 1.5, "big": 2.0}


@pytest.fixture(scope="module")
def built():
    return {}


@pytest.fixture
def tables_of(built, cuda_device):
    def get(name):
        if name not in built:
            code = BATCH_CODES[name]()
            built[name] = (code, kernel_tables(to_sorted_device(code, cuda_device, with_layers=True)))
        return built[name]

    return get


@pytest.fixture
def force():
    """Force a batch form of K1 or K3 (or a stream form of K4) for one test."""
    def set_forms(k1=None, k3=None, k4=None):
        df.BATCH_FORM_OVERRIDE = k1
        dl.BATCH_FORM_OVERRIDE = k3
        dl.STREAM_FORM_OVERRIDE = k4

    yield set_forms
    df.BATCH_FORM_OVERRIDE = None
    dl.BATCH_FORM_OVERRIDE = None
    dl.STREAM_FORM_OVERRIDE = None


def k1_fits(tables, forced, dtype):
    frames_, stage = forced
    return frames_ == 0 or df.flood_tile_bytes(tables, frames_, dtype, stage) <= df.SMEM_BLOCK_BYTES


def k3_fits(tables, forced):
    frames_, stage = forced
    return frames_ == 0 or dl.fast_tile_bytes(tables, frames_, stage) <= dl.SMEM_BLOCK_BYTES


def _held(built, kernel, plain, module, forced, fits, tables, llr, iterations, early_term, form,
          dtype, key):
    """``kernel`` in the form ``forced`` against ``plain`` (cached under
    ``key``): the launch raises when the form does not fit."""
    module.BATCH_FORM_OVERRIDE = forced
    if not fits:
        with pytest.raises(RuntimeError, match="launch failed"):
            kernel(tables, llr, iterations, early_term, form, dtype)
        return
    launches = kernel.launches[dtype]
    got = kernel(tables, llr, iterations, early_term, form, dtype)
    assert kernel.launches[dtype] == launches + 1
    assert kernel.last_form == forced
    if key not in built:
        built[key] = plain(tables, llr, iterations, early_term, form, dtype)
    torch.cuda.synchronize()
    assert_matches(got, built[key], form, tol_of(dtype))
    if not early_term:
        assert bool((got.iterations == iterations).all())


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("k1", K1_FORMS)
@pytest.mark.parametrize("name", ["bench1152", "wifi1944", "regular36"])
def test_flood_batch_forms(tables_of, force, built, name, k1, dtype, form, early_term):
    code, tables = tables_of(name)
    llr, _ = frames(code, tables, B_RAGGED, BATCH_SNR[name], seed=21)
    for iterations in (1, 12):
        _held(built, df.bp_decode_fused, df.bp_decode_fused_plain, df, k1,
              k1_fits(tables, k1, dtype), tables, llr, iterations, early_term, form, dtype,
              ("k1", name, iterations, dtype, str(form), early_term))


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("k3", K3_FORMS)
@pytest.mark.parametrize("name", ["wifi1944", "qc36"])
def test_fast_batch_forms(tables_of, force, built, name, k3, dtype, form, early_term):
    code, tables = tables_of(name)
    assert tables.layers_disjoint
    llr, _ = frames(code, tables, B_RAGGED, BATCH_SNR[name], seed=22)
    for iterations in (1, 12):
        _held(built, dl.bp_decode_layered_fast, dl.bp_decode_layered_fast_plain, dl, k3,
              k3_fits(tables, k3), tables, llr, iterations, early_term, form, dtype,
              ("k3", name, iterations, dtype, str(form), early_term))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_batch_forms_at_full_batch(tables_of, dtype):
    """The rules' forms at B = 16384 (the smoke run's shape) against the
    plain versions, min-sum, early termination on."""
    form = "BP_MS"
    for name, kernel, plain in (("bench1152", df.bp_decode_fused, df.bp_decode_fused_plain),
                                ("wifi1944", df.bp_decode_fused, df.bp_decode_fused_plain),
                                ("wifi1944", dl.bp_decode_layered_fast,
                                 dl.bp_decode_layered_fast_plain)):
        code, tables = tables_of(name)
        llr, _ = frames(code, tables, 16384, 2.0, seed=23)
        got = kernel(tables, llr, 20, True, form, dtype)
        assert kernel.last_form[0] > 0
        want = plain(tables, llr, 20, True, form, dtype)
        torch.cuda.synchronize()
        assert_matches(got, want, form, tol_of(dtype))


def test_batch_form_rules(tables_of):
    _, bench = tables_of("bench1152")
    _, wifi = tables_of("wifi1944")
    dtypes = ("float32", "bfloat16", "int8")
    assert [df.batch_form(bench, dt) for dt in dtypes] == [(8, True), (16, True), (16, True)]
    assert [df.batch_form(wifi, dt) for dt in dtypes] == [(4, True), (8, True), (16, True)]
    assert [df.batch_form(t, dt) for t in (bench, wifi) for dt in dtypes] == [
        df.stream_form(t, dt) for t in (bench, wifi) for dt in dtypes]
    assert dl.batch_form(wifi) == dl.stream_form(wifi) == (16, True)
    _, big = tables_of("big")
    assert dl.batch_form(big) == (0, False)
    assert [df.batch_form(big, dt) for dt in dtypes] == [(0, False), (0, False), (4, False)]


@pytest.mark.parametrize("name", ["bench1152", "wifi1944", "qc36", "big"])
def test_fast_tile_bytes_match_the_kernels(tables_of, name):
    """K3's and K4's size rule counts a tile's shared memory as their
    launchers do (K1's is K2's count, ``ldpc_flood_tile_bytes``, held in
    ``test_torch_tile_kernels.py``)."""
    lib = build.load()
    _, t = tables_of(name)
    c = t.code
    for frames_ in (16, 8):
        for stage in (True, False):
            assert dl.fast_tile_bytes(t, frames_, stage) == lib.ldpc_fast_tile_bytes(
                c.nc, c.mc, c.nnz, t.n_layers, t.layer_checks.shape[0], frames_, int(stage))


def _launch_refused(kind, tables, llr, cw, monkeypatch, force):
    if kind == "k1":
        force(k1=(16, False))
        df.bp_decode_fused(tables, llr, 4, True, "BP_MS")
    elif kind == "k3":
        force(k3=(16, False))
        dl.bp_decode_layered_fast(tables, llr, 4, True, "BP_MS")
    elif kind == "k4":
        force(k4=(16, False))
        st = init_state(tables, llr.shape[1])
        st.llr_in.copy_(llr)
        st.codeword.copy_(cw)
        st.done.zero_()
        zero = torch.zeros(1, dtype=torch.int32, device=llr.device)
        dl.bp_stream_chunk_layered_fast(
            tables, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
            st.fresh_llr, st.fresh_cw, zero, zero.clone(), k=2, cap=4, minsum_mode="BP_MS")
    else:  # K6 with its words in shared memory, whatever their size
        monkeypatch.setattr(db, "words_in_shared", lambda tables_: True)
        sym, cw_ = bec_frames(tables, llr.shape[1], 0.05, seed=3)
        db.bec_decode_fused(tables, sym, cw_, 4, True)


@pytest.mark.parametrize("kind", ["k1", "k3", "k4", "k6"])
def test_refused_form_leaves_no_error(tables_of, force, monkeypatch, kind):
    """A form forced past shared memory raises at its launch; the refused
    limit is cleared, so the next launch, of another kernel, succeeds."""
    code, big = tables_of("big")
    llr, cw = frames(code, big, 64, BATCH_SNR["big"], seed=24)
    with pytest.raises(RuntimeError, match="launch failed"):
        _launch_refused(kind, big, llr, cw, monkeypatch, force)
    force()
    monkeypatch.undo()
    code2, bench = tables_of("bench1152")
    llr2, _ = frames(code2, bench, 64, 1.5, seed=25)
    got = df.bp_decode_fused(bench, llr2, 8, True, "BP_MS")
    want = df.bp_decode_fused_plain(bench, llr2, 8, True, "BP_MS")
    torch.cuda.synchronize()
    assert_matches(got, want, "BP_MS", 0.0)
