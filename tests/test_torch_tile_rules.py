"""The tables and size rules of the tile forms of the flooding streaming
kernel (K2) and of the exact layered kernel (K5), on the CPU: pure
arithmetic, no kernel runs.

* ``KernelTables.layer_vars``: per layer, the variables its checks reach,
  against the union of ``col_sorted`` over the JAX package's layer masks.
* ``decode_fused.stream_form`` and ``decode_layered.exact_form`` on the
  codes of the smoke run (``PERF.md`` section 4) in every message form, and
  on a code too large for any tile, which keeps the HBM-plane form; the
  byte counts match the kernels' shared-memory layouts.
* ``decode_layered.exact_form`` past the tiles: the plane form exactly
  where no 4-frame tile fits, on the (3,6) QC codes it was timed on.
* ``decode_fused.tile_form``, the rule all three tile kernels share (K2,
  K4, K5): the most frames whose tile keeps its tables on chip, staged or
  in the L1 left beside it; K4's ``stream_form`` through it picks what its
  own rule picked.
* ``KernelTables.exact16``, the 16-bit tables of K5's tiles: entry for
  entry the int32 tables; 16 bits hold every entry of a code whose
  smallest tile fits; staged, they take 2 bytes an entry, 4-byte aligned.
* K5's frames' priors in shared memory: 4 bytes a variable and frame
  after the tile, 16-byte aligned; ``exact_form`` takes them where the tile
  rule with them keeps the frames it gives without them, or frames enough
  to keep ``EXACT_BUSY_CHECKS`` threads busy in a layer's checks.
"""

import dataclasses

import numpy as np
import pytest

from libldpc_tpu.models import make_benchmark_code, wifi_code
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import LDPCCode, make_qc_benchmark_code, qc_natural_layers
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import TABLE16_MAX, kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device

DTYPES = ("float32", "bfloat16", "int8")


def even_odd(code):
    return dataclasses.replace(code, layers=[np.arange(0, code.mc, 2, dtype=np.int32),
                                             np.arange(1, code.mc, 2, dtype=np.int32)])


def tables_of(jcode):
    return kernel_tables(to_sorted_device(code_from_jax(jcode), "cpu", with_layers=True))


@pytest.mark.parametrize("name", ["wifi648", "wifi1944", "even_odd"])
def test_layer_vars_are_the_union_of_each_layers_columns(name):
    jcode = (even_odd(make_benchmark_code(96, dv=3, dc=6, seed=7)) if name == "even_odd"
             else wifi_code(int(name[4:])))
    jsdc = jsorted.to_sorted_device(jcode, with_layers=True)
    masks, col = np.asarray(jsdc.layer_edge_masks), np.asarray(jsdc.col_sorted)
    tables = tables_of(jcode)
    ptr, lvars = tables.layer_var_ptr.numpy(), tables.layer_vars.numpy()
    assert ptr.tolist()[0] == 0 and len(ptr) == masks.shape[0] + 1
    for l, mask in enumerate(masks):
        np.testing.assert_array_equal(lvars[ptr[l]:ptr[l + 1]], np.unique(col[mask]))
    if name != "even_odd":  # layers that reach each variable once: at most nnz in all
        assert tables.layers_disjoint and lvars.size == tables.code.nnz


def test_no_layers_no_layer_vars():
    tables = kernel_tables(to_sorted_device(code_from_jax(make_benchmark_code(96, 3, 6, seed=7)),
                                            "cpu"))
    assert tables.layer_var_ptr.tolist() == [0] and tables.layer_vars.numel() == 0


@pytest.fixture(scope="module")
def smoke_codes():
    return {"bench1152": tables_of(make_benchmark_code(1152, 3, 6, seed=0)),
            "wifi1944": tables_of(wifi_code(1944)), "wifi648": tables_of(wifi_code(648)),
            "wifi1296": tables_of(wifi_code(1296))}


#: the rules' choice per code and message form: (frames, tables staged)
K2_RULE = {
    "bench1152": [(8, True), (16, True), (16, True)],
    "wifi1944": [(4, True), (8, True), (16, True)],
    "wifi648": [(16, True), (16, True), (16, True)],
    "wifi1296": [(8, False), (16, False), (16, True)],
}
K5_RULE = {
    "wifi648": [(16, True, False), (16, True, True), (16, True, True)],
    "wifi1296": [(8, True, False), (8, True, True), (8, False, True)],
    "wifi1944": [(4, True, True), (4, True, True), (4, False, True)],
}
#: K5's tile rule on the tiles without their priors (``exact_tile_form``)
K5_TILES = {
    "wifi648": [(16, True), (16, True), (16, True)],
    "wifi1296": [(8, True), (16, True), (16, False)],
    "wifi1944": [(4, True), (8, True), (8, False)],
}


@pytest.mark.parametrize("name", list(K2_RULE))
def test_stream_form_rule(smoke_codes, name):
    tables = smoke_codes[name]
    assert [df.stream_form(tables, dt) for dt in DTYPES] == K2_RULE[name]
    for dt, (frames, stage) in zip(DTYPES, K2_RULE[name]):
        assert df.flood_tile_bytes(tables, frames, dt, stage) <= df.SMEM_BLOCK_BYTES
        if frames < 16:  # the next size up does not fit
            assert df.flood_tile_bytes(tables, 2 * frames, dt, False) > df.SMEM_BLOCK_BYTES


def test_stream_tile_bytes_layout(smoke_codes):
    """``flood_tile_bytes`` + ``flood_table_bytes`` of the 1152 (3,6) code:
    lc2v and posterior tiles, uint16 decisions, four int32 tables."""
    t = smoke_codes["bench1152"]
    assert df.flood_tile_bytes(t, 8, "float32", False) == (3456 + 1152) * 8 * 4 + 1152 * 2
    assert df.flood_tile_bytes(t, 8, "float32", True) == 184328
    assert df.flood_tile_bytes(t, 16, "int8", True) == 110600


@pytest.mark.parametrize("name", list(K5_RULE))
def test_exact_form_rule(smoke_codes, name):
    tables = smoke_codes[name]
    assert [dl.exact_form(tables, dt) for dt in DTYPES] == K5_RULE[name]
    assert dl.exact_tile_bytes(smoke_codes["wifi648"], 16, "float32", True) == 211736


def test_exact_form_int8_takes_two_blocks_an_sm(smoke_codes):
    """int8 (two blocks an SM): the most frames whose unstaged tile lets two
    blocks share an SM, whatever the L1 holds; float32 and bfloat16 keep
    ``tile_form``'s tables-on-chip rule over 16, 8 and 4 frames."""
    two = df.SMEM_SM_BYTES // 2 - 1024
    for name, (frames, stage) in zip(("wifi648", "wifi1296", "wifi1944"),
                                     ((16, True), (8, False), (4, False))):
        t = smoke_codes[name]
        assert dl.exact_form(t, "int8") == (frames, stage, True)
        assert dl.exact_tile_bytes(t, frames, "int8", stage, True) <= two
        if frames < 16:
            assert dl.exact_tile_bytes(t, 2 * frames, "int8", False, True) > two
    t = smoke_codes["wifi1944"]
    for dt in ("float32", "bfloat16"):
        assert dl.exact_form(t, dt) == (*df.tile_form(
            lambda frames, stage: dl.exact_tile_bytes(t, frames, dt, stage, True), (16, 8, 4)),
            True)


@pytest.mark.parametrize("nc,dtype,frames", [
    (4800, "float32", 0), (4800, "bfloat16", 4), (8000, "bfloat16", 0), (8000, "int8", 4),
    (16000, "int8", 0)])
def test_exact_form_past_the_tiles_is_the_plane_form(nc, dtype, frames):
    """The (3,6) QC codes of ``tests_gpu/k5_forms.py`` (N variables in 50
    columns of circulants, 25 layers): the 4-frame tile where it fits, else
    the plane form, which keeps nothing in shared memory."""
    code = make_qc_benchmark_code(nc, nc // 50, seed=0)
    qc_natural_layers(code)
    t = kernel_tables(to_sorted_device(code, "cpu", with_layers=True))
    assert t.n_layers == 25
    assert dl.exact_form(t, dtype) == (frames, False, False)
    assert (dl.exact_tile_bytes(t, 4, dtype, False) <= df.SMEM_BLOCK_BYTES) == (frames == 4)
    assert dl.exact_tile_bytes(t, 8, dtype, False) > df.SMEM_BLOCK_BYTES


@pytest.mark.parametrize("tile16_kb,table_kb,per_sm,want", [
    # one block an SM, a 16-frame tile of 190 KB: 60 KB of L1 beside it
    (190, 50, 1, (16, False)),   # 16 frames fit only unstaged, their tables fit the L1 left
    (190, 70, 1, (8, True)),     # ... they do not: 8 frames, staged
    (190, 140, 1, (8, False)),   # 8 staged does not fit, the tables fit the L1 beside 8 frames
    (190, 170, 1, (16, False)),  # no tile keeps its tables on chip: the most frames that fit
    # two blocks an SM, a 16-frame tile of 100 KB (28 KB of L1 beside two)
    (100, 10, 2, (16, True)),    # two staged tiles fit an SM
    (100, 20, 2, (16, False)),   # they do not, the tables fit the L1 beside two tiles
    (100, 40, 2, (8, True)),     # ... they do not: 8 frames, two staged tiles
    (100, 70, 2, (8, False)),    # two 8-frame tiles, unstaged: 124 KB of L1
])
def test_tile_form_keeps_the_tables_on_chip(tile16_kb, table_kb, per_sm, want):
    def bytes_of(frames, stage):
        return frames * tile16_kb * 1024 // 16 + (table_kb * 1024 if stage else 0)

    assert df.tile_form(bytes_of, (16, 8), blocks_per_sm=lambda frames: per_sm) == want
    assert df.tile_form(bytes_of, (16, 8), tables_in_l1=False)[0] == 16
    assert df.tile_form(bytes_of, (64,)) == (0, False)


def test_l1_left():
    """The carve-outs the driver can pick: 196 KB of shared memory leave
    60 KB of L1, 100 KB leave 156 KB, 228 KB leave 28 KB."""
    assert df.l1_left(191 * 1024) == 60 * 1024 and df.l1_left(100 * 1024) == 156 * 1024
    assert df.l1_left(2 * 101 * 1024) == 28 * 1024


def k4_rule_as_before(tables):
    """K4's size rule as written before it went through ``tile_form``."""
    fits = dl.SMEM_BLOCK_BYTES
    if dl.fast_tile_bytes(tables, 16, False) <= fits:
        return 16, dl.fast_tile_bytes(tables, 16, True) <= fits
    if dl.fast_tile_bytes(tables, 8, False) <= fits:
        staged = dl.fast_tile_bytes(tables, 8, True)
        return 8, staged <= fits and 2 * (staged + 1024) <= df.SMEM_SM_BYTES
    return 0, False


@pytest.mark.parametrize("nc", [648, 1944, 4000, 6000, 7000, 8000])
def test_k4_stream_form_unchanged(smoke_codes, nc):
    """K4's rule through ``tile_form`` on the wifi codes and on (3,6) codes
    around its 16-frame, staging and 8-frame limits."""
    rng = np.random.default_rng(nc)
    mc = nc // 2
    code = LDPCCode(rows=np.repeat(np.arange(mc), 6).astype(np.int32),
                    cols=rng.permutation(np.repeat(np.arange(nc), 3)).astype(np.int32),
                    nc=nc, mc=mc, layers=[np.arange(mc // 2), np.arange(mc // 2, mc)])
    tables = kernel_tables(to_sorted_device(code, "cpu", with_layers=True))
    for t in (tables, *smoke_codes.values()):
        assert dl.stream_form(t) == k4_rule_as_before(t)


def test_too_large_for_any_tile_keeps_the_hbm_planes():
    """A (3,6) code of 30000 variables: no tile fits even at 4 frames of
    int8 messages, so both kernels keep their HBM-plane forms."""
    rng = np.random.default_rng(0)
    nc, mc = 30000, 15000
    code = LDPCCode(rows=np.repeat(np.arange(mc), 6).astype(np.int32),
                    cols=rng.permutation(np.repeat(np.arange(nc), 3)).astype(np.int32),
                    nc=nc, mc=mc, layers=[np.arange(mc // 2), np.arange(mc // 2, mc)])
    tables = kernel_tables(to_sorted_device(code, "cpu", with_layers=True))
    for dt in DTYPES:
        assert df.stream_form(tables, dt) == (0, False)
        assert dl.exact_form(tables, dt) == (0, False, False)
        assert df.flood_tile_bytes(tables, 4, dt, False) > df.SMEM_BLOCK_BYTES


def test_overrides_take_precedence(smoke_codes):
    t = smoke_codes["wifi648"]
    try:
        df.STREAM_FORM_OVERRIDE = (0, False)
        dl.EXACT_FORM_OVERRIDE = (8, False)
        assert df.stream_form(t, "int8") == (0, False)
        assert dl.exact_form(t, "int8") == (8, False, False)  # the priors in device memory
        dl.EXACT_FORM_OVERRIDE = (4, True, True)
        assert dl.exact_form(t, "float32") == (4, True, True)
    finally:
        df.STREAM_FORM_OVERRIDE = None
        dl.EXACT_FORM_OVERRIDE = None
    assert df.stream_form(t, "int8") == (16, True)
    assert dl.exact_form(t, "int8") == (16, True, True)


@pytest.mark.parametrize("name", list(K5_RULE))
def test_exact_priors_rule(smoke_codes, name):
    """The tile rule without the priors picks what it picked before they
    could be staged (``K5_TILES``); with them it picks a tile of as many
    frames or fewer.  ``exact_form`` takes the tile with the priors where it
    keeps the frames, or keeps ``EXACT_BUSY_CHECKS`` threads busy in a
    layer's checks (frames x the checks a layer): every form of wifi 1944,
    wifi 648 and wifi 1296 in bfloat16 and int8 (8 x 54 checks), not wifi
    648 or wifi 1296 in float32 (8 x 27, 4 x 54).  The tile it takes fits
    its blocks an SM (one in float32 and bfloat16, two in int8)."""
    t = smoke_codes[name]
    two = df.SMEM_SM_BYTES // 2 - 1024
    checks = t.layer_checks.shape[0] / t.n_layers
    for dt, want, tiles in zip(DTYPES, K5_RULE[name], K5_TILES[name]):
        assert dl.exact_tile_form(t, dt, False) == tiles
        on_chip = dl.exact_tile_form(t, dt, True)
        assert on_chip[0] <= tiles[0]
        keep = on_chip[0] == tiles[0] or on_chip[0] * checks >= dl.EXACT_BUSY_CHECKS
        assert dl.exact_form(t, dt) == want == ((*on_chip, True) if keep else (*tiles, False))
        room = two if dt == "int8" else df.SMEM_BLOCK_BYTES
        assert dl.exact_tile_bytes(t, want[0], dt, want[1], want[2]) <= room


def test_exact_prior_bytes(smoke_codes):
    """The priors add float32 ``[nc, frames]`` after the tile and its staged
    tables, 16-byte aligned: cell 2's 4-frame float32 tile 196,076 (196,080
    aligned) + 31,104 = 227,184 bytes, under a block's 232,192; wifi 648's
    16-frame float32 tile does not fit with them (211,744 + 41,472), its
    int8 tile still lets two blocks share an SM (66,592 + 41,472)."""
    t = smoke_codes["wifi1944"]
    assert dl.exact_tile_bytes(t, 4, "float32", True, True) == 227_184 <= df.SMEM_BLOCK_BYTES
    assert df.SMEM_BLOCK_BYTES == 232_192
    for name, tb in smoke_codes.items():
        if tb.exact16 is None:
            continue
        for dt in DTYPES:
            for f in (16, 8, 4):
                for stage in (True, False):
                    n = dl.exact_tile_bytes(tb, f, dt, stage)
                    assert (dl.exact_tile_bytes(tb, f, dt, stage, True)
                            == (n + 15) // 16 * 16 + 4 * tb.code.nc * f)
    w648 = smoke_codes["wifi648"]
    assert dl.exact_tile_bytes(w648, 16, "float32", True, True) == 253_216 > df.SMEM_BLOCK_BYTES
    assert dl.exact_tile_bytes(w648, 16, "int8", True, True) == 108_064
    assert 2 * (108_064 + 1024) <= df.SMEM_SM_BYTES


def _int32_tables(t):
    """K5's eight int32 tables in ``exact16``'s order."""
    return (t.row_ptr, t.col_sorted, t.vn_ptr, t.perm_c2v, t.layer_ptr, t.layer_checks,
            t.layer_var_ptr, t.layer_vars)


@pytest.mark.parametrize("name", ["wifi648", "wifi1296", "wifi1944"])
def test_exact16_is_the_int32_tables(smoke_codes, name):
    """Entry for entry the eight int32 tables back to back, read as uint16,
    then one zero where the count is odd."""
    t = smoke_codes[name]
    want = np.concatenate([x.numpy() for x in _int32_tables(t)])
    got = t.exact16.numpy().view(np.uint16).astype(np.int64)
    assert want.size == dl.exact_table_entries(t) and got.size == want.size + want.size % 2
    np.testing.assert_array_equal(got[:want.size], want)
    assert got[want.size:].tolist() in ([], [0])


def test_exact16_without_layers_is_none(smoke_codes):
    """Built only where the code has layers: the 1152 code's flooding
    tables carry none, its tables in two layers do."""
    assert smoke_codes["bench1152"].n_layers == 0 and smoke_codes["bench1152"].exact16 is None
    code = even_odd(make_benchmark_code(1152, 3, 6, seed=0))
    assert kernel_tables(to_sorted_device(code_from_jax(code), "cpu")).exact16 is None
    t = tables_of(code)
    assert t.n_layers == 2 and t.exact16.numel() == dl.exact_table_entries(t)


def _regular(nc, dv, dc, seed=0):
    rng = np.random.default_rng(seed)
    mc = nc * dv // dc
    return LDPCCode(rows=np.repeat(np.arange(mc), dc).astype(np.int32),
                    cols=rng.permutation(np.repeat(np.arange(nc), dv)).astype(np.int32),
                    nc=nc, mc=mc, layers=[np.arange(mc // 2), np.arange(mc // 2, mc)])


@pytest.mark.parametrize("nc,dv,dc", [(12_900, 3, 6), (12_896, 3, 6), (9_600, 4, 8),
                                      (7_200, 5, 10), (6_000, 6, 12)])
def test_a_code_whose_smallest_tile_fits_has_16_bit_tables(nc, dv, dc):
    """The smallest tile (int8, 4 frames) holds 4 (nnz + nc) bytes, so a code
    whose tile fits a block has nnz + nc < 58,048: with layers that split
    its checks, every entry (pointers up to nnz, labels below nc, slots
    below nnz, layer pointers up to nlc <= mc or nlv <= nnz) is below
    65,536.  Codes at the edge of that tile, of several degrees."""
    t = kernel_tables(to_sorted_device(_regular(nc, dv, dc), "cpu", with_layers=True))
    fits = dl.exact_tile_bytes(t, 4, "int8", False) <= df.SMEM_BLOCK_BYTES
    assert fits == (nc != 12_900)
    assert t.code.nnz + t.code.nc < df.SMEM_BLOCK_BYTES // 4 or not fits
    if fits:
        assert t.exact16 is not None
        assert max(int(x.max()) for x in _int32_tables(t) if x.numel()) <= TABLE16_MAX


def test_past_16_bits_no_exact16_and_the_plane_form():
    """A (3,6) code of 30,000 variables (90,000 edges): row pointers pass
    65,535, so there are no 16-bit tables, and no tile fits: the rule keeps
    the plane form, which reads the int32 tables."""
    t = kernel_tables(to_sorted_device(_regular(30_000, 3, 6), "cpu", with_layers=True))
    assert int(t.row_ptr.max()) > TABLE16_MAX and t.exact16 is None
    assert all(dl.exact_form(t, dt) == (0, False, False) for dt in DTYPES)


def test_layers_past_16_bits_take_the_plane_form():
    """A code small enough for every tile, in 1,367 layers that repeat its
    48 checks: the layer pointers pass 65,535, so there are no 16-bit tables
    and the rule keeps the plane form in every message form."""
    code = dataclasses.replace(_regular(96, 3, 6), layers=[np.arange(48)] * 1366 + [np.arange(24)])
    t = kernel_tables(to_sorted_device(code, "cpu", with_layers=True))
    assert int(t.layer_ptr.max()) > TABLE16_MAX and t.exact16 is None
    assert dl.exact_tile_bytes(t, 16, "float32", False) <= df.SMEM_BLOCK_BYTES
    assert all(dl.exact_form(t, dt) == (0, False, False) for dt in DTYPES)


@pytest.mark.parametrize("name", ["wifi648", "wifi1296", "wifi1944"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_bytes_are_the_tile_and_two_bytes_an_entry(smoke_codes, name, dtype):
    """Staged: the tile, then the eight tables at 2 bytes an entry, the sum
    4-byte aligned; unstaged: the tile alone (lc2v and the posterior in the
    message type, the packed decisions)."""
    t = smoke_codes[name]
    c = t.code
    msg = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
    n = dl.exact_table_entries(t)
    for f in (16, 8, 4):
        tile = df._align4((c.nnz + c.nc) * f * msg) + df._align4(2 * c.nc)
        assert dl.exact_tile_bytes(t, f, dtype, False) == tile
        assert dl.exact_tile_bytes(t, f, dtype, True) == tile + (2 * n + 3) // 4 * 4
    if name == "wifi1944" and dtype == "float32":  # cell 2's tile: 146,448 + 49,628 bytes
        assert n == 24_814
        assert [dl.exact_tile_bytes(t, 4, dtype, s) for s in (False, True)] == [146_448, 196_076]
