"""The tables and size rules of the tile forms of the flooding streaming
kernel (K2) and of the exact layered kernel (K5), on the CPU: pure
arithmetic, no kernel runs.

* ``KernelTables.layer_vars``: per layer, the variables its checks reach,
  against the union of ``col_sorted`` over the JAX package's layer masks.
* ``decode_fused.stream_form`` and ``decode_layered.exact_form`` on the
  codes of the smoke run (``PERF.md`` section 4) in every message form, and
  on a code too large for any tile, which keeps the HBM-plane form; the
  byte counts match the kernels' shared-memory layouts.
* ``decode_fused.tile_form``, the rule all three tile kernels share (K2,
  K4, K5): the most frames whose tile keeps its tables on chip, staged or
  in the L1 left beside it; K4's ``stream_form`` through it picks what its
  own rule picked.
"""

import dataclasses

import numpy as np
import pytest

from libldpc_tpu.models import make_benchmark_code, wifi_code
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import LDPCCode
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
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
    "wifi648": [(16, True), (16, True), (16, True)],
    "wifi1296": [(8, False), (8, True), (8, False)],
    "wifi1944": [(0, False), (8, False), (16, False)],
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
    assert dl.exact_tile_bytes(smoke_codes["wifi648"], 16, "float32", True) == 228640


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
        assert dl.exact_form(tables, dt) == (0, False)
        assert df.flood_tile_bytes(tables, 4, dt, False) > df.SMEM_BLOCK_BYTES


def test_overrides_take_precedence(smoke_codes):
    t = smoke_codes["wifi648"]
    try:
        df.STREAM_FORM_OVERRIDE = (0, False)
        dl.EXACT_FORM_OVERRIDE = (8, False)
        assert df.stream_form(t, "int8") == (0, False)
        assert dl.exact_form(t, "int8") == (8, False)
    finally:
        df.STREAM_FORM_OVERRIDE = None
        dl.EXACT_FORM_OVERRIDE = None
    assert df.stream_form(t, "int8") == (16, True) and dl.exact_form(t, "int8") == (16, True)
