"""The batch decode kernel's wrapper and plain version against the JAX
fused kernel (``bp_decode_pallas`` in interpret mode) on the same numpy
LLRs.  On the CPU the wrapper runs the plain version and launches nothing;
``tests_gpu/`` compares the CUDA kernel with the plain version on a card."""

import pytest
import torch

import jax.numpy as jnp

from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops.pallas.decode_fused import bp_decode_pallas
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.ops.sorted import to_sorted_device

from test_torch_sorted import awgn_llrs, compare

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup():
    code = make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)
    pdc = to_pallas_device(code)
    tables = kernel_tables(to_sorted_device(code_from_jax(code), "cpu"))
    llr = awgn_llrs(code, pdc.sorted_dc.vn_perm, 128, 1.0, seed=3)
    return code, pdc, tables, llr


def test_tables(setup):
    code, _, tables, _ = setup
    assert tables.row_ptr.tolist() == list(range(0, code.nnz + 1, 6))
    assert tables.vn_ptr.tolist() == list(range(0, code.nnz + 1, 3))
    assert tables.max_dc == 6 and tables.device.type == "cpu"


@pytest.mark.parametrize("early_term", [True, False])
@pytest.mark.parametrize("form", ["BP", "BP_MS"])
def test_matches_pallas_kernel(setup, form, early_term):
    _, pdc, tables, llr = setup
    launches = dict(df.bp_decode_fused.launches)
    jout = bp_decode_pallas(pdc, jnp.asarray(llr), iterations=12, early_term=early_term,
                            minsum_mode=form, batch_tile=128, interpret=True)
    tout = df.bp_decode_fused(tables, torch.from_numpy(llr), 12, early_term, form)
    compare(jout, tout, exact=form == "BP_MS", rtol=0 if form == "BP_MS" else 1e-4)
    assert df.bp_decode_fused.launches == launches  # CPU: plain version, no launch


def test_zero_iterations(setup):
    _, _, tables, llr = setup
    out = df.bp_decode_fused(tables, torch.from_numpy(llr), 0)
    assert not out.llr_out.any() and not out.hard.any()
    assert not out.iterations.any() and not out.is_codeword.any()


def test_ragged_batch_matches_full(setup):
    """B = 100 is not a multiple of the kernel's 128-frame block."""
    _, _, tables, llr = setup
    full = df.bp_decode_fused(tables, torch.from_numpy(llr), 10)
    part = df.bp_decode_fused(tables, torch.from_numpy(llr[:, :100].copy()), 10)
    assert torch.equal(part.llr_out, full.llr_out[:, :100])
    assert torch.equal(part.iterations, full.iterations[:100])


def test_rejects_bad_input(setup):
    _, _, tables, llr = setup
    with pytest.raises(ValueError, match="llr_in"):
        df.bp_decode_fused(tables, torch.from_numpy(llr).double(), 5)
    with pytest.raises(ValueError, match="llr_in"):
        df.bp_decode_fused(tables, torch.from_numpy(llr).t(), 5)


@pytest.mark.parametrize("mode,want", [
    ("BP", (0, 0.0, 0.0)), ("BP_MS", (1, 0.0, 0.0)), ("BP_NMS", (1, 0.0, 0.0)),
    (("BP_NMS", 0.75, 0.15), (3, 0.75, 0.15)), (("BP_OMS", 0.5, 0.25), (4, 0.5, 0.25)),
    ("BP_PHI", (6, 0.0, 0.0)), ("NOT_A_FORM", (0, 0.0, 0.0)), (True, (1, 0.0, 0.0)),
])
def test_cn_mode_args(mode, want):
    assert df.cn_mode_args(mode) == pytest.approx(want)
