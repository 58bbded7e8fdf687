"""The exact layered schedule on a code whose checks have degree 36 (past
the degree up to which the CUDA check combine is unrolled): the port's
plain version, through the kernel wrapper on the CPU, against the JAX
package on the same numpy LLRs.  Fixture and tolerances as in
``test_torch_high_degree.py``."""

import jax
import jax.numpy as jnp
import pytest
import torch

from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.utils.params import DecoderParams
from libldpc_tpu_torch.ops.kernels import decode_layered as dl

from test_torch_high_degree import SNR_DB, dc36  # noqa: F401 (dc36 is a fixture)
from test_torch_sorted import awgn_llrs, compare

torch.set_num_threads(2)

#: BP's degree-36 chain takes XLA ~35 s to compile on two layers: one case
CASES = [("BP_MS", True), ("BP_MS", False), ("BP_NMS", True), ("BP_OMS", True), ("BP", True)]


@pytest.mark.parametrize("form,early_term", CASES)
def test_exact_layered_matches_jax(dc36, form, early_term):  # noqa: F811
    jcode, jsdc, tsdc, tables = dc36
    mode = DecoderParams(type=form).cn_mode
    llr = awgn_llrs(jcode, jsdc.vn_perm, 16, SNR_DB, seed=4)
    jout = jax.jit(lambda l: jsorted.bp_decode_sorted(jsdc, l, 8, early_term, mode, layered=True))(
        jnp.asarray(llr))
    launches = dict(dl.bp_decode_layered.launches)
    tout = dl.bp_decode_layered(tables, torch.from_numpy(llr), 8, early_term, mode)
    assert dl.bp_decode_layered.launches == launches  # CPU: the plain version, no refusal
    compare(jout, tout, exact=form != "BP", rtol=1e-4 if form == "BP" else 1e-5)
