"""The port's cost model (``utils/roofline.py``) against the JAX package's.

``decode_frame_cost`` counts what the JAX model counts on its sorted path
(``n_pad=None``), field for field, except the transport: the port's CN<->VN
permutation is an indexed load, so ``permute_ops`` and ``mxu_flops`` are 0.
``roofline_pct`` is the same arithmetic on the H100's float32 peak."""

import numpy as np
import pytest

from libldpc_tpu.models import make_benchmark_code, make_regular_code, wifi_code
from libldpc_tpu.ops.sorted import to_sorted_device
from libldpc_tpu.utils import roofline as jroof
from libldpc_tpu_torch.utils import roofline


@pytest.fixture(scope="module")
def cn_classes():
    codes = {"bench1152": make_benchmark_code(1152, dv=3, dc=6, seed=0, with_G=False),
             "wifi1944": wifi_code(1944),
             "degree36": make_regular_code(1152, 3, 36, seed=1)}
    out = {}
    for name, code in codes.items():
        sdc = to_sorted_device(code)
        out[name] = (code.nc, sdc.nnz, tuple(sdc.cn_classes))
    return out


@pytest.mark.parametrize("name", ["bench1152", "wifi1944", "degree36"])
@pytest.mark.parametrize("minsum,cn_form", [(True, "auto"), (False, "auto"), (False, "tanh"),
                                            (False, "phi")])
@pytest.mark.parametrize("early_term,channel", [(True, True), (False, False)])
def test_frame_cost_equals_jax_sorted_path(cn_classes, name, minsum, cn_form, early_term,
                                           channel):
    nc, nnz, classes = cn_classes[name]
    args = dict(nc=nc, nnz=nnz, cn_classes=classes, iterations=50, minsum=minsum,
                cn_form=cn_form, early_term=early_term, channel=channel)
    got = roofline.decode_frame_cost(**args)
    want = jroof.decode_frame_cost(**args, n_pad=None)
    for field in ("cn_ops", "vn_ops", "syndrome_ops", "other_ops", "iterations"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.permute_ops == 0 and got.mxu_flops == 0  # no transport on the card
    assert want.permute_ops == 2 * nnz * 2 * 50  # the JAX gather proxy the port drops
    assert got.total_ops == want.total_ops - want.permute_ops
    d = got.as_dict()
    assert d["permute_ops"] == 0 and d["total_ops"] == round(got.total_ops)
    assert set(d) == set(want.as_dict())


def test_constants_equal_jax():
    for name in ("TRANSCENDENTAL_OPS", "BOXPLUS_OPS", "MINSUM_OPS", "TANH_PRE_OPS",
                 "TANH_POST_OPS", "PHI_IN_OPS", "PHI_OUT_OPS"):
        assert getattr(roofline, name) == getattr(jroof, name), name


def test_roofline_pct_is_arithmetic_on_the_h100_peak(cn_classes):
    nc, nnz, classes = cn_classes["bench1152"]
    cost = roofline.decode_frame_cost(nc=nc, nnz=nnz, cn_classes=classes, iterations=50)
    fps = 1.2e6
    assert roofline.OPS_S == 67e12 and roofline.HBM_BYTES_S == 3.35e12
    assert roofline.roofline_pct(fps, cost) == pytest.approx(100 * fps * cost.total_ops / 67e12)
    assert roofline.roofline_pct(fps, cost, peak_ops=1e12) == pytest.approx(
        jroof.roofline_pct(fps, cost, peak_ops=1e12))


@pytest.mark.parametrize("nbytes,ops,by", [(3.35e9, 1e9, "bytes"), (1e6, 6.7e10, "operations"),
                                           (0.0, 0.0, "bytes")])
def test_bound(nbytes, ops, by):
    ms, what = roofline.bound(nbytes, ops)
    assert what == by
    assert ms == pytest.approx(max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    assert np.isfinite(ms)
