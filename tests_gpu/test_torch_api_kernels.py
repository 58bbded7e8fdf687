"""``LDPC.decode`` and resumed streaming points on the card.

``LDPC.decode`` launches K1 (flooding), K3 (the fast layered engine) or K5
(the exact layered schedule), as the sweep routes the call; each route, in
every message form (every CN form in float32 and bfloat16, the min-sum
family on the int8 lattice), against the plain version of its kernel on
the same LLRs, mapped through the same labels: min-sum bit-exact, the rest
identical in decisions and iterations on >= 99.9 % of frames.  A streaming
point resumed from a hand-written mid-point checkpoint with ``max_frames``
binding counts exactly ``max_frames`` frames on K2 and on K4."""

import json

import numpy as np
import pytest
import torch

from libldpc_tpu_torch import LDPC
from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import decode_layered as dl
from libldpc_tpu_torch.sim.driver import ChannelParams, DecoderParams, SimulationParams, Simulator
from libldpc_tpu_torch.sim.results import SimResults

pytestmark = pytest.mark.cuda

MINSUM = ["BP_MS", "BP_NMS", "BP_OMS"]
FORMS = MINSUM + ["BP", "BP_PHI", "BP_TANH", "BP_LIN"]
DTYPE_FORMS = ([("float32", f) for f in FORMS] + [("bfloat16", f) for f in FORMS]
               + [("int8", f) for f in MINSUM])
#: route -> (code, layered, usePallas, kernel, its plain version)
ROUTES = {
    "K1": (lambda: make_benchmark_code(1152, 3, 6, seed=0, with_G=True), False, True,
           df.bp_decode_fused, df.bp_decode_fused_plain),
    "K3": (lambda: wifi_code(1944), True, True, dl.bp_decode_layered_fast,
           dl.bp_decode_layered_fast_plain),
    "K5": (lambda: wifi_code(648), True, True, dl.bp_decode_layered, dl.bp_decode_layered_plain),
}


@pytest.fixture(scope="module")
def apis():
    return {}


@pytest.mark.parametrize("dtype,form", DTYPE_FORMS)
@pytest.mark.parametrize("route", list(ROUTES))
def test_decode_runs_its_kernel_and_matches_plain(apis, cuda_device, route, dtype, form):
    make, layered, use_pallas, kernel, plain = ROUTES[route]
    if route not in apis:
        apis[route] = LDPC(code=make(), device=cuda_device)
    ldpc = apis[route]
    rng = np.random.default_rng(7)
    B, sigma2 = 300, 10 ** (-1.5 / 10)
    llr = (2 * (1 + rng.normal(size=(B, ldpc.nct)) * np.sqrt(sigma2)) / sigma2).astype(np.float32)
    kw = dict(iters=12, dec_type=form, usePallas=use_pallas, messageDtype=dtype, layered=layered)
    before = kernel.launches[dtype]
    out, it = ldpc.decode(llr, **kw)
    assert kernel.launches[dtype] == before + 1
    dec = DecoderParams(type=form, layered=layered, message_dtype=dtype)
    schedule, run_dtype = ldpc._route(dec, use_pallas)
    assert run_dtype == dtype
    tables = ldpc._tables_for(schedule)
    tx = tables.code.bit_pos
    full = torch.zeros((ldpc.n, B), dtype=torch.float32, device=cuda_device)
    full[tx] = torch.from_numpy(llr).to(cuda_device).T
    want = plain(tables, full, 12, True, dec.cn_mode, dtype)
    w_out = want.llr_out.index_select(0, tx).T.cpu().numpy()
    w_it = want.iterations.cpu().numpy()
    same = ((out <= 0) == (w_out <= 0)).all(1) & (it == w_it)
    if form in MINSUM:
        np.testing.assert_array_equal(out, w_out)
        np.testing.assert_array_equal(it, w_it)
    else:
        assert same.mean() >= 0.999
        tol = {"float32": 1e-4, "bfloat16": 2 ** -8 if route != "K5" else 2 ** -4}[dtype]
        np.testing.assert_allclose(out[same], w_out[same], rtol=tol, atol=tol)


@pytest.mark.parametrize("layered", [False, True], ids=["K2", "K4"])
def test_resumed_streaming_point_counts_max_frames(cuda_device, tmp_path, layered):
    code = wifi_code(1944) if layered else make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    kernel = dl.bp_stream_chunk_layered_fast if layered else df.bp_stream_chunk_fused
    B, max_frames, counted = 2048, 5 * 2048 + 77, 2 * 2048 + 333
    ckpt = tmp_path / "c.json"
    sim = Simulator(code, DecoderParams(iterations=20, layered=layered),
                    ChannelParams(seed=1, x_range=(2.0, 2.01, 1.0)),
                    SimulationParams(batch_size=B, fec=10**9, max_frames=max_frames,
                                     checkpoint_file=str(ckpt)),
                    device=cuda_device, verbose=False, use_pallas=True)
    assert "streaming=on" in sim.decode_path
    ckpt.write_text(json.dumps({
        "x_vals": [2.0], "point": 0, "counters": [0, 0, counted, counted * 5, 0.25, 3],
        "seed": 1, "channel": "AWGN", "config": sim._checkpoint_config(),
        "results": json.loads(SimResults.empty(1, [2.0]).to_json())}))
    before = kernel.launches["float32"]
    res = sim.start(resume=True)
    assert kernel.launches["float32"] > before
    assert int(res.frames[0]) == max_frames
