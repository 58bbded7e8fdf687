"""The port's routing of a message dtype against the JAX package's
``_select_layout`` on the CPU: for each code, ``--pallas`` with bfloat16
and int8, BP and BP_MS, early termination on and off, the dtype the JAX
``decode_path`` says and every ``fallback[...]`` reason, in order, with
the JAX package's walls at their values and lowered (in both packages) so
that each branch is reached: the edge-major layout (Beneš n_pad, the MXU
plan), the qc lanes and their two sub-32-bit walls, the Clos lanes' fill
wall, the lanes' n_pad walls, and the fixed-iteration reroute.  The
NumPy sizes behind it (:mod:`libldpc_tpu_torch.sim.tpu_layouts`) are held
to the JAX layouts' own.  The streaming engine each command line runs is
held to the one the JAX driver builds (its XLA super-step without
``--pallas``, its fused steps with it, batch stepping where streaming is
off)."""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest

from libldpc_tpu.models import make_benchmark_code, make_qc_benchmark_code, wifi_code
from libldpc_tpu.models.standards import make_nr_like_code
from libldpc_tpu.ops.pallas import lanes_layout, layout
from libldpc_tpu.ops.pallas.lanes_layout import to_lanes_device
from libldpc_tpu.ops.pallas.layout import to_pallas_device
from libldpc_tpu.sim import driver as jax_driver
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import make_regular_code
from libldpc_tpu_torch.sim import driver, tpu_layouts
from libldpc_tpu_torch.utils.params import DecoderParams


def _shuffled(code):
    """``code`` with its edges in a scrambled file order: the QC metadata
    stays, but the qc lane layout no longer builds."""
    order = np.random.default_rng(0).permutation(code.nnz)
    return dataclasses.replace(code, rows=code.rows[order], cols=code.cols[order])


CODES = {
    "bench96": lambda: make_benchmark_code(96, 3, 6, seed=7),
    "bench1152": lambda: make_benchmark_code(1152, 3, 6, seed=0),
    "bench3000": lambda: make_benchmark_code(3000, 3, 6, seed=1),
    "wifi648": lambda: wifi_code(648, with_G=False),
    "wifi1296": lambda: wifi_code(1296, with_G=False),
    "wifi1944": lambda: wifi_code(1944, with_G=False),
    "wifi1944-shuffled": lambda: _shuffled(wifi_code(1944, with_G=False)),
    "qc2048": lambda: make_qc_benchmark_code(2048, 128, seed=1),
    "nr-like-104": lambda: make_nr_like_code(2, 104, seed=2, with_G=False),
}

#: the JAX package's walls, lowered in both packages to reach each branch
WALLS = {
    "as-shipped": {},
    "edge-major-256": dict(FUSED_EDGE_SPACE_LIMIT=256),
    "clos-fill-2000": dict(FUSED_EDGE_SPACE_LIMIT=256, CLOS_LANES_FILL_LIMIT=2000),
    "lanes-n_pad": dict(FUSED_EDGE_SPACE_LIMIT=256, LANES_EDGE_SPACE_LIMIT=4096,
                        QC_LANES_EDGE_SPACE_LIMIT=8192),
    "qc-sub32": dict(FUSED_EDGE_SPACE_LIMIT=256, QC_LANES_SUB32_EDGE_SPACE_LIMIT=2000,
                     QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT=6000),
    "qc-sub32-crossed": dict(FUSED_EDGE_SPACE_LIMIT=256, QC_LANES_SUB32_EDGE_SPACE_LIMIT=10000,
                             QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT=2000),
}


@pytest.fixture(scope="module")
def codes():
    return {name: make() for name, make in CODES.items()}


_LAYOUTS: dict = {}


@pytest.fixture(autouse=True)
def built_once(monkeypatch):
    """The JAX layouts are deterministic and the walls do not change them,
    so each (code, layout) is built once for the whole file: the Beneš and
    Clos networks are routed in Python and take seconds."""
    for module, name in ((layout, "to_pallas_device"), (lanes_layout, "to_lanes_device")):
        build = getattr(module, name)

        def cached(code, *args, _build=build, _name=name, **kwargs):
            key = (_name, id(code), args, tuple(sorted(kwargs.items())))
            if key not in _LAYOUTS:
                _LAYOUTS[key] = (code, _build(code, *args, **kwargs))  # the code keeps its id
            return _LAYOUTS[key][1]

        monkeypatch.setattr(module, name, cached)


def jax_route(jcode, dec, use_pallas):
    """The ``dtype=`` of the JAX ``decode_path`` and its fallback reasons."""
    reasons = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, use_pallas, dp, _ = jax_driver._select_layout(
            jcode, jparams.DecoderParams(**dec), jparams.ChannelParams(), use_pallas,
            lambda reason, warn_msg="": reasons.append(reason))
    return (dp.message_dtype if use_pallas else "float32"), tuple(reasons)


@pytest.mark.parametrize("walls", list(WALLS))
def test_route_equals_jax_select_layout(codes, monkeypatch, walls):
    for name, value in WALLS[walls].items():
        monkeypatch.setattr(driver, name, value)
        monkeypatch.setattr(jax_driver, name, value)
    reached = set()
    for name, jcode in codes.items():
        code = code_from_jax(jcode)
        for dtype, form, et in itertools.product(("bfloat16", "int8"), ("BP", "BP_MS"),
                                                 (True, False)):
            dec = dict(type=form, message_dtype=dtype, early_term=et, iterations=8)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, got, fallbacks = driver.route(code, DecoderParams(**dec), True)
            assert (got, fallbacks) == jax_route(jcode, dec, True), (name, dec)
            reached.add(driver.tpu_layout(code, DecoderParams(**dec), True)[0])
            reached.update(r.split(" ")[0] for r in fallbacks)
    want = {"as-shipped": {"fused", "qc", "clos"},
            "edge-major-256": {"fused", "qc", "clos"},
            "clos-fill-2000": {"clos", "benes", "xla"},
            "lanes-n_pad": {"xla", "lanes"},
            "qc-sub32": {"qc"}, "qc-sub32-crossed": {"qc"}}[walls]
    assert want <= reached, reached


def test_route_without_pallas_and_for_the_bec(codes):
    code = code_from_jax(codes["bench3000"])
    for dtype in ("bfloat16", "int8"):
        dec = DecoderParams(type="BP_MS", message_dtype=dtype)
        assert driver.route(code, dec, False) == ("flooding", "float32", ())
        assert driver.route(code, dec, True, "BEC") == ("flooding", "uint8-3state", ())
        assert jax_route(codes["bench3000"], dict(type="BP_MS", message_dtype=dtype),
                         False) == ("float32", ())


def test_sizes_equal_the_jax_layouts(codes):
    """``benes_size``/``has_mxu_plan`` against ``to_pallas_device``,
    ``lanes_space`` against the Clos lanes and ``qc_lanes_pad`` against the
    qc lanes (None where that layout raises)."""
    for name in ("bench96", "bench1152", "wifi648", "wifi1296", "wifi1944",
                 "wifi1944-shuffled", "qc2048"):
        jcode = codes[name]
        code = code_from_jax(jcode)
        pdc = to_pallas_device(jcode, with_clos=False)
        assert tpu_layouts.benes_size(code.nnz) == pdc.n_pad, name
        assert tpu_layouts.has_mxu_plan(code) == (pdc.mxu_blocks_fwd is not None), name
        if pdc.mxu_blocks_fwd is not None:
            assert tpu_layouts.mxu_pairs(code) == pdc.mxu_blocks_fwd.shape[0]
        ldc = to_lanes_device(jcode, transport="clos")
        cb, vb = ldc.cn_blocks[-1], ldc.vn_blocks[-1]
        assert tpu_layouts.lanes_space(code) == (
            max(cb[0] + cb[1] * cb[2], vb[0] + vb[1] * vb[2]), ldc.n_pad), name
        try:
            want = to_lanes_device(jcode, transport="qc").n_pad
        except ValueError:
            want = None
        assert tpu_layouts.qc_lanes_pad(code) == want, name
    assert tpu_layouts.qc_lanes_pad(code_from_jax(codes["wifi1944-shuffled"])) is None
    assert tpu_layouts.qc_lanes_pad(code_from_jax(codes["wifi648"])) is None  # Z = 27 < 64


def test_clos_n_pad_wall(monkeypatch):
    """The JAX driver's second Clos wall is a literal 65536 on the lanes'
    n_pad, so no test can lower it there, and a code past it takes ~36 s
    to lay out in the JAX package.  With the fill wall at its value, a code
    past n_pad 65536 is past the fill wall first; with the fill wall
    raised, the n_pad wall alone widens it, and with both raised the dtype
    is kept."""
    code = make_regular_code(22000, 3, 6, seed=0)  # 66000 edges
    assert tpu_layouts.lanes_space(code) == (66048, 131072)
    dec = DecoderParams(type="BP_MS", message_dtype="bfloat16")
    assert driver.tpu_layout(code, dec, True) == (
        "benes", "float32", ("clos fill 66048 > envelope -> f32/benes lanes",))
    monkeypatch.setattr(driver, "CLOS_LANES_FILL_LIMIT", 10**9)
    assert driver.tpu_layout(code, dec, True) == (
        "benes", "float32", ("clos n_pad 131072 > envelope -> f32/benes lanes",))
    assert driver.tpu_layout(code, dataclasses.replace(dec, early_term=False), True) == (
        "xla", "float32", ("clos n_pad 131072 > envelope -> f32/benes lanes",
                           "fixed-iteration f32/benes lanes measured slower than xla "
                           "-> xla sorted decoder"))
    monkeypatch.setattr(driver, "CLOS_LANES_N_PAD_LIMIT", 131072)
    assert driver.tpu_layout(code, dec, True) == ("clos", "bfloat16", ())
    small = make_regular_code(16384, 3, 6, seed=0)  # 49152 edges: within both walls
    assert tpu_layouts.lanes_space(small) == (49152, 65536)
    monkeypatch.setattr(driver, "CLOS_LANES_FILL_LIMIT", 65536)
    monkeypatch.setattr(driver, "CLOS_LANES_N_PAD_LIMIT", 65536)
    assert driver.tpu_layout(small, dec, True) == ("clos", "bfloat16", ())


#: command lines as ``Simulator`` arguments: (decoder, channel, simulation,
#: use_pallas, code)
ENGINE_CASES = {
    "default": (dict(), dict(), dict(), False, "bench96"),
    "--pallas": (dict(), dict(), dict(), True, "bench96"),
    "--no-early-term": (dict(early_term=False), dict(), dict(), False, "bench96"),
    "--channel BEC": (dict(), dict(type="BEC", x_range=(0.3, 0.31, 0.1)), dict(), False,
                      "bench96"),
    "--layer-file": (dict(layered=True), dict(), dict(), False, "wifi1944"),
    "--layer-file --pallas": (dict(layered=True), dict(), dict(), True, "wifi1944"),
    "--error-log": (dict(), dict(), dict(error_log_file="e.txt"), False, "bench96"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_of_each_command_line_is_the_jax_drivers(codes, monkeypatch, tmp_path, case):
    """Which streaming engine each command line runs, in both packages:
    the JAX driver's XLA super-step (``ops.streaming.make_streaming_step``)
    without ``--pallas``, its fused steps (``streaming_pallas``) with it,
    batch stepping where streaming is off (spies on the JAX makers; the
    port's ``Simulator.engine``)."""
    from libldpc_tpu.ops import streaming as jstreaming
    from libldpc_tpu.ops import streaming_pallas as jstreaming_pallas
    from libldpc_tpu.sim.driver import Simulator as JaxSimulator
    from libldpc_tpu_torch.utils.params import ChannelParams, SimulationParams

    made = []
    for mod, name, engine in ((jstreaming, "make_streaming_step", "xla-superstep"),
                              (jstreaming_pallas, "make_streaming_pallas_step", "fused-pool"),
                              (jstreaming_pallas, "make_streaming_lanes_step", "fused-pool")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _e=engine, **k: (made.append(_e),
                                                                            _r(*a, **k))[1])
    dec, ch, simp, use_pallas, name = ENGINE_CASES[case]
    jcode = codes[name]
    if dec.get("layered"):
        jcode = dataclasses.replace(jcode, layers=[np.arange(i * 81, (i + 1) * 81)
                                                   for i in range(jcode.mc // 81)])
        jcode.qc = wifi_code(1944).qc
    simp = dict(batch_size=32, fec=3, max_frames=64, **simp)
    if "error_log_file" in simp:
        simp["error_log_file"] = str(tmp_path / "e.txt")
    ch = dict(dict(seed=1, x_range=(1.0, 1.1, 1.0)), **ch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JaxSimulator(jcode, jparams.DecoderParams(iterations=8, **dec),
                     jparams.ChannelParams(**ch), jparams.SimulationParams(**simp),
                     use_pallas=use_pallas, verbose=False)
        sim = driver.Simulator(code_from_jax(jcode), DecoderParams(iterations=8, **dec),
                               ChannelParams(**ch), SimulationParams(**simp), device="cpu",
                               verbose=False, use_pallas=use_pallas)
    assert sim.engine == (made[0] if made else "batch"), (case, made)
    assert sim.engine == {"default": "xla-superstep", "--pallas": "fused-pool",
                          "--layer-file --pallas": "fused-pool"}.get(case, "batch")


def test_start_wide_runs_the_engine_of_its_command_line(codes, monkeypatch):
    """``start_wide`` without ``--pallas`` streams on the multipoint XLA
    super-step, with it on the fused multipoint step."""
    from libldpc_tpu_torch.parallel.mesh import FRAME_AXIS, POINT_AXIS, make_mesh
    from libldpc_tpu_torch.utils.params import ChannelParams, SimulationParams

    for use_pallas, maker in ((False, "make_streaming_multipoint_step"),
                              (True, "make_streaming_fused_multipoint_step")):
        calls = []
        real = getattr(driver, maker)
        monkeypatch.setattr(driver, maker, lambda *a, _r=real, **k: (calls.append(1),
                                                                     _r(*a, **k))[1])
        sim = driver.Simulator(code_from_jax(codes["bench96"]), DecoderParams(iterations=6),
                               ChannelParams(seed=2, x_range=(2.0, 3.01, 1.0)),
                               SimulationParams(batch_size=32, fec=5, max_frames=96),
                               device="cpu", verbose=False, use_pallas=use_pallas)
        res = sim.start_wide(make_mesh((2, 1), (POINT_AXIS, FRAME_AXIS), ["cpu"] * 2))
        assert calls and res.frames.tolist() and min(res.frames.tolist()) > 0
