"""The port's XLA streaming super-step (``ops.streaming.make_streaming_step``,
the default sweep without ``--pallas``) against the JAX package's, on the
CPU.

The channel draw is replaced in both packages by one fixed frame table made
with NumPy (``libldpc_tpu.ops.streaming.simulate_channel`` and the port's
``ops.streaming.simulate_channel`` and ``ops.kernels.pool_refill.simulate_channel``
are monkeypatched; nothing of the JAX package is edited), so both run the
same frames: every reload of lane ``b`` takes column ``b``.  Then, super-step
by super-step:

* ``BP_MS``: the deltas, ``started`` and every state plane are equal, bit
  for bit, for the port's plain super-step (``_superstep_body``).  The card's
  sequence (``_card_superstep``: a one-pass K2 chunk, then K8's reload form,
  here through the wrappers' plain versions, selected by replacing
  ``ops.streaming._runs_kernels``) is held to the same, except ``lv2c`` on
  idle lanes, which the JAX super-step overwrites with the extrinsics of
  their stale frames and K2 leaves alone (no later pass reads them: a
  reload rewrites them);
* ``BP``: equal deltas, ``started`` and planes, but ``lv2c`` to 1e-4
  (relative and absolute: the box-plus's ``log1p(exp(.))`` differs in the
  last bits between XLA and PyTorch).

Covered: a binding quota, a drain (``refill=False``), injected age-0 state
and a 2-shard mesh of ``"cpu"``.  The CLI without ``--pallas`` draws torch's
random numbers, not jax's, so its FER is held to the JAX CLI's within |z| < 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libldpc_tpu import cli as jax_cli
from libldpc_tpu.models import make_benchmark_code
from libldpc_tpu.ops import channel as jchannel
from libldpc_tpu.ops import sorted as jsorted
from libldpc_tpu.ops import streaming as jstreaming
from libldpc_tpu.utils import params as jparams
from libldpc_tpu_torch import cli
from libldpc_tpu_torch.convert import code_from_jax
from libldpc_tpu_torch.models import write_codefile
from libldpc_tpu_torch.ops import streaming as tstreaming
from libldpc_tpu_torch.ops.channel import ChannelOutput, make_generator
from libldpc_tpu_torch.ops.kernels import pool_refill
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
from libldpc_tpu_torch.ops.sorted import to_sorted_device
from libldpc_tpu_torch.parallel.mesh import FRAME_AXIS, Mesh, shard_generators
from libldpc_tpu_torch.utils.params import DecoderParams

torch.set_num_threads(2)

B = 48
ITERS = 10
PLANES = ("llr_in", "codeword", "lv2c", "active", "age", "iters", "started")


@pytest.fixture(scope="module")
def code():
    return make_benchmark_code(96, dv=3, dc=6, seed=7, with_G=True)


@pytest.fixture(scope="module")
def sorted_codes(code):
    return jsorted.to_sorted_device(code), to_sorted_device(code_from_jax(code), "cpu")


def frame_table(code, vn_perm, batch, snr_db, seed):
    """Random codewords and their AWGN LLRs, made with NumPy, sorted labels."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, 2, size=(code.G.shape[0], batch))
    cw = (code.G.T.astype(np.int64) @ u % 2).astype(np.uint8)
    s2 = 10 ** (-snr_db / 10)
    llr = np.zeros((code.nc, batch), np.float32)
    x = 1.0 - 2.0 * cw[code.bit_pos]
    llr[code.bit_pos] = 2.0 * (x + rng.normal(size=x.shape) * np.sqrt(s2)) / s2
    vp = np.asarray(vn_perm)
    return np.ascontiguousarray(llr[vp]), np.ascontiguousarray(cw[vp])


def patch_draws(monkeypatch, llr, cw):
    """Both packages' super-step draws (and the reload form's plain draw on
    the CPU) return the table ``(llr, cw)``."""
    monkeypatch.setattr(jstreaming, "simulate_channel",
                        lambda *a, **k: jchannel.ChannelOutput(jnp.asarray(llr), jnp.asarray(cw)))
    for mod in (tstreaming, pool_refill):
        monkeypatch.setattr(mod, "simulate_channel",
                            lambda *a, **k: ChannelOutput(torch.from_numpy(llr).clone(),
                                                          torch.from_numpy(cw).clone()))


@pytest.fixture
def fixed_draw(monkeypatch, code, sorted_codes):
    jsdc, _ = sorted_codes
    llr, cw = frame_table(code, jsdc.vn_perm, B, 1.5, seed=11)
    patch_draws(monkeypatch, llr, cw)
    return llr, cw


@pytest.fixture
def card(request, monkeypatch):
    """``True``: the port's step runs the card's sequence (on the CPU, the
    wrappers' plain versions)."""
    if request.param:
        monkeypatch.setattr(tstreaming, "_runs_kernels", lambda device: True)
    return request.param


def _deltas(acc):
    return [int(v) for v in acc]


def _compare_states(jst, tst, lanes, idle_lv2c: bool, exact: bool):
    """``tst`` (a port state, or a list of shard states) against the JAX
    state's columns ``lanes``."""
    active = np.asarray(jst.active)[lanes]
    for name in PLANES:
        j = np.asarray(getattr(jst, name))
        t = getattr(tst, name).numpy()
        if name == "started":
            np.testing.assert_array_equal(t, j)
            continue
        j = j[..., lanes]
        if name == "lv2c" and not idle_lv2c:
            j, t = j[:, active], t[:, active]
        if name == "lv2c" and not exact:
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)


def _run_both(jsdc, tsdc, form, max_frames, card, schedule, gen_threshold=None,
              inject=None):
    """The JAX and the port's step over ``schedule`` (a list of refill
    flags), compared after every super-step; returns the summed deltas."""
    jdec = jparams.DecoderParams(iterations=ITERS, type=form)
    tdec = DecoderParams(iterations=ITERS, type=form)
    j_init, j_step = jstreaming.make_streaming_step(jsdc, "AWGN", jdec, B, max_frames=max_frames,
                                                    gen_threshold=gen_threshold)
    t_init, t_step = tstreaming.make_streaming_step(
        kernel_tables(tsdc), "AWGN", tdec, B, max_frames=max_frames, gen_threshold=gen_threshold)
    jst, tst = j_init(), t_init()
    if inject is not None:
        jst, tst = inject(jst, tst)
    exact = form == "BP_MS"
    total = np.zeros(5, np.int64)
    for s, refill in enumerate(schedule):
        jst, jacc = j_step(jst, jax.random.PRNGKey(s), jnp.float32(1.5), jnp.bool_(refill))
        tst, tacc = t_step(tst, make_generator("cpu", 0, s), 1.5, refill)
        assert _deltas(tacc) == _deltas(jacc), (s, refill)
        _compare_states(jst, tst, slice(None), idle_lv2c=not card, exact=exact)
        total += _deltas(tacc)
    return total


@pytest.mark.parametrize("card", [False, True], indirect=True)
@pytest.mark.parametrize("form", ["BP_MS", "BP"])
def test_superstep_equals_jax(fixed_draw, sorted_codes, form, card):
    jsdc, tsdc = sorted_codes
    total = _run_both(jsdc, tsdc, form, 10**6, card, [True] * 4 + [False] * 3)
    assert total[2] > B  # lanes were reloaded and finished again


@pytest.mark.parametrize("card", [False, True], indirect=True)
def test_binding_quota_and_drain(fixed_draw, sorted_codes, card):
    jsdc, tsdc = sorted_codes
    total = _run_both(jsdc, tsdc, "BP_MS", 70, card, [True] * 5 + [False] * 4, gen_threshold=3)
    assert total[2] == 70  # the quota lands exactly once drained


@pytest.mark.parametrize("card", [False, True], indirect=True)
def test_injected_warm_up_state(fixed_draw, sorted_codes, card):
    """Frames injected at age 0 on zero messages (the zero-init protocol)
    warm up for one pass, then count as the JAX super-step counts them."""
    jsdc, tsdc = sorted_codes
    llr, cw = fixed_draw
    lanes = np.arange(B) % 3 != 0

    def inject(jst, tst):
        act = jnp.asarray(lanes)
        jst = jst._replace(llr_in=jnp.asarray(llr), codeword=jnp.asarray(cw), active=act,
                           started=jnp.full((1,), int(lanes.sum()), jnp.int32))
        tst.llr_in.copy_(torch.from_numpy(llr))
        tst.codeword.copy_(torch.from_numpy(cw))
        tst.active.copy_(torch.from_numpy(lanes))
        tst.started.fill_(int(lanes.sum()))
        return jst, tst

    _run_both(jsdc, tsdc, "BP_MS", 10**6, card, [False, True, True, False, False],
              inject=inject)


@pytest.mark.parametrize("card", [False, True], indirect=True)
def test_two_shard_mesh(monkeypatch, code, sorted_codes, card):
    """A 2-shard frames mesh: each shard's quota ``base + (idx < rem)``, the
    deltas summed over the shards, each shard's state the JAX state's
    columns; the draw of each shard is the same table here (each shard's
    own key is the port's generator, the JAX ``fold_in``)."""
    jsdc, tsdc = sorted_codes
    llr, cw = frame_table(code, jsdc.vn_perm, B, 1.5, seed=5)
    patch_draws(monkeypatch, llr, cw)
    jmesh = jax.make_mesh((2,), (jstreaming.FRAME_AXIS,), devices=jax.devices()[:2])
    tmesh = Mesh(["cpu", "cpu"], (FRAME_AXIS,))
    dec = dict(iterations=ITERS, type="BP_MS")
    j_init, j_step = jstreaming.make_streaming_step(jsdc, "AWGN", jparams.DecoderParams(**dec), B,
                                                    mesh=jmesh, max_frames=101)
    t_init, t_step = tstreaming.make_streaming_step(tsdc, "AWGN", DecoderParams(**dec), B,
                                                    mesh=tmesh, max_frames=101)
    jst, tst = j_init(), t_init()
    assert [int(s.started[0]) for s in tst] == [0, 0]
    for s, refill in enumerate([True] * 6 + [False] * 4):
        jst, jacc = j_step(jst, jax.random.PRNGKey(s), jnp.float32(1.5), jnp.bool_(refill))
        tst, tacc = t_step(tst, shard_generators(tmesh, 0, s), 1.5, refill)
        assert _deltas(tacc) == _deltas(jacc), s
        for i, shard in enumerate(tst):
            lanes = slice(i * B, (i + 1) * B)
            jcols = type(jst)(*(np.asarray(v)[..., lanes] if v.ndim and v.shape[-1] == 2 * B
                                else np.asarray(v)[i:i + 1] for v in jst))
            _compare_states(jcols, shard, slice(None), idle_lv2c=not card, exact=True)
    assert sum(int(s.started[0]) for s in tst) == 101


def test_edges_of_the_jax_signature(sorted_codes):
    _, tsdc = sorted_codes
    dec = DecoderParams(iterations=ITERS, type="BP_MS")
    with pytest.raises(ValueError, match="does not cover the BEC"):
        tstreaming.make_streaming_step(tsdc, "BEC", dec, B)
    with pytest.raises(ValueError, match="iterations >= 1"):
        tstreaming.make_streaming_step(tsdc, "AWGN", DecoderParams(iterations=0), B)
    with pytest.raises(ValueError, match="does not cover the BEC"):
        tstreaming.make_streaming_multipoint_step(tsdc, "BEC", dec, B, Mesh(["cpu"], (FRAME_AXIS,)))
    # fast_rng changes nothing: the same generator gives the same super-step
    outs = []
    for fast in (False, True):
        init, step = tstreaming.make_streaming_step(tsdc, "AWGN", dec, B, fast_rng=fast)
        st, acc = step(init(), make_generator("cpu", 1), 2.0, True)
        outs.append((_deltas(acc), st.llr_in.clone(), st.age.clone()))
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    # the default reload threshold, max(1, B // 16) = 4 idle lanes of 64:
    # lanes in warm-up (age 0) do not finish in the pass
    init, step = tstreaming.make_streaming_step(tsdc, "AWGN", dec, 64, chunk_iters=1)
    for n_busy, want in ((61, 0), (60, 4)):
        st = init()
        st.active[:n_busy] = True
        st, _ = step(st, make_generator("cpu", 2), 2.0, True)
        assert int(st.started[0]) == want and int(st.active.sum()) == n_busy + want
    # converged lanes are counted and reloaded in the same pass
    st = init()
    st.active[:61] = True
    st.age[:61] = 1
    st.llr_in.fill_(9.0)  # the all-zero codeword, decided at once
    st, acc = step(st, make_generator("cpu", 3), 2.0, True)
    assert int(acc.frames) == 61 and int(st.started[0]) == 64 and bool(st.active.all())


def test_cli_without_pallas_agrees_with_the_jax_cli(tmp_path, code):
    """The default command line (no ``--pallas``) of both CLIs on the same
    files: the port's XLA super-step, the same rows, FER within |z| < 3."""
    write_codefile(str(tmp_path / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = np.nonzero(code.G)
    (tmp_path / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    args = [str(tmp_path / "h.txt"), None, "1.5", "2.51", "1.0", "-G", str(tmp_path / "g.txt"),
            "-i", "12", "--frame-error-count", "40", "--batch-size", "64",
            "--max-frames", "20000", "-s", "9"]
    rows = {}
    for name, main, extra in (("torch", cli.main, ["--device", "cpu"]),
                              ("jax", jax_cli.main, [])):
        out = tmp_path / f"{name}.txt"
        assert main([args[0], str(out)] + args[2:] + extra) == 0
        rows[name] = np.array([ln.split() for ln in out.read_text().splitlines()
                               if not ln.startswith("#")][1:], dtype=float)
    assert rows["torch"].shape == rows["jax"].shape == (2, 6)
    for (_, fer_t, _, n_t, _, _), (_, fer_j, _, n_j, _, _) in zip(rows["torch"], rows["jax"]):
        p = (fer_t * n_t + fer_j * n_j) / (n_t + n_j)
        z = (fer_t - fer_j) / np.sqrt(p * (1 - p) * (1 / n_t + 1 / n_j))
        assert abs(z) < 3, (fer_t, n_t, fer_j, n_j)
