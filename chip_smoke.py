"""On-card smoke run of the PyTorch / CUDA port (``libldpc_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the CUDA decode kernels from ``libldpc_tpu_torch/csrc``, holds
each against its plain PyTorch version at the main paths' shapes, drives
the ``ldpcsim-torch`` sweeps on the card (the flooding sweep of the 1152
code; the 802.11n layered sweep: wifi 1944 on the fast QC engine, streaming
and fixed-iteration, and wifi 648 on the exact layered schedule; the BEC
sweep of the 1152 code and the BEC streaming step; the flooding and the
layered sweeps with bfloat16 and int8 messages, ``--pallas
--message-dtype``; a code with checks of degree 36 through a batch, a
streaming and the BEC kernels), holds K8, the streaming pool's refill,
against its plain version for BPSK, 4-ASK, BSC and the BEC (phase 7e) and
the streaming chunks K2, K4 and K7 under a binding quota, their starts
granted in lane order, against their plain chunks (phase 7f: the grants'
cost, and the streaming step repeating under a binding quota), times kernels
against plain versions, and prints a ``{"kernels": [...]}`` line (each kernel with
its launches on its path, its error against the plain version, its time,
the plain version's, its bound: the larger of the bytes it must move
over the HBM rate and its operations over the float32 rate
(``libldpc_tpu_torch/utils/roofline.py``), and the form
of the kernel that ran; the kernels with a tile form, K1 to K5, are held
against their plain versions and timed in each form side by side, K5 on
wifi 648, and on wifi 1296 and wifi 1944 in every form (its tiles of 16, 8
and 4 frames and its plane form), each held against the plain version and
its size rule's form checked the fastest), the default command
line on the exact schedule (phase 9c: ``--layer-file`` on wifi 1944
without ``--pallas``, batch-stepped on K8 and K5), the fixed-iteration ``Simulator`` frames/s of the
1152 flooding and the wifi 1944 layered-fast points in each message form,
the checkpoint / error-log / ``LDPC`` slice (phase 11: sweeps stopped and
resumed against the uninterrupted ones on K2 and K4, a streaming point
resumed mid-point, the forensic error log on K1, K3 and K6, ``LDPC.decode``
on K1, K3 and K5 against the plain versions, the threaded simulation on
each streaming engine, the CLI with ``--checkpoint --resume --error-log --log-codewords``), the
modulation slice (phase 12: the ``sim_cuda`` command line with 4-ASK on the
1152 code on the XLA super-step (K2 and K8's reload form) and, with
``-layer``, 8-ASK on wifi 1944 on K5,
``LDPC.simulate`` with 16-ASK on wifi 1944 on K4, each in its waterfall;
M = 2 against BPSK on the same draws and 4-ASK on the fused step; a modulated error log whose ``dE`` is
recomputed on the host; the bfloat16 sweep of a (3,6) code of 49152 edges
that the port once refused, and K2's bfloat16 form there against its plain
chunk on the same frames; K5 on wifi 1944 against its plain version,
timed), the multi-device slice (phase 13: ``Simulator.start_wide`` on a
``(2, 2)`` mesh of this card over the 1152 code on K2 with and without
``--pallas`` (the fused step and the XLA super-step), wifi 1944 on K4, the
error-logged 1152 sweep on K1 and the BEC on K6, against ``start()``, each
engine checked, and each kernel's and each streaming engine's per-shard
counters against its plain step; phase 14: two ranks of the CLI with
``--multihost --points-parallel 2`` on this card, with and without
``--pallas``;
phase 15: ``tune_nms_scales``, ``tune_oms_offsets`` and ``decode_soft``
against K1), the default sweep without ``--pallas`` (phase 16: the JAX
package's XLA super-step on a one-pass K2 launch and K8's reload form, its
super-step against the plain super-step on the card, the reload and K2's one-pass launch
timed, the CLI sweep of the 1152 code beside phase 8's ``--pallas`` sweep,
a ``max_frames``-ended point run five times), the padded-layout library
(phase 17: ``bp_decode`` on K1 and K5, ``bec_decode`` on K6, each against
its plain padded version, timed), the native host runtime and the examples
(phase 18: ``native.available()`` asserted, the codefile parse and the
GF(2) rank timed natively and on the NumPy paths, equal; each
``examples/torch_*.py`` run through its ``main`` at a reduced depth, its
engine and launches checked), and, last, an ``{"ok": true, ...}`` line.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing any
result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
BATCH = 16384
ITERS = 50
COMPARE_SNR_DB = 1.5  # inside the waterfall of every code here (sigma^2 = 10^(-snr/10))
#: phase 10: the frames and iterations each K5 form is held to plain on
#: before it is timed (no multiple of 16)
K5_CHECK_B, K5_CHECK_ITERS = 1000, 12
SWEEP = ["1.0", "3.01", "0.5"]  # 1.0 .. 3.0 dB: the 1152 code's waterfall
LAYERED_SWEEP = ["1.0", "2.51", "0.5"]  # 1.0 .. 2.5 dB: wifi 1944's waterfall
FORMS = ("BP_MS", ("BP_NMS", 0.75, 0.15), "BP")
#: CN forms per message dtype: the int8 lattice takes the min-sum family only
DTYPE_FORMS = {"float32": FORMS, "bfloat16": FORMS, "int8": ("BP_MS", ("BP_OMS", 0.75, 0.15))}
#: the JSON name suffix of each message form of kernels 1-5
SUFFIX = {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}
MSG_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}
BEC_EPS = 0.40  # inside the 1152 code's BEC waterfall (BP threshold ~0.429)
BEC_SWEEP = ["0.30", "0.451", "0.05"]  # 0.45 .. 0.30, run reversed
#: phase 12: Gray labels, and the SNRs of each constellation's waterfall
GRAY_LABELS = {4: [0, 1, 3, 2], 8: [0, 1, 3, 2, 6, 7, 5, 4], 16: [i ^ (i >> 1) for i in range(16)]}
MOD_SNRS = {4: (7.25, 7.5, 7.75), 8: (10.75, 11.0, 11.25)}  # the 1152 code, wifi 1944 (-layer)
MOD_SNR_RANGE_16 = (15.0, 15.51, 0.25)  # wifi 1944, LDPC.simulate
BIG_SWEEP = ["1.3", "1.41", "0.1"]  # the (3,6) code of 16384 variables


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, setup=None, warm: bool = True, busy: bool = False) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run unless ``warm`` is False (a plain version of seconds a
    call that the kernel checks already ran at the same shapes); ``setup()``
    runs before each, outside the timing.  ``busy`` gives the card ~1 ms of
    work before the start event, so that the host's launch work overlaps it
    and the events span the device's work alone (for calls of tens of µs)."""
    if setup:
        setup()
    if warm:
        fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if busy:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def in_form(kernel, module, attr: str, forced):
    """``kernel`` with a form forced for each call: ``module.attr = forced``
    (a size rule's override), reset to None after the call."""
    def call(*args, **kwargs):
        setattr(module, attr, forced)
        try:
            return kernel(*args, **kwargs)
        finally:
            setattr(module, attr, None)

    return call


def compare_batch(tag, kernel, plain, tb, llr, dtype=None, tol=1e-4, also=()) -> float:
    """Hold a batch decode kernel against its plain version: every CN form
    of FORMS (of DTYPE_FORMS[dtype] in a message form), early termination
    on and off.  The min-sum family must be bit-exact; BP must agree in
    decisions and iteration counts on >= 99.9 % of frames and within
    ``tol`` (relative and absolute) on their posteriors.  ``also``: more
    ``(label, kernel)`` pairs (other forms of it) held to the same plain
    outputs.  Returns the largest absolute posterior difference of
    ``kernel`` over agreeing frames."""
    worst = 0.0
    form_args = () if dtype is None else (dtype,)
    for form in FORMS if dtype is None else DTYPE_FORMS[dtype]:
        for et in (True, False):
            want = plain(tb, llr, ITERS, et, form, *form_args)
            for name, fn in (("", kernel), *also):
                got = fn(tb, llr, ITERS, et, form, *form_args)
                torch.cuda.synchronize()
                same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
                diff = (got.llr_out - want.llr_out)[:, same].abs()
                err = diff.max().item() if diff.numel() else 0.0
                if not name:
                    worst = max(worst, err)
                label = form if isinstance(form, str) else form[0]
                where = f"{tag}{' ' + name if name else ''}{'' if dtype is None else ' ' + dtype}"
                print(f"{where} {label} et={int(et)}: frames agreeing "
                      f"{same.float().mean().item():.6f} max_abs_err {err:.3e} "
                      f"avg_iter {got.iterations.float().mean().item():.3f} "
                      f"codewords {got.is_codeword.float().mean().item():.4f}")
                check(torch.isfinite(got.llr_out).all(), f"{where} output not finite")
                if label == "BP":
                    check(same.float().mean().item() >= 0.999, f"{where} BP decisions disagree")
                    torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same],
                                               rtol=tol, atol=tol)
                else:
                    check(bool(same.all()) and torch.equal(got.llr_out, want.llr_out)
                          and torch.equal(got.is_codeword, want.is_codeword),
                          f"{where} {label} not bit-exact")
    return worst


def run_resume_log_api(dev, codes, name_power, zero_counts, read_counts) -> dict:
    """Phase 11, the checkpoint / error-log / ``LDPC`` slice at B = 16384:
    a sweep stopped after its first point and resumed against the same
    sweep uninterrupted (K2 on the 1152 code, K4 on wifi 1944), a streaming
    point resumed mid-point from a hand-written checkpoint with
    ``max_frames`` binding, the forensic error log on K1, K3 and K6 (lines
    against the counts), ``LDPC.decode`` on K1, K3 and K5 against the plain
    versions, the threaded ``LDPC.simulate``, and the CLI with every new
    flag.  Prints each sweep's frames/s beside the same sweep without the
    new flags.  Returns the launches of this path's run, read before the
    ``LDPC.decode`` timings, which launch the kernels again."""
    import numpy as np

    from libldpc_tpu_torch import LDPC, cli
    from libldpc_tpu_torch.models import write_codefile
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )
    from libldpc_tpu_torch.sim.results import SimResults

    work = WORK / "slice11"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()

    def sim(key, x_range, *, layered=False, channel="AWGN", dec=None, **simp):
        return Simulator(
            codes[key], DecoderParams(iterations=ITERS, layered=layered, **(dec or {})),
            ChannelParams(seed=1, x_range=x_range, type=channel),
            SimulationParams(batch_size=BATCH, **{"fec": 50, "max_frames": 2_000_000, **simp}),
            device=dev, verbose=False, use_pallas=True)

    def rows(res):  # each point's row, frame_time aside
        return np.stack([res.x_values, res.fer, res.ber, res.avg_iter, res.fec, res.frames], 1)

    def rates(res, unit="dB"):
        return ", ".join(f"{x} {unit} {1.0 / t:.0f}" for x, t in zip(res.x_values, res.time))

    zero_counts()
    # -- resume at a point boundary: K2 (1152 flooding), K4 (wifi 1944
    # layered-fast), at points that 50 frame errors end: where max_frames
    # ends a streaming point, the quota's atomic grants decide which frames
    # start last, so no two runs count the same frames
    for key, x_range, layered in (("bench1152", (2.0, 2.51, 0.5), False),
                                  ("wifi1944", (1.25, 1.51, 0.25), True)):
        plain = sim(key, x_range, layered=layered).start()
        ckpt = str(work / f"{key}_ckpt.json")
        whole = sim(key, x_range, layered=layered, checkpoint_file=ckpt).start()
        check((whole.fec >= 50).all(), f"{key}: a point ended by max_frames")
        os.remove(ckpt)
        stopped = sim(key, x_range, layered=layered, checkpoint_file=ckpt)
        first = stopped.start(stop_flag=lambda: stopped.results.fec[0] >= 50)
        check(first.frames[0] > 0 and first.frames[1] == 0, f"{key}: the stop did not follow point 0")
        resumed = sim(key, x_range, layered=layered, checkpoint_file=ckpt).start(resume=True)
        check(np.array_equal(rows(resumed), rows(whole)), f"{key}: resumed rows differ")
        check(np.array_equal(rows(plain), rows(whole)), f"{key}: the checkpoint changed the rows")
        print(f"resume {key} {'layered-fast' if layered else 'flooding'} BP: resumed rows equal the "
              f"uninterrupted sweep's ({[int(f) for f in whole.frames]} frames); frames/s plain "
              f"[{rates(plain)}], with --checkpoint [{rates(whole)}] [{name_power}]")

    # -- resume mid-point: a hand-written checkpoint, frames not a multiple of B
    for key, snr, layered in (("bench1152", 2.5, False), ("wifi1944", 2.0, True)):
        max_frames, counted = 6 * BATCH + 1001, 3 * BATCH + 777
        ckpt = work / f"{key}_mid.json"
        mid = sim(key, (snr, snr + 0.01, 1.0), layered=layered, fec=10**9, max_frames=max_frames,
                  checkpoint_file=str(ckpt))
        check("streaming=on" in mid.decode_path, f"{key} mid-point: not streaming")
        ckpt.write_text(json.dumps({
            "x_vals": [snr], "point": 0, "counters": [0, 0, counted, counted * 5, 0.5, 4],
            "seed": 1, "channel": "AWGN", "config": mid._checkpoint_config(),
            "results": json.loads(SimResults.empty(1, [snr]).to_json())}))
        res = mid.start(resume=True)
        check(int(res.frames[0]) == max_frames, f"{key} mid-point resume counted "
              f"{int(res.frames[0])} frames, not {max_frames}")
        print(f"resume {key} mid-point at {counted} frames: {int(res.frames[0])} frames counted, "
              f"max_frames {max_frames}")

    # -- the forensic error log: K1 (flooding), K3 (layered-fast), K6 (BEC)
    idx = r"[\d,]*(?:,\.\.\.\(\d+ total\))?"  # indices, cut at 64
    line = re.compile(rf"x=(\S+) frame=(\d+) bit_errors=(\d+) is_codeword=([01]) dE=([\d.]+) "
                      rf"dH=(\d+) syndrome_weight=(\d+) failed_bits={idx} failed_checks={idx} "
                      r"decided_cw=([0-9a-f]+) true_cw=([0-9a-f]+)$")
    for key, x_range, layered, channel in (("bench1152", (2.0, 2.01, 1.0), False, "AWGN"),
                                           ("wifi1944", (1.5, 1.51, 1.0), True, "AWGN"),
                                           ("bench1152", (0.40, 0.401, 1.0), False, "BEC")):
        log = work / f"{key}_{channel}_errors.txt"
        plain_sim = sim(key, x_range, layered=layered, channel=channel)
        plain = plain_sim.start()
        logged = sim(key, x_range, layered=layered, channel=channel, error_log_file=str(log),
                     error_log_codewords=True)
        check(channel == "BEC" or "fallback[forensic error log" in logged.decode_path,
              "error-log provenance")
        res = logged.start()
        lines = log.read_text().splitlines()
        check(len(lines) == int(res.fec[0]) > 0, f"{key} {channel}: {len(lines)} log lines for "
              f"{int(res.fec[0])} frame errors")
        nc = codes[key].nc
        for ln in lines:
            m = line.match(ln)
            check(m is not None, f"log line does not parse: {ln[:200]}")
            be, iscw, dE, dH, sw = (int(m[3]), int(m[4]), float(m[5]), int(m[6]), int(m[7]))
            check(dH >= be >= 1 and abs(dE - 2 * math.sqrt(be)) < 5e-4 and iscw == (sw == 0),
                  f"log line fields: {ln[:200]}")
            d, t = (np.unpackbits(np.frombuffer(bytes.fromhex(h), np.uint8))[:nc]
                    for h in (m[8], m[9]))
            check(int((d != t).sum()) == dH, "log codewords do not give dH")
        unit = "eps" if channel == "BEC" else "dB"
        print(f"error log {key} {channel} {'layered-fast' if layered else 'flooding'}: "
              f"{len(lines)} lines = frame errors; frames/s without the log {rates(plain, unit)} "
              f"(streaming {plain_sim.decode_path.split(' streaming=')[1].split()[0]}), with it "
              f"{rates(res, unit)} (batch-stepped) [{name_power}]")

    # -- LDPC.decode: K1 and K3 at B = 16384, K5 on wifi 648
    timings: list = []  # run once the path's counts are read

    def api_case(key, layered, use_pallas, dtype, form, kernel, plain, batch=BATCH,
                 iters=ITERS, snr=COMPARE_SNR_DB):
        ldpc = LDPC(code=codes[key], device=dev)
        schedule, _ = ldpc._route(DecoderParams(type=form, layered=layered, message_dtype=dtype),
                                  use_pallas)
        tb = ldpc._tables_for(schedule)
        tx = tb.code.bit_pos
        ch = awgn_channel(tb.code, make_generator(dev, 11, 0, 0), batch, snr)
        llr = ch.llr.index_select(0, tx).T.contiguous().cpu().numpy()  # [B, nct], file order
        kw = dict(iters=iters, dec_type=form, usePallas=use_pallas, messageDtype=dtype,
                  layered=layered)
        before = kernel.launches[dtype]
        out, it = ldpc.decode(llr, **kw)
        check(kernel.launches[dtype] == before + 1, f"LDPC.decode {key}: not one {kernel.__name__}")
        full = torch.zeros_like(ch.llr)
        full[tx] = torch.from_numpy(llr).to(dev).T
        want = plain(tb, full, iters, True, form, dtype)
        w_out = want.llr_out.index_select(0, tx).T.cpu().numpy()
        w_it = want.iterations.cpu().numpy()
        same = ((out <= 0) == (w_out <= 0)).all(1) & (it == w_it)
        if form == "BP":
            check(same.mean() >= 0.999, f"LDPC.decode {key} BP: decisions disagree")
            err = float(np.abs(out - w_out)[same].max())
            np.testing.assert_allclose(out[same], w_out[same], rtol=1e-4, atol=1e-4)
        else:
            check(np.array_equal(out, w_out) and np.array_equal(it, w_it),
                  f"LDPC.decode {key} {dtype} {form} not bit-exact")
            err = 0.0
        where = f"LDPC.decode {key} {kernel.__name__} {dtype} {form} {iters} it B={batch}"
        print(f"{where}: frames agreeing {same.mean():.6f}, max_abs_err {err:.3e}")

        def time_it():  # after the counts are read: these launches are not the path's
            api_ms = cuda_ms(lambda: ldpc.decode(llr, **kw), 3)
            direct_ms = cuda_ms(lambda: kernel(tb, full, iters, True, form, dtype), 3)
            # the host copies alone: the LLRs in, a posterior plane of the same size out
            in_ms = cuda_ms(lambda: torch.from_numpy(llr).to(dev), 3)
            out_ms = cuda_ms(lambda: full.cpu(), 3)
            print(f"{where}: {api_ms:.3f} ms a call, the kernel alone {direct_ms:.3f} ms on the "
                  f"same LLRs: the API's own {api_ms - direct_ms:.3f} ms, of which host copies "
                  f"in {in_ms:.3f} ms and out {out_ms:.3f} ms [{name_power}]")
        timings.append(time_it)

    api_case("bench1152", False, False, "float32", "BP_MS", df.bp_decode_fused,
             df.bp_decode_fused_plain)
    api_case("bench1152", False, True, "int8", "BP_MS", df.bp_decode_fused,
             df.bp_decode_fused_plain)
    api_case("wifi1944", True, True, "float32", "BP", dl.bp_decode_layered_fast,
             dl.bp_decode_layered_fast_plain)
    api_case("wifi648", True, False, "float32", "BP_MS", dl.bp_decode_layered,
             dl.bp_decode_layered_plain, batch=4096, iters=20)

    # -- the threaded simulation, polled and stopped, on each streaming
    # engine: the XLA super-step (the default) and the fused step (usePallas)
    for use_pallas, engine in ((False, "xla-superstep"), (True, "fused-pool")):
        ldpc = LDPC(code=codes["bench1152"], device=dev)
        ldpc.simulate(snr=[1.0, 3.01, 0.5], fec=10**9, batchSize=BATCH, iterations=ITERS,
                      maxFrames=10**12, usePallas=use_pallas)
        t0 = time.perf_counter()
        while not len(ldpc.get_results().get("frames", ())) and time.perf_counter() - t0 < 120:
            time.sleep(0.05)
        ldpc.stop_simulation()
        got = ldpc.get_results()
        check(ldpc._simulator.engine == engine, f"LDPC.simulate usePallas={use_pallas}: engine "
              f"{ldpc._simulator.engine}")
        check(ldpc._sim_thread is None and len(got["frames"]) == 1 and got["frames"][0] > 0
              and np.isfinite(got["fer"]).all(), f"threaded simulate on {engine}")
        print(f"LDPC.simulate threaded ({engine}): stopped after {int(got['frames'][0])} frames "
              f"at 1.0 dB, FER {got['fer'][0]:.4e}, avg_iter {got['avg_iter'][0]:.3f}")

    # -- the CLI with every new flag, twice (the second resumes the finished sweep)
    code = codes["bench1152"]
    write_codefile(str(work / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = code.G.nonzero()
    (work / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    argv = [str(work / "h.txt"), str(work / "res.txt"), "2.0", "2.51", "0.5", "-G",
            str(work / "g.txt"), "-i", str(ITERS), "--batch-size", str(BATCH),
            "--frame-error-count", "20", "--checkpoint", str(work / "c.json"), "--resume",
            "--error-log", str(work / "e.txt"), "--log-codewords", "--device", str(dev)]
    for _ in range(2):
        check(cli.main(argv) == 0, "CLI with --checkpoint --resume --error-log --log-codewords")
    n_log = len((work / "e.txt").read_text().splitlines())
    state = json.loads((work / "c.json").read_text())
    check(state["point"] == 2 and n_log == sum(state["results"]["fec"]),
          "CLI checkpoint / error log")
    print(f"CLI --checkpoint --resume --error-log --log-codewords: {n_log} log lines, "
          f"checkpoint at point {state['point']}")
    counts = read_counts()
    for time_it in timings:
        time_it()
    return counts


def pool_drain(fn, tb, ch, form, dtype):
    """A pool of ``BATCH`` frames (``ch``) drained to the end by the stream
    chunk ``fn`` in message form ``dtype``; the summed counters (bit
    errors, frame errors, frames, iterations, starts)."""
    from libldpc_tpu_torch.ops.streaming_fused import init_state

    dev = ch.llr.device
    st = init_state(tb, BATCH, message_dtype=dtype)
    st.fresh_llr.copy_(ch.llr)
    st.fresh_cw.copy_(ch.codeword)
    st.avail.fill_(1)
    refill = torch.ones(1, dtype=torch.int32, device=dev)
    remaining = torch.full((1,), BATCH, dtype=torch.int32, device=dev)
    for _ in range(ITERS):
        fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
           st.fresh_llr, st.fresh_cw, refill, remaining, k=6, cap=ITERS, minsum_mode=form,
           message_dtype=dtype)
        refill.zero_()
        if int((st.done == 0).sum()) == 0:
            return st.ctr.sum(1).tolist()
    raise RuntimeError("streams did not drain")


def check_big_bf16_drains(tb, ch, df) -> None:
    """Pools of ``BATCH`` frames drained to the end by K2's bfloat16 form
    and by its plain chunk, and decoded by K1's bfloat16 form, in every CN
    form: the summed counters equal under the min-sum family, and under BP
    within what 0.1 % of the frames can change (``compare_batch``'s rule
    for BP): frame errors by ``ceil(BATCH / 1000)``, iterations by ``ITERS``
    times that, bit errors by ``nc`` times that."""
    bp = tb.code.bit_pos.long()
    frames_ = math.ceil(BATCH / 1000)
    for form in DTYPE_FORMS["bfloat16"]:
        label = form if isinstance(form, str) else form[0]
        got = pool_drain(df.bp_stream_chunk_fused, tb, ch, form, "bfloat16")
        want = pool_drain(df.bp_stream_chunk_fused_plain, tb, ch, form, "bfloat16")
        out1 = df.bp_decode_fused(tb, ch.llr, ITERS, True, form, "bfloat16")
        errs1 = (out1.hard[bp] != ch.codeword[bp].bool()).sum(0)
        batch1 = [int(errs1.sum()), int((errs1 > 0).sum()), BATCH, int(out1.iterations.sum()),
                  BATCH]
        print(f"kernel2 bfloat16 drain (3,6) n=16384 {label}: kernel {got} plain {want} "
              f"batch {batch1}")
        check(got[2] == got[4] == want[2] == want[4] == BATCH,
              f"K2 bf16 n=16384 {label}: not every frame started and counted")
        if label == "BP":
            room = (frames_ * tb.code.nc, frames_, 0, frames_ * ITERS, 0)
            check(all(abs(a - b) <= r for a, b, r in zip(got, want, room)),
                  f"K2 bf16 n=16384 BP: counters {got} against plain {want}, beyond {room}")
        else:
            check(got == want == batch1, f"K2 bf16 n=16384 {label}: drained totals differ")


def run_modulation_slice(dev, codes, tables, name_power, zero_counts, read_counts) -> dict:
    """Phase 12, the modulation slice and the widened sub-32-bit routing at
    B = 16384: the ``sim_cuda`` command line (simfile + mapfile) with 4-ASK
    on the 1152 code (K2) and, with ``-layer``, 8-ASK on wifi 1944 (the
    exact schedule, K5), and ``LDPC.simulate`` with 16-ASK on wifi 1944
    (the fast layered engine, K4), counted; then M = 2 with labels
    ``[1, 0]`` against the BPSK sweep of the same seed, a modulated
    ``--error-log`` point whose ``dE`` is recomputed on the host, and the
    bfloat16 ``--pallas`` sweep of a (3,6) code of 49152 edges, which the
    port once refused, against the dtype of the mirrored routing, and K2's
bfloat16 form that it runs against the plain chunk at its shape.  Last,
    K5 on wifi 1944 against its plain version, timed.  Returns the
    launches of the three runs and K5's wifi 1944 row."""
    import numpy as np

    from libldpc_tpu_torch import LDPC, cli, sim_cuda
    from libldpc_tpu_torch.models import make_benchmark_code, write_codefile, write_layerfile
    from libldpc_tpu_torch.ops import modulation as mod
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator, tpu_layout,
    )

    work = WORK / "slice12"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()

    def mapper(key, M):  # consecutive transmitted bits per symbol, the code's own labels
        code = codes[key]
        bits = int(math.log2(M))
        return code.bit_pos[mod.default_bit_mapper(bits, code.nct // bits)]

    def files(key, M, layers=False):
        code = codes[key]
        write_codefile(str(work / f"{key}.txt"), code.rows, code.cols, code.nc, code.mc)
        r, c = code.G.nonzero()
        (work / f"{key}_g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
        (work / f"{key}_map{M}.txt").write_text(", ".join(map(str, mapper(key, M).ravel())))
        argv = ["-code", str(work / f"{key}.txt"), "-G", str(work / f"{key}_g.txt"),
                "-map", str(work / f"{key}_map{M}.txt"), "-threads", str(BATCH), "-seed", "1",
                "-device", str(dev)]
        if layers:
            write_layerfile(str(work / f"{key}_layers.txt"), code.layers)
            argv += ["-layer", str(work / f"{key}_layers.txt")]
        return argv

    def simfile(M, snrs, out, max_frames):
        path = work / f"sim_{out}"
        path.write_text(f"name: {work / out}\nM: {M}\nbits: {int(math.log2(M))}\n"
                        f"labels: {' '.join(map(str, GRAY_LABELS[M]))}\n"
                        f"snrs: {' '.join(map(str, snrs))}\nmax frames: {max_frames}\n"
                        f"min fec: 50\nbp iter: {ITERS}\nearly term: 1\n")
        return ["-sim", str(path)]

    def read_rows(out):
        lines = (work / out).read_text().splitlines()
        rows_ = [[float(v) for v in ln.split()] for ln in lines[2:]]
        check(rows_ and all(math.isfinite(v) for r in rows_ for v in r), f"{out} rows")
        return lines[0], rows_

    def in_waterfall(tag, rows_):
        fers = [r[1] for r in rows_]
        check(fers == sorted(fers, reverse=True), f"{tag}: FER does not fall across the sweep")
        check(any(1e-3 <= f <= 1e-1 for f in fers), f"{tag}: no point with FER in [1e-3, 1e-1]")
        check(all(0 < r[4] <= ITERS for r in rows_), f"{tag}: avg_iter out of range")

    zero_counts()
    t0 = time.perf_counter()
    check(sim_cuda.main(files("bench1152", 4) + simfile(4, MOD_SNRS[4], "res_4ask.txt",
                                                         2_000_000)) == 0, "sim_cuda 4-ASK")
    t4 = time.perf_counter() - t0
    check(sim_cuda.main(files("wifi1944", 8, layers=True)
                        + simfile(8, MOD_SNRS[8], "res_8ask.txt", 1_000_000)) == 0,
          "sim_cuda 8-ASK -layer")
    ldpc = LDPC(code=codes["wifi1944"], device=dev)
    ldpc.simulate(blocking=True, snr=list(MOD_SNR_RANGE_16), fec=50, batchSize=BATCH,
                  iterations=ITERS, maxFrames=2_000_000, seed=1, usePallas=True, layered=True,
                  modulation=(mod.Constellation.mask(16, GRAY_LABELS[16]), mapper("wifi1944", 16)),
                  resultFile=str(work / "res_16ask.txt"))
    counts = read_counts()
    print(f"modulation path launches: {counts}")
    # sim_cuda has no --pallas: its 4-ASK sweep streams on the XLA super-step
    # (K2 one pass a launch, K8's reload form); the fused step takes 4-ASK
    # in this phase's Simulator sweeps below (use_pallas=True)
    for name, what in (("bp_stream_chunk_fused", "K2 (4-ASK sim_cuda)"),
                       ("stream_reload", "K8's reload form (4-ASK sim_cuda)"),
                       ("stream_reload_staged", "K8's staged reload (4-ASK sim_cuda)"),
                       ("bp_decode_layered", "K5 (8-ASK sim_cuda -layer)"),
                       ("bp_stream_chunk_layered_fast", "K4 (16-ASK LDPC.simulate)")):
        check(counts[name] > 0, f"the modulation path did not run {what}")
    for out, M, key, path in (("res_4ask.txt", 4, "bench1152", "schedule=flooding streaming=on"),
                              ("res_8ask.txt", 8, "wifi1944", "schedule=layered streaming=off"),
                              ("res_16ask.txt", 16, "wifi1944",
                               "schedule=layered-fast streaming=on")):
        head, rows_ = read_rows(out)
        check(head.startswith(f"# kernel=cuda-fused dtype=float32 cn=BP {path}"),
              f"{M}-ASK provenance: {head}")
        in_waterfall(f"{M}-ASK {key}", rows_)
        for r in rows_:
            print(f"{M}-ASK {key} {path.split()[0]} {r[0]} dB: FER {r[1]:.4e} BER {r[2]:.4e} "
                  f"frames {int(r[3])} avg_iter {r[4]:.3f} [{name_power}]")
    print(f"sim_cuda 4-ASK sweep: {t4:.1f} s of host time, warm-up included")

    # -- M = 2, labels [1, 0] against BPSK: the same draws, the same quota
    zero_counts()
    code = codes["bench1152"]
    quota = 40 * BATCH + 123

    def sweep(modulation, x_values=(2.0, 2.5)):
        return Simulator(code, DecoderParams(iterations=ITERS),
                         ChannelParams(seed=3, x_values=x_values),
                         SimulationParams(batch_size=BATCH, fec=10**9, max_frames=quota),
                         device=dev, verbose=False, use_pallas=True,
                         modulation=modulation).start()

    bpsk = sweep(None)
    m2 = sweep((mod.Constellation.mask(2, labels=[1, 0]), code.bit_pos.reshape(1, -1)))
    check((bpsk.frames == quota).all() and (m2.frames == quota).all(), "M = 2: frame counts")
    for i, (x, f1, f2, n) in enumerate(zip(bpsk.x_values, bpsk.fer, m2.fer, bpsk.frames)):
        p = (f1 + f2) / 2
        z = (f1 - f2) / math.sqrt(p * (1 - p) * 2 / n) if 0 < p < 1 else 0.0
        check(abs(z) < 3, f"M = 2 at {x} dB: FER {f2} against BPSK {f1}, z {z:.2f}")
        print(f"M = 2 [1, 0] against BPSK, 1152 at {x} dB: {int(n)} frames each, FER {f2:.6e} / "
              f"{f1:.6e} (z {z:.3f}), BER {m2.ber[i]:.6e} / {bpsk.ber[i]:.6e}, avg_iter "
              f"{m2.avg_iter[i]:.6f} / {bpsk.avg_iter[i]:.6f}, frames/s {1.0 / m2.time[i]:.0f} / "
              f"{1.0 / bpsk.time[i]:.0f} [{name_power}]")
    differ = [k for k in ("fer", "ber", "avg_iter", "frames")
              if not np.array_equal(getattr(bpsk, k), getattr(m2, k))]
    print("M = 2 [1, 0] against BPSK: rows "
          + (f"not equal in {', '.join(differ)}" if differ else "equal"))
    # 4-ASK at 7.5 dB, where avg_iter is close to BPSK's at 2.0 dB, the same quota
    ask4 = sweep((mod.Constellation.mask(4, GRAY_LABELS[4]), mapper("bench1152", 4)), (7.5,))
    print(f"4-ASK 1152 at 7.5 dB, {int(ask4.frames[0])} frames: FER {ask4.fer[0]:.4e}, avg_iter "
          f"{ask4.avg_iter[0]:.4f}, {1.0 / ask4.time[0]:.0f} frames/s = "
          f"{bpsk.time[0] / ask4.time[0]:.3f}x BPSK at 2.0 dB (avg_iter {bpsk.avg_iter[0]:.4f}) "
          f"[{name_power}]")
    fused_counts = read_counts()
    check(fused_counts["pool_refill"] > 0 and fused_counts["stream_reload"] == 0
          and fused_counts["stream_reload_staged"] == 0,
          f"the use_pallas sweeps (BPSK, M = 2, 4-ASK) did not run the fused step: "
          f"{fused_counts}")

    # -- a modulated --error-log point, dE recomputed on the host
    log = work / "errors_4ask.txt"
    m4 = (mod.Constellation.mask(4, GRAY_LABELS[4]), mapper("bench1152", 4))
    res = Simulator(code, DecoderParams(iterations=ITERS),
                    ChannelParams(seed=4, x_values=(MOD_SNRS[4][0],)),
                    SimulationParams(batch_size=BATCH, fec=50, max_frames=2_000_000,
                                     error_log_file=str(log), error_log_codewords=True),
                    device=dev, verbose=False, use_pallas=True, modulation=m4).start()
    lines = log.read_text().splitlines()
    check(len(lines) == int(res.fec[0]) > 0, "modulated error log: a line per frame error")
    cstl, mp = m4
    weights = (1 << np.arange(1, -1, -1))[:, None]

    def points(hexword):
        word = np.unpackbits(np.frombuffer(bytes.fromhex(hexword), np.uint8))[:code.nc]
        return cstl.points[cstl.labels_rev[(word[mp].astype(np.int64) * weights).sum(0)]]

    for ln in lines:
        fields = dict(kv.split("=", 1) for kv in ln.split() if "=" in kv)
        d = points(fields["decided_cw"]) - points(fields["true_cw"])
        host = f"{math.sqrt(float((d * d).sum())):.3f}"
        check(fields["dE"] == host, f"modulated error log: dE {fields['dE']}, the host's {host}")
    print(f"modulated error log, 1152 4-ASK {MOD_SNRS[4][0]} dB: {len(lines)} lines, every dE "
          f"equal to the host's recomputation from the logged words")

    # -- the formerly refused bfloat16 sweep: n = 16384, 49152 edges
    big = make_benchmark_code(16384, 3, 6, seed=0)
    write_codefile(str(work / "big.txt"), big.rows, big.cols, big.nc, big.mc)
    want = tpu_layout(big, DecoderParams(message_dtype="bfloat16"), True)
    check(want == ("clos", "bfloat16", ()), f"routing of the 49152-edge code: {want}")
    argv = [str(work / "big.txt"), str(work / "res_big_bf16.txt"), *BIG_SWEEP, "-i", str(ITERS),
            "--batch-size", str(BATCH), "--frame-error-count", "50", "--max-frames", "1000000",
            "--pallas", "--message-dtype", "bfloat16", "--device", str(dev)]
    check(cli.main(argv) == 0, "the bfloat16 sweep of the 49152-edge code")
    big_form = df.bp_stream_chunk_fused.last_form  # the sweep's, its last K2 launch
    head, rows_ = read_rows("res_big_bf16.txt")
    check(f"dtype={want[1]} " in head and "fallback" not in head, f"49152-edge provenance: {head}")
    for r in rows_:
        print(f"bf16 (3,6) n=16384 {r[0]} dB: FER {r[1]:.4e} frames {int(r[3])} avg_iter "
              f"{r[4]:.3f} frames/s {1.0 / r[5]:.0f} [{name_power}]")
    extra = read_counts()
    print(f"M = 2 / error-log / bfloat16 path launches: {extra}")
    check(extra["bp_stream_chunk_fused_bf16"] > 0, "the 49152-edge sweep did not run K2 bf16")
    check(extra["bp_decode_fused"] > 0, "the modulated error log did not run K1")

    # -- K2's bfloat16 form on the 49152-edge code at B = 16384 against its
    # plain chunk (and K1's form) on the same frames: pool drains, the form
    # the sweep ran
    tb_big = kernel_tables(to_sorted_device(big, dev))
    rule = df.stream_form(tb_big, "bfloat16")
    print(f"K2 bf16 form on the 49152-edge code: the sweep ran {big_form}, the size rule says "
          f"{rule}")
    check(big_form == rule, "the 49152-edge sweep did not run the size rule's K2 form")
    check_big_bf16_drains(tb_big, awgn_channel(tb_big.code, make_generator(dev, 7, 12, 0), BATCH,
                                                float(BIG_SWEEP[0])), df)
    check(df.bp_stream_chunk_fused.last_form == rule, "the drains did not run the rule's K2 form")

    # -- K5 on wifi 1944 against its plain version, in the rule's form and in
    # the plane form on the same frames, then timed (phase 10's manner)
    tb = tables["wifi1944"]
    ch = awgn_channel(tb.code, make_generator(dev, 7, 8, 0), BATCH, COMPARE_SNR_DB)
    err = plain_ms = 0.0
    rule = dl.exact_form(tb)
    for form, et in (("BP_MS", True), ("BP", False)):
        got = dl.bp_decode_layered(tb, ch.llr, ITERS, et, form)
        check(dl.bp_decode_layered.last_form == rule, "K5 wifi1944 did not run the rule's form")
        try:
            dl.EXACT_FORM_OVERRIDE = (0, False)
            got_plane = dl.bp_decode_layered(tb, ch.llr, ITERS, et, form)
        finally:
            dl.EXACT_FORM_OVERRIDE = None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want_ = dl.bp_decode_layered_plain(tb, ch.llr, ITERS, et, form)
        end.record()
        torch.cuda.synchronize()
        for what, out_ in (("rule's form", got), ("plane form", got_plane)):
            same_ = (out_.hard == want_.hard).all(0) & (out_.iterations == want_.iterations)
            if form == "BP":
                check(same_.float().mean().item() >= 0.999,
                      f"K5 wifi1944 BP {what}: decisions disagree")
                torch.testing.assert_close(out_.llr_out[:, same_], want_.llr_out[:, same_],
                                           rtol=1e-4, atol=1e-4)
                if out_ is got:
                    plain_ms = start.elapsed_time(end)
                    err = (out_.llr_out - want_.llr_out)[:, same_].abs().max().item()
            else:
                check(bool(same_.all()) and torch.equal(out_.llr_out, want_.llr_out),
                      f"K5 wifi1944 BP_MS {what} not bit-exact")
            print(f"K5 wifi1944 {form} et={int(et)} {what}: frames agreeing "
                  f"{same_.float().mean().item():.6f} (the rule's form {rule})")
    ms = cuda_ms(lambda: dl.bp_decode_layered(tb, ch.llr, ITERS, False, "BP"), 3)
    return counts, {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "form": rule}


#: phases 13-14: the stopping rule of the wide sweeps (max_frames binds at
#: the highest SNR / lowest epsilon of each)
WIDE_FEC = 100
WIDE_MAX = 12 * BATCH
WIDE_SNRS = (1.0, 1.5, 2.0, 2.5)
WIDE_LOG_SNRS = (2.0, 2.25, 2.5, 2.75)
WIDE_BEC_EPS = (0.45, 0.42, 0.39, 0.36)


def z_score(f1, n1, f2, n2) -> float:
    """Two-proportion z of FERs ``f1`` over ``n1`` and ``f2`` over ``n2``."""
    p = (f1 * n1 + f2 * n2) / (n1 + n2)
    return 0.0 if p in (0.0, 1.0) else (f1 - f2) / math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


@contextlib.contextmanager
def plain_superstep():
    """Inside it, the XLA streaming super-step's makers build the plain
    super-step (``ops.streaming._superstep_body``, its draws K8's full batch
    on each pass's key) on the card: the reference the card's launches are
    held to."""
    from libldpc_tpu_torch.ops import streaming

    saved = streaming._runs_kernels
    streaming._runs_kernels = lambda device: False
    try:
        yield
    finally:
        streaming._runs_kernels = saved


def check_counters(tag, got, want, frames: int, nc: int, exact: bool) -> None:
    """One shard's counters of a kernel step against its plain step's:
    equal in the min-sum family and the BEC; for BP, off by at most what
    ``compare_batch``'s rule allows (0.1 % of the shard's frames
    disagreeing, each by at most every bit and every iteration)."""
    got, want = [int(v) for v in got], [int(v) for v in want]
    if exact:
        check(got == want, f"{tag}: kernel {got} plain {want}")
        return
    n_tol = math.ceil(0.001 * frames)
    bounds = [n_tol * nc, n_tol, n_tol, n_tol * ITERS, n_tol][:len(got)]
    check(all(abs(a - b) <= t for a, b, t in zip(got, want, bounds)),
          f"{tag}: kernel {got} plain {want} past {bounds}")


def run_wide_slice(dev, codes, tables, name_power, zero_counts, read_counts) -> dict:
    """Phase 13, the point-parallel sweep on one card at B = 16384 a point:
    ``Simulator.start_wide`` on a ``(2, 2)`` mesh of this card (8192 frames
    a shard, the shards of a point one after another) over four points of
    the 1152 code streaming on K2 (f32 BP) twice, with ``--pallas`` (the
    fused step, ``"fused-pool"``) and without (the XLA super-step,
    ``"xla-superstep"``: K2 one pass a launch and K8's reload form), wifi
    1944 on K4 (``--layer-file --pallas``), the 1152 code batch-stepped with
    the error log on K1, and the BEC on K6, each counted and its engine
    checked; per point the stopping rule, exact frame counts, FER against
    ``start()`` on the same card (|z| < 3), every error-log line's ``dE``
    against the host's recomputation.  Then, for one batch (one super-step)
    of each kernel and of each streaming engine, the per-shard counters of
    the kernel step against its plain step on the same generators.
    Returns the launches and the two K2 sweeps' rows by engine (phase 14's
    references)."""
    import numpy as np

    from libldpc_tpu_torch.ops.streaming import make_streaming_multipoint_step
    from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_multipoint_step
    from libldpc_tpu_torch.parallel.mesh import (
        FRAME_AXIS, POINT_AXIS, make_mesh, make_multipoint_sim_step, shard_generators,
    )
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

    work = WORK / "slice13"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    mesh = make_mesh((2, 2), (POINT_AXIS, FRAME_AXIS), [dev] * 4)
    # (tag, code, kernel counted, channel, decoder, --pallas, the engine)
    cases = (
        ("K2 1152", "bench1152", "bp_stream_chunk_fused",
         ChannelParams(seed=21, x_values=WIDE_SNRS), DecoderParams(iterations=ITERS), True,
         "fused-pool"),
        ("K2 1152 XLA super-step", "bench1152", "stream_reload",
         ChannelParams(seed=21, x_values=WIDE_SNRS), DecoderParams(iterations=ITERS), False,
         "xla-superstep"),
        ("K4 wifi1944", "wifi1944", "bp_stream_chunk_layered_fast",
         ChannelParams(seed=22, x_values=WIDE_SNRS),
         DecoderParams(iterations=ITERS, layered=True), True, "fused-pool"),
        ("K1 1152 error log", "bench1152", "bp_decode_fused",
         ChannelParams(seed=23, x_values=WIDE_LOG_SNRS), DecoderParams(iterations=ITERS), False,
         "batch"),
        ("K6 1152 BEC", "bench1152", "bec_decode_fused",
         ChannelParams(seed=24, x_values=WIDE_BEC_EPS, type="BEC"),
         DecoderParams(iterations=ITERS), False, "batch"),
    )
    launches, k2_rows = {}, {}
    for tag, key, kernel, ch, dec, pallas, engine in cases:
        logged = kernel == "bp_decode_fused"

        def build(run):
            extra = dict(error_log_file=str(work / f"{kernel}_{run}.log"),
                         error_log_codewords=True) if logged else {}
            return Simulator(codes[key], dec, ch,
                             SimulationParams(batch_size=BATCH, fec=WIDE_FEC, max_frames=WIDE_MAX,
                                              result_file=str(work / f"{kernel}_{run}.txt"),
                                              **extra),
                             device=dev, verbose=False, use_pallas=pallas)

        sim = build("wide")
        check(sim.engine == engine, f"{tag}: engine {sim.engine}, not {engine}")
        zero_counts()
        t0 = time.perf_counter()
        wide = sim.start_wide(mesh)
        t_wide = time.perf_counter() - t0
        counts = read_counts()
        launches[tag] = counts[kernel]
        print(f"phase 13 {tag} start_wide launches: "
              f"{ {k: v for k, v in counts.items() if v} }")
        check(counts[kernel] > 0, f"the wide {tag} sweep did not run {kernel}")
        if engine != "batch":
            xla = engine == "xla-superstep"
            check(counts["stream_reload"] > 0 if xla else counts["stream_reload"] == 0,
                  f"{tag}: K8's reload form ran {counts['stream_reload']} times")
            check(counts["pool_refill"] == 0 if xla else counts["pool_refill"] > 0,
                  f"{tag}: the pool's refill ran {counts['pool_refill']} times")
            if xla:
                check(counts["bp_stream_chunk_fused"] > 0, f"{tag}: K2 did not run")
        t0 = time.perf_counter()
        seq = build("start").start()
        t_seq = time.perf_counter() - t0
        heads = [(work / f"{kernel}_{r}.txt").read_text().splitlines()[0] for r in ("wide", "start")]
        check(heads[0] == heads[1], f"{tag}: provenance {heads}")
        streaming = "streaming=on" in heads[0]
        check(streaming == (not logged and ch.type != "BEC"), f"{tag}: {heads[0]}")
        for i, x in enumerate(wide.x_values):
            for name, r in (("wide", wide), ("start", seq)):
                if streaming:
                    check(r.fec[i] >= WIDE_FEC or r.frames[i] == WIDE_MAX,
                          f"{tag} {name} {x}: stopping rule ({r.fec[i]}, {r.frames[i]})")
                    check(r.frames[i] <= WIDE_MAX, f"{tag} {name} {x}: past the quota")
                else:
                    check(r.fec[i] >= WIDE_FEC or r.frames[i] >= WIDE_MAX,
                          f"{tag} {name} {x}: stopping rule")
                    check(r.frames[i] % BATCH == 0, f"{tag} {name} {x}: whole batches")
            z = z_score(wide.fer[i], wide.frames[i], seq.fer[i], seq.frames[i])
            check(abs(z) < 3, f"{tag} {x}: FER {wide.fer[i]} against start() {seq.fer[i]}")
            print(f"phase 13 {tag} {x}: wide FER {wide.fer[i]:.4e} frames {int(wide.frames[i])} "
                  f"avg_iter {wide.avg_iter[i]:.3f} frames/s {1.0 / wide.time[i]:.0f} | start() "
                  f"FER {seq.fer[i]:.4e} frames {int(seq.frames[i])} frames/s "
                  f"{1.0 / seq.time[i]:.0f} | z {z:.2f} [{name_power}]")
        print(f"phase 13 {tag}: start_wide {t_wide:.2f} s, start() {t_seq:.2f} s of host time "
              f"for {int(wide.frames.sum())} / {int(seq.frames.sum())} frames "
              f"({wide.frames.sum() / t_wide:.0f} / {seq.frames.sum() / t_seq:.0f} frames/s)")
        if key == "bench1152" and engine != "batch":
            k2_rows[engine] = wide
        if logged:
            code = codes[key]
            for run, r in (("wide", wide), ("start", seq)):
                lines = (work / f"{kernel}_{run}.log").read_text().splitlines()
                check(len(lines) == int(r.fec.sum()), f"{tag} {run}: a line per frame error")
                for ln in lines:
                    fields = dict(kv.split("=", 1) for kv in ln.split() if "=" in kv)
                    words = [np.unpackbits(np.frombuffer(bytes.fromhex(fields[w]), np.uint8))
                             [:code.nc] for w in ("decided_cw", "true_cw")]
                    diff = int((words[0][code.bit_pos] != words[1][code.bit_pos]).sum())
                    host = f"{2.0 * math.sqrt(diff):.3f}"
                    check(fields["dE"] == host and int(fields["bit_errors"]) == diff,
                          f"{tag} {run} error log: dE {fields['dE']}, the host's {host}")
                print(f"phase 13 {tag} {run}: {len(lines)} error-log lines, every dE equal to "
                      f"the host's recomputation from the logged words")

    # one batch (one super-step) of each kernel, per shard, against its
    # plain step on the same generators
    xs = {"bench1152": [COMPARE_SNR_DB, 2.0], "wifi1944": [COMPARE_SNR_DB, 2.0]}
    for form in ("BP_MS", "BP"):
        dec = DecoderParams(iterations=ITERS, type=form)
        steps = [make_multipoint_sim_step(tables["bench1152"], "AWGN", dec, BATCH // 2,
                                          "flooding", mesh, plain=p) for p in (False, True)]
        got, want = (s.per_shard(shard_generators(mesh, 7, 13, 0), xs["bench1152"])
                     for s in steps)
        for i, (g, w) in enumerate(zip(got, want)):
            check_counters(f"K1 shard {i} {form}", g, w, BATCH // 2, 1152, form != "BP")
        print(f"phase 13 K1 {form} per shard (kernel / plain): "
              f"{[[int(v) for v in g] for g in got]} / {[[int(v) for v in w] for w in want]}")
        for key, layered, name in (("bench1152", False, "K2"), ("wifi1944", True, "K4")):
            bundles = [make_streaming_fused_multipoint_step(
                tables[key], "AWGN", DecoderParams(iterations=ITERS, type=form, layered=layered),
                BATCH // 2, mesh, layered=layered, plain=p) for p in (False, True)]
            got, want = (step.per_shard(init(), shard_generators(mesh, 7, 14, 0), xs[key],
                                        [True, True]) for init, step in bundles)
            for i, (g, w) in enumerate(zip(got, want)):
                check_counters(f"{name} shard {i} {form}", g, w, BATCH // 2,
                               tables[key].code.nc, form != "BP")
            print(f"phase 13 {name} {form} per shard, one super-step (kernel / plain): "
                  f"{[[int(v) for v in g] for g in got]} / {[[int(v) for v in w] for w in want]}")
        # the XLA super-step (the default engine) against the plain
        # super-step on the card, on the same generators
        bundles = []
        for p in (False, True):
            with plain_superstep() if p else contextlib.nullcontext():
                bundles.append(make_streaming_multipoint_step(
                    tables["bench1152"], "AWGN", dec, BATCH // 2, mesh))
        got, want = (step.per_shard(init(), shard_generators(mesh, 7, 16, 0), xs["bench1152"],
                                    [True, True]) for init, step in bundles)
        for i, (g, w) in enumerate(zip(got, want)):
            check_counters(f"XLA super-step shard {i} {form}", g, w, BATCH // 2, 1152,
                           form != "BP")
        print(f"phase 13 XLA super-step {form} per shard, one super-step (kernel / plain): "
              f"{[[int(v) for v in g] for g in got]} / {[[int(v) for v in w] for w in want]}")
    steps = [make_multipoint_sim_step(tables["bench1152"], "BEC", DecoderParams(iterations=ITERS),
                                      BATCH // 2, "flooding", mesh, plain=p) for p in (False, True)]
    got, want = (s.per_shard(shard_generators(mesh, 7, 15, 0), [0.40, 0.42]) for s in steps)
    for i, (g, w) in enumerate(zip(got, want)):
        check_counters(f"K6 shard {i}", g, w, BATCH // 2, 1152, True)
    print(f"phase 13 K6 per shard (kernel / plain): {[[int(v) for v in g] for g in got]} / "
          f"{[[int(v) for v in w] for w in want]}")
    return {"launches": launches, "k2_rows": k2_rows}


#: phase 14: runs the CLI with the given arguments and prints, on every
#: rank, the counters of the sweep it ran and the kernels' launches
RANK_WORKER = """
import json, sys
sys.path.insert(0, {root!r})
from libldpc_tpu_torch import cli
from libldpc_tpu_torch.ops.kernels import decode_fused as df
from libldpc_tpu_torch.ops.kernels import pool_refill as pr
from libldpc_tpu_torch.sim import driver

start_wide = driver.Simulator.start_wide


def reported(self, *a, **k):
    res = start_wide(self, *a, **k)
    print("RESULT " + json.dumps({{"frames": res.frames.tolist(), "fec": res.fec.tolist(),
                                  "ber": res.ber.tolist(), "avg_iter": res.avg_iter.tolist(),
                                  "time": res.time.tolist(), "engine": self.engine}}), flush=True)
    print("LAUNCHES " + json.dumps({{"k2": df.bp_stream_chunk_fused.launches["float32"],
                                    "reload": pr.stream_reload.launches,
                                    "refill": pr.pool_refill.launches}}), flush=True)
    return res


driver.Simulator.start_wide = reported
sys.exit(cli.main(sys.argv[1:]))
"""


def run_two_ranks(dev, codes, name_power, refs) -> dict:
    """Phase 14, two processes on this card: two ranks of ``python -m
    libldpc_tpu_torch.cli --multihost --points-parallel 2`` (gloo on the
    host for the counters, each rank on ``cuda:0`` with one point of each
    group, 16384 frames), phase 13's K2 sweep, once with ``--pallas`` (the
    fused step) and once without (the XLA super-step).  Both ranks must
    report the same counters and the engine of their command line, only
    rank 0 may write its results file, and the rows must match phase 13's
    of the same engine (|z| < 3).  A rank that fails or hangs fails the
    phase."""
    import socket

    from libldpc_tpu_torch.models import write_codefile

    work = WORK / "slice14"
    work.mkdir(parents=True, exist_ok=True)
    for f in work.iterdir():
        f.unlink()
    code = codes["bench1152"]
    write_codefile(str(work / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r_, c_ = code.G.nonzero()
    (work / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r_, c_)))
    (work / "worker.py").write_text(RANK_WORKER.format(root=str(ROOT)))
    launches = {}
    for engine, flags in (("fused-pool", ["--pallas"]), ("xla-superstep", [])):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = []
        t0 = time.perf_counter()
        for rank in range(2):
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
            argv = [sys.executable, str(work / "worker.py"), str(work / "h.txt"),
                    str(work / f"res_{engine}_{rank}.txt"), str(WIDE_SNRS[0]),
                    str(WIDE_SNRS[-1] + 0.01), str(WIDE_SNRS[1] - WIDE_SNRS[0]), "-G",
                    str(work / "g.txt"), "-i", str(ITERS), "-s", "21", "--batch-size", str(BATCH),
                    "--frame-error-count", str(WIDE_FEC), "--max-frames", str(WIDE_MAX),
                    "--multihost", "--points-parallel", "2", "--device", str(dev), *flags]
            procs.append(subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True, env=env, cwd=str(ROOT)))
        outs = []
        try:
            for rank, p in enumerate(procs):
                try:
                    out, _ = p.communicate(timeout=400)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"check failed: {engine} rank {rank} hung") from None
                outs.append(out)
                print(f"--- {engine} rank {rank} (exit {p.returncode})\n{out[-1500:]}")
                check(p.returncode == 0, f"{engine} rank {rank} exited {p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        res = []
        for rank, out in enumerate(outs):
            found = {k: [ln[len(k) + 1:] for ln in out.splitlines() if ln.startswith(k + " ")]
                     for k in ("RESULT", "LAUNCHES")}
            check(all(len(v) == 1 for v in found.values()), f"{engine} rank {rank}: no result")
            res.append((json.loads(found["RESULT"][0]), json.loads(found["LAUNCHES"][0])))
        (r0, l0), (r1, l1) = res
        for k in ("frames", "fec", "ber", "avg_iter", "engine"):
            check(r0[k] == r1[k], f"the {engine} ranks disagree on {k}: {r0[k]} / {r1[k]}")
        check(r0["engine"] == engine, f"two ranks with {flags}: engine {r0['engine']}")
        xla = engine == "xla-superstep"
        for rank, lr in enumerate((l0, l1)):
            check(lr["k2"] > 0 and (lr["reload"] > 0) == xla and (lr["refill"] > 0) != xla,
                  f"{engine} rank {rank} launches: {lr}")
        check((work / f"res_{engine}_0.txt").exists()
              and not (work / f"res_{engine}_1.txt").exists(),
              f"{engine}: the results file was not written by rank 0 alone")
        head = (work / f"res_{engine}_0.txt").read_text().splitlines()[0]
        check(head.startswith("# kernel=cuda-fused") and "streaming=on" in head,
              f"{engine} rank 0: {head}")
        ref = refs[engine]
        for i, x in enumerate(WIDE_SNRS):
            fer = r0["fec"][i] / r0["frames"][i]
            check(r0["fec"][i] >= WIDE_FEC or r0["frames"][i] == WIDE_MAX,
                  f"{engine} rank 0 {x}: stopping rule")
            z = z_score(fer, r0["frames"][i], ref.fer[i], ref.frames[i])
            check(abs(z) < 3, f"two ranks {engine} {x}: FER {fer} against phase 13's {ref.fer[i]}")
            print(f"phase 14 two ranks {engine} {x} dB: FER {fer:.4e} frames {r0['frames'][i]} "
                  f"avg_iter {r0['avg_iter'][i]:.3f} frames/s {1.0 / r0['time'][i]:.0f} | one "
                  f"process (phase 13) FER {ref.fer[i]:.4e} frames/s {1.0 / ref.time[i]:.0f} | z "
                  f"{z:.2f} [{name_power}]")
        print(f"phase 14 {engine}: two ranks on one card, {wall:.1f} s wall (start-up and build "
              f"load included), launches {l0} + {l1}")
        launches[engine] = [l0, l1]
    return launches


def run_tuning(dev, tables, name_power) -> None:
    """Phase 15, gradient tuning on the card: ``tune_nms_scales`` on the
    (dv = 4, dc = 16) n = 1024 code at 5 dB, 15 iterations, and
    ``tune_oms_offsets`` (``quant_scale`` 0.1875) on wifi 1944 at 50
    iterations, with the JAX defaults (40 / 60 steps, B = 256); ms a step,
    peak memory and held-out FER against plain min-sum (alpha = 1, offset
    0).  Then ``decode_soft`` at a constant 0.8 against K1 ``BP_NMS`` 0.8
    (no ET, 15 iterations) on the same B = 16384 LLRs, within 1e-4."""
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops import tuning
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    tb16 = kernel_tables(to_sorted_device(make_benchmark_code(1024, dv=4, dc=16, seed=0), dev))
    sdc16 = tb16.code

    def held_out_fer(sdc, decode, snr, batches=8, b=4096):
        fe = 0
        tx = sdc.bit_pos.long()
        with torch.no_grad():
            for i in range(batches):
                ch = awgn_channel(sdc, make_generator(dev, 3000, i), b, snr)
                hard = decode(ch.llr) <= 0
                fe += int(((hard[tx] != ch.codeword[tx].bool()).sum(0) > 0).sum())
        return fe / (batches * b)

    for label, sdc, run, decode_plain, decode_tuned, snr in (
            ("NMS dc=16 n=1024, 5 dB, 15 it", sdc16,
             lambda: tuning.tune_nms_scales(sdc16, 5.0, iterations=15),
             lambda llr: tuning.decode_soft(sdc16, llr, torch.ones(15, device=dev)),
             lambda s: (lambda llr: tuning.decode_soft(sdc16, llr, s)), 5.0),
            ("OMS int8-lattice wifi 1944, 1.5 dB, 50 it", tables["wifi1944"].code,
             lambda: tuning.tune_oms_offsets(tables["wifi1944"].code, 1.5, quant_scale=0.1875),
             lambda llr: tuning.decode_soft_oms(tables["wifi1944"].code, llr,
                                                torch.zeros(ITERS, device=dev))[-1],
             lambda b: (lambda llr: tuning.decode_soft_oms(tables["wifi1944"].code, llr, b,
                                                           quant_scale=0.1875)[-1]), 1.5)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = res.losses.tolist()
        check(all(math.isfinite(v) for v in losses), f"{label}: loss not finite")
        fer_plain = held_out_fer(sdc, decode_plain, snr)
        fer_tuned = held_out_fer(sdc, decode_tuned(res.scales), snr)
        print(f"phase 15 {label}: {secs / len(losses) * 1e3:.1f} ms a step over {len(losses)} "
              f"steps, peak memory {peak:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
              f"held-out FER (32768 frames) tuned {fer_tuned:.4e} against plain min-sum "
              f"{fer_plain:.4e}; schedule {[round(v, 3) for v in res.scales.tolist()]} "
              f"[{name_power}]")
        if label.startswith("NMS"):  # the JAX test's criteria
            check(sum(losses[-4:]) < sum(losses[:4]), f"{label}: the loss did not fall")
            check(fer_tuned < 0.7 * fer_plain, f"{label}: tuned FER {fer_tuned} not below "
                                               f"0.7x plain {fer_plain}")
        else:
            check(bool(((res.scales >= 0) & (res.scales <= 1.5)).all()), f"{label}: clip")
    llr = awgn_channel(sdc16, make_generator(dev, 7, 16, 0), BATCH, 5.0).llr
    out = df.bp_decode_fused(tb16, llr, iterations=15, early_term=False,
                             minsum_mode=("BP_NMS", 0.8, 0.0))
    with torch.no_grad():
        soft = tuning.decode_soft(sdc16, llr, torch.full((15,), 0.8, device=dev))
    err = (soft - out.llr_out).abs().max().item()
    torch.testing.assert_close(soft, out.llr_out, rtol=1e-4, atol=1e-4)
    print(f"phase 15 decode_soft at 0.8 against K1 BP_NMS 0.8 (dc=16 n=1024, 15 it, no ET, "
          f"B = {BATCH}): max_abs_err {err:.3e}")


#: phase 7e: K8 draws once 3/4 of the pool is used (12,288 of 16,384
#: entries); the used entries of its checks and times, and its channels
POOL_USED = 13000
POOL_CHANNELS = (("BPSK", "AWGN", 2.0), ("4-ASK", "AWGN", 7.5), ("BSC", "BSC", 0.05),
                 ("BEC", "BEC", BEC_EPS))
#: phase 7e: K8's times: (code, channel) pairs, each drawn at POOL_USED and
#: as a full batch
POOL_TIMED = (("bench1152", "BPSK"), ("bench1152", "4-ASK"), ("bench1152", "BSC"),
              ("bench1152", "BEC"), ("wifi1944", "BPSK"))
#: phase 7f: a chunk's quota that every idle lane's start fits in its first
#: pass and that binds in a later one
BINDING = BATCH // 2 + 1000
#: phase 7f: the batch sizes the lane-order scans are held at (16-byte
#: vectors, a ragged last run, a single partial run)
SCAN_BATCHES = (BATCH, 1000, 33)


def pool_case(tb, kind, channel_type, x_value, used=POOL_USED):
    """K8's tables for one channel on ``tb`` (4-ASK: Gray labels, the
    transmitted bits mapped consecutively) and a pool of ``BATCH`` entries
    with ``used`` of them used, its values sentinels."""
    from libldpc_tpu_torch.ops import modulation as mod
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr

    sdc, dev = tb.code, tb.device
    modulation = None
    if kind == "4-ASK":
        modulation = (mod.Constellation.mask(4, GRAY_LABELS[4]),
                      sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
    g = torch.Generator(device="cpu").manual_seed(3)
    avail = torch.ones(BATCH, dtype=torch.int32)
    avail[torch.randperm(BATCH, generator=g)[:used]] = 0
    vals = torch.uint8 if channel_type == "BEC" else torch.float32
    state = dict(avail=avail.to(dev),
                 fresh=torch.full((sdc.nc, BATCH), 1 if channel_type == "BEC" else 123.0,
                                  dtype=vals, device=dev),
                 fresh_cw=torch.full((sdc.nc, BATCH), 7, dtype=torch.uint8, device=dev),
                 ctr=torch.zeros((5, BATCH), dtype=torch.int32, device=dev),
                 started=torch.zeros(1, dtype=torch.int64, device=dev),
                 remaining=torch.zeros(1, dtype=torch.int32, device=dev))
    return pr.pool_tables(sdc, channel_type, modulation), modulation, state


def syndromes_zero(tb, cw) -> bool:
    """``H c = 0`` for every column of ``cw`` (u8 ``[nc, n]``, sorted labels)."""
    row_ptr = tb.row_ptr.long()
    rows = torch.repeat_interleave(torch.arange(tb.code.mc, device=cw.device),
                                   row_ptr[1:] - row_ptr[:-1])
    par = torch.zeros((tb.code.mc, cw.shape[1]), dtype=torch.int32, device=cw.device)
    par.index_add_(0, rows, cw.index_select(0, tb.col_sorted.long()).to(torch.int32))
    return bool((cw <= 1).all()) and bool(((par % 2) == 0).all())


def encoded(tb, info):
    """``u G mod 2`` of info words ``info`` (int32 ``[kwords, n]``, bit ``i``
    of word ``j`` info bit ``32 j + i``), u8 ``[nc, n]``."""
    G = tb.code.G
    shifts = torch.arange(32, device=info.device, dtype=torch.int64)
    bits = ((info.to(torch.int64)[:, None, :] >> shifts[None, :, None]) & 1).reshape(-1, info.shape[1])
    return (torch.matmul(G.t(), bits[: G.shape[0]].to(torch.float32)).to(torch.int64) % 2).to(
        torch.uint8)


def check_drawn(tag, tb, pt, channel_type, x, modulation, cw, vals, draws, info) -> float:
    """K8's drawn columns against the plain formulas: codewords with ``H c
    = 0`` equal to ``u G`` of the lanes' info words; the values equal to
    ``channel_values`` on the codewords and K8's own draws (4-ASK within
    1e-5 relative).  Returns the largest 4-ASK |difference| (0 elsewhere)."""
    from libldpc_tpu_torch.ops import channel

    check(syndromes_zero(tb, cw), f"{tag}: a drawn codeword with H c != 0")
    check(pt.gtiles is None or torch.equal(cw, encoded(tb, info)),
          f"{tag}: a drawn codeword is not u G of its info words")
    check(not bool(torch.isnan(draws).any()), f"{tag}: an item without its draw")
    want = channel.channel_values(tb.code, channel_type, cw, draws, x, modulation)
    if modulation is not None:
        rel = float(((vals - want).abs() / want.abs().clamp(min=1.0)).max())
        check(rel <= 1e-5, f"{tag}: relative error {rel:.2e}")
        return float((vals - want).abs().max())
    check(torch.equal(vals, want), f"{tag}: values differ from the plain formulas on its draws")
    return 0.0


def pool_z(tb, channel_type, a_pool, b_pool) -> tuple:
    """The drawn transmitted bits' mean signed LLR (AWGN), flip share (BSC)
    or erasure share (BEC) of two pools ``(values, codewords)``, and their z."""
    tx = tb.code.bit_pos.long()
    stats = []
    for v, c in (a_pool, b_pool):
        v, c = v[tx].double(), c[tx].double()
        stats.append(((v == 2).double() if channel_type == "BEC" else
                      ((v < 0).double() != c).double() if channel_type == "BSC" else
                      v * (1 - 2 * c)).flatten())
    a, b = stats
    z = float((a.mean() - b.mean()).abs() / (a.var() / a.numel() + b.var() / b.numel()).sqrt())
    return float(a.mean()), float(b.mean()), z


def k8_bound(pt, taken: int, batch: int, refill: bool):
    """K8's bound: each drawn entry's values (float32, u8
    for the BEC) and codeword (u8) written once, and for a refill ``avail``
    (and ``ctr``'s starts row) read once and ``avail`` written once; the
    encode counted word-wise, an AND and an XOR per generator word."""
    from libldpc_tpu_torch.utils.roofline import bound

    nc = pt.code.nc
    nbytes = taken * nc * (2 if pt.channel_type == "BEC" else 5) + (batch * 4 * 3 if refill else 0)
    return bound(nbytes, taken * nc * 2 * pt.kw)


def run_pool_refill(dev, tables, name_power) -> dict:
    """Phase 7e: K8 (the channel draw) against its plain version on the
    1152 code and wifi 1944, for BPSK, 4-ASK, BSC and the BEC, in both its
    forms.  The refill (``POOL_USED`` of ``BATCH`` entries used): the
    entries taken, ``avail`` after, the untouched entries and ``remaining``
    equal to the plain refill's.  The full batch (``channel_batch``):
    shapes and types as ``simulate_channel``'s.  In both: every drawn
    codeword with ``H c = 0`` and equal to ``u G`` of its lane's info words
    (the ``debug_info`` plane); the plain formulas on K8's codewords and its
    drawn normals or uniforms (its ``debug`` plane) equal to K8's values
    (4-ASK within 1e-5 relative); the drawn entries' mean signed LLR, flip
    or erasure share within 5 standard errors of the plain version's.  A
    batch step of K1, K5 and K6 drawn through ``channel_batch`` counts as
    its plain step on the same draws.  Then the refill (and its plan and
    draw apart) and the full batch timed against the plain versions on
    ``POOL_TIMED``.  Returns K8's largest errors, times and bounds."""
    from libldpc_tpu_torch.ops import channel
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.parallel.mesh import make_sim_step
    from libldpc_tpu_torch.sim.driver import DecoderParams

    refill_on = torch.ones(1, dtype=torch.int32, device=dev)

    def refill(fn, pt, st, x, seed, **kw):
        fn(pt, channel.make_generator(dev, 5, seed), x, refill_on, st["avail"], st["fresh"],
           st["fresh_cw"], st["ctr"], st["started"], 10**9, st["remaining"], **kw)

    err = {"pool_refill": 0.0, "channel_batch": 0.0}
    for key in ("bench1152", "wifi1944"):
        tb = tables[key]
        for kind, channel_type, x in POOL_CHANNELS:
            pt, modulation, s0 = pool_case(tb, kind, channel_type, x)
            taken = s0["avail"] == 0
            k8 = {n: t.clone() for n, t in s0.items()}
            plain = {n: t.clone() for n, t in s0.items()}
            debug = torch.full((pt.item_src.shape[0], BATCH), float("nan"), device=dev)
            info = torch.zeros((pt.kwords, BATCH), dtype=torch.int32, device=dev)
            refill(pr.pool_refill, pt, k8, x, 1, debug=debug, debug_info=info)
            refill(pr.pool_refill_plain, pt, plain, x, 1)
            torch.cuda.synchronize()
            check(torch.equal(k8["avail"], plain["avail"]) and bool((k8["avail"] == 1).all()),
                  f"K8 {key} {kind}: avail after")
            check(torch.equal(k8["remaining"], plain["remaining"]), f"K8 {key} {kind}: remaining")
            for name in ("fresh", "fresh_cw"):
                check(torch.equal(k8[name][:, ~taken], s0[name][:, ~taken]),
                      f"K8 {key} {kind}: an untouched entry moved")
                check(not bool((k8[name][:, taken] == s0[name][:, taken]).all(0).any()),
                      f"K8 {key} {kind}: a used entry was not drawn")
            err["pool_refill"] = max(err["pool_refill"], check_drawn(
                f"K8 {key} {kind}", tb, pt, channel_type, x, modulation, k8["fresh_cw"][:, taken],
                k8["fresh"][:, taken], debug[:, taken], info[:, taken]))
            a, b, z = pool_z(tb, channel_type, (k8["fresh"][:, taken], k8["fresh_cw"][:, taken]),
                             (plain["fresh"][:, taken], plain["fresh_cw"][:, taken]))
            print(f"K8 {key} {kind} ({channel_type} {x}): {int(taken.sum())} entries drawn, equal "
                  f"to plain where it must be; codewords u G with H c = 0, values from its draws "
                  f"exact; drawn statistic {a:.5f} against plain {b:.5f} (z {z:.2f})")
            check(z < 5, f"K8 {key} {kind}: pool statistics differ from the plain refill's")
            # the full batch
            debug.fill_(float("nan"))
            out = pr.channel_batch(pt, channel.make_generator(dev, 6, 1), BATCH, x, debug=debug,
                                   debug_info=info)
            want = channel.simulate_channel(tb.code, channel_type, channel.make_generator(dev, 6, 1),
                                            BATCH, x, modulation)
            torch.cuda.synchronize()
            check(out.llr.dtype == want.llr.dtype and out.llr.shape == want.llr.shape and
                  out.codeword.shape == want.codeword.shape, f"K8 full batch {key} {kind}: shapes")
            err["channel_batch"] = max(err["channel_batch"], check_drawn(
                f"K8 full batch {key} {kind}", tb, pt, channel_type, x, modulation, out.codeword,
                out.llr, debug, info))
            a, b, z = pool_z(tb, channel_type, (out.llr, out.codeword), (want.llr, want.codeword))
            print(f"K8 full batch {key} {kind}: {BATCH} frames, codewords u G with H c = 0, values "
                  f"from its draws exact; statistic {a:.5f} against simulate_channel {b:.5f} "
                  f"(z {z:.2f})")
            check(z < 5, f"K8 full batch {key} {kind}: statistics differ from simulate_channel's")
    # a batch step of K1, K5 and K6 through channel_batch, kernel against plain
    for name, key, channel_type, x, schedule in (
            ("K1", "bench1152", "AWGN", 2.0, "flooding"), ("K5", "wifi648", "AWGN", 2.0, "layered"),
            ("K6", "bench1152", "BEC", BEC_EPS, "flooding")):
        dec = DecoderParams(iterations=ITERS, type="BP_MS", layered=schedule == "layered")
        before = pr.channel_batch.launches
        got, want = (make_sim_step(tables[key], channel_type, dec, BATCH // 4, schedule, plain=p)(
            channel.make_generator(dev, 4, 0), x) for p in (False, True))
        got, want = [int(v) for v in got], [int(v) for v in want]
        print(f"batch step {name} {key} through channel_batch: kernel {got} plain {want} "
              f"(channel_batch launches {pr.channel_batch.launches - before})")
        check(got == want and pr.channel_batch.launches - before == 2,
              f"batch step {name}: kernel and plain steps differ on the same draws")
    # times: the refill (its plan and draw together, and apart) and the full
    # batch, against the plain versions (a channel batch and the merge; a
    # channel batch), from the same pool
    times = {}
    for key, kind in POOL_TIMED:
        tb = tables[key]
        channel_type, x = {k: (c, v) for k, c, v in POOL_CHANNELS}[kind]
        pt, _, s0 = pool_case(tb, kind, channel_type, x)
        box = {}

        def reset():
            box["st"] = {n: t.clone() for n, t in s0.items()}

        key_t = pr.draw_keys(channel.make_generator(dev, 7), 1, dev)

        def plan_only():
            st = box["st"]
            return pr.pool_plan(refill_on, st["avail"], st["ctr"], st["started"], 10**9,
                                st["remaining"])

        def draw_only():
            st = box["st"]
            pr._draw(pt, x, st["fresh"], st["fresh_cw"], BATCH, key_t, avail=st["avail"],
                     lanes=box["lanes"], count=box["ctl"][1:])

        def plan_then_reset():
            reset()
            box["ctl"], box["lanes"] = plan_only()

        ms = cuda_ms(lambda: refill(pr.pool_refill, pt, box["st"], x, 7), 20, reset, busy=True)
        plain_ms = cuda_ms(lambda: refill(pr.pool_refill_plain, pt, box["st"], x, 7), 10, reset,
                           busy=True)
        plan_ms = cuda_ms(plan_only, 20, reset, busy=True)
        draw_ms = cuda_ms(draw_only, 20, plan_then_reset, busy=True)
        full_ms = cuda_ms(lambda: pr.channel_batch(pt, None, BATCH, x, key=key_t), 20, busy=True)
        gen_t = channel.make_generator(dev, 7)
        full_plain_ms = cuda_ms(lambda: channel.simulate_channel(
            tb.code, channel_type, gen_t, BATCH, x, pt.modulation), 10, busy=True)
        b_refill = k8_bound(pt, POOL_USED, BATCH, True)
        b_full = k8_bound(pt, BATCH, BATCH, False)
        times[key, kind] = dict(ms=ms, plain_ms=plain_ms, plan_ms=plan_ms, draw_ms=draw_ms,
                                bound=b_refill, full_ms=full_ms, full_plain_ms=full_plain_ms,
                                full_bound=b_full)
        print(f"time K8 {key} {kind}, {POOL_USED} of {BATCH} entries drawn: kernel {ms:.4f} ms "
              f"(plan {plan_ms:.4f} ms, draw {draw_ms:.4f} ms), plain (channel batch and merge) "
              f"{plain_ms:.4f} ms; bound {b_refill[0]:.4f} ms by {b_refill[1]} "
              f"({b_refill[0] / ms:.1%} of the bound) [{name_power}]")
        print(f"time K8 full batch {key} {kind}, {BATCH} frames: kernel {full_ms:.4f} ms, plain "
              f"(simulate_channel) {full_plain_ms:.4f} ms; bound {b_full[0]:.4f} ms by {b_full[1]} "
              f"({b_full[0] / full_ms:.1%} of the bound) [{name_power}]")
    return {"max_abs_err": err, "times": times,
            "tables": pool_case(tables["bench1152"], "BPSK", "AWGN", 2.0)[0]}


def run_ordered_grants(dev, tables, name_power) -> dict:
    """Phase 7f: the start grants in lane order.  A chunk whose quota binds
    after its first pass (``BINDING``), from one state, ``ordered`` in K2
    (the rule's form and the HBM-plane form; float32, bfloat16 and int8),
    K4 (the rule's form and the HBM-plane form) and K7 (words and bytes)
    against the plain chunk: planes, counters and ``remaining`` equal (the
    min-sum family).  Then the grant kernel against its plain version and
    timed; K2 and K4 timed on that state unordered and not binding, and
    ordered under the binding quota; and the streaming step, three times
    from empty streams on the same draws under a quota of 3 B + 5000 (K2 on
    the 1152 code at 3.0 dB, K4 on wifi 1944 at 2.0 dB): one outcome."""
    import dataclasses

    from libldpc_tpu_torch.ops import channel
    from libldpc_tpu_torch.ops.kernels import decode_bec as db
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import DecoderParams
    from libldpc_tpu_torch.utils.roofline import bound

    ones = torch.ones(1, dtype=torch.int32, device=dev)

    def half_started(tb, plain, bec, x, dtype, form):
        """Half the lanes started from a full pool by the plain chunk, one
        pass run; then a fresh pool on every lane."""
        kind = "BEC" if bec else "AWGN"
        kw = {} if bec else {"message_dtype": dtype, "minsum_mode": form}
        st = init_state(tb, BATCH, kind, "float32" if bec else dtype)
        gen = channel.make_generator(dev, 8, 0)

        def fresh_pool():
            ch = channel.simulate_channel(tb.code, kind, gen, BATCH, x)
            st.fresh_llr.copy_(ch.llr)
            st.fresh_cw.copy_(ch.codeword)
            st.avail.fill_(1)

        fresh_pool()
        plain(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
              st.fresh_llr, st.fresh_cw, ones, torch.tensor([BATCH // 2], dtype=torch.int32,
                                                            device=dev), k=1, cap=ITERS, **kw)
        fresh_pool()
        st.ctr.zero_()
        return st

    def copy(st):
        return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                          for f in dataclasses.fields(st)
                                          if isinstance(getattr(st, f.name), torch.Tensor)})

    def chunk(fn, tb, st, quota, **kw):
        rem = torch.tensor([quota], dtype=torch.int32, device=dev)
        fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
           st.fresh_llr, st.fresh_cw, ones, rem, k=6, cap=ITERS, **kw)
        return rem

    cases = [("K2", "bench1152", df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain, False,
              2.5, dtype, form, (df, "STREAM_FORM_OVERRIDE", forced, None))
             for dtype, form in (("float32", "BP_MS"), ("bfloat16", "BP_MS"), ("int8", "BP_OMS"))
             for forced in (None, (0, False))]
    cases += [("K4", "wifi1944", dl.bp_stream_chunk_layered_fast,
               dl.bp_stream_chunk_layered_fast_plain, False, 2.5, "float32", "BP_MS",
               (dl, "STREAM_FORM_OVERRIDE", forced, None)) for forced in (None, (0, False))]
    cases += [("K7", "bench1152", db.bec_stream_chunk_fused, db.bec_stream_chunk_fused_plain,
               True, 0.25, "float32", None, (db, "FORCE_BYTES", forced, False))
              for forced in (False, True)]
    states = {}
    for name, key, kernel, plain, bec, x, dtype, form, (mod_, attr, forced, default) in cases:
        tb = tables[key]
        kw = {} if bec else {"minsum_mode": form, "message_dtype": dtype}
        if (name, dtype) not in states:
            states[name, dtype] = half_started(tb, plain, bec, x, dtype, form)
        st_p, st_k = copy(states[name, dtype]), copy(states[name, dtype])
        setattr(mod_, attr, forced)
        try:
            rk = chunk(kernel, tb, st_k, BINDING, ordered=True, **kw)
        finally:
            setattr(mod_, attr, default)
        rp = chunk(plain, tb, st_p, BINDING, **kw)
        starts = int(st_p.ctr[4].sum())
        same = [n for n in ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr")
                if torch.equal(getattr(st_k, n), getattr(st_p, n))]
        print(f"{name} {key} {dtype} {form or 'peeling'} form {forced}: a chunk under a quota of "
              f"{BINDING}, ordered: {starts} starts (plain), remaining {int(rk)} / {int(rp)}; "
              f"equal planes {same}")
        check(BATCH // 2 < starts <= BINDING and int(rp) == 0, f"{name}: the quota did not bind")
        check(len(same) == 8 and torch.equal(rk, rp),
              f"{name} {dtype} form {forced}: the ordered chunk differs from the plain chunk")
    # the grant kernel alone, against its plain version, on the K2 state
    st = states["K2", "float32"]
    rem_k = torch.tensor([BINDING], dtype=torch.int32, device=dev)
    rem_p = rem_k.clone()
    grant_k = df.stream_grant(st.done, st.avail, ones, rem_k)
    grant_p = df.stream_grant_plain(st.done, st.avail, ones, rem_p)
    check(torch.equal(grant_k, grant_p) and torch.equal(rem_k, rem_p), "stream_grant differs")
    # the lane-order scans (the grant, the refill plan's lane list) against
    # their plain versions at odd batch sizes, on aligned planes and on
    # planes 4 bytes past an aligned start
    g = torch.Generator(device="cpu").manual_seed(17)
    for b_ in SCAN_BATCHES:
        for offset in (0, 1):
            # done 60 % of the lanes; avail 10 %: past the refill's watermark
            done_, avail_ = ((torch.rand(b_ + offset, generator=g) < share).to(torch.int32)
                             .to(dev)[offset:] for share in (0.6, 0.1))
            ctr_ = torch.randint(0, 3, (5, b_), dtype=torch.int32, generator=g).to(dev)
            for quota in (0, b_ // 3, 10**6):
                rk = torch.tensor([quota], dtype=torch.int32, device=dev)
                rp = rk.clone()
                check(torch.equal(df.stream_grant(done_, avail_, ones, rk),
                                  df.stream_grant_plain(done_, avail_, ones, rp))
                      and torch.equal(rk, rp), f"stream_grant B={b_} offset {offset} quota {quota}")
            rk, rp = (torch.zeros(1, dtype=torch.int32, device=dev) for _ in range(2))
            started_ = torch.tensor([5], dtype=torch.int64, device=dev)
            ctl, lanes = pr.pool_plan(ones, avail_, ctr_, started_, 10**6, rk)
            ctl_p, lanes_p = pr.pool_plan_plain(ones, avail_, ctr_, started_, 10**6, rp)
            n = int(ctl[1])
            check(torch.equal(ctl, ctl_p) and torch.equal(rk, rp) and int(ctl[0]) == 1
                  and n == int((avail_ == 0).sum()) and torch.equal(lanes[:n], lanes_p[:n]),
                  f"pool_plan's lane list B={b_} offset {offset}")
        print(f"lane-order scans B={b_}: stream_grant and pool_plan's lane list equal to their "
              f"plain versions (aligned and offset planes)")
    rem = torch.tensor([BINDING], dtype=torch.int32, device=dev)
    grant_ms = cuda_ms(lambda: df.stream_grant(st.done, st.avail, ones, rem), 50,
                       lambda: rem.fill_(BINDING), busy=True)
    grant_plain_ms = cuda_ms(lambda: df.stream_grant_plain(st.done, st.avail, ones, rem), 50,
                             lambda: rem.fill_(BINDING), busy=True)
    grant_host_ms = cuda_ms(lambda: df.stream_grant(st.done, st.avail, ones, rem), 50,
                            lambda: rem.fill_(BINDING))
    # read: done, avail (int32), remaining; written: the grant plane, remaining
    grant_bound = bound(BATCH * (4 + 4 + 1) + 8, BATCH * 4)
    # the floor of a launch: a one-element fill, timed alike
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = cuda_ms(lambda: tiny.fill_(1), 50, busy=True)
    plan_ms = cuda_ms(lambda: pr.pool_plan(ones, st.avail, st.ctr, st.started, 10**9, rem), 50,
                      busy=True)
    print(f"time stream_grant B={BATCH}: kernel {grant_ms:.4f} ms on the device "
          f"({grant_host_ms:.4f} ms with the host's launch work), plain {grant_plain_ms:.4f} ms; "
          f"bound {grant_bound[0]:.5f} ms by {grant_bound[1]}; a launch's floor (a one-element "
          f"fill) {floor_ms:.4f} ms; pool_plan (the same scan listing the used lanes) "
          f"{plan_ms:.4f} ms [{name_power}]")
    # K2 and K4 (the rules' forms, float32 BP) on the same state: not binding
    # (every wanting lane starts; one launch of 6 passes), and ordered under
    # the binding quota (6 grant launches and 6 one-pass launches)
    times = {}
    for name, key, kernel in (("K2", "bench1152", df.bp_stream_chunk_fused),
                              ("K4", "wifi1944", dl.bp_stream_chunk_layered_fast)):
        base = states[name, "float32"]
        box = {}

        def reset():
            box["st"] = copy(base)

        row = {}
        for label, quota, ordered in (("not binding", 10**9, False), ("binding, ordered",
                                                                      BINDING, True),
                                      ("binding, ordered again", BINDING, True),
                                      ("not binding again", 10**9, False)):
            row[label] = cuda_ms(lambda: chunk(kernel, tables[key], box["st"], quota,
                                               ordered=ordered, minsum_mode="BP"), 5, reset)
        times[name] = row
        print(f"time {name} {key} float32 BP chunk of 6 passes B={BATCH}, half the lanes in "
              f"flight: " + "; ".join(f"{k} {v:.3f} ms" for k, v in row.items())
              + f" [{name_power}]")
    # the streaming step repeats under a binding quota
    for key, snr, layered in (("bench1152", 3.0, False), ("wifi1944", 2.0, True)):
        init_fn, step_fn = make_streaming_fused_step(
            tables[key], "AWGN", DecoderParams(iterations=ITERS, layered=layered), BATCH,
            max_frames=3 * BATCH + 5000, layered=layered)
        outcomes = set()
        for _ in range(3):
            st_, totals = init_fn(), []
            for step in range(2):
                st_, acc = step_fn(st_, channel.make_generator(dev, 1, 0, step), snr, True)
                totals.append(torch.stack(list(acc)).tolist())
            outcomes.add((st_.done.cpu().numpy().tobytes(), st_.iters.cpu().numpy().tobytes(),
                          st_.avail.cpu().numpy().tobytes(), int(st_.started), str(totals)))
        started = sorted({o[3] for o in outcomes})
        print(f"grant {key} {'K4' if layered else 'K2'} {snr} dB, quota {3 * BATCH + 5000}: "
              f"{len(outcomes)} distinct outcome(s) in 3 repetitions (frames started {started})")
        check(len(outcomes) == 1 and started == [3 * BATCH + 5000],
              f"the streaming step under a binding quota does not repeat on {key}")
    return {"grant_ms": grant_ms, "grant_plain_ms": grant_plain_ms, "grant_bound": grant_bound,
            "grant_host_ms": grant_host_ms, "launch_floor_ms": floor_ms, "plan_ms": plan_ms,
            "chunk_times": times}


#: phase 16: the idle lanes a timed reload grants (a burst of the 1152
#: sweep at 2.0 dB is ~1-2 k lanes), and the max_frames of the repeated point
RELOAD_IDLE = 1536
REPEAT_MAX_FRAMES = 100000


def run_xla_streaming(dev, codes, tables, name_power, zero_counts, read_counts,
                      write_files) -> dict:
    """Phase 16: the JAX package's default streaming sweep (its XLA
    super-step, no ``--pallas``) on the card: per pass a one-pass K2 launch
    and K8's reload form, staged in every pass but a super-step's last.
    The card's super-step against the plain super-step on the card
    (``_superstep_body``, whose draw is K8's full batch on the pass's key)
    on the 1152 code at B = 16384: BP_MS bit-exact (deltas, ``started``,
    every plane; ``lv2c`` on the lanes in flight), BP to the frames
    counted, and under a binding quota.  Both reload forms timed against
    their plain versions at ``RELOAD_IDLE`` idle lanes (the staged one also
    held to its plain version), and K2's one-pass launch against its 6-pass
    chunk and with ``RELOAD_IDLE`` staged starts pending (held to the plain
    chunk in BP_MS).  Then the default CLI sweep (no ``--pallas``) beside
    the ``--pallas`` sweep of the same code, in turn: frames/s, avg_iter,
    FER within |z| < 3, both reload forms' launches; and a
    ``max_frames``-ended point run 5 times: one outcome."""
    from libldpc_tpu_torch import cli
    from libldpc_tpu_torch.ops import channel, streaming
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.streaming_fused import init_state
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )
    from libldpc_tpu_torch.utils.roofline import OPS_BP_SLOT, bound

    tb = tables["bench1152"]
    sdc = tb.code
    out = {}
    # -- the card's super-step against the plain one
    worst = 0.0
    for form, max_frames in (("BP_MS", 10**9), ("BP_MS", BATCH + BATCH // 3), ("BP", 10**9)):
        dec = DecoderParams(iterations=ITERS, type=form)
        runs = []
        for plain in (False, True):
            # the reference: the plain super-step on the card, K8's draws
            with plain_superstep() if plain else contextlib.nullcontext():
                init, step = streaming.make_streaming_step(tb, "AWGN", dec, BATCH,
                                                           max_frames=max_frames)
            st, deltas = init(), []
            for s in range(8):
                st, acc = step(st, channel.make_generator(dev, 16, s), 1.5, s < 5)
                deltas.append([int(v) for v in acc])
            runs.append((st, deltas))
        (ka, kd), (pa, pd) = runs
        frames_k, frames_p = sum(d[2] for d in kd), sum(d[2] for d in pd)
        print(f"phase 16 superstep {form} max_frames {max_frames}: kernel deltas {kd[-3:]} "
              f"plain {pd[-3:]}; frames {frames_k} / {frames_p}, started "
              f"{int(ka.started)} / {int(pa.started)}")
        check(frames_k > BATCH, f"phase 16 {form}: the streams did not recycle")
        if form == "BP_MS":
            check(kd == pd, f"phase 16 {form}: super-step deltas differ from the plain super-step")
            for name in ("llr_in", "codeword", "active", "age", "iters", "started"):
                check(torch.equal(getattr(ka, name), getattr(pa, name)),
                      f"phase 16 {form}: plane {name} differs")
            act = ka.active
            check(torch.equal(ka.lv2c[:, act], pa.lv2c[:, act]), f"phase 16 {form}: lv2c differs")
            worst = max(worst, float((ka.llr_in - pa.llr_in).abs().max()))
            if max_frames < 10**9:
                check(frames_k == max_frames == int(ka.started),
                      "phase 16: the quota did not land exactly")
        else:
            check(abs(frames_k - frames_p) <= BATCH // 1000, f"phase 16 BP: frames {frames_k} "
                  f"against the plain super-step's {frames_p}")
    out["max_abs_err"] = worst
    # -- the reload alone, in the path's tiling, timed against its plain version
    pt = pr.reload_tables(pr.pool_tables(sdc, "AWGN"))
    g = torch.Generator(device="cpu").manual_seed(3)
    idle_lanes = torch.randperm(BATCH, generator=g)[:RELOAD_IDLE].to(dev)
    planes = dict(done=torch.zeros(BATCH, dtype=torch.int32, device=dev),
                  llr=torch.zeros((sdc.nc, BATCH), device=dev),
                  cw=torch.zeros((sdc.nc, BATCH), dtype=torch.uint8, device=dev),
                  lv2c=torch.zeros((sdc.nnz, BATCH), device=dev),
                  age=torch.zeros(BATCH, dtype=torch.int32, device=dev),
                  iters=torch.zeros(BATCH, dtype=torch.int32, device=dev),
                  started=torch.zeros(1, dtype=torch.int32, device=dev))
    refill_on = torch.ones(1, dtype=torch.int32, device=dev)
    key = torch.tensor([99], dtype=torch.int64, device=dev)

    def reset():
        planes["done"].zero_()
        planes["done"][idle_lanes] = 1
        planes["started"].zero_()

    args = lambda: (refill_on, planes["done"], planes["llr"], planes["cw"], planes["lv2c"],
                    planes["age"], planes["iters"], planes["started"], 10**9, BATCH // 16)
    ms = cuda_ms(lambda: pr.stream_reload(pt, None, 2.0, *args(), vn_ptr=tb.vn_ptr,
                                          perm_c2v=tb.perm_c2v, key=key), 20, setup=reset,
                 busy=True)
    check(int(planes["started"]) == RELOAD_IDLE, "the timed reload did not grant its lanes")
    plain_ms = cuda_ms(lambda: pr.stream_reload_plain(
        pt, lambda: pr.channel_batch(pt, None, BATCH, 2.0, key=key), *args()), 5, setup=reset)
    nbytes = RELOAD_IDLE * (sdc.nc * 5 + sdc.nnz * 4 + 12) + BATCH * 4
    out["bound"] = bound(nbytes, RELOAD_IDLE * sdc.nc * 2 * pt.kw)
    out["ms"], out["plain_ms"] = ms, plain_ms
    # the plan alone, and a pass's reload where do_gen fails (a plan, no draw)
    plan_ms = cuda_ms(lambda: pr.reload_plan(refill_on, planes["done"], planes["started"], 10**9,
                                             BATCH // 16), 20, setup=reset, busy=True)
    idle_ms = cuda_ms(lambda: pr.stream_reload(pt, None, 2.0, refill_on, planes["done"],
                                               planes["llr"], planes["cw"], planes["lv2c"],
                                               planes["age"], planes["iters"],
                                               planes["started"], 10**9, BATCH + 1,
                                               vn_ptr=tb.vn_ptr, perm_c2v=tb.perm_c2v, key=key),
                      20, setup=reset, busy=True)
    print(f"time stream_reload bench1152 BPSK {RELOAD_IDLE} of {BATCH} lanes granted: kernel "
          f"{ms:.4f} ms (plan {plan_ms:.4f}; no draw {idle_ms:.4f}), plain {plain_ms:.4f} ms; "
          f"bound {out['bound'][0]:.4f} ms by {out['bound'][1]} "
          f"({out['bound'][0] / ms:.1%} of the bound) [{name_power}]")
    # the staged form on the same lanes and key, held to its plain version:
    # the slot plane, the staged columns, done / age / iters and started
    stage = pr.ReloadStage.empty(sdc.nc, BATCH, dev)
    plain_stage = pr.ReloadStage.empty(sdc.nc, BATCH, dev)

    def reset_staged():
        reset()
        stage.slot.fill_(-1)
        plain_stage.slot.fill_(-1)

    def staged_reload():
        pr.stream_reload(pt, None, 2.0, *args(), key=key, stage=stage)

    def staged_plain():
        pr.stream_reload_plain(pt, lambda: pr.channel_batch(pt, None, BATCH, 2.0, key=key),
                               *args(), stage=plain_stage)

    got = []
    for fn, buf in ((staged_reload, stage), (staged_plain, plain_stage)):
        reset_staged()
        fn()
        got.append([planes[n].clone() for n in ("done", "age", "iters", "started")]
                   + [buf.slot.clone(), buf.cw[:, :RELOAD_IDLE].clone(),
                      buf.llr[:, :RELOAD_IDLE].clone()])
    check(all(torch.equal(a, b) for a, b in zip(got[0][:-1], got[1][:-1])),
          "the staged reload differs from its plain version")
    out["staged_err"] = float((got[0][-1] - got[1][-1]).abs().max())
    check(out["staged_err"] == 0.0, f"the staged LLRs differ from the plain ones by "
                                    f"{out['staged_err']}")
    out["staged_ms"] = cuda_ms(staged_reload, 20, setup=reset_staged, busy=True)
    out["staged_plain_ms"] = cuda_ms(staged_plain, 5, setup=reset_staged)
    # the staged kernel's own bytes: done read; a granted lane's staged
    # column (LLRs and codeword), its slot, done, age and iters written;
    # started read and written.  No first message: K2 makes those
    out["staged_bound"] = bound(BATCH * 4 + RELOAD_IDLE * (sdc.nc * 5 + 16) + 8,
                                RELOAD_IDLE * sdc.nc * 2 * pt.kw)
    print(f"time stream_reload staged bench1152 BPSK {RELOAD_IDLE} of {BATCH} lanes granted: "
          f"kernel {out['staged_ms']:.4f} ms, plain {out['staged_plain_ms']:.4f} ms; bound "
          f"{out['staged_bound'][0]:.4f} ms by {out['staged_bound'][1]} "
          f"({out['staged_bound'][0] / out['staged_ms']:.1%} of the bound); against the reload "
          f"function's output (LLRs, codewords and first messages, {out['bound'][0]:.4f} ms) "
          f"{out['bound'][0] / out['staged_ms']:.1%}; {ms / out['staged_ms']:.2f}x the reload "
          f"into the state [{name_power}]")
    # -- K2: one pass a launch against a 6-pass chunk, from the same full pool
    ch = channel.awgn_channel(sdc, channel.make_generator(dev, 16, 99), BATCH, 1.5)
    st = init_state(tb, BATCH)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    saved = {}

    def load():
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        st.done.fill_(1)
        df.bp_stream_chunk_fused(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age,
                                 st.avail, st.ctr, st.fresh_llr, st.fresh_cw, refill_on,
                                 torch.full((1,), BATCH, dtype=torch.int32, device=dev), k=1,
                                 cap=ITERS, minsum_mode="BP")
        for name in ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr"):
            saved[name] = getattr(st, name).clone()

    load()

    def restore():
        for name, v in saved.items():
            getattr(st, name).copy_(v)

    def chunk(k):
        return lambda: df.bp_stream_chunk_fused(
            tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
            st.llr_in, st.codeword, zero, zero, k=k, cap=ITERS, minsum_mode="BP")

    one = cuda_ms(chunk(1), 20, setup=restore)
    six = cuda_ms(chunk(6), 10, setup=restore)
    out["k2_one_pass_ms"], out["k2_six_pass_ms"] = one, six
    print(f"time K2 bench1152 BP one-pass launch (no starts) {one:.3f} ms, 6-pass chunk "
          f"{six:.3f} ms ({six / 6:.3f} a pass; one pass a launch costs "
          f"{one / (six / 6):.2f}x) [{name_power}]")
    # -- K2's one-pass launch with RELOAD_IDLE staged starts pending (the
    # default sweep's pass after a staged reload), held to the plain chunk
    pending = torch.randperm(BATCH, generator=torch.Generator(device="cpu").manual_seed(5))[
        :RELOAD_IDLE].to(dev)
    started_k2 = torch.zeros(1, dtype=torch.int32, device=dev)

    def restore_pending():
        restore()
        st.done.zero_()  # every other lane in flight, so the plan grants these alone
        st.done[pending] = 1
        started_k2.zero_()
        stage.slot.fill_(-1)
        pr.stream_reload(pt, None, 2.0, refill_on, st.done, st.llr_in, st.codeword, st.lv2c,
                         st.age, st.iters, started_k2, 10**9, BATCH // 16, key=key, stage=stage)

    def staged_chunk(minsum_mode, plain=False):
        fn = df.bp_stream_chunk_fused_plain if plain else df.bp_stream_chunk_fused
        return lambda: fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age,
                          st.avail, st.ctr, st.llr_in, st.codeword, zero, zero, k=1, cap=ITERS,
                          minsum_mode=minsum_mode, stage=stage)

    k2_runs = []
    for plain in (False, True):
        restore_pending()
        check(int(started_k2) == RELOAD_IDLE, "the staged starts were not granted")
        staged_chunk("BP_MS", plain)()
        k2_runs.append([getattr(st, n).clone() for n in ("llr_in", "codeword", "lv2c", "done",
                                                     "iters", "age", "ctr")])
        check(not bool((stage.slot >= 0).any()), "K2 left staged starts pending")
    check(all(torch.equal(a, b) for a, b in zip(*k2_runs)),
          "K2's one-pass launch with staged starts differs from the plain chunk (BP_MS)")
    pend_ms = cuda_ms(staged_chunk("BP"), 20, setup=restore_pending)
    pend_plain_ms = cuda_ms(staged_chunk("BP", plain=True), 3, setup=restore_pending)
    # the frames this timed launch finishes (BP, as timed): each reads its
    # transmitted bits' codeword bytes
    restore_pending()
    staged_chunk("BP")()
    finished = int((st.ctr.view(5, -1)[2] - saved["ctr"].view(5, -1)[2]).sum())
    # one pass of every lane, as this run's data needs it: a lane in flight
    # reads its LLRs and its lv2c, a staged lane its staged column (and
    # writes it into llr_in and codeword, and its slot); every lane writes
    # its lv2c and reads and writes done, iters, age, avail and the 5
    # counters, and reads its slot; BP's operations a slot
    carried = BATCH - RELOAD_IDLE
    out["k2_pending_bound"] = bound(
        carried * (sdc.nc + sdc.nnz) * 4 + BATCH * (sdc.nnz * 4 + 2 * 4 * 4 + 2 * 5 * 4 + 4)
        + RELOAD_IDLE * (sdc.nc * 10 + 4) + finished * sdc.nct, BATCH * sdc.nnz * OPS_BP_SLOT)
    out["k2_pending_ms"], out["k2_pending_plain_ms"] = pend_ms, pend_plain_ms
    print(f"time K2 bench1152 BP one-pass launch with {RELOAD_IDLE} staged starts pending "
          f"{pend_ms:.3f} ms (no starts {one:.3f}: +{pend_ms - one:.3f}), plain "
          f"{pend_plain_ms:.3f} ms; {finished} frames finished; bound "
          f"{out['k2_pending_bound'][0]:.4f} ms by "
          f"{out['k2_pending_bound'][1]} ({out['k2_pending_bound'][0] / pend_ms:.1%} of the "
          f"bound) [{name_power}]")
    # -- the default sweep (no --pallas) and the --pallas sweep of the same
    # code in this run, through the CLI; each Simulator's results kept (the
    # results file rounds a frame's time to the microsecond)
    from libldpc_tpu_torch.sim import driver

    files = write_files("bench1152")
    runs = {}
    real_start = driver.Simulator.start

    def keep(self, *a, **k):
        res = real_start(self, *a, **k)
        runs[self.engine] = res
        return res

    driver.Simulator.start = keep
    try:
        for out_name, flags in (("res_xla.txt", []), ("res_xla_pallas.txt", ["--pallas"])):
            if not flags:
                zero_counts()
            args_cli = [files[0], str(WORK / out_name), *SWEEP, *files[1:], "-i", str(ITERS),
                        "--batch-size", str(BATCH), "--frame-error-count", "50",
                        "--max-frames", "2000000", *flags]
            t0 = time.perf_counter()
            check(cli.main(args_cli) == 0, f"the CLI sweep {out_name} failed")
            text = (WORK / out_name).read_text()
            print(f"--- {out_name} ({time.perf_counter() - t0:.1f} s)\n{text}", end="")
            if not flags:
                launches = read_counts()
                head = text.splitlines()[0]
    finally:
        driver.Simulator.start = real_start
    print(f"phase 16 default sweep launches: {launches}")
    print(f"phase 16 default sweep reloads: {launches['stream_reload_staged']} staged, "
          f"{launches['stream_reload']} into the state (a super-step's last pass); K2 one-pass "
          f"launches {launches['bp_stream_chunk_fused']}, {launches['bp_stream_chunk_fused_staged']}"
          f" of them given the staging buffer")
    check(set(runs) == {"xla-superstep", "fused-pool"}, f"phase 16 engines: {sorted(runs)}")
    check(launches["bp_stream_chunk_fused"] > 0, "the default sweep did not run K2")
    check(launches["stream_reload"] > 0, "the default sweep did not reload with K8's reload form")
    check(launches["stream_reload_staged"] == (ITERS - 1) * launches["stream_reload"],
          "the default sweep did not stage every reload of a super-step but its last")
    check(launches["bp_stream_chunk_fused_staged"] == launches["bp_stream_chunk_fused"]
          == launches["stream_reload"] + launches["stream_reload_staged"],
          "the default sweep's K2 launches did not all take the staging buffer")
    check(launches["pool_refill"] == 0 and launches["stream_grant"] == 0,
          "the default sweep ran the fused step's pool")
    check(head.startswith("# kernel=cuda-fused") and "streaming=on" in head,
          "default sweep provenance line")
    xla, fused = runs["xla-superstep"], runs["fused-pool"]
    for i, x in enumerate(xla.x_values):
        fx, ff = 1.0 / xla.time[i], 1.0 / fused.time[i]
        z = z_score(xla.fer[i], xla.frames[i], fused.fer[i], fused.frames[i])
        print(f"phase 16 {x:.1f} dB: default (XLA super-step) {fx:.0f} frames/s avg_iter "
              f"{xla.avg_iter[i]:.4f} FER {xla.fer[i]:.4e} ({int(xla.frames[i])} frames) | "
              f"--pallas (fused step) {ff:.0f} frames/s avg_iter {fused.avg_iter[i]:.4f} FER "
              f"{fused.fer[i]:.4e} ({int(fused.frames[i])} frames) | ratio {fx / ff:.3f} | "
              f"z {z:.2f} [{name_power}]")
        check(math.isfinite(fx) and xla.frames[i] > 0, f"default sweep row {x}")
        check(abs(z) < 3, f"default sweep FER at {x} dB against --pallas: z {z:.2f}")
    out["launches"] = launches["stream_reload"]
    out["staged_launches"] = launches["stream_reload_staged"]
    out["k2_launches"] = launches["bp_stream_chunk_fused"]
    # -- a max_frames-ended point, 5 times: one outcome
    outcomes = set()
    for _ in range(5):
        res = Simulator(codes["bench1152"], DecoderParams(iterations=ITERS),
                        ChannelParams(seed=4, x_range=(2.0, 2.01, 1.0)),
                        SimulationParams(batch_size=BATCH, fec=10**9,
                                         max_frames=REPEAT_MAX_FRAMES),
                        device=dev, verbose=False).start()
        outcomes.add((int(res.frames[0]), int(res.fec[0]), float(res.ber[0]),
                      float(res.avg_iter[0])))
    print(f"phase 16 max_frames {REPEAT_MAX_FRAMES} point, 5 runs: {sorted(outcomes)}")
    check(len(outcomes) == 1 and next(iter(outcomes))[0] == REPEAT_MAX_FRAMES,
          "the max_frames-ended point does not repeat")
    return out


def run_padded(dev, codes, name_power, zero_counts, read_counts) -> dict:
    """Phase 17: the padded-layout library on the card at B = 16384, each
    entry against its plain padded version on the same card, both timed:
    ``bp_decode`` on wifi 1944 (50 it, K1), ``bp_decode(layered=True)`` on
    wifi 648 (K5, 50 it) and ``bec_decode`` on the 1152 code at ε 0.40 (K6).
    BP_MS and the BEC bit-exact, BP to 99.9 % of decisions and counts."""
    from libldpc_tpu_torch.ops import bec, channel, decoder
    from libldpc_tpu_torch.ops.device import to_device

    out = {}
    zero_counts()
    cases = (("bp_decode wifi1944", "wifi1944", False, "bp_decode_fused"),
             ("bp_decode layered wifi648", "wifi648", True, "bp_decode_layered"))
    for tag, key, layered, kernel in cases:
        dc = to_device(codes[key], with_layers=layered, device=dev)
        llr = channel.awgn_channel(dc, channel.make_generator(dev, 17, 0), BATCH,
                                   COMPARE_SNR_DB).llr
        for form in ("BP_MS", "BP"):
            got = decoder.bp_decode(dc, llr, ITERS, True, form, layered)
            want = decoder.bp_decode_plain(dc, llr, ITERS, True, form, layered)
            same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
            print(f"phase 17 {tag} {form}: frames agreeing {same.float().mean().item():.6f}, "
                  f"avg_iter {got.iterations.float().mean().item():.3f}")
            if form == "BP":
                check(same.float().mean().item() >= 0.999, f"phase 17 {tag} BP decisions")
                torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same],
                                           rtol=1e-4, atol=1e-4)
            else:
                check(bool(same.all()) and torch.equal(got.llr_out, want.llr_out),
                      f"phase 17 {tag} {form} not bit-exact")
        ms = cuda_ms(lambda: decoder.bp_decode(dc, llr, ITERS, True, "BP", layered), 3)
        plain_ms = cuda_ms(lambda: decoder.bp_decode_plain(dc, llr, ITERS, True, "BP", layered),
                           1, warm=False)
        out[tag] = (ms, plain_ms)
        print(f"time phase 17 {tag} BP {ITERS} it ET B={BATCH} {COMPARE_SNR_DB} dB: padded entry "
              f"on {kernel} {ms:.3f} ms, plain padded {plain_ms:.3f} ms [{name_power}]")
    dc = to_device(codes["bench1152"], device=dev)
    ch = channel.bec_channel(dc, channel.make_generator(dev, 17, 1), BATCH, BEC_EPS)
    for stale in (None, 0):
        got = bec.bec_decode(dc, ch.llr, ch.codeword, ITERS, True, stale)
        want = bec.bec_decode_plain(dc, ch.llr, ch.codeword, ITERS, True, stale)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"phase 17 bec_decode (stale {stale}) not bit-exact")
    ms = cuda_ms(lambda: bec.bec_decode(dc, ch.llr, ch.codeword, ITERS), 5)
    plain_ms = cuda_ms(lambda: bec.bec_decode_plain(dc, ch.llr, ch.codeword, ITERS), 1,
                       warm=False)
    out["bec_decode bench1152"] = (ms, plain_ms)
    print(f"time phase 17 bec_decode bench1152 ε {BEC_EPS} {ITERS} it B={BATCH}: padded entry on "
          f"K6 {ms:.3f} ms, plain padded {plain_ms:.3f} ms [{name_power}]")
    launches = read_counts()
    print(f"phase 17 launches: {launches}")
    for name in ("bp_decode_fused", "bp_decode_layered", "bec_decode_fused"):
        check(launches[name] > 0, f"phase 17 did not run {name}")
    out["launches"] = launches
    return out


#: phase 18: the codefile the native parser reads and the H it ranks
#: (``make_benchmark_code(n, 3, 6)``: 196,608 edges; 8192 x 16384)
PARSE_NC, RANK_NC = 65536, 16384


@contextlib.contextmanager
def numpy_paths(native):
    """The port's NumPy parse and rank: the runtime reported unavailable
    inside the block."""
    saved = vars(native)["available"]
    native.available = staticmethod(lambda: False)
    try:
        yield
    finally:
        native.available = saved


def best_s(fn, reps: int) -> float:
    """The least host-clock seconds of ``reps`` calls of ``fn()``."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def run_host_runtime(name_power, parse_nc: int = PARSE_NC, rank_nc: int = RANK_NC) -> dict:
    """Phase 18a: the native host runtime on this machine's host.  It must
    build (``native.available()``; a failed build prints the compiler's
    output and fails the run), and the codefile parse of
    ``make_benchmark_code(parse_nc, 3, 6)`` and the GF(2) rank of
    ``make_benchmark_code(rank_nc, 3, 6)``'s H are timed natively and on
    the NumPy paths, with equal results.  The file is read warm (written
    just before, the page cache kept)."""
    from libldpc_tpu_torch import runtime
    from libldpc_tpu_torch.models import gf2, io, make_benchmark_code, write_codefile
    from libldpc_tpu_torch.runtime import native

    built = native.available()  # built at the run's first parse (phase 8's CLI) or here
    if not built:
        print(f"phase 18: the native runtime did not build:\n{runtime.last_build_error}")
    check(built, "phase 18: native.available() is False")
    print(f"phase 18: native runtime {pathlib.Path(runtime._lib._name).name} loaded"
          + (f"; refused first:\n{runtime.last_build_error}" if runtime.last_build_error else ""))
    out = {}
    code = make_benchmark_code(parse_nc, 3, 6, seed=0)
    path = str(WORK / f"runtime_h{parse_nc}.txt")
    write_codefile(path, code.rows, code.cols, code.nc, code.mc)
    got = io.parse_codefile(path)
    with numpy_paths(native):
        want = io.parse_codefile(path)
        out["parse_numpy_s"] = best_s(lambda: io.parse_codefile(path), 3)
        out["pairs_numpy_s"] = best_s(lambda: io._pairs(path), 3)
    check(all((getattr(got, f) == getattr(want, f)).all() for f in ("rows", "cols", "puncture",
                                                                  "shorten"))
          and (got.nc, got.mc) == (want.nc, want.mc) == (code.nc, code.mc)
          and (got.rows == code.rows).all() and (got.cols == code.cols).all(),
          "phase 18: the native parse differs from the NumPy parse")
    out["parse_native_s"] = best_s(lambda: io.parse_codefile(path), 3)
    out["pairs_native_s"] = best_s(lambda: native.parse_pairs(path), 3)
    print(f"time phase 18 parse_codefile of the {parse_nc}-column codefile ({code.nnz} edges, "
          f"warm page cache, best of 3): native {out['parse_native_s'] * 1e3:.2f} ms, NumPy "
          f"{out['parse_numpy_s'] * 1e3:.2f} ms ({out['parse_numpy_s'] / out['parse_native_s']:.1f}"
          f"x); the pairs alone: native {out['pairs_native_s'] * 1e3:.2f} ms, NumPy "
          f"{out['pairs_numpy_s'] * 1e3:.2f} ms [{name_power}]")
    H = make_benchmark_code(rank_nc, 3, 6, seed=0).H_dense
    out["pack_s"] = best_s(lambda: gf2.pack_rows(H), 1)
    t0 = time.perf_counter()
    r_native = gf2.rank(H)
    out["rank_native_s"] = time.perf_counter() - t0
    with numpy_paths(native):
        t0 = time.perf_counter()
        r_numpy = gf2.rank(H)
        out["rank_numpy_s"] = time.perf_counter() - t0
    check(r_native == r_numpy, f"phase 18: rank native {r_native}, NumPy {r_numpy}")
    print(f"time phase 18 GF(2) rank of the {H.shape[0]} x {H.shape[1]} H (rank {r_native}): "
          f"native {out['rank_native_s']:.3f} s, NumPy {out['rank_numpy_s']:.3f} s "
          f"({out['rank_numpy_s'] / out['rank_native_s']:.1f}x), each with its "
          f"{out['pack_s']:.3f} s pack [{name_power}]")
    return out


#: phase 18b: each example at its full width and a reduced depth (fewer
#: points or frames), its results file under the smoke's work directory
EXAMPLE_ARGS = {
    "basic_sweep": ["--snr", "1.0", "3.01", "1.0", "--max-frames", "100000"],
    "pyldpc_style": ["--snr", "1.0", "3.01", "1.0", "--max-frames", "100000", "--polls", "2",
                     "--poll-seconds", "1.0", "--decode-snr", "3.0"],
    "qc_code_sweep": ["--max-frames", "100000"],
    "wifi_sweep": ["--max-frames", "100000"],
    "wide_streaming_sweep": [],
    "multihost_sweep": ["--max-frames", "20000"],
}


def run_examples(name_power, zero_counts, read_counts) -> dict:
    """Phase 18b: each ``examples/torch_*.py`` through its ``main`` on the
    card, its launches counted from zero, and the engine or route it must
    reach: the XLA super-step (K2 one pass a launch, K8's reload) for
    ``basic_sweep``, ``wide_streaming_sweep`` and ``multihost_sweep`` (one
    rank); K1 for ``pyldpc_style``'s ``LDPC.decode`` (its threaded sweep
    runs no K1); the fused pool with bf16 messages (K2 on ``Bf16Msg``) for
    ``qc_code_sweep``; K4 on ``Int8Msg`` for ``wifi_sweep``.  Returns each
    example's wall seconds."""
    import importlib.util

    walls = {}
    for name, args in EXAMPLE_ARGS.items():
        spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                      ROOT / "examples" / f"torch_{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if name in ("basic_sweep", "multihost_sweep"):
            args = args + ["--result-file", str(WORK / f"example_{name}.txt")]
        print(f"--- phase 18 example {name} {' '.join(args)}", flush=True)
        zero_counts()
        t0 = time.perf_counter()
        ret = module.main(args)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches = {k: v for k, v in read_counts().items() if v}
        if name == "pyldpc_style":
            check(ret["bit_errors"] == 0, "phase 18 pyldpc_style: the 3 dB frame has bit errors")
            check(launches.get("bp_decode_fused", 0) > 0, "phase 18: LDPC.decode ran no K1")
            res = ret["ldpc"].get_results()
            route = f"LDPC.decode on K1, rank {ret['rank']}"
        else:
            sim = ret
            check(sim.device.type == "cuda", f"phase 18 {name} ran on {sim.device}")
            res = sim.results.as_dict()
            want = {"qc_code_sweep": ("fused-pool", "flooding", "bfloat16",
                                      "bp_stream_chunk_fused_bf16"),
                    "wifi_sweep": ("fused-pool", "layered-fast", "int8",
                                   "bp_stream_chunk_layered_fast_int8")}.get(
                name, ("xla-superstep", "flooding", "float32", "bp_stream_chunk_fused"))
            check((sim.engine, sim.schedule, sim.message_dtype) == want[:3],
                  f"phase 18 {name}: {sim.engine} {sim.schedule} {sim.message_dtype}")
            check(launches.get(want[3], 0) > 0, f"phase 18 {name} did not launch {want[3]}")
            if sim.engine == "xla-superstep":
                check(launches.get("stream_reload", 0) > 0 and "bp_decode_fused" not in launches,
                      f"phase 18 {name}: launches {launches}")
            route = f"engine {sim.engine}, schedule {sim.schedule}, dtype {sim.message_dtype}"
        check(len(res["frames"]) > 0 and all(f > 0 for f in res["frames"])
              and all(0.0 <= v <= 1.0 for v in res["fer"]), f"phase 18 {name}: rows {res}")
        print(f"time phase 18 example {name}: {walls[name]:.2f} s wall (host clock, setup "
              f"included), {route}, launches {launches} [{name_power}]")
    return walls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from libldpc_tpu_torch import cli
    from libldpc_tpu_torch.models import (
        make_benchmark_code, make_regular_code, wifi_code, write_codefile, write_layerfile,
    )
    from libldpc_tpu_torch.ops.channel import awgn_channel, bec_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import decode_bec as db
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )
    # the card's peaks and the operations a slot (H100 SXM; one copy, with
    # the port's cost model)
    from libldpc_tpu_torch.utils.roofline import (
        HBM_BYTES_S, OPS_BEC_SLOT, OPS_BP_FAST_SLOT, OPS_BP_SLOT, OPS_MS_FAST_SLOT, OPS_MS_SLOT,
        bound,
    )

    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        print(f"[{time.perf_counter() - t_start:7.1f} s] {phase}", flush=True)

    # ---- 1. environment
    name_power = card()
    print(name_power)  # as nvidia-smi gives it: name, power limit
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    cap = torch.cuda.get_device_capability()
    print(f"capability: {cap}")
    check(cap == (9, 0), f"expected a Hopper card (9, 0), got {cap}")
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    # ---- 2. build (one nvcc per source, in parallel) and dims
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    if build.last_build_log:
        print(build.last_build_log)
        # -Xptxas -v: each kernel's stack frame (local memory per thread)
        frames_b = [int(n) for n in re.findall(r"(\d+) bytes stack frame", build.last_build_log)]
        secs = [float(x) for x in re.findall(r"^# ([0-9.]+) s$", build.last_build_log, re.M)]
        print(f"stack frames: {len(frames_b)} functions, {sum(n == 0 for n in frames_b)} with 0 "
              f"bytes, largest {max(frames_b)} bytes; slowest nvcc {max(secs):.1f} s of "
              f"{len(secs)} started together")

    codes = {
        "bench1152": make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
        "wifi1944": wifi_code(1944),  # Z = 81, 12 natural layers
        "wifi648": wifi_code(648),  # Z = 27, 12 natural layers
        "wifi1296": wifi_code(1296),  # Z = 54: the exact schedule too; K5's forms timed only
        # every check of degree 36, past the combine's unrolled limit (no
        # generator: the all-zero codeword)
        "regular36": make_regular_code(1152, 3, 36, seed=1),
    }
    tables = {k: kernel_tables(to_sorted_device(c, dev, with_layers=True))
              for k, c in codes.items()}
    for k, t in tables.items():
        print(f"code {k}: nc {t.code.nc} mc {t.code.mc} nnz {t.code.nnz} max_dc {t.max_dc} "
              f"layers {t.n_layers} disjoint {t.layers_disjoint}")

    def llrs(key, point, snr_db=COMPARE_SNR_DB):
        tb_ = tables[key]
        return awgn_channel(tb_.code, make_generator(dev, 7, point, 0), BATCH, snr_db)

    mark("build and tables done")

    def form_name(form):
        """A tile kernel's form ``(frames, stage)`` as the kernels line names it."""
        frames_, stage = form
        if frames_ == 0:
            return "HBM planes, 32 frames x 8 warps"
        return f"tile, {frames_} frames a block{', tables staged' if stage else ''}"

    def k5_name(tb, dtype="float32", tile=None):
        """K5's form as the kernels line names it: the rule's, or the one forced."""
        tile = dl.exact_form(tb, dtype) if tile is None else tile
        if tile[0]:
            return form_name(tile)
        return "plane, lc2v and the posterior in device memory, 16 frames a block"

    def k5_forms(tb, dtype):
        """Every form of K5 that fits a block: ``(name, forced form)``."""
        return [(k5_name(tb, dtype, f), f)
                for f in ((16, True), (16, False), (8, True), (8, False), (4, True), (4, False),
                          (0, False))
                if f[0] == 0 or dl.exact_tile_bytes(tb, f[0], dtype, f[1]) <= dl.SMEM_BLOCK_BYTES]

    def k1_forms(key, dtype="float32"):
        """Kernel 1's other forms that fit, as ``also`` pairs: every tile
        size and staging beside the rule's, and the HBM-plane form."""
        tb, rule = tables[key], df.batch_form(tables[key], dtype)
        return tuple((form_name(f), in_form(df.bp_decode_fused, df, "BATCH_FORM_OVERRIDE", f))
                     for f in ((16, True), (16, False), (8, True), (8, False), (4, True),
                               (4, False), (0, False))
                     if f != rule and (f[0] == 0 or df.flood_tile_bytes(
                         tb, f[0], dtype, f[1]) <= df.SMEM_BLOCK_BYTES))

    k3_forms = tuple((form_name(f), in_form(dl.bp_decode_layered_fast, dl, "BATCH_FORM_OVERRIDE",
                                            f))
                     for f in ((16, False), (8, True), (8, False), (0, False)))
    # ---- 3. kernel 1 (flooding batch) against its plain version, in the
    # size rule's form and, on the same plain outputs, in its other forms
    err1 = 0.0
    for key in ("bench1152", "wifi1944"):
        err1 = max(err1, compare_batch(f"kernel1 {key}", df.bp_decode_fused,
                                       df.bp_decode_fused_plain, tables[key], llrs(key, 0).llr,
                                       also=k1_forms(key)))
        print(f"kernel1 form chosen for {key}: "
              f"{[form_name(df.batch_form(tables[key], dt)) for dt in SUFFIX]}")

    # ---- 4. kernel 2 (flooding stream) against its plain version
    def drain(fn, tb, llr, cw, form):
        st = init_state(tb, llr.shape[1])
        st.llr_in.copy_(llr)
        st.codeword.copy_(cw)
        st.done.zero_()
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        for _ in range(ITERS):
            fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
               st.ctr, st.fresh_llr, st.fresh_cw, zero, zero.clone(), k=6, cap=ITERS,
               minsum_mode=form)
            if int((st.done == 0).sum()) == 0:
                return st.ctr.sum(1).tolist()
        raise RuntimeError("streams did not drain")

    def fresh_pool_state(tb, ch, dtype="float32"):
        st = init_state(tb, BATCH, message_dtype=dtype)
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        return st

    refill_on = torch.ones(1, dtype=torch.int32, device=dev)

    def check_stream(tag, kernel, plain, key, point, snr_db=COMPARE_SNR_DB, also=()):
        """Drains of injected frames (BP_MS exact, BP to the counters'
        differences) and a quota of 5000, of ``kernel`` and of each
        ``(label, kernel)`` of ``also`` (its other forms) against one plain
        drain; the largest total difference of ``kernel``."""
        tb = tables[key]
        ch = llrs(key, point, snr_db)
        err = 0
        for form in ("BP_MS", "BP"):
            want = drain(plain, tb, ch.llr, ch.codeword, form)
            for name, fn in ((tag, kernel), *((f"{tag} {n}", f) for n, f in also)):
                got = drain(fn, tb, ch.llr, ch.codeword, form)
                print(f"{name} drain {key} {form}: kernel {got} plain {want}")
                check(got[2] == BATCH, f"{name}: not every injected frame was counted")
                if form == "BP_MS":
                    check(got == want, f"{name}: BP_MS drained totals differ")
                if fn is kernel:
                    err = max(err, max(abs(a - b) for a, b in zip(got, want)))
        quota = 5000
        for name, fn in ((tag, kernel), *((f"{tag} {n}", f) for n, f in also)):
            st = fresh_pool_state(tb, ch)
            remaining = torch.full((1,), quota, dtype=torch.int32, device=dev)
            fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
               st.fresh_llr, st.fresh_cw, refill_on, remaining, k=6, cap=ITERS, minsum_mode="BP")
            starts = int(st.ctr[4].sum())
            print(f"{name} quota {quota}: starts {starts}, pool entries used "
                  f"{BATCH - int(st.avail.sum())}")
            check(starts == quota == BATCH - int(st.avail.sum()), f"{name}: quota not exact")
        return err

    # kernel 2's other forms, held to the same plain drains: the HBM-plane
    # form (the rule's for a code whose tile does not fit) and the tile at 4
    # frames a block
    k2_hbm = ("HBM planes", in_form(df.bp_stream_chunk_fused, df, "STREAM_FORM_OVERRIDE",
                                    (0, False)))
    k2_tile4 = ("tile 4", in_form(df.bp_stream_chunk_fused, df, "STREAM_FORM_OVERRIDE",
                                  (4, True)))
    err2 = check_stream("kernel2", df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain,
                        "bench1152", 1, also=(k2_hbm, k2_tile4))
    print(f"kernel2 form chosen for bench1152: {df.stream_form(tables['bench1152'])}")

    # ---- 4b. the bfloat16 and int8 forms of kernels 1 and 2 against their
    # plain versions (int8: the min-sum family only).  Kernel 2 drains
    # frames that every lane takes from a full pool (its reload stores the
    # prior in the message form, as kernel 1 starts), against its plain
    # version and kernel 1's form on the same frames; then a quota.
    err_form = {}
    for dtype in ("bfloat16", "int8"):
        err_form[f"k1 {dtype}"] = max(
            compare_batch(f"kernel1 {key}", df.bp_decode_fused, df.bp_decode_fused_plain,
                          tables[key], llrs(key, 0).llr, dtype, also=k1_forms(key, dtype))
            for key in ("bench1152", "wifi1944"))

    def check_form_stream(tag, chunk, chunk_plain, batch, key, point, also=()):
        """Pool drains of ``chunk`` in each sub-32-bit form against its plain
        version and the batch kernel's form on the same frames (min-sum
        exact), then a quota of 5000; ``also``: more ``(label, chunk)``
        pairs (its other forms) held to the same; the largest total
        difference of ``chunk`` per form."""
        tb, ch = tables[key], llrs(key, point)
        bp = tb.code.bit_pos.long()
        chunks = ((tag, chunk), *((f"{tag} {n}", f) for n, f in also))
        errs_out = {}
        for dtype in ("bfloat16", "int8"):
            err = 0
            for form in DTYPE_FORMS[dtype]:
                want = pool_drain(chunk_plain, tb, ch, form, dtype)
                out1 = batch(tb, ch.llr, ITERS, True, form, dtype)
                errs1 = (out1.hard[bp] != ch.codeword[bp].bool()).sum(0)
                batch1 = [int(errs1.sum()), int((errs1 > 0).sum()), BATCH,
                          int(out1.iterations.sum()), BATCH]
                label = form if isinstance(form, str) else form[0]
                for name, fn in chunks:
                    got = pool_drain(fn, tb, ch, form, dtype)
                    print(f"{name} {dtype} drain {key} {label}: kernel {got} plain {want} "
                          f"batch {batch1}")
                    check(got[2] == got[4] == BATCH,
                          f"{name} {dtype}: not every frame started and counted")
                    if label != "BP":
                        check(got == want == batch1,
                              f"{name} {dtype} {label}: drained totals differ")
                    if fn is chunk:
                        err = max(err, max(abs(a - b) for a, b in zip(got, want)))
            for name, fn in chunks:
                st = fresh_pool_state(tb, ch, dtype)
                remaining = torch.full((1,), 5000, dtype=torch.int32, device=dev)
                fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                   st.ctr, st.fresh_llr, st.fresh_cw, refill_on, remaining, k=6, cap=ITERS,
                   minsum_mode=DTYPE_FORMS[dtype][0], message_dtype=dtype)
                starts = int(st.ctr[4].sum())
                print(f"{name} {dtype} quota 5000: starts {starts}, pool entries used "
                      f"{BATCH - int(st.avail.sum())}")
                check(starts == 5000 == BATCH - int(st.avail.sum()),
                      f"{name} {dtype}: quota not exact")
            errs_out[dtype] = float(err)
        return errs_out

    for dtype, err in check_form_stream("kernel2", df.bp_stream_chunk_fused,
                                        df.bp_stream_chunk_fused_plain, df.bp_decode_fused,
                                        "bench1152", 1, also=(k2_hbm,)).items():
        err_form[f"k2 {dtype}"] = err

    mark("kernels 1 and 2 held against plain")
    # ---- 5. K3 (fast layered engine, batch) against its plain version, in
    # the size rule's form (16 frames a block, staged) and, on the same plain
    # outputs, in its other forms
    err3 = compare_batch("K3 wifi1944", dl.bp_decode_layered_fast,
                         dl.bp_decode_layered_fast_plain, tables["wifi1944"],
                         llrs("wifi1944", 3).llr, also=k3_forms)
    print(f"K3 form chosen for wifi 1944: {form_name(dl.batch_form(tables['wifi1944']))}")

    # ---- 5b. K3's bfloat16 and int8 forms (lc2v in the form, the APP float32)
    # against their plain versions; bf16 BP's APP within one bf16 step
    for dtype in ("bfloat16", "int8"):
        err_form[f"k3 {dtype}"] = compare_batch(
            "K3 wifi1944", dl.bp_decode_layered_fast, dl.bp_decode_layered_fast_plain,
            tables["wifi1944"], llrs("wifi1944", 3).llr, dtype, tol=2 ** -8, also=k3_forms)

    # ---- 5c. K1 and K3 at a batch that is not a multiple of the frames a
    # block, in every form, each message form, ET on and off
    for dtype in SUFFIX:
        compare_batch("kernel1 bench1152 B=301", df.bp_decode_fused, df.bp_decode_fused_plain,
                      tables["bench1152"], llrs("bench1152", 9).llr[:, :301].contiguous(), dtype,
                      also=k1_forms("bench1152", dtype))
        compare_batch("K3 wifi1944 B=301", dl.bp_decode_layered_fast,
                      dl.bp_decode_layered_fast_plain, tables["wifi1944"],
                      llrs("wifi1944", 9).llr[:, :301].contiguous(), dtype,
                      tol=2 ** -8 if dtype == "bfloat16" else 1e-4, also=k3_forms)

    # ---- 6. K4 (fast layered engine, stream) against its plain version
    err4 = check_stream("K4", dl.bp_stream_chunk_layered_fast,
                        dl.bp_stream_chunk_layered_fast_plain, "wifi1944", 4)

    # ---- 6a. K4's other forms (the size rule picks one per code: here 16
    # frames a block with staged tables): 8 frames a block and the HBM-plane
    # form drain the same frames to the same totals
    form_of = {(16, True): "tile16+tables", (16, False): "tile16", (8, True): "tile8+tables",
               (8, False): "tile8", (0, False): "hbm-planes"}
    k4_form = form_of[dl.stream_form(tables["wifi1944"])]
    ch4 = llrs("wifi1944", 4)
    want4 = drain(dl.bp_stream_chunk_layered_fast_plain, tables["wifi1944"], ch4.llr, ch4.codeword,
                  "BP_MS")
    for forced in ((16, True), (8, False), (0, False)):
        dl.STREAM_FORM_OVERRIDE = forced
        got4 = drain(dl.bp_stream_chunk_layered_fast, tables["wifi1944"], ch4.llr, ch4.codeword,
                     "BP_MS")
        dl.STREAM_FORM_OVERRIDE = None
        print(f"K4 form {form_of[forced]} drain wifi1944 BP_MS: kernel {got4} plain {want4}")
        check(got4 == want4, f"K4 form {form_of[forced]}: drained totals differ")
    print(f"K4 form chosen for wifi 1944: {k4_form}")

    # ---- 6b. K4's forms: pool drains against the plain chunk and K3's form
    # on the same frames (a reload starts the APP at the prior in the form's
    # units, as K3 starts), then a quota
    for dtype, err in check_form_stream("K4", dl.bp_stream_chunk_layered_fast,
                                        dl.bp_stream_chunk_layered_fast_plain,
                                        dl.bp_decode_layered_fast, "wifi1944", 4).items():
        err_form[f"k4 {dtype}"] = err

    # ---- 7. K5 (exact layered schedule) against its plain version, in the
    # rule's form and, on the same frames, in the 4-frame tile and the plane
    # form (the rule's for a code whose tile does not fit)
    k5_also = tuple((name, in_form(dl.bp_decode_layered, dl, "EXACT_FORM_OVERRIDE", f))
                    for name, f in (("tile4", (4, True)), ("plane", (0, False))))
    err5 = compare_batch("K5 wifi648", dl.bp_decode_layered, dl.bp_decode_layered_plain,
                         tables["wifi648"], llrs("wifi648", 5).llr, also=k5_also)
    print(f"K5 form chosen for wifi 648: {dl.exact_form(tables['wifi648'])}")

    # ---- 7a. K5's message forms (lc2v and the posterior in the form); bf16 BP's
    # posterior within eight bf16 steps: it is recomputed from every stored
    # message after each of the 12 layers
    for dtype in ("bfloat16", "int8"):
        err_form[f"k5 {dtype}"] = compare_batch(
            "K5 wifi648", dl.bp_decode_layered, dl.bp_decode_layered_plain, tables["wifi648"],
            llrs("wifi648", 5).llr, dtype, tol=2 ** -4, also=k5_also)

    mark("K3, K4 and K5 held against plain")
    # ---- 7b. K6 (BEC peeling, batch) against its plain version: integer
    # algebra, so all four outputs must be equal byte for byte
    def bec_frames(key, point, eps=BEC_EPS):
        return bec_channel(tables[key].code, make_generator(dev, 8, point, 0), BATCH, eps)

    err6 = 0.0  # largest |kernel - plain| over symbols, decisions and iteration counts
    for key in ("bench1152", "wifi1944"):
        ch = bec_frames(key, 0)
        for et in (True, False):
            for stale in (None, 0):
                got = db.bec_decode_fused(tables[key], ch.llr, ch.codeword, ITERS, et, stale)
                want = db.bec_decode_fused_plain(tables[key], ch.llr, ch.codeword, ITERS, et, stale)
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(got, want)]
                err6 = max([err6] + [float((a.int() - b.int()).abs().max())
                                     for a, b in zip(got, want)])
                print(f"K6 {key} eps {BEC_EPS} et={int(et)} compat={int(stale is not None)}: "
                      f"equal {same} avg_iter {got.iterations.float().mean().item():.3f} "
                      f"resolved {got.resolved.float().mean().item():.4f}")
                check(all(same), f"K6 {key} not bit-exact")
        # the form for a code whose words pass a block's shared memory: the
        # same words in a device-memory scratch
        db.FORCE_SCRATCH = True
        got = db.bec_decode_fused(tables[key], ch.llr, ch.codeword, ITERS, True)
        db.FORCE_SCRATCH = False
        want = db.bec_decode_fused_plain(tables[key], ch.llr, ch.codeword, ITERS, True)
        check(all(torch.equal(a, b) for a, b in zip(got, want)) and
              db.bec_decode_fused.last_in_shared is False,
              f"K6 {key} with its words in device memory not bit-exact")

    # ---- 7c. K7 (BEC peeling, stream) in each form (the size rule's words
    # in shared memory, and the byte planes forced) against its plain
    # version and K6: every frame enters through the pool (a reload starts
    # from the channel symbols, as the batch decode does), then the lanes
    # drain; the state after a chunk from mid-stream; the quota
    def bec_drain(fn, tb, ch):
        st = init_state(tb, BATCH, "BEC")
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        refill = torch.ones(1, dtype=torch.int32, device=dev)
        remaining = torch.full((1,), BATCH, dtype=torch.int32, device=dev)
        for _ in range(ITERS):
            fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
               st.fresh_llr, st.fresh_cw, refill, remaining, k=6, cap=ITERS)
            refill.zero_()
            if int((st.done == 0).sum()) == 0:
                return st.ctr.sum(1).tolist()
        raise RuntimeError("BEC streams did not drain")

    k7_planes = ("llr_in", "codeword", "lv2c", "done", "iters", "age", "avail", "ctr")

    def k7_chunk_state(key, stale):
        """One chunk of 6 passes from mid-stream (a plain chunk of 3 passes
        with half the lanes started, the consumed pool entries refreshed),
        kernel against plain; the largest |difference| over the carried
        planes and counters."""
        tb = tables[key]
        ch, ch2 = bec_frames(key, 4), bec_frames(key, 5)
        st = init_state(tb, BATCH, "BEC")
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        half = torch.full((1,), BATCH // 2, dtype=torch.int32, device=dev)
        db.bec_stream_chunk_fused_plain(
            tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
            st.fresh_llr, st.fresh_cw, refill_on, half, k=3, cap=ITERS, degree1_stale_byte=stale)
        st.fresh_llr.copy_(torch.where(st.avail == 0, ch2.llr, st.fresh_llr))
        st.fresh_cw.copy_(torch.where(st.avail == 0, ch2.codeword, st.fresh_cw))
        st.avail.fill_(1)
        out = []
        for fn in (db.bec_stream_chunk_fused, db.bec_stream_chunk_fused_plain):
            s_ = init_state(tb, BATCH, "BEC")
            for n in k7_planes + ("fresh_llr", "fresh_cw"):
                getattr(s_, n).copy_(getattr(st, n))
            fn(tb, s_.llr_in, s_.codeword, s_.lv2c, s_.done, s_.iters, s_.age, s_.avail, s_.ctr,
               s_.fresh_llr, s_.fresh_cw, refill_on,
               torch.full((1,), BATCH, dtype=torch.int32, device=dev), k=6, cap=ITERS,
               degree1_stale_byte=stale)
            out.append(s_)
        torch.cuda.synchronize()
        same = [torch.equal(getattr(out[0], n), getattr(out[1], n)) for n in k7_planes]
        print(f"K7 {db.bec_stream_chunk_fused.last_form} {key} chunk from mid-stream, "
              f"compat={int(stale is not None)}: equal {same}, frames finished "
              f"{int(out[1].ctr[2].sum())}, started {int(out[1].ctr[4].sum())}")
        check(all(same), f"K7 {key} state after a chunk not bit-exact")
        return max(float((getattr(out[0], n).int() - getattr(out[1], n).int()).abs().max())
                   for n in k7_planes)

    tb7, ch7 = tables["bench1152"], bec_frames("bench1152", 1)
    want7 = bec_drain(db.bec_stream_chunk_fused_plain, tb7, ch7)
    out6 = db.bec_decode_fused(tb7, ch7.llr, ch7.codeword, ITERS, True)
    bp7 = tb7.code.bit_pos.long()
    errs6 = (out6.hard[bp7] != ch7.codeword[bp7]).sum(0)
    batch7 = [int(errs6.sum()), int((errs6 > 0).sum()), BATCH, int(out6.iterations.sum()), BATCH]
    check(want7 == batch7, "K7's plain version drains unlike K6")
    check(db.bec_stream_form(tb7) == db.bec_stream_form(tables["wifi1944"]) == "words",
          "K7's size rule: words for the 1152 code and wifi 1944")
    err7 = 0.0  # largest |kernel - plain| over drained totals and carried state
    for form in ("words", "bytes"):
        db.FORCE_BYTES = form == "bytes"
        try:
            got7 = bec_drain(db.bec_stream_chunk_fused, tb7, ch7)
            print(f"K7 {form} drain bench1152 eps {BEC_EPS}: kernel {got7} plain {want7} K6 "
                  f"batch {batch7}")
            check(db.bec_stream_chunk_fused.last_form == form, f"K7 ran {form}")
            check(got7 == want7, f"K7 {form} drained totals differ from its plain version or K6")
            err7 = max([err7] + [float(abs(a - b)) for a, b in zip(got7, want7)])
            for key in ("bench1152", "wifi1944"):
                for stale in (None, 0):
                    err7 = max(err7, k7_chunk_state(key, stale))
            st = init_state(tb7, BATCH, "BEC")
            st.fresh_llr.copy_(ch7.llr)
            st.fresh_cw.copy_(ch7.codeword)
            st.avail.fill_(1)
            remaining = torch.full((1,), 5000, dtype=torch.int32, device=dev)
            db.bec_stream_chunk_fused(tb7, st.llr_in, st.codeword, st.lv2c, st.done, st.iters,
                                      st.age, st.avail, st.ctr, st.fresh_llr, st.fresh_cw,
                                      refill_on, remaining, k=6, cap=ITERS)
            starts = int(st.ctr[4].sum())
            print(f"K7 {form} quota 5000: starts {starts}, pool entries used "
                  f"{BATCH - int(st.avail.sum())}")
            check(starts == 5000 == BATCH - int(st.avail.sum()), f"K7 {form} quota not exact")
        finally:
            db.FORCE_BYTES = False

    # ---- 7d. a code whose checks have degree 36, past the combine's unrolled
    # limit (the windowed combine): kernel 1, kernel 2 (its tile and
    # HBM-plane forms) and K6 against their plain versions.  Rate 11/12:
    # 6.5 dB and eps 0.04 are in its waterfalls.
    tb36 = tables["regular36"]
    check(tb36.max_dc == 36, "the degree-36 code's tables")
    err36 = compare_batch("kernel1 regular36", df.bp_decode_fused, df.bp_decode_fused_plain, tb36,
                          llrs("regular36", 6, 6.5).llr, also=k1_forms("regular36"))
    err36 = max(err36, check_stream("kernel2 regular36", df.bp_stream_chunk_fused,
                                    df.bp_stream_chunk_fused_plain, "regular36", 6, 6.5,
                                    also=(k2_hbm,)))
    ch36 = bec_channel(tb36.code, make_generator(dev, 8, 6, 0), BATCH, 0.04)
    for et in (True, False):
        got = db.bec_decode_fused(tb36, ch36.llr, ch36.codeword, ITERS, et)
        want = db.bec_decode_fused_plain(tb36, ch36.llr, ch36.codeword, ITERS, et)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        print(f"K6 regular36 eps 0.04 et={int(et)}: equal {same} avg_iter "
              f"{got.iterations.float().mean().item():.3f} resolved "
              f"{got.resolved.float().mean().item():.4f}")
        check(all(same), "K6 on the degree-36 code not bit-exact")
    print(f"degree-36 code: largest |kernel - plain| {err36:.3e}")

    mark("K6, K7 and the degree-36 code held against plain")
    # ---- 7e. K8, the streaming pool's refill, against its plain version
    k8 = run_pool_refill(dev, tables, name_power)
    # ---- 7f. the start grants in lane order of K2, K4 and K7 where the
    # quota binds, and their cost
    grants = run_ordered_grants(dev, tables, name_power)
    mark("K8 and the ordered grants held against plain")
    # ---- 8. the flooding slice: the CLI sweep of the 1152 code on the card
    WORK.mkdir(parents=True, exist_ok=True)

    def write_files(key):
        code = codes[key]
        write_codefile(str(WORK / f"{key}_h.txt"), code.rows, code.cols, code.nc, code.mc)
        r, c = code.G.nonzero()
        (WORK / f"{key}_g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
        files = [str(WORK / f"{key}_h.txt"), "-G", str(WORK / f"{key}_g.txt")]
        if code.layers:
            write_layerfile(str(WORK / f"{key}_layers.txt"), code.layers)
        return files

    def run_cli(key, out, snrs, *flags, layered=False, pallas=True):
        files = write_files(key)
        h, g = files[0], files[1:]
        args = [h, str(WORK / out), *snrs, *g, "-i", str(ITERS), "--batch-size", str(BATCH),
                *(["--pallas"] if pallas else []), *flags]
        if layered:
            args += ["--layer-file", str(WORK / f"{key}_layers.txt")]
        t0 = time.perf_counter()
        check(cli.main(args) == 0, f"CLI run {out} failed")
        text = (WORK / out).read_text()
        print(f"--- {out} ({time.perf_counter() - t0:.1f} s)\n{text}", end="")
        lines = text.splitlines()
        rows = [[float(v) for v in ln.split()] for ln in lines[2:]]
        check(rows and all(math.isfinite(v) for r in rows for v in r), f"{out} rows")
        return lines[0], rows

    counted = (db.bec_decode_fused, db.bec_stream_chunk_fused, pr.pool_refill, df.stream_grant,
               pr.channel_batch, pr.stream_reload)
    layered_fns = (dl.bp_decode_layered_fast, dl.bp_stream_chunk_layered_fast,
                   dl.bp_decode_layered)
    by_form = (df.bp_decode_fused, df.bp_stream_chunk_fused, *layered_fns)  # a count per form

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        for fn in by_form:
            fn.launches = dict.fromkeys(SUFFIX, 0)
        # the staged reload and K2's launches given its staging buffer
        pr.stream_reload.staged_launches = 0
        df.bp_stream_chunk_fused.staged_launches = 0

    def read_counts():
        out = {fn.__name__: fn.launches for fn in counted}
        out.update({fn.__name__ + SUFFIX[dt]: n for fn in by_form for dt, n in fn.launches.items()})
        out["stream_reload_staged"] = pr.stream_reload.staged_launches
        out["bp_stream_chunk_fused_staged"] = df.bp_stream_chunk_fused.staged_launches
        return out

    # the sweeps of phases 8-9b draw every channel batch with K8: the plain
    # channel (simulate_channel) must not run on the card
    plain_channel = pr.simulate_channel

    def no_plain_channel(sdc, *args, **kwargs):
        check(sdc.device.type != "cuda", "a card step fell back to simulate_channel")
        return plain_channel(sdc, *args, **kwargs)

    pr.simulate_channel = no_plain_channel
    zero_counts()
    head, rows = run_cli("bench1152", "res.txt", SWEEP, "--frame-error-count", "50",
                         "--max-frames", "2000000")
    head_fixed, fixed = run_cli("bench1152", "res_fixed.txt", ["2.0", "2.01", "1"],
                                "--frame-error-count", "50", "--max-frames", str(8 * BATCH),
                                "--no-early-term")
    flooding_launches = read_counts()
    print(f"flooding path launches: {flooding_launches}")
    check(flooding_launches["bp_stream_chunk_fused"] > 0, "the sweep did not run kernel 2")
    check(flooding_launches["pool_refill"] > 0, "the sweep did not refill its pool with K8")
    check(flooding_launches["stream_grant"] > 0,
          "no chunk of the sweep's max_frames-ended points ran the ordered grants")
    check(flooding_launches["bp_decode_fused"] > 0, "the fixed point did not run kernel 1")
    check(flooding_launches["channel_batch"] > 0, "the fixed point did not draw with K8")
    check(head.startswith("# kernel=cuda-fused") and "schedule=flooding streaming=on" in head,
          "flooding provenance line")
    check(len(rows) == 5 and rows[0][1] > rows[-1][1], "FER does not fall across the sweep")
    check(all(0 < r[4] <= ITERS for r in rows), "avg_iter out of range")
    check(fixed[0][4] == ITERS, "fixed-iteration point did not run every iteration")

    # ---- 8b. the message forms: the flooding sweeps with --pallas
    # --message-dtype (frames capped: each point stops at 50 frame errors or
    # 1 M frames)
    zero_counts()
    cap = ["--frame-error-count", "50", "--max-frames", "1000000"]
    fixed_cap = ["--frame-error-count", "50", "--max-frames", str(4 * BATCH), "--no-early-term"]
    bf16 = ["--message-dtype", "bfloat16"]
    int8_oms = ["--message-dtype", "int8", "--decoding", "BP_OMS"]
    head_b16, rows_b16 = run_cli("bench1152", "res_bf16.txt", SWEEP, *bf16, *cap)
    head_b16f, fixed_b16 = run_cli("bench1152", "res_bf16_fixed.txt", ["2.0", "2.01", "1"], *bf16,
                                   *fixed_cap)
    head_i8, rows_i8 = run_cli("bench1152", "res_int8.txt", SWEEP, *int8_oms, *cap)
    head_i8f, fixed_i8 = run_cli("bench1152", "res_int8_fixed.txt", ["2.0", "2.01", "1"],
                                 *int8_oms, *fixed_cap)
    head_w8, rows_w8 = run_cli("wifi1944", "res_int8_1944.txt", ["1.5", "2.01", "0.5"],
                               "--message-dtype", "int8", "--decoding", "BP_MS", *cap)
    form_launches = read_counts()
    print(f"message-form path launches: {form_launches}")
    for name in ("bp_decode_fused_bf16", "bp_stream_chunk_fused_bf16", "bp_decode_fused_int8",
                 "bp_stream_chunk_fused_int8"):
        check(form_launches[name] > 0, f"the message-form sweeps did not run {name}")
    for head, dtype, cn, streaming in (
            (head_b16, "bfloat16", "BP", "on"), (head_b16f, "bfloat16", "BP", "off"),
            (head_i8, "int8", "BP_OMS", "on"), (head_i8f, "int8", "BP_OMS", "off"),
            (head_w8, "int8", "BP_MS", "on")):
        check(head.startswith(f"# kernel=cuda-fused dtype={dtype} cn={cn} schedule=flooding "
                              f"streaming={streaming}"), f"{dtype} provenance line: {head}")
    for rows_, n in ((rows_b16, 5), (rows_i8, 5), (rows_w8, 2)):
        check(len(rows_) == n and rows_[0][1] > rows_[-1][1], "FER does not fall across a sweep")
        check(all(0 < r[4] <= ITERS for r in rows_), "avg_iter out of range")
    check(fixed_b16[0][4] == ITERS == fixed_i8[0][4], "fixed points did not run every iteration")
    for (x, fer32, *_), (_, fer8, *_) in zip(rows, rows_i8):
        print(f"bench1152 {x} dB: FER BP float32 {fer32:.4e}, BP_OMS int8 {fer8:.4e} "
              f"[{name_power}]")

    mark("flooding sweeps done")
    # ---- 9. the layered slice: the 802.11n sweep on the card
    zero_counts()
    head_l, rows_l = run_cli("wifi1944", "res_layered.txt", LAYERED_SWEEP, "--qc-z", "81",
                             "--frame-error-count", "50", "--max-frames", "4000000",
                             layered=True)
    head_lf, fixed_l = run_cli("wifi1944", "res_layered_fixed.txt", ["2.0", "2.01", "1"],
                               "--qc-z", "81", "--frame-error-count", "50", "--max-frames",
                               str(4 * BATCH), "--no-early-term", layered=True)
    head_648, rows_648 = run_cli("wifi648", "res_layered_648.txt", ["2.0", "2.01", "1"],
                                 "--frame-error-count", "50", "--max-frames", str(4 * BATCH),
                                 layered=True)
    layered_launches = read_counts()
    print(f"layered path launches: {layered_launches}")
    check(layered_launches["bp_stream_chunk_layered_fast"] > 0, "the layered sweep did not run K4")
    check(layered_launches["bp_decode_layered_fast"] > 0, "the fixed layered point did not run K3")
    check(layered_launches["bp_decode_layered"] > 0, "the wifi 648 point did not run K5")
    check(layered_launches["channel_batch"] > 0, "the batch-stepped layered points did not draw "
                                                 "with K8")
    check("schedule=layered-fast streaming=on" in head_l, "wifi 1944 sweep provenance")
    check("schedule=layered-fast streaming=off" in head_lf, "wifi 1944 fixed provenance")
    check("schedule=layered streaming=off" in head_648, "wifi 648 provenance")
    check(len(rows_l) == 4 and rows_l[0][1] > rows_l[-1][1],
          "FER does not fall across the layered sweep")
    check(all(0 < r[4] <= ITERS for r in rows_l + rows_648), "layered avg_iter out of range")
    check(fixed_l[0][4] == ITERS, "fixed layered point did not run every iteration")
    # flooding on the same code at one SNR of the layered sweep, and a
    # fixed-iteration flooding point (kernel 1 on wifi 1944)
    _, rows_flood = run_cli("wifi1944", "res_flooding_1944.txt", ["1.5", "1.51", "1"],
                            "--frame-error-count", "50", "--max-frames", "4000000")
    run_cli("wifi1944", "res_flooding_1944_fixed.txt", ["2.0", "2.01", "1"], *fixed_cap)
    k1_1944_launches = read_counts()["bp_decode_fused"]
    at15 = [r for r in rows_l if abs(r[0] - 1.5) < 1e-6][0]
    print(f"wifi 1944 at 1.5 dB: layered avg_iter {at15[4]} FER {at15[1]}, flooding avg_iter "
          f"{rows_flood[0][4]} FER {rows_flood[0][1]} [{name_power}]")
    check(at15[4] < rows_flood[0][4], "layered avg_iter not below flooding")

    # ---- 9a. the layered slice with bfloat16 and int8 messages: the wifi
    # 1944 sweep on the fast engine (K4; K3 on a --no-early-term point) with
    # bf16 BP and int8 BP_OMS, and wifi 648 on the exact schedule (K5) with
    # bf16 BP and int8 BP_MS at 2.0 dB (frames capped as in 8b)
    zero_counts()
    layered_forms = {}  # (code, dtype, cn) -> (provenance line, rows)
    for dtype, cn in (("bfloat16", "BP"), ("int8", "BP_OMS")):
        flags = ["--message-dtype", dtype, "--decoding", cn]
        tag = SUFFIX[dtype]
        layered_forms["wifi1944", dtype, cn] = run_cli(
            "wifi1944", f"res_layered{tag}.txt", LAYERED_SWEEP, "--qc-z", "81", *flags, *cap,
            layered=True)
        layered_forms["wifi1944 fixed", dtype, cn] = run_cli(
            "wifi1944", f"res_layered{tag}_fixed.txt", ["2.0", "2.01", "1"], "--qc-z", "81",
            *flags, *fixed_cap, layered=True)
    for dtype, cn in (("bfloat16", "BP"), ("int8", "BP_MS")):
        layered_forms["wifi648", dtype, cn] = run_cli(
            "wifi648", f"res_layered_648{SUFFIX[dtype]}.txt", ["2.0", "2.01", "1"],
            "--message-dtype", dtype, "--decoding", cn, "--frame-error-count", "50",
            "--max-frames", str(4 * BATCH), layered=True)
    layered_form_launches = read_counts()
    print(f"layered message-form path launches: {layered_form_launches}")
    for fn in layered_fns:
        for dtype in ("bfloat16", "int8"):
            check(layered_form_launches[fn.__name__ + SUFFIX[dtype]] > 0,
                  f"the layered message-form sweeps did not run {fn.__name__} {dtype}")
    for (key, dtype, cn), (head, rows_) in layered_forms.items():
        schedule, streaming = {"wifi1944": ("layered-fast", "on"),
                               "wifi1944 fixed": ("layered-fast", "off"),
                               "wifi648": ("layered", "off")}[key]
        check(head.startswith(f"# kernel=cuda-fused dtype={dtype} cn={cn} schedule={schedule} "
                              f"streaming={streaming}"), f"{key} {dtype} provenance line: {head}")
        check(all(0 < r[4] <= ITERS for r in rows_), f"{key} {dtype} avg_iter out of range")
        if key == "wifi1944":
            check(len(rows_) == 4 and rows_[0][1] > rows_[-1][1],
                  f"FER does not fall across the {dtype} layered sweep")
        if key == "wifi1944 fixed":
            check(rows_[0][4] == ITERS, f"fixed {dtype} layered point did not run every iteration")
    # FER and avg_iter against float32 BP on the same schedule and SNRs
    for i, row32 in enumerate(rows_l):
        b16 = layered_forms["wifi1944", "bfloat16", "BP"][1][i]
        i8 = layered_forms["wifi1944", "int8", "BP_OMS"][1][i]
        print(f"wifi1944 layered-fast {row32[0]} dB: FER / avg_iter float32 BP {row32[1]:.4e} / "
              f"{row32[4]:.3f}, bfloat16 BP {b16[1]:.4e} / {b16[4]:.3f}, int8 BP_OMS "
              f"{i8[1]:.4e} / {i8[4]:.3f} [{name_power}]")
    for dtype, cn in (("bfloat16", "BP"), ("int8", "BP_MS")):
        r648 = layered_forms["wifi648", dtype, cn][1][0]
        print(f"wifi648 layered 2.0 dB: FER / avg_iter float32 BP {rows_648[0][1]:.4e} / "
              f"{rows_648[0][4]:.3f}, {dtype} {cn} {r648[1]:.4e} / {r648[4]:.3f} [{name_power}]")

    mark("layered sweeps done")
    # ---- 9c. the default command line on the exact schedule: --layer-file on
    # wifi 1944 without --pallas (the JAX CLI's default: float32, the exact
    # layered schedule, batch-stepped): each batch K8's channel, then K5 in
    # its rule's form
    zero_counts()
    console = io.StringIO()
    with contextlib.redirect_stdout(console):
        head_d, rows_d = run_cli("wifi1944", "res_default_layered.txt", ["2.0", "2.01", "1"],
                                 "--frame-error-count", "50", "--max-frames", str(16 * BATCH),
                                 layered=True, pallas=False)
    print(console.getvalue(), end="")
    default_layered_launches = read_counts()
    k5_1944_form = dl.bp_decode_layered.last_form
    print(f"default --layer-file path launches: {default_layered_launches}")
    check("Engine: batch" in console.getvalue(), "the default --layer-file sweep is not "
                                                 "batch-stepped")
    check(head_d.startswith("# kernel=cuda-fused dtype=float32 cn=BP schedule=layered "
                            "streaming=off"), f"default --layer-file provenance: {head_d}")
    check(default_layered_launches["bp_decode_layered"] > 0
          and default_layered_launches["channel_batch"] > 0,
          "the default --layer-file sweep did not run K8 and K5")
    check(k5_1944_form == dl.exact_form(tables["wifi1944"]),
          f"the default --layer-file sweep ran K5 in {k5_1944_form}, not the rule's form")
    check(all(0 < r[4] <= ITERS for r in rows_d), "default --layer-file avg_iter out of range")
    # its frames/s from the same sweep's Simulator (the CLI's seed 0): the
    # results file keeps a frame's time to 1 us (and its row is the point's
    # as of its last frame error)
    res_d = Simulator(codes["wifi1944"], DecoderParams(iterations=ITERS, layered=True),
                      ChannelParams(seed=0, x_range=(2.0, 2.01, 1.0)),
                      SimulationParams(batch_size=BATCH, fec=50, max_frames=16 * BATCH),
                      device=dev, verbose=False, use_pallas=False).start()
    for i, r in enumerate(rows_d):
        print(f"default --layer-file wifi1944 {r[0]} dB: results file FER {r[1]:.4e} frames "
              f"{int(r[3])} avg_iter {r[4]:.3f}; its Simulator FER {res_d.fer[i]:.4e} frames "
              f"{int(res_d.frames[i])} avg_iter {res_d.avg_iter[i]:.3f} frames/s "
              f"{1.0 / res_d.time[i]:.0f} (K5 {k5_name(tables['wifi1944'])}, "
              f"{default_layered_launches['bp_decode_layered']} launches on the CLI's run) "
              f"[{name_power}]")
    # ---- 9b. the BEC slice: the CLI's --channel BEC sweep of the 1152 code,
    # a fixed-iteration point, the 802.11n code with --layer-file --pallas
    # (the peeling runs flooding), and the BEC streaming step
    zero_counts()
    head_b, rows_b = run_cli("bench1152", "res_bec.txt", BEC_SWEEP, "--channel", "BEC",
                             "--frame-error-count", "50", "--max-frames", "2000000")
    head_bf, fixed_b = run_cli("bench1152", "res_bec_fixed.txt", ["0.40", "0.401", "1"],
                               "--channel", "BEC", "--frame-error-count", "50", "--max-frames",
                               str(4 * BATCH), "--no-early-term")
    k6_before = db.bec_decode_fused.launches
    head_bw, rows_bw = run_cli("wifi1944", "res_bec_1944.txt", ["0.40", "0.401", "1"],
                               "--channel", "BEC", "--qc-z", "81", "--frame-error-count", "50",
                               "--max-frames", str(4 * BATCH), layered=True)
    k6_1944_launches = db.bec_decode_fused.launches - k6_before
    # the second entry point: make_streaming_fused_step(tables, "BEC", ...)
    sinit, sstep = make_streaming_fused_step(tables["bench1152"], "BEC",
                                             DecoderParams(iterations=ITERS), BATCH,
                                             max_frames=4 * BATCH)
    sst, s_frames, s_fec, s_iter = sinit(), 0, 0, 0
    for step in range(200):
        sst, acc = sstep(sst, make_generator(dev, 9, 0, step), BEC_EPS, True)
        vals = torch.stack(list(acc)).tolist()
        s_frames, s_fec, s_iter = s_frames + vals[2], s_fec + vals[1], s_iter + vals[3]
        if s_frames >= 4 * BATCH and vals[4] == 0:
            break
    bec_launches = read_counts()
    print(f"BEC path launches: {bec_launches} (K7 in its {db.bec_stream_chunk_fused.last_form} "
          f"form)")
    check(db.bec_stream_chunk_fused.last_form == db.bec_stream_form(tables["bench1152"]),
          "the BEC streaming step ran K7 in another form than its size rule's")
    print(f"BEC streaming step eps {BEC_EPS}: {s_frames} frames, FER {s_fec / s_frames:.4e}, "
          f"avg_iter {s_iter / s_frames:.3f}")
    check(bec_launches["bec_decode_fused"] > 0, "the BEC sweep did not run K6")
    check(bec_launches["channel_batch"] > 0, "the BEC sweep did not draw with K8")
    check(bec_launches["bec_stream_chunk_fused"] > 0, "the BEC streaming step did not run K7")
    check(s_frames == 4 * BATCH and int(sst.started) == 4 * BATCH, "BEC streaming quota")
    for head in (head_b, head_bf, head_bw):
        check(head.startswith("# kernel=cuda-bec dtype=uint8-3state cn=peeling "
                              "schedule=flooding streaming=off"), "BEC provenance line")
    check(len(rows_b) == 4 and [r[0] for r in rows_b] == sorted((r[0] for r in rows_b),
                                                                 reverse=True),
          "BEC sweep points")
    check(all(a[1] > b[1] for a, b in zip(rows_b, rows_b[1:])), "BEC FER does not fall with eps")
    check(all(0 <= r[4] <= ITERS for r in rows_b + rows_bw), "BEC avg_iter out of range")
    check(fixed_b[0][4] == ITERS, "fixed-iteration BEC point did not run every iteration")

    pr.simulate_channel = plain_channel
    mark("BEC sweeps done")
    # ---- 10. times (CUDA events), kernel against plain
    times = {}
    for key in ("bench1152", "wifi1944"):
        tb_, llr = tables[key], llrs(key, 2).llr
        times[f"k1 {key}"] = (cuda_ms(lambda: df.bp_decode_fused(tb_, llr, ITERS, False, "BP"), 5),
                              cuda_ms(lambda: df.bp_decode_fused_plain(tb_, llr, ITERS, False, "BP"), 2))
    tb3, llr3 = tables["wifi1944"], llrs("wifi1944", 2).llr
    times["K3 wifi1944"] = (
        cuda_ms(lambda: dl.bp_decode_layered_fast(tb3, llr3, ITERS, False, "BP"), 5),
        cuda_ms(lambda: dl.bp_decode_layered_fast_plain(tb3, llr3, ITERS, False, "BP"), 1,
                warm=False))
    tb5, llr5 = tables["wifi648"], llrs("wifi648", 2).llr
    times["K5 wifi648"] = (
        cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, "BP"), 3),
        cuda_ms(lambda: dl.bp_decode_layered_plain(tb5, llr5, ITERS, False, "BP"), 1,
                warm=False))
    # the message forms of kernel 1: BP in bfloat16, min-sum on the lattice;
    # and min-sum in each form, kernel only, for the forms side by side
    for dtype, form in (("bfloat16", "BP"), ("int8", "BP_MS")):
        for key in ("bench1152", "wifi1944"):
            tb_, llr = tables[key], llrs(key, 2).llr
            times[f"k1{SUFFIX[dtype]} {key}"] = (
                cuda_ms(lambda: df.bp_decode_fused(tb_, llr, ITERS, False, form, dtype), 5),
                cuda_ms(lambda: df.bp_decode_fused_plain(tb_, llr, ITERS, False, form, dtype), 2))
    # the message forms of K3 and K5 likewise
    for dtype, form in (("bfloat16", "BP"), ("int8", "BP_MS")):
        times[f"K3{SUFFIX[dtype]} wifi1944"] = (
            cuda_ms(lambda: dl.bp_decode_layered_fast(tb3, llr3, ITERS, False, form, dtype), 5),
            cuda_ms(lambda: dl.bp_decode_layered_fast_plain(tb3, llr3, ITERS, False, form, dtype),
                    1, warm=False))
        times[f"K5{SUFFIX[dtype]} wifi648"] = (
            cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, form, dtype), 3),
            cuda_ms(lambda: dl.bp_decode_layered_plain(tb5, llr5, ITERS, False, form, dtype), 1,
                    warm=False))
    tb_, llr = tables["bench1152"], llrs("bench1152", 2).llr
    for dtype in SUFFIX:
        ms = cuda_ms(lambda: df.bp_decode_fused(tb_, llr, ITERS, False, "BP_MS", dtype), 5)
        ms3 = cuda_ms(lambda: dl.bp_decode_layered_fast(tb3, llr3, ITERS, False, "BP_MS", dtype),
                      5)
        ms5 = cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, "BP_MS", dtype), 3)
        print(f"time BP_MS {dtype} {ITERS} it no-ET B={BATCH}, kernel only: k1 bench1152 "
              f"{ms:.3f} ms, K3 wifi1944 {ms3:.3f} ms, K5 wifi648 {ms5:.3f} ms [{name_power}]")
    for tag, (k_ms, p_ms) in times.items():
        print(f"time {tag} {'BP_MS' if 'int8' in tag else 'BP'} {ITERS} it no-ET B={BATCH}: "
              f"kernel {k_ms:.3f} ms "
              f"({BATCH / k_ms * 1e3:.0f} frames/s), plain {p_ms:.3f} ms "
              f"({BATCH / p_ms * 1e3:.0f} frames/s) [{name_power}]")

    def time_chunk(kernel, plain, key, reps_plain, form="BP", dtype=None):
        tb = tables[key]
        ch = llrs(key, 2)
        box = {}
        form_args = {} if dtype is None else {"message_dtype": dtype}

        def reset():
            box["st"] = fresh_pool_state(tb, ch, dtype or "float32")
            box["rem"] = torch.full((1,), BATCH, dtype=torch.int32, device=dev)

        def run(fn):
            st = box["st"]
            fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
               st.fresh_llr, st.fresh_cw, refill_on, box["rem"], k=6, cap=ITERS,
               minsum_mode=form, **form_args)

        ms = cuda_ms(lambda: run(kernel), 5, reset)
        # frame-passes the kernel ran: every lane starts at age 1 and adds
        # one per pass
        box_passes[0] = int(box["st"].age.sum()) - int(box["st"].ctr[4].sum())
        return ms, plain and cuda_ms(lambda: run(plain), reps_plain, reset)

    box_passes = [0]

    times["k2 bench1152"] = time_chunk(df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain,
                                       "bench1152", 2)
    passes = {"k2 bench1152": int(box_passes[0])}
    times["K4 wifi1944"] = time_chunk(dl.bp_stream_chunk_layered_fast,
                                      dl.bp_stream_chunk_layered_fast_plain, "wifi1944", 1)
    passes["K4 wifi1944"] = int(box_passes[0])
    for dtype, form in (("bfloat16", "BP"), ("int8", "BP_MS")):
        tag = f"k2{SUFFIX[dtype]} bench1152"
        times[tag] = time_chunk(df.bp_stream_chunk_fused, df.bp_stream_chunk_fused_plain,
                                "bench1152", 2, form, dtype)
        passes[tag] = int(box_passes[0])
        tag = f"K4{SUFFIX[dtype]} wifi1944"
        times[tag] = time_chunk(dl.bp_stream_chunk_layered_fast,
                                dl.bp_stream_chunk_layered_fast_plain, "wifi1944", 1, form, dtype)
        passes[tag] = int(box_passes[0])
    # K4's other forms on the same inputs, kernel only (the rule's choice is timed above)
    for forced in ((16, False), (8, True), (8, False), (0, False)):
        dl.STREAM_FORM_OVERRIDE = forced
        ms_bp = time_chunk(dl.bp_stream_chunk_layered_fast, None, "wifi1944", 0, "BP")[0]
        ms_ms = time_chunk(dl.bp_stream_chunk_layered_fast, None, "wifi1944", 0, "BP_MS")[0]
        ms_i8 = time_chunk(dl.bp_stream_chunk_layered_fast, None, "wifi1944", 0, "BP_MS", "int8")[0]
        dl.STREAM_FORM_OVERRIDE = None
        print(f"time K4 form {form_of[forced]} wifi1944 6 passes from a full pool B={BATCH}, kernel "
              f"only: float32 BP {ms_bp:.3f} ms, float32 BP_MS {ms_ms:.3f} ms, int8 BP_MS "
              f"{ms_i8:.3f} ms [{name_power}]")
    # K2 and K5: the form the size rule picks and the HBM-plane form (K5's
    # plane form), forced, on the same inputs, in turns (HBM, rule, rule, HBM)
    for dtype, form in (("float32", "BP"), ("bfloat16", "BP"), ("float32", "BP_MS"),
                        ("bfloat16", "BP_MS"), ("int8", "BP_MS")):
        for key in ("bench1152", "wifi1944"):
            ms = {}
            for forced in ((0, False), None, None, (0, False)):
                df.STREAM_FORM_OVERRIDE = forced
                t = time_chunk(df.bp_stream_chunk_fused, None, key, 0, form, dtype)[0]
                ms[forced] = ms.get(forced, 0.0) + t / 2
            df.STREAM_FORM_OVERRIDE = None
            print(f"time K2 {key} {dtype} {form} 6 passes from a full pool B={BATCH}, kernel "
                  f"only: {form_name(df.stream_form(tables[key], dtype))} {ms[None]:.3f} ms, "
                  f"HBM planes {ms[(0, False)]:.3f} ms [{name_power}]")
            check(ms[None] < ms[(0, False)], f"K2 {key} {dtype} {form}: the rule's form is slower")
        ms = {}
        for forced in ((0, False), None, None, (0, False)):
            dl.EXACT_FORM_OVERRIDE = forced
            t = cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, form, dtype), 2)
            ms[forced] = ms.get(forced, 0.0) + t / 2
        dl.EXACT_FORM_OVERRIDE = None
        print(f"time K5 wifi648 {dtype} {form} {ITERS} it no-ET B={BATCH}, kernel only: "
              f"{form_name(dl.exact_form(tb5, dtype))} {ms[None]:.3f} ms, "
              f"{k5_name(tb5, dtype, (0, False))} {ms[(0, False)]:.3f} ms [{name_power}]")
        check(ms[None] < ms[(0, False)], f"K5 wifi648 {dtype} {form}: the rule's form is slower")
    # K1 and K3: every form that fits, the HBM-plane form first and last, on
    # the same inputs, in turns (HBM, forms, forms reversed, HBM), kernel only
    for dtype, form in (("float32", "BP"), ("bfloat16", "BP"), ("float32", "BP_MS"),
                        ("int8", "BP_MS")):
        for tag, key, kernel, module, rule, fits in (
                ("K1", "bench1152", df.bp_decode_fused, df, df.batch_form(tables["bench1152"], dtype),
                 lambda f: df.flood_tile_bytes(tables["bench1152"], f[0], dtype, f[1])),
                ("K1", "wifi1944", df.bp_decode_fused, df, df.batch_form(tables["wifi1944"], dtype),
                 lambda f: df.flood_tile_bytes(tables["wifi1944"], f[0], dtype, f[1])),
                ("K3", "wifi1944", dl.bp_decode_layered_fast, dl, dl.batch_form(tables["wifi1944"]),
                 lambda f: dl.fast_tile_bytes(tables["wifi1944"], *f))):
            tb_, llr = tables[key], llrs(key, 2).llr
            forms = [(0, False)] + [f for f in ((16, True), (16, False), (8, True), (8, False),
                                                (4, True), (4, False))
                                    if not (tag == "K3" and f[0] == 4)
                                    and fits(f) <= df.SMEM_BLOCK_BYTES]
            ms = {}
            for forced in forms + forms[::-1]:
                module.BATCH_FORM_OVERRIDE = forced
                t = cuda_ms(lambda: kernel(tb_, llr, ITERS, False, form, dtype), 2)
                ms[forced] = ms.get(forced, 0.0) + t / 2
            module.BATCH_FORM_OVERRIDE = None
            print(f"time {tag} forms {key} {dtype} {form} {ITERS} it no-ET B={BATCH}, kernel only "
                  f"(the rule's: {form_name(rule)}; fastest: {form_name(min(ms, key=ms.get))}): "
                  f"{'; '.join(f'{form_name(f)} {t:.3f} ms' for f, t in ms.items())} "
                  f"[{name_power}]")
            check(ms[rule] < ms[(0, False)], f"{tag} {key} {dtype} {form}: the rule's form is slower")
    # every tile form of K2 and K5 that fits, kernel only, on the same inputs
    # (what the size rules are chosen from)
    for dtype, form in (("float32", "BP"), ("float32", "BP_MS"), ("bfloat16", "BP"),
                        ("int8", "BP_MS")):
        row = []
        for forced in ((16, True), (16, False), (8, True), (8, False), (4, True), (4, False)):
            if df.flood_tile_bytes(tables["bench1152"], forced[0], dtype,
                                    forced[1]) > df.SMEM_BLOCK_BYTES:
                continue
            df.STREAM_FORM_OVERRIDE = forced
            t = time_chunk(df.bp_stream_chunk_fused, None, "bench1152", 0, form, dtype)[0]
            row.append(f"{form_name(forced)} {t:.3f} ms")
        df.STREAM_FORM_OVERRIDE = None
        print(f"time K2 tile forms bench1152 {dtype} {form} 6 passes from a full pool "
              f"B={BATCH}: {'; '.join(row)} [{name_power}]")
        row = []
        for forced in ((16, True), (16, False), (8, True), (8, False), (4, True), (4, False)):
            if dl.exact_tile_bytes(tb5, forced[0], dtype, forced[1]) > dl.SMEM_BLOCK_BYTES:
                continue
            dl.EXACT_FORM_OVERRIDE = forced
            t = cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, form, dtype), 2)
            row.append(f"{form_name(forced)} {t:.3f} ms")
        dl.EXACT_FORM_OVERRIDE = None
        print(f"time K5 tile forms wifi648 {dtype} {form} {ITERS} it no-ET B={BATCH}: "
              f"{'; '.join(row)} [{name_power}]")
    # K5 on wifi 1296 and wifi 1944 (Z = 54 and 81: the exact schedule where
    # wifi 648's 16-frame tile does not fit): every form that fits, first
    # held against the plain version on K5_CHECK_B frames, 12 iterations,
    # early termination on and off (min-sum and int8 bit-exact, BP's
    # decisions and counts on >= 99.9 % of frames), then timed, kernel only,
    # on the same inputs, in turns (the forms, then reversed, twice).  Where
    # the rule's form is not the fastest and the gap is within twice the
    # larger spread (max - min over the mean) of the two forms' samples, the
    # two take 16 more samples in turns.  The rule's form must be the
    # fastest or within 0.3 % of it
    k5_times = {}
    for key in ("wifi1296", "wifi1944"):
        tbk, llrk = tables[key], llrs(key, 2).llr
        small = llrk[:, :K5_CHECK_B].contiguous()
        for dtype, form in (("float32", "BP"), ("float32", "BP_MS"), ("bfloat16", "BP"),
                            ("int8", "BP_MS")):
            forms = k5_forms(tbk, dtype)
            for et in (True, False):
                want_ = dl.bp_decode_layered_plain(tbk, small, K5_CHECK_ITERS, et, form, dtype)
                for name, forced in forms:
                    got_ = in_form(dl.bp_decode_layered, dl, "EXACT_FORM_OVERRIDE", forced)(
                        tbk, small, K5_CHECK_ITERS, et, form, dtype)
                    torch.cuda.synchronize()
                    same_ = (got_.hard == want_.hard).all(0) & (got_.iterations == want_.iterations)
                    agree = same_.float().mean().item()
                    exact = (bool(same_.all()) and torch.equal(got_.llr_out, want_.llr_out)
                             and torch.equal(got_.is_codeword, want_.is_codeword))
                    print(f"K5 {key} {dtype} {form} et={int(et)} {name} against plain, "
                          f"B={K5_CHECK_B}, {K5_CHECK_ITERS} it: frames agreeing {agree:.6f}, "
                          f"bit-exact {exact}")
                    check(agree >= 0.999 if form == "BP" else exact,
                          f"K5 {key} {dtype} {form} et={int(et)} {name} disagrees with plain")
            samples = {name: [] for name, _ in forms}

            def sample(which):
                for name, forced in which:
                    fn = in_form(dl.bp_decode_layered, dl, "EXACT_FORM_OVERRIDE", forced)
                    samples[name].append(cuda_ms(lambda: fn(tbk, llrk, ITERS, False, form, dtype),
                                                 1, warm=False))

            for _, forced in forms:  # warm-up
                in_form(dl.bp_decode_layered, dl, "EXACT_FORM_OVERRIDE", forced)(
                    tbk, llrk, ITERS, False, form, dtype)
            sample((forms + forms[::-1]) * 2)
            rule = k5_name(tbk, dtype)
            ms = {n: sum(v) / len(v) for n, v in samples.items()}
            spread = {n: (max(v) - min(v)) / ms[n] for n, v in samples.items()}
            fastest = min(ms, key=ms.get)
            if fastest != rule and ms[rule] / ms[fastest] - 1 < 2 * max(spread[rule],
                                                                        spread[fastest]):
                pair = [f for f in forms if f[0] in (rule, fastest)]
                sample((pair + pair[::-1]) * 8)
                ms = {n: sum(v) / len(v) for n, v in samples.items()}
                spread = {n: (max(v) - min(v)) / ms[n] for n, v in samples.items()}
                fastest = min(ms, key=ms.get)
            k5_times[f"{key} {dtype} {form}"] = {"rule": rule, "ms": ms, "spread": spread,
                                                 "samples": {n: len(v) for n, v in samples.items()}}
            print(f"time K5 forms {key} {dtype} {form} {ITERS} it no-ET B={BATCH}, kernel only "
                  f"(the rule's: {rule}, {ms[rule] / ms[fastest] - 1:+.2%} on the fastest: "
                  f"{fastest}): {'; '.join(f'{n} {t:.3f} ms (spread {spread[n]:.2%}, '
                                           f'{len(samples[n])} samples)' for n, t in ms.items())} "
                  f"[{name_power}]")
            check(ms[rule] <= 1.003 * ms[fastest],
                  f"K5 {key} {dtype} {form}: the rule's form {rule} is not the fastest")
    for dtype in SUFFIX:  # min-sum in each form, kernel only, for the forms side by side
        ms = time_chunk(df.bp_stream_chunk_fused, None, "bench1152", 0, "BP_MS", dtype)[0]
        ms4 = time_chunk(dl.bp_stream_chunk_layered_fast, None, "wifi1944", 0, "BP_MS", dtype)[0]
        print(f"time BP_MS {dtype} 6 passes from a full pool B={BATCH}, kernel only: k2 "
              f"bench1152 {ms:.3f} ms, K4 wifi1944 {ms4:.3f} ms [{name_power}]")
    for tag in ("k2 bench1152", "K4 wifi1944", "k2_bf16 bench1152", "k2_int8 bench1152",
                "K4_bf16 wifi1944", "K4_int8 wifi1944"):
        print(f"time {tag} {'BP_MS' if 'int8' in tag else 'BP'} 6 passes from a full pool "
              f"B={BATCH}: kernel {times[tag][0]:.3f} ms, plain {times[tag][1]:.3f} ms "
              f"({passes[tag]} frame-passes) [{name_power}]")
    # K6 (no ET: every frame runs every iteration) and K7 (6 passes from a
    # full pool), BEC at eps 0.40
    for key in ("bench1152", "wifi1944"):
        tb_, ch = tables[key], bec_frames(key, 2)
        times[f"K6 {key}"] = (
            cuda_ms(lambda: db.bec_decode_fused(tb_, ch.llr, ch.codeword, ITERS, False), 5),
            cuda_ms(lambda: db.bec_decode_fused_plain(tb_, ch.llr, ch.codeword, ITERS, False), 2))
        db.FORCE_SCRATCH = True
        scratch_ms = cuda_ms(lambda: db.bec_decode_fused(tb_, ch.llr, ch.codeword, ITERS, False), 5)
        db.FORCE_SCRATCH = False
        db.bec_decode_fused(tb_, ch.llr, ch.codeword, 1)  # last_in_shared: the rule's form again
        print(f"time K6 {key} BEC {ITERS} it no-ET B={BATCH}: kernel {times[f'K6 {key}'][0]:.3f} "
              f"ms (words in device memory {scratch_ms:.3f} ms), plain "
              f"{times[f'K6 {key}'][1]:.3f} ms [{name_power}]")
    # K7, 6 passes from a full pool, in each form; the plain version on the
    # 1152 code (the kernels line's row) and once on wifi 1944
    box7 = {}

    def reset7(key):
        ch_ = box7.setdefault(("ch", key), bec_frames(key, 3))
        st_ = init_state(tables[key], BATCH, "BEC")
        st_.fresh_llr.copy_(ch_.llr)
        st_.fresh_cw.copy_(ch_.codeword)
        st_.avail.fill_(1)
        box7["st"] = st_
        box7["rem"] = torch.full((1,), BATCH, dtype=torch.int32, device=dev)

    def run7(fn, key, k=6):
        st_ = box7["st"]
        fn(tables[key], st_.llr_in, st_.codeword, st_.lv2c, st_.done, st_.iters, st_.age,
           st_.avail, st_.ctr, st_.fresh_llr, st_.fresh_cw, refill_on, box7["rem"], k=k,
           cap=ITERS)

    k7_forms = {}
    for key in ("bench1152", "wifi1944"):
        for form in ("words", "bytes"):
            db.FORCE_BYTES = form == "bytes"
            try:
                # k = 1 and 12 beside the timed 6: a chunk's fixed cost and its cost a pass
                by_k = {k: cuda_ms(lambda: run7(db.bec_stream_chunk_fused, key, k), 5,
                                   lambda: reset7(key)) for k in (1, 12, 6)}
                check(db.bec_stream_chunk_fused.last_form == form, f"K7 {key} timed {form}")
            finally:
                db.FORCE_BYTES = False
            k7_forms[key, form] = by_k[6]
            print(f"time K7 {form} {key} BEC from a full pool B={BATCH}: k=1 {by_k[1]:.3f} ms, "
                  f"k=6 {by_k[6]:.3f} ms, k=12 {by_k[12]:.3f} ms [{name_power}]")
        passes[f"K7 {key}"] = int(box7["st"].age.sum()) - int(box7["st"].ctr[4].sum())
        rule = db.bec_stream_form(tables[key])
        times[f"K7 {key}"] = (k7_forms[key, rule], cuda_ms(
            lambda: run7(db.bec_stream_chunk_fused_plain, key), 2 if key == "bench1152" else 1,
            lambda: reset7(key)))
        print(f"time K7 {key} BEC 6 passes from a full pool B={BATCH}: words in shared memory "
              f"{k7_forms[key, 'words']:.3f} ms, byte planes {k7_forms[key, 'bytes']:.3f} ms "
              f"(the rule's: {rule}), plain {times[f'K7 {key}'][1]:.3f} ms "
              f"({passes[f'K7 {key}']} frame-passes) [{name_power}]")

    def bec_stream_rate(eps, steps=8):
        """Frames/s of the BEC streaming step (50 iterations, chunks of 6
        passes, a channel batch each) on the host clock over ``steps``
        super-steps, after two warm ones."""
        sinit_, sstep_ = make_streaming_fused_step(tables["bench1152"], "BEC",
                                                   DecoderParams(iterations=ITERS), BATCH)
        st_ = sinit_()
        for step in range(2):
            st_, _ = sstep_(st_, make_generator(dev, 11, int(eps * 100), step), eps, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames_ = torch.zeros((), dtype=torch.int64, device=dev)
        for step in range(2, 2 + steps):
            st_, acc_ = sstep_(st_, make_generator(dev, 11, int(eps * 100), step), eps, True)
            frames_ += acc_.frames
        n = int(frames_)  # synchronises
        return n / (time.perf_counter() - t0), n

    for eps in (0.35, 0.40):
        res = Simulator(
            codes["bench1152"], DecoderParams(iterations=ITERS),
            ChannelParams(seed=1, x_range=(eps, eps + 0.001, 1.0), type="BEC"),
            # a fixed frame count: at these eps 50 frame errors come in one batch
            SimulationParams(batch_size=BATCH, fec=10**9, max_frames=20 * BATCH),
            device=dev, verbose=False, use_pallas=True,
        ).start()
        ch = bec_channel(tb7.code, make_generator(dev, 10, int(eps * 100), 0), BATCH, eps)
        k6_et = cuda_ms(lambda: db.bec_decode_fused(tb7, ch.llr, ch.codeword, ITERS, True), 5)
        print(f"sweep bench1152 BEC ET eps {eps}: {1.0 / res.time[0]:.0f} frames/s (avg_iter "
              f"{res.avg_iter[0]:.3f}, FER {res.fer[0]:.3e}, {int(res.frames[0])} frames); K6 "
              f"with ET on one batch {k6_et:.3f} ms of {res.time[0] * BATCH * 1e3:.3f} ms per "
              f"batch [{name_power}]")
        rates = []
        for form in ("words", "bytes"):
            db.FORCE_BYTES = form == "bytes"
            try:
                rates.append(bec_stream_rate(eps))
            finally:
                db.FORCE_BYTES = False
        print(f"stream bench1152 BEC ET eps {eps}: {rates[0][0]:.0f} frames/s with K7's words, "
              f"{rates[1][0]:.0f} with its byte planes ({rates[0][1]} and {rates[1][1]} frames "
              f"in 8 super-steps), batch-stepped {1.0 / res.time[0]:.0f} [{name_power}]")

    mark("kernel times done")
    # end-to-end sweep rate from the Simulator's own float timing (the
    # results file keeps frame_time to 6 decimals)
    for key, layered, snrs, dtype, form in (
            ("bench1152", False, (2.0, 2.5), "float32", "BP"),
            ("bench1152", False, (2.0, 2.5), "bfloat16", "BP"),
            ("bench1152", False, (2.0, 2.5), "int8", "BP_OMS"),
            ("wifi1944", False, (1.5, 2.0), "float32", "BP"),
            ("wifi1944", True, (1.5, 2.0), "float32", "BP"),
            ("wifi1944", True, (1.5, 2.0), "bfloat16", "BP"),
            ("wifi1944", True, (1.5, 2.0), "int8", "BP_OMS"),
            ("wifi648", True, (2.0,), "float32", "BP"),
            ("wifi648", True, (2.0,), "int8", "BP_MS")):
        for snr in snrs:
            res = Simulator(
                codes[key], DecoderParams(iterations=ITERS, layered=layered, type=form,
                                          message_dtype=dtype),
                ChannelParams(seed=1, x_range=(snr, snr + 0.01, 1.0)),
                SimulationParams(batch_size=BATCH, fec=50, max_frames=2_000_000),
                device=dev, verbose=False, use_pallas=True,
            ).start()
            schedule = ("flooding" if not layered else
                        "layered-exact" if key == "wifi648" else "layered-fast")
            print(f"sweep {key} {schedule} {form} {dtype} ET SNR "
                  f"{snr} dB: {1.0 / res.time[0]:.0f} frames/s (avg_iter {res.avg_iter[0]:.3f}, "
                  f"FER {res.fer[0]:.3e}, {int(res.frames[0])} frames) [{name_power}]")

    # the fixed-iteration rate (no ET: K1 and K3) of the 1152 flooding and the
    # wifi 1944 layered-fast points, from the Simulator's own float timing
    for key, layered, kernel in (("bench1152", False, df.bp_decode_fused),
                                 ("wifi1944", True, dl.bp_decode_layered_fast)):
        for dtype, form in (("float32", "BP"), ("bfloat16", "BP"), ("int8", "BP_OMS")):
            before = kernel.launches[dtype]
            res = Simulator(
                codes[key], DecoderParams(iterations=ITERS, early_term=False, layered=layered,
                                          type=form, message_dtype=dtype),
                ChannelParams(seed=1, x_range=(2.0, 2.01, 1.0)),
                SimulationParams(batch_size=BATCH, fec=10**9, max_frames=8 * BATCH),
                device=dev, verbose=False, use_pallas=True,
            ).start()
            check(kernel.launches[dtype] - before >= 8, f"fixed {key} {dtype}: not on its kernel")
            print(f"fixed {key} {'layered-fast' if layered else 'flooding'} {form} {dtype} "
                  f"{ITERS} it no-ET B={BATCH} 2.0 dB: {1.0 / res.time[0]:.0f} frames/s (FER "
                  f"{res.fer[0]:.3e}, {int(res.frames[0])} frames; form "
                  f"{form_name(kernel.last_form)}) [{name_power}]")

    mark("sweep rates done")
    # ---- 11. the checkpoint / error-log / LDPC slice: its own path, counted
    slice_launches = run_resume_log_api(dev, codes, name_power, zero_counts, read_counts)
    print(f"checkpoint / error-log / LDPC path launches: {slice_launches}")
    for name in ("bp_decode_fused", "bp_stream_chunk_fused", "bp_decode_layered_fast",
                 "bp_stream_chunk_layered_fast", "bp_decode_layered", "bec_decode_fused",
                 "bp_decode_fused_int8", "channel_batch"):
        check(slice_launches[name] > 0, f"the checkpoint / error-log / LDPC path did not run {name}")
    mark("checkpoint, error log and LDPC done")
    # ---- 12. the modulation slice and the widened routing: its own path, counted
    mod_launches, k5_1944 = run_modulation_slice(dev, codes, tables, name_power, zero_counts,
                                                 read_counts)
    mark("modulation slice done")
    # ---- 13. the point-parallel sweep on one card: its own paths, counted
    wide = run_wide_slice(dev, codes, tables, name_power, zero_counts, read_counts)
    print(f"phase 13 launches on the wide paths: {wide['launches']}")
    mark("wide sweeps done")
    # ---- 14. two processes on one card (their launches counted in each rank)
    run_two_ranks(dev, codes, name_power, wide["k2_rows"])
    mark("two ranks done")
    # ---- 15. gradient tuning (plain PyTorch autograd; no kernel of its own)
    run_tuning(dev, tables, name_power)
    mark("tuning done")
    # ---- 16. the default sweep (no --pallas): the XLA super-step on K2 and
    # K8's reload form, its own path, counted
    xla = run_xla_streaming(dev, codes, tables, name_power, zero_counts, read_counts,
                            write_files)
    mark("XLA super-step done")
    # ---- 17. the padded-layout library on K1, K5 and K6
    run_padded(dev, codes, name_power, zero_counts, read_counts)
    mark("padded decoders done")
    # ---- 18. the native host runtime, then the six examples on the card
    run_host_runtime(name_power)
    run_examples(name_power, zero_counts, read_counts)
    mark("host runtime and examples done")
    # each kernel's count from the run of the path it belongs to
    launches = {**layered_launches,
                "bp_decode_layered_wifi1944": default_layered_launches["bp_decode_layered"],
                "bp_decode_fused": flooding_launches["bp_decode_fused"],
                "bp_stream_chunk_fused": flooding_launches["bp_stream_chunk_fused"],
                "bec_decode_fused": bec_launches["bec_decode_fused"],
                "bec_stream_chunk_fused": bec_launches["bec_stream_chunk_fused"],
                "pool_refill": flooding_launches["pool_refill"],
                "channel_batch": flooding_launches["channel_batch"],
                "stream_grant": flooding_launches["stream_grant"],
                "stream_reload": xla["launches"],
                "stream_reload_staged": xla["staged_launches"],
                **{f"{fn.__name__}{SUFFIX[dt]}": form_launches[f"{fn.__name__}{SUFFIX[dt]}"]
                   for fn in by_form[:2] for dt in ("bfloat16", "int8")},
                **{f"{fn.__name__}{SUFFIX[dt]}":
                   layered_form_launches[f"{fn.__name__}{SUFFIX[dt]}"]
                   for fn in layered_fns for dt in ("bfloat16", "int8")}}
    print(f"launches on wifi 1944: kernel 1 (flooding, fixed point) {k1_1944_launches}, "
          f"K6 (BEC point) {k6_1944_launches}")

    # bounds of the timed calls: each input read once, each output written
    # once (the stream chunks' state planes are both), and the operations
    # of the frame-iterations these inputs needed
    def dims(key):
        c = tables[key].code
        return c.nc, c.nnz

    def batch_bytes(key, in_b, out_b):  # per-node bytes in and out, plus 8 B per frame
        nc, _ = dims(key)
        return BATCH * (nc * (in_b + out_b) + 8)

    def stream_bytes(key, val_b, msg_b=None):
        """Channel values of val_b bytes, messages of msg_b (default val_b),
        u8 codewords, 9 int planes; the state read and written, the pool read."""
        nc, nnz = dims(key)
        state = nc * val_b + nc + nnz * (msg_b or val_b) + 9 * 4
        return BATCH * (2 * state + nc * (val_b + 1))

    nc648, nnz648 = dims("wifi648")
    n_layers648 = tables["wifi648"].n_layers
    # K5 as the schedule needs it: per iteration each layer's checks (the
    # combine and the extrinsic, 1 operation, per slot), then the posterior
    # of that layer's own variables (1 operation per slot of each); a
    # no-ET decode needs one syndrome, at the end.  The count of 4 x n_layers
    # per slot (a full variable phase and syndrome after every layer) is
    # what the HBM-plane design does, printed beside it.
    tb648 = tables["wifi648"]
    vdeg = tb648.vn_ptr[1:] - tb648.vn_ptr[:-1]
    layer_var_slots = int(vdeg[tb648.layer_vars.long()].sum())

    def k5_needed(combine):
        return BATCH * ITERS * (nnz648 * (combine + 1) + layer_var_slots)

    for dt, combine in (("float32", 3 * 10), ("bfloat16", 3 * 10), ("int8", 3 * 3)):
        full = bound(batch_bytes("wifi648", 4, MSG_BYTES[dt]),
                     BATCH * ITERS * nnz648 * (combine + 4 * n_layers648))
        need = bound(batch_bytes("wifi648", 4, MSG_BYTES[dt]), k5_needed(combine))
        print(f"bound K5 wifi648 {dt}: {need[0]:.4f} ms by {need[1]} as the schedule needs it "
              f"(layer checks, then the layer's {layer_var_slots} variable slots an iteration), "
              f"{full[0]:.4f} ms by {full[1]} counting a full variable phase and syndrome after "
              f"each of {n_layers648} layers [{name_power}]")
    # K5 on wifi 1944 (phase 12's -layer sweep), counted as the schedule needs it
    tb1944 = tables["wifi1944"]
    vdeg1944 = tb1944.vn_ptr[1:] - tb1944.vn_ptr[:-1]
    slots1944 = int(vdeg1944[tb1944.layer_vars.long()].sum())
    b5 = bound(batch_bytes("wifi1944", 4, 4),
               BATCH * ITERS * (dims("wifi1944")[1] * (3 * 10 + 1) + slots1944))
    # K5's bound on wifi 1296 and wifi 1944 in each message form (phase 10's
    # times beside it: the rule's form and the fastest plane form)
    for key in ("wifi1296", "wifi1944"):
        tbk = tables[key]
        slots = int((tbk.vn_ptr[1:] - tbk.vn_ptr[:-1])[tbk.layer_vars.long()].sum())
        for dt, combine, form in (("float32", 3 * 10, "BP"), ("float32", 3 * 3, "BP_MS"),
                                  ("bfloat16", 3 * 10, "BP"), ("int8", 3 * 3, "BP_MS")):
            b_ = bound(batch_bytes(key, 4, MSG_BYTES[dt]),
                       BATCH * ITERS * (dims(key)[1] * (combine + 1) + slots))
            row = k5_times[f"{key} {dt} {form}"]
            t_rule = row["ms"][row["rule"]]
            t_plane = min(t for n, t in row["ms"].items() if n.startswith("plane"))
            print(f"bound K5 {key} {dt} {form}: {b_[0]:.4f} ms by {b_[1]}, the rule's form "
                  f"{t_rule:.3f} ms ({b_[0] / t_rule:.1%} of the bound), the fastest plane form "
                  f"{t_plane:.3f} ms ({b_[0] / t_plane:.1%}) [{name_power}]")
    print(f"time K5 wifi1944 BP {ITERS} it no-ET B={BATCH}: kernel {k5_1944['ms']:.3f} ms, plain "
          f"{k5_1944['plain_ms']:.3f} ms, max_abs_err {k5_1944['max_abs_err']:.3e}, form "
          f"{k5_name(tb1944)}; bound {b5[0]:.4f} ms by {b5[1]} "
          f"({b5[0] / k5_1944['ms']:.1%} of the bound); launches on the modulation path "
          f"{mod_launches['bp_decode_layered']} [{name_power}]")
    # K3's tile moves lc2v through device memory: read and written at every
    # iteration, its design floor beside the bound
    for dt in SUFFIX:
        floor_ms = 2 * dims("wifi1944")[1] * MSG_BYTES[dt] * BATCH * ITERS / HBM_BYTES_S * 1e3
        print(f"floor K3 tile wifi1944 {dt}: lc2v read and written every iteration, "
              f"{floor_ms:.3f} ms at the HBM rate [{name_power}]")
    bounds = {
        "bp_decode_fused": bound(batch_bytes("bench1152", 4, 4),
                                 BATCH * ITERS * dims("bench1152")[1] * OPS_BP_SLOT),
        "bp_stream_chunk_fused": bound(stream_bytes("bench1152", 4),
                                       passes["k2 bench1152"] * dims("bench1152")[1] * OPS_BP_SLOT),
        "bp_decode_layered_fast": bound(batch_bytes("wifi1944", 4, 4),
                                        BATCH * ITERS * dims("wifi1944")[1] * OPS_BP_FAST_SLOT),
        "bp_stream_chunk_layered_fast": bound(
            stream_bytes("wifi1944", 4), passes["K4 wifi1944"] * dims("wifi1944")[1]
            * OPS_BP_FAST_SLOT),
        "bp_decode_layered": bound(batch_bytes("wifi648", 4, 4), k5_needed(3 * 10)),
        "bp_decode_layered_wifi1944": b5,
        "bec_decode_fused": bound(batch_bytes("bench1152", 2, 2),
                                  BATCH * ITERS * dims("bench1152")[1] * OPS_BEC_SLOT),
        "bec_stream_chunk_fused": bound(stream_bytes("bench1152", 1),
                                        passes["K7 bench1152"] * dims("bench1152")[1]
                                        * OPS_BEC_SLOT),
        # the forms: float32 priors in, the posterior out in the message form
        "bp_decode_fused_bf16": bound(batch_bytes("bench1152", 4, 2),
                                      BATCH * ITERS * dims("bench1152")[1] * OPS_BP_SLOT),
        "bp_decode_fused_int8": bound(batch_bytes("bench1152", 4, 1),
                                      BATCH * ITERS * dims("bench1152")[1] * OPS_MS_SLOT),
        "bp_stream_chunk_fused_bf16": bound(stream_bytes("bench1152", 4, 2),
                                            passes["k2_bf16 bench1152"] * dims("bench1152")[1]
                                            * OPS_BP_SLOT),
        "bp_stream_chunk_fused_int8": bound(stream_bytes("bench1152", 4, 1),
                                            passes["k2_int8 bench1152"] * dims("bench1152")[1]
                                            * OPS_MS_SLOT),
        # the layered forms: K3 reads f32 priors and writes the f32 APP in
        # every form; K4's state holds the f32 APP and lc2v in the form;
        # K5 writes its posterior in the form
        "bp_decode_layered_fast_bf16": bound(batch_bytes("wifi1944", 4, 4), BATCH * ITERS
                                             * dims("wifi1944")[1] * OPS_BP_FAST_SLOT),
        "bp_decode_layered_fast_int8": bound(batch_bytes("wifi1944", 4, 4), BATCH * ITERS
                                             * dims("wifi1944")[1] * OPS_MS_FAST_SLOT),
        "bp_stream_chunk_layered_fast_bf16": bound(
            stream_bytes("wifi1944", 4, 2), passes["K4_bf16 wifi1944"] * dims("wifi1944")[1]
            * OPS_BP_FAST_SLOT),
        "bp_stream_chunk_layered_fast_int8": bound(
            stream_bytes("wifi1944", 4, 1), passes["K4_int8 wifi1944"] * dims("wifi1944")[1]
            * OPS_MS_FAST_SLOT),
        "bp_decode_layered_bf16": bound(batch_bytes("wifi648", 4, 2), k5_needed(3 * 10)),
        "bp_decode_layered_int8": bound(batch_bytes("wifi648", 4, 1), k5_needed(3 * 3)),
        "pool_refill": k8["times"]["bench1152", "BPSK"]["bound"],
        "channel_batch": k8["times"]["bench1152", "BPSK"]["full_bound"],
        "stream_grant": grants["grant_bound"],
        "stream_reload": xla["bound"],
        # the staged kernel's own bytes (its first messages are K2's)
        "stream_reload_staged": xla["staged_bound"],
    }
    # the wifi 1944 rows of kernel 1 (float32, BP), K6 and K7 (BEC); K7's
    # two forms on both codes
    k7_bound = {key: bound(stream_bytes(key, 1), passes[f"K7 {key}"] * dims(key)[1]
                           * OPS_BEC_SLOT) for key in ("bench1152", "wifi1944")}
    for name, b_, t in (
            ("k1 wifi1944", bound(batch_bytes("wifi1944", 4, 4),
                                  BATCH * ITERS * dims("wifi1944")[1] * OPS_BP_SLOT),
             times["k1 wifi1944"][0]),
            ("K6 wifi1944", bound(batch_bytes("wifi1944", 2, 2),
                                  BATCH * ITERS * dims("wifi1944")[1] * OPS_BEC_SLOT),
             times["K6 wifi1944"][0]),
            *[(f"K7 {form} {key}", k7_bound[key], k7_forms[key, form])
              for key in ("bench1152", "wifi1944") for form in ("words", "bytes")]):
        print(f"bound {name}: {b_[0]:.4f} ms by {b_[1]}, kernel {t:.3f} ms "
              f"({b_[0] / t:.1%} of the bound) [{name_power}]")
    # K1, K2, K3 and K5: the source of the form the size rule picks (the
    # tile's template, or the HBM-plane kernel)
    fused = {dt: "libldpc_tpu_torch/csrc/flood_stream.cuh"
             if df.batch_form(tables["bench1152"], dt)[0] else
             "libldpc_tpu_torch/csrc/decode_fused.cu" for dt in SUFFIX}
    stream_src = {dt: "libldpc_tpu_torch/csrc/flood_stream.cuh"
                  if df.stream_form(tables["bench1152"], dt)[0] else
                  "libldpc_tpu_torch/csrc/decode_stream.cu" for dt in SUFFIX}
    exact_src = {dt: "libldpc_tpu_torch/csrc/layered_exact_tile.cuh"
                 if dl.exact_form(tb648, dt)[0] else
                 "libldpc_tpu_torch/csrc/decode_layered_exact.cu" for dt in SUFFIX}
    exact_src_1944 = ("libldpc_tpu_torch/csrc/layered_exact_tile.cuh"
                      if dl.exact_form(tb1944)[0] else
                      "libldpc_tpu_torch/csrc/decode_layered_exact.cu")
    layered_src = ("libldpc_tpu_torch/csrc/layered_stream.cuh"
                   if dl.batch_form(tables["wifi1944"])[0] else
                   "libldpc_tpu_torch/csrc/decode_layered.cu")
    k4_src = "libldpc_tpu_torch/csrc/layered_stream.cuh"
    bec_src = "libldpc_tpu_torch/csrc/decode_bec.cu"
    k7_src = ("libldpc_tpu_torch/csrc/bec_stream_words.cuh"
              if db.bec_stream_form(tb7) == "words" else bec_src)
    # the form of each kernel that ran: K4 by its size rule, K6 with its
    # words in shared memory or in the device-memory scratch
    forms_run = {"bp_stream_chunk_layered_fast": k4_form,
                 "bp_decode_layered_fast": form_name(dl.batch_form(tables["wifi1944"])),
                 "bec_decode_fused": "words in shared memory" if db.bec_decode_fused.last_in_shared
                 else "words in device memory",
                 "bec_stream_chunk_fused": "words in shared memory"
                 if db.bec_stream_form(tb7) == "words" else "HBM planes, 32 frames x 8 warps"}
    k8_form = (f"{k8['tables'].lane_tile} lanes x {k8['tables'].items_per_slab} items a block "
               f"of 8 warps, the encode on the tensor cores (mma.sync m16n8k256 b1 .and.popc, "
               f"systematic columns from the info words)")
    forms_run["pool_refill"] = ("a one-block lane-order scan lists the used lanes; the draw over "
                                "them, " + k8_form)
    forms_run["channel_batch"] = "the draw over every lane, " + k8_form
    forms_run["stream_grant"] = ("one block of 1024 threads, 16 lanes a thread in 16-byte loads "
                                 "and stores, a warp-then-block shuffle scan")
    reload_form = (f"{pr.RELOAD_LANE_TILE} lanes x {pr.RELOAD_SLAB_COLS} items a block of 8 warps, "
                   f"the encode on the tensor cores")
    forms_run["stream_reload"] = ("a one-block lane-order scan lists the idle lanes and grants "
                                  "them on the device (do_gen, the quota); the draw over the "
                                  "granted lanes straight into the stream state (LLRs, codewords, "
                                  "each edge's first message), " + reload_form)
    forms_run["stream_reload_staged"] = ("the same plan; the draw over the granted lanes into a "
                                         "staging buffer, column = the lane's rank (a warp's "
                                         "stores fill whole sectors), no first message: K2's "
                                         "next one-pass launch starts the lane from it, "
                                         + reload_form)
    # K1, K2 and K5 by their size rules, per message form, at the timed shapes
    for dt in SUFFIX:
        forms_run["bp_decode_fused" + SUFFIX[dt]] = form_name(df.batch_form(tables["bench1152"], dt))
        forms_run["bp_stream_chunk_fused" + SUFFIX[dt]] = form_name(
            df.stream_form(tables["bench1152"], dt))
        forms_run["bp_decode_layered" + SUFFIX[dt]] = k5_name(tb648, dt)
    forms_run["bp_decode_layered_wifi1944"] = k5_name(tb1944)
    rows_json = [
        ("bp_decode_fused", fused["float32"], "libldpc_tpu/ops/pallas/decode_fused.py:617", err1,
         times["k1 bench1152"]),
        ("bp_stream_chunk_fused", stream_src["float32"],
         "libldpc_tpu/ops/pallas/decode_fused.py:404", err2, times["k2 bench1152"]),
        ("bp_decode_layered_fast", layered_src, "libldpc_tpu/ops/pallas/decode_lanes.py:1153",
         err3, times["K3 wifi1944"]),
        ("bp_stream_chunk_layered_fast", k4_src,
         "libldpc_tpu/ops/pallas/decode_lanes.py:753", err4, times["K4 wifi1944"]),
        ("bp_decode_layered", exact_src["float32"], "libldpc_tpu/ops/pallas/decode_fused.py:544",
         err5, times["K5 wifi648"]),
        # K5 on wifi 1944, where no 16- or 8-frame tile fits in float32: the
        # default --layer-file command line's decoder (phase 9c)
        ("bp_decode_layered_wifi1944", exact_src_1944,
         "libldpc_tpu/ops/pallas/decode_fused.py:544", k5_1944["max_abs_err"],
         (k5_1944["ms"], k5_1944["plain_ms"])),
        ("bec_decode_fused", bec_src, "libldpc_tpu/ops/pallas/decode_lanes.py:1235", err6,
         times["K6 bench1152"]),
        ("bec_stream_chunk_fused", k7_src, "libldpc_tpu/ops/pallas/decode_lanes.py:590", err7,
         times["K7 bench1152"]),
        ("bp_decode_fused_bf16", fused["bfloat16"], "libldpc_tpu/ops/pallas/decode_fused.py:617",
         err_form["k1 bfloat16"], times["k1_bf16 bench1152"]),
        ("bp_decode_fused_int8", fused["int8"], "libldpc_tpu/ops/pallas/decode_fused.py:617",
         err_form["k1 int8"], times["k1_int8 bench1152"]),
        ("bp_stream_chunk_fused_bf16", stream_src["bfloat16"],
         "libldpc_tpu/ops/pallas/decode_fused.py:404",
         err_form["k2 bfloat16"], times["k2_bf16 bench1152"]),
        ("bp_stream_chunk_fused_int8", stream_src["int8"],
         "libldpc_tpu/ops/pallas/decode_fused.py:404",
         err_form["k2 int8"], times["k2_int8 bench1152"]),
        *[(f"bp_decode_layered_fast{SUFFIX[dt]}", layered_src,
           "libldpc_tpu/ops/pallas/decode_lanes.py:1153", err_form[f"k3 {dt}"],
           times[f"K3{SUFFIX[dt]} wifi1944"]) for dt in ("bfloat16", "int8")],
        *[(f"bp_stream_chunk_layered_fast{SUFFIX[dt]}", k4_src,
           "libldpc_tpu/ops/pallas/decode_lanes.py:753", err_form[f"k4 {dt}"],
           times[f"K4{SUFFIX[dt]} wifi1944"]) for dt in ("bfloat16", "int8")],
        *[(f"bp_decode_layered{SUFFIX[dt]}", exact_src[dt],
           "libldpc_tpu/ops/pallas/decode_fused.py:544", err_form[f"k5 {dt}"],
           times[f"K5{SUFFIX[dt]} wifi648"]) for dt in ("bfloat16", "int8")],
        # K8: the pool's refill, XLA in the JAX super-step (simulate_channel
        # and the merge under lax.cond), a kernel here
        ("pool_refill", "libldpc_tpu_torch/csrc/pool_refill.cu",
         "libldpc_tpu/ops/streaming_pallas.py:134", k8["max_abs_err"]["pool_refill"],
         (k8["times"]["bench1152", "BPSK"]["ms"], k8["times"]["bench1152", "BPSK"]["plain_ms"])),
        # K8's full batch: the batch step's channel, XLA in the JAX package
        ("channel_batch", "libldpc_tpu_torch/csrc/pool_refill.cu",
         "libldpc_tpu/parallel/mesh.py:89", k8["max_abs_err"]["channel_batch"],
         (k8["times"]["bench1152", "BPSK"]["full_ms"],
          k8["times"]["bench1152", "BPSK"]["full_plain_ms"])),
        # the start grants in lane order of a chunk where the quota binds
        # (the JAX kernels' in-kernel scan)
        ("stream_grant", "libldpc_tpu_torch/csrc/pool_refill.cu",
         "libldpc_tpu/ops/pallas/decode_fused.py:464", 0.0,
         (grants["grant_ms"], grants["grant_plain_ms"])),
        # K8's reload form: the XLA super-step's per-pass reload (the draw
        # and the lane-order merge under lax.cond), a kernel here
        ("stream_reload", "libldpc_tpu_torch/csrc/pool_refill.cu",
         "libldpc_tpu/ops/streaming.py:176", xla["max_abs_err"], (xla["ms"], xla["plain_ms"])),
        # its staged form, every pass of a super-step but the last
        ("stream_reload_staged", "libldpc_tpu_torch/csrc/pool_refill.cu",
         "libldpc_tpu/ops/streaming.py:176", xla["staged_err"],
         (xla["staged_ms"], xla["staged_plain_ms"])),
    ]
    for name, _, _, _, t in rows_json:
        print(f"bound {name}: {bounds[name][0]:.4f} ms by {bounds[name][1]}, kernel {t[0]:.3f} ms "
              f"({bounds[name][0] / t[0]:.1%} of the bound) [{name_power}]")
    # every form of K5 timed in phase 10, per message form
    k5_forms_of = {name: {k: v for k, v in k5_times.items() if f" {dt} " in k}
                   for name, dt in (("bp_decode_layered", "float32"),
                                    ("bp_decode_layered_wifi1944", "float32"),
                                    ("bp_decode_layered_bf16", "bfloat16"),
                                    ("bp_decode_layered_int8", "int8"))}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call decodes an LDPC code, draws an encoded
         # frame or grants starts in lane order against a quota
         "library_ms": None,
         "form": forms_run.get(name, forms_run.get(name.replace("_bf16", "").replace("_int8", ""),
                                                   "HBM planes, 32 frames x 8 warps")),
         **({"forms": k5_forms_of[name]} if name in k5_forms_of else {})}
        for name, src, rep, err, t in rows_json
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
