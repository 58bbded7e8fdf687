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
streaming and the BEC kernels), times kernels
against plain versions, and prints a ``{"kernels": [...]}`` line (each kernel with
its launches on its path, its error against the plain version, its time,
the plain version's, its bound: the larger of the bytes it must move
over the HBM rate and its operations over the float32 rate, and the form
of the kernel that ran; the kernels with a tile form, K1 to K5, are held
against their plain versions and timed in each form side by side, K5 on
wifi 648 and wifi 1296), the fixed-iteration ``Simulator`` frames/s of the
1152 flooding and the wifi 1944 layered-fast points in each message form,
the checkpoint / error-log / ``LDPC`` slice (phase 11: sweeps stopped and
resumed against the uninterrupted ones on K2 and K4, a streaming point
resumed mid-point, the forensic error log on K1, K3 and K6, ``LDPC.decode``
on K1, K3 and K5 against the plain versions, the threaded simulation, the
CLI with ``--checkpoint --resume --error-log --log-codewords``), the
modulation slice (phase 12: the ``sim_cuda`` command line with 4-ASK on the
1152 code on K2 and, with ``-layer``, 8-ASK on wifi 1944 on K5,
``LDPC.simulate`` with 16-ASK on wifi 1944 on K4, each in its waterfall;
M = 2 against BPSK on the same draws; a modulated error log whose ``dE`` is
recomputed on the host; the bfloat16 sweep of a (3,6) code of 49152 edges
that the port once refused, and K2's bfloat16 form there against its plain
chunk on the same frames; K5 on wifi 1944 against its plain version,
timed), and, last, an ``{"ok": true, ...}`` line.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero before printing any
result.
"""

from __future__ import annotations

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
#: The card's published peaks (H100 SXM, NVIDIA's data sheet): HBM bytes/s,
#: and float32 operations/s outside the tensor cores, against which the
#: byte and integer operations of the decoders are counted too.
HBM_BYTES_S = 3.35e12
OPS_S = 67e12
#: Operations per CN-space slot and iteration, counted from the kernels:
#: the check combine makes ~3 pairwise operations per slot (forward,
#: backward, exclusion), a BP box-plus ~10 (min, sign, two exp, two log1p,
#: adds), the VN sum and extrinsic 2, the syndrome 2.  The fast layered
#: engine adds the APP update (3); the exact layered schedule recomputes
#: every posterior and syndrome per layer.  The BEC peeling: 4 operations
#: per slot in the check phase, 4 in the variable phase, each of which can
#: be one 32-bit word operation for 32 frames (the batch kernel's
#: bit-sliced algebra), so a slot of one frame counts 8 / 32.
OPS_BP_SLOT = 3 * 10 + 2 + 2
OPS_MS_SLOT = 3 * 3 + 2 + 2  # a min-sum pair: min, sign, multiply
OPS_BP_FAST_SLOT = 3 * 10 + 3 + 2
OPS_MS_FAST_SLOT = 3 * 3 + 3 + 2
OPS_BEC_SLOT = 8 / 32


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events), after
    one warm-up run; ``setup()`` runs before each, outside the timing."""
    if setup:
        setup()
    fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    # -- the threaded simulation, polled and stopped
    ldpc = LDPC(code=codes["bench1152"], device=dev)
    ldpc.simulate(snr=[1.0, 3.01, 0.5], fec=10**9, batchSize=BATCH, iterations=ITERS,
                  maxFrames=10**12)
    t0 = time.perf_counter()
    while not len(ldpc.get_results().get("frames", ())) and time.perf_counter() - t0 < 120:
        time.sleep(0.05)
    ldpc.stop_simulation()
    got = ldpc.get_results()
    check(ldpc._sim_thread is None and len(got["frames"]) == 1 and got["frames"][0] > 0
          and np.isfinite(got["fer"]).all(), "threaded simulate")
    print(f"LDPC.simulate threaded: stopped after {int(got['frames'][0])} frames at 1.0 dB, "
          f"FER {got['fer'][0]:.4e}, avg_iter {got['avg_iter'][0]:.3f}")

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
    for name, what in (("bp_stream_chunk_fused", "K2 (4-ASK sim_cuda)"),
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

    # -- K5 on wifi 1944 against its plain version, then timed (phase 10's manner)
    tb = tables["wifi1944"]
    ch = awgn_channel(tb.code, make_generator(dev, 7, 8, 0), BATCH, COMPARE_SNR_DB)
    err = plain_ms = 0.0
    for form, et in (("BP_MS", True), ("BP", False)):
        got = dl.bp_decode_layered(tb, ch.llr, ITERS, et, form)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want_ = dl.bp_decode_layered_plain(tb, ch.llr, ITERS, et, form)
        end.record()
        torch.cuda.synchronize()
        same_ = (got.hard == want_.hard).all(0) & (got.iterations == want_.iterations)
        if form == "BP":
            plain_ms = start.elapsed_time(end)
            check(same_.float().mean().item() >= 0.999, "K5 wifi1944 BP: decisions disagree")
            torch.testing.assert_close(got.llr_out[:, same_], want_.llr_out[:, same_], rtol=1e-4,
                                       atol=1e-4)
            err = (got.llr_out - want_.llr_out)[:, same_].abs().max().item()
        else:
            check(bool(same_.all()) and torch.equal(got.llr_out, want_.llr_out),
                  "K5 wifi1944 BP_MS not bit-exact")
        print(f"K5 wifi1944 {form} et={int(et)}: frames agreeing {same_.float().mean().item():.6f}"
              f" (form {dl.exact_form(tb)})")
    ms = cuda_ms(lambda: dl.bp_decode_layered(tb, ch.llr, ITERS, False, "BP"), 3)
    return counts, {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                    "form": dl.exact_form(tb)}


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
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import init_state, make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
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
    # rule's form and in the HBM-plane form (the rule's for a code whose
    # tile does not fit) on the same frames
    k5_hbm = ("HBM planes", in_form(dl.bp_decode_layered, dl, "EXACT_FORM_OVERRIDE", (0, False)))
    err5 = compare_batch("K5 wifi648", dl.bp_decode_layered, dl.bp_decode_layered_plain,
                         tables["wifi648"], llrs("wifi648", 5).llr, also=(k5_hbm,))
    print(f"K5 form chosen for wifi 648: {dl.exact_form(tables['wifi648'])}")

    # ---- 7a. K5's forms (lv2c, lc2v and the posterior in the form); bf16 BP's
    # posterior within eight bf16 steps: it is recomputed from every stored
    # message after each of the 12 layers
    for dtype in ("bfloat16", "int8"):
        err_form[f"k5 {dtype}"] = compare_batch(
            "K5 wifi648", dl.bp_decode_layered, dl.bp_decode_layered_plain, tables["wifi648"],
            llrs("wifi648", 5).llr, dtype, tol=2 ** -4, also=(k5_hbm,))

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

    def run_cli(key, out, snrs, *flags, layered=False):
        files = write_files(key)
        h, g = files[0], files[1:]
        args = [h, str(WORK / out), *snrs, *g, "-i", str(ITERS), "--batch-size", str(BATCH),
                "--pallas", *flags]
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

    counted = (db.bec_decode_fused, db.bec_stream_chunk_fused)
    layered_fns = (dl.bp_decode_layered_fast, dl.bp_stream_chunk_layered_fast,
                   dl.bp_decode_layered)
    by_form = (df.bp_decode_fused, df.bp_stream_chunk_fused, *layered_fns)  # a count per form

    def zero_counts():
        for fn in counted:
            fn.launches = 0
        for fn in by_form:
            fn.launches = dict.fromkeys(SUFFIX, 0)

    def read_counts():
        out = {fn.__name__: fn.launches for fn in counted}
        out.update({fn.__name__ + SUFFIX[dt]: n for fn in by_form for dt, n in fn.launches.items()})
        return out

    zero_counts()
    head, rows = run_cli("bench1152", "res.txt", SWEEP, "--frame-error-count", "50",
                         "--max-frames", "2000000")
    head_fixed, fixed = run_cli("bench1152", "res_fixed.txt", ["2.0", "2.01", "1"],
                                "--frame-error-count", "50", "--max-frames", str(8 * BATCH),
                                "--no-early-term")
    flooding_launches = read_counts()
    print(f"flooding path launches: {flooding_launches}")
    check(flooding_launches["bp_stream_chunk_fused"] > 0, "the sweep did not run kernel 2")
    check(flooding_launches["bp_decode_fused"] > 0, "the fixed point did not run kernel 1")
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
        cuda_ms(lambda: dl.bp_decode_layered_fast_plain(tb3, llr3, ITERS, False, "BP"), 1))
    tb5, llr5 = tables["wifi648"], llrs("wifi648", 2).llr
    times["K5 wifi648"] = (
        cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, "BP"), 3),
        cuda_ms(lambda: dl.bp_decode_layered_plain(tb5, llr5, ITERS, False, "BP"), 1))
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
                    1))
        times[f"K5{SUFFIX[dtype]} wifi648"] = (
            cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, form, dtype), 3),
            cuda_ms(lambda: dl.bp_decode_layered_plain(tb5, llr5, ITERS, False, form, dtype), 1))
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
    # K2 and K5: the form the size rule picks and the HBM-plane form
    # (forced), on the same inputs, in turns (HBM, rule, rule, HBM)
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
              f"{form_name(dl.exact_form(tb5, dtype))} {ms[None]:.3f} ms, HBM planes "
              f"{ms[(0, False)]:.3f} ms [{name_power}]")
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
        for forced in ((16, True), (16, False), (8, True), (8, False)):
            if dl.exact_tile_bytes(tb5, forced[0], dtype, forced[1]) > dl.SMEM_BLOCK_BYTES:
                continue
            dl.EXACT_FORM_OVERRIDE = forced
            t = cuda_ms(lambda: dl.bp_decode_layered(tb5, llr5, ITERS, False, form, dtype), 2)
            row.append(f"{form_name(forced)} {t:.3f} ms")
        dl.EXACT_FORM_OVERRIDE = None
        print(f"time K5 tile forms wifi648 {dtype} {form} {ITERS} it no-ET B={BATCH}: "
              f"{'; '.join(row)} [{name_power}]")
    # K5 on wifi 1296 (Z = 54: the exact schedule, where its rule picks
    # other tile forms than on wifi 648): every form that fits and the
    # HBM-plane form, kernel only, on the same inputs
    tb1296, llr1296 = tables["wifi1296"], llrs("wifi1296", 2).llr
    for dtype, form in (("float32", "BP"), ("float32", "BP_MS"), ("bfloat16", "BP"),
                        ("int8", "BP_MS")):
        row, ms = [], {}
        for forced in ((16, True), (16, False), (8, True), (8, False), (0, False)):
            if forced[0] and dl.exact_tile_bytes(tb1296, forced[0], dtype,
                                                 forced[1]) > dl.SMEM_BLOCK_BYTES:
                continue
            dl.EXACT_FORM_OVERRIDE = forced
            ms[forced] = cuda_ms(
                lambda: dl.bp_decode_layered(tb1296, llr1296, ITERS, False, form, dtype), 2)
            row.append(f"{form_name(forced)} {ms[forced]:.3f} ms")
        dl.EXACT_FORM_OVERRIDE = None
        rule = dl.exact_form(tb1296, dtype)
        print(f"time K5 forms wifi1296 {dtype} {form} {ITERS} it no-ET B={BATCH}, kernel only "
              f"(the rule's: {form_name(rule)}; fastest: {form_name(min(ms, key=ms.get))}): "
              f"{'; '.join(row)} [{name_power}]")
        check(ms[rule] < ms[(0, False)], f"K5 wifi1296 {dtype} {form}: the rule's form is slower")
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
                 "bp_decode_fused_int8"):
        check(slice_launches[name] > 0, f"the checkpoint / error-log / LDPC path did not run {name}")
    mark("checkpoint, error log and LDPC done")
    # ---- 12. the modulation slice and the widened routing: its own path, counted
    mod_launches, k5_1944 = run_modulation_slice(dev, codes, tables, name_power, zero_counts,
                                                 read_counts)
    mark("modulation slice done")
    # each kernel's count from the run of the path it belongs to
    launches = {**layered_launches,
                "bp_decode_fused": flooding_launches["bp_decode_fused"],
                "bp_stream_chunk_fused": flooding_launches["bp_stream_chunk_fused"],
                "bec_decode_fused": bec_launches["bec_decode_fused"],
                "bec_stream_chunk_fused": bec_launches["bec_stream_chunk_fused"],
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
    print(f"time K5 wifi1944 BP {ITERS} it no-ET B={BATCH}: kernel {k5_1944['ms']:.3f} ms, plain "
          f"{k5_1944['plain_ms']:.3f} ms, max_abs_err {k5_1944['max_abs_err']:.3e}, form "
          f"{form_name(k5_1944['form'])}; bound {b5[0]:.4f} ms by {b5[1]} "
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
    # K1, K2 and K5 by their size rules, per message form, at the timed shapes
    for dt in SUFFIX:
        forms_run["bp_decode_fused" + SUFFIX[dt]] = form_name(df.batch_form(tables["bench1152"], dt))
        forms_run["bp_stream_chunk_fused" + SUFFIX[dt]] = form_name(
            df.stream_form(tables["bench1152"], dt))
        forms_run["bp_decode_layered" + SUFFIX[dt]] = form_name(dl.exact_form(tb648, dt))
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
    ]
    for name, _, _, _, t in rows_json:
        print(f"bound {name}: {bounds[name][0]:.4f} ms by {bounds[name][1]}, kernel {t[0]:.3f} ms "
              f"({bounds[name][0] / t[0]:.1%} of the bound) [{name_power}]")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         # no single PyTorch call decodes an LDPC code
         "library_ms": None,
         "form": forms_run.get(name, forms_run.get(name.replace("_bf16", "").replace("_int8", ""),
                                                   "HBM planes, 32 frames x 8 warps"))}
        for name, src, rep, err, t in rows_json
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
