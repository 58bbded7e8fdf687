"""On-card smoke run of the PyTorch / CUDA port (``libldpc_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the two CUDA decode kernels from ``libldpc_tpu_torch/csrc``,
holds each against its plain PyTorch version at the main path's shapes,
drives the ``ldpcsim-torch`` sweep (streaming early termination, and one
fixed-iteration point) on the card, times kernels against plain versions,
and prints a ``{"kernels": [...]}`` line and, last, an ``{"ok": true, ...}``
line.  Any failure raises and exits non-zero; without a CUDA device it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
BATCH = 16384
ITERS = 50
COMPARE_SNR_DB = 1.5  # inside the waterfall of both codes (sigma^2 = 10^(-snr/10))
SWEEP = ["1.0", "3.01", "0.5"]  # 1.0 .. 3.0 dB: the 1152 code's waterfall


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from libldpc_tpu_torch import cli
    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code, write_codefile
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import init_state
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

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

    # ---- 2. build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    if build.last_build_log:
        print(build.last_build_log)

    codes = {
        "bench1152": make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
        "wifi1944": wifi_code(1944),
    }
    tables = {k: kernel_tables(to_sorted_device(c, dev)) for k, c in codes.items()}
    for k, t in tables.items():
        print(f"code {k}: nc {t.code.nc} mc {t.code.mc} nnz {t.code.nnz} max_dc {t.max_dc}")

    # ---- 3. kernel 1 against its plain version
    err1 = 0.0
    for key, tb in tables.items():
        ch = awgn_channel(tb.code, make_generator(dev, 7, 0, 0), BATCH, COMPARE_SNR_DB)
        for form in ("BP_MS", ("BP_NMS", 0.75, 0.15), "BP"):
            for et in (True, False):
                got = df.bp_decode_fused(tb, ch.llr, ITERS, et, form)
                want = df.bp_decode_fused_plain(tb, ch.llr, ITERS, et, form)
                torch.cuda.synchronize()
                same = (got.hard == want.hard).all(0) & (got.iterations == want.iterations)
                diff = (got.llr_out - want.llr_out)[:, same].abs()
                err = diff.max().item() if diff.numel() else 0.0
                err1 = max(err1, err)
                label = form if isinstance(form, str) else form[0]
                print(f"kernel1 {key} {label} et={int(et)}: frames agreeing "
                      f"{same.float().mean().item():.6f} max_abs_err {err:.3e} "
                      f"avg_iter {got.iterations.float().mean().item():.3f} "
                      f"codewords {got.is_codeword.float().mean().item():.4f}")
                check(torch.isfinite(got.llr_out).all(), "kernel 1 output not finite")
                if label == "BP":
                    check(same.float().mean().item() >= 0.999, "BP decisions disagree")
                    torch.testing.assert_close(got.llr_out[:, same], want.llr_out[:, same],
                                               rtol=1e-4, atol=1e-4)
                else:
                    check(bool(same.all()) and torch.equal(got.llr_out, want.llr_out)
                          and torch.equal(got.is_codeword, want.is_codeword),
                          f"{label} kernel 1 not bit-exact")

    # ---- 4. kernel 2 against its plain version
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

    tb = tables["bench1152"]
    ch = awgn_channel(tb.code, make_generator(dev, 7, 1, 0), BATCH, COMPARE_SNR_DB)
    err2 = 0
    for form in ("BP_MS", "BP"):
        got = drain(df.bp_stream_chunk_fused, tb, ch.llr, ch.codeword, form)
        want = drain(df.bp_stream_chunk_fused_plain, tb, ch.llr, ch.codeword, form)
        print(f"kernel2 drain {form}: kernel {got} plain {want}")
        check(got[2] == BATCH, "not every injected frame was counted")
        if form == "BP_MS":
            check(got == want, "BP_MS drained totals differ")
        err2 = max(err2, max(abs(a - b) for a, b in zip(got, want)))

    def fresh_pool_state():
        st = init_state(tb, BATCH)
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        return st

    quota = 5000
    st = fresh_pool_state()
    remaining = torch.full((1,), quota, dtype=torch.int32, device=dev)
    refill_on = torch.ones(1, dtype=torch.int32, device=dev)
    df.bp_stream_chunk_fused(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age,
                             st.avail, st.ctr, st.fresh_llr, st.fresh_cw, refill_on, remaining,
                             k=6, cap=ITERS, minsum_mode="BP")
    starts = int(st.ctr[4].sum())
    print(f"kernel2 quota {quota}: starts {starts}, pool entries used "
          f"{BATCH - int(st.avail.sum())}")
    check(starts == quota == BATCH - int(st.avail.sum()), "quota not exact")

    # ---- 5. the slice: the CLI sweep on the card
    WORK.mkdir(parents=True, exist_ok=True)
    code = codes["bench1152"]
    write_codefile(str(WORK / "h.txt"), code.rows, code.cols, code.nc, code.mc)
    r, c = code.G.nonzero()
    (WORK / "g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
    args = [str(WORK / "h.txt"), str(WORK / "res.txt"), *SWEEP, "-G", str(WORK / "g.txt"),
            "-i", str(ITERS), "--frame-error-count", "50", "--max-frames", "2000000",
            "--batch-size", str(BATCH), "--pallas"]
    df.bp_decode_fused.launches = 0
    df.bp_stream_chunk_fused.launches = 0
    t0 = time.perf_counter()
    check(cli.main(args) == 0, "ET sweep failed")
    sweep_s = time.perf_counter() - t0
    fixed_args = [str(WORK / "h.txt"), str(WORK / "res_fixed.txt"), "2.0", "2.01", "1",
                  "-G", str(WORK / "g.txt"), "-i", str(ITERS), "--frame-error-count", "50",
                  "--max-frames", str(8 * BATCH), "--batch-size", str(BATCH), "--pallas",
                  "--no-early-term"]
    check(cli.main(fixed_args) == 0, "fixed-iteration point failed")
    launches = {"bp_decode_fused": df.bp_decode_fused.launches,
                "bp_stream_chunk_fused": df.bp_stream_chunk_fused.launches}
    print(f"main-path launches: {launches} (ET sweep {sweep_s:.1f} s)")
    check(launches["bp_stream_chunk_fused"] > 0, "the sweep did not run kernel 2")
    check(launches["bp_decode_fused"] > 0, "the fixed-iteration point did not run kernel 1")
    for f in ("res.txt", "res_fixed.txt"):
        print(f"--- {f}\n{(WORK / f).read_text()}", end="")
    lines = (WORK / "res.txt").read_text().splitlines()
    check(lines[0].startswith("# kernel=cuda-fused"), "provenance line")
    rows = [[float(v) for v in ln.split()] for ln in lines[2:]]
    check(len(rows) == 5 and all(math.isfinite(v) for r in rows for v in r), "sweep rows")
    check(rows[0][1] > rows[-1][1], "FER does not fall across the sweep")
    check(all(0 < r[4] <= ITERS for r in rows), "avg_iter out of range")
    fixed = [float(v) for v in (WORK / "res_fixed.txt").read_text().splitlines()[2].split()]
    check(fixed[4] == ITERS, "fixed-iteration point did not run every iteration")

    # ---- 6. times (CUDA events), kernel against plain
    times = {}
    for key, tb_ in tables.items():
        llr = awgn_channel(tb_.code, make_generator(dev, 7, 2, 0), BATCH, COMPARE_SNR_DB).llr
        k_ms = cuda_ms(lambda: df.bp_decode_fused(tb_, llr, ITERS, False, "BP"), 5)
        p_ms = cuda_ms(lambda: df.bp_decode_fused_plain(tb_, llr, ITERS, False, "BP"), 2)
        times[key] = (k_ms, p_ms)
        print(f"time kernel1 {key} BP {ITERS} it no-ET B={BATCH}: kernel {k_ms:.3f} ms "
              f"({BATCH / k_ms * 1e3:.0f} frames/s), plain {p_ms:.3f} ms "
              f"({BATCH / p_ms * 1e3:.0f} frames/s) [{name_power}]")
    st2 = {}

    def reset_state():
        st2["st"] = fresh_pool_state()
        st2["rem"] = torch.full((1,), BATCH, dtype=torch.int32, device=dev)

    def chunk(fn):
        st = st2["st"]
        fn(tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
           st.fresh_llr, st.fresh_cw, refill_on, st2["rem"], k=6, cap=ITERS, minsum_mode="BP")

    k2_ms = cuda_ms(lambda: chunk(df.bp_stream_chunk_fused), 5, reset_state)
    p2_ms = cuda_ms(lambda: chunk(df.bp_stream_chunk_fused_plain), 2, reset_state)
    print(f"time kernel2 bench1152 BP 6 passes from a full pool B={BATCH}: kernel {k2_ms:.3f} ms, "
          f"plain {p2_ms:.3f} ms [{name_power}]")
    # the results file keeps frame_time to 6 decimals; take the sweep rate
    # from the Simulator's own float timing
    for snr in (2.0, 2.5):
        res = Simulator(
            code, DecoderParams(iterations=ITERS), ChannelParams(seed=1, x_range=(snr, snr + 0.01, 1.0)),
            SimulationParams(batch_size=BATCH, fec=50, max_frames=2_000_000),
            device=dev, verbose=False,
        ).start()
        print(f"sweep bench1152 BP ET SNR {snr} dB: {1.0 / res.time[0]:.0f} frames/s "
              f"(avg_iter {res.avg_iter[0]:.3f}, FER {res.fer[0]:.3e}, {int(res.frames[0])} frames) "
              f"[{name_power}]")

    src = "libldpc_tpu_torch/csrc/decode_fused.cu"
    print(json.dumps({"kernels": [
        {"name": "bp_decode_fused", "route": "cuda", "source": src,
         "replaces": "libldpc_tpu/ops/pallas/decode_fused.py:617",
         "launches": launches["bp_decode_fused"], "max_abs_err": err1,
         "ms": times["bench1152"][0], "plain_ms": times["bench1152"][1]},
        {"name": "bp_stream_chunk_fused", "route": "cuda", "source": src,
         "replaces": "libldpc_tpu/ops/pallas/decode_fused.py:404",
         "launches": launches["bp_stream_chunk_fused"], "max_abs_err": err2,
         "ms": k2_ms, "plain_ms": p2_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
