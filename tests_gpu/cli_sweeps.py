"""The smoke run's CLI sweeps from any checkout of the port, for comparing
two commits on one card in one call.

    python3 tests_gpu/cli_sweeps.py <root of a checkout> [default-layered]

It imports ``libldpc_tpu_torch`` from that root, writes the code files
under ``<root>/build/sweeps/`` and runs, with ``--pallas -i 50
--batch-size 16384`` and the seeds of the defaults: the 802.11n n=1944
layered sweep (1.0-2.5 dB) in float32 BP, bfloat16 BP and int8 BP_OMS, the
n=648 exact layered point at 2.0 dB (float32 BP and int8 BP_MS), the BEC
sweep (eps 0.30-0.45), the flooding sweep of the 1152 (3,6) code
(1.0-3.0 dB in float32 BP; 2.0 and 2.5 dB in bfloat16 BP and int8
BP_OMS), and the fixed-iteration points (``--no-early-term``, 2.0 dB) of
the 1152 code's flooding decode and the n=1944 layered decode, each in
float32 BP, bfloat16 BP and int8 BP_OMS; then the default command line on
the exact schedule: ``--layer-file`` on n=1944 without ``--pallas`` (float32
BP, batch-stepped, 1.5-2.5 dB), its results file and one ``rate`` line a
point (frames/s, avg_iter, FER).  Each results file is printed after its
run time.  With ``default-layered`` only that last sweep runs.  The channel
draws come from seeded generators, so two commits that decode alike print
the same rows (the ``frame_time`` column aside).

Then the smoke run's end-to-end rates, from the ``Simulator``'s own float
timing (B = 16384, ET, 50 frame errors): the 1152 code's flooding point at
2.0 and 2.5 dB (float32 BP) and the n=648 exact layered point at 2.0 dB
(float32 BP, int8 BP_MS), one ``rate`` line each; then the fixed-iteration
rates (no ET, 8 batches) of the 1152 flooding point and the n=1944
layered-fast point at 2.0 dB in each message form; last, the 1152 code over
the BEC at erasure rates 0.35 and 0.40: the batch-stepped ``Simulator``'s
frames/s (ET, 20 batches) and the streaming step's
(``make_streaming_fused_step(tables, "BEC")``, 50 iterations, host clock
over 8 super-steps after 2 warm ones).  Run it on two trees in turns
(parent, change, change, parent) to compare their rates in one call.
"""

import pathlib
import sys
import time

#: (message dtype, CN form) of the fixed-iteration points
FIXED_FORMS = (("float32", "BP"), ("bfloat16", "BP"), ("int8", "BP_OMS"))


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch import cli
    from libldpc_tpu_torch.models import (
        make_benchmark_code, wifi_code, write_codefile, write_layerfile,
    )
    from libldpc_tpu_torch.ops.channel import make_generator
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

    work = root / "build" / "sweeps"
    work.mkdir(parents=True, exist_ok=True)
    codes = {"bench1152": make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
             "wifi1944": wifi_code(1944), "wifi648": wifi_code(648)}

    def run(key, out, snrs, *flags, layered=False, pallas=True):
        code = codes[key]
        write_codefile(str(work / f"{key}_h.txt"), code.rows, code.cols, code.nc, code.mc)
        r, c = code.G.nonzero()
        (work / f"{key}_g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
        args = [str(work / f"{key}_h.txt"), str(work / out), *snrs, "-G", str(work / f"{key}_g.txt"),
                "-i", "50", "--batch-size", "16384", *(["--pallas"] if pallas else []), *flags]
        if layered:
            write_layerfile(str(work / f"{key}_layers.txt"), code.layers)
            args += ["--layer-file", str(work / f"{key}_layers.txt")]
        t0 = time.perf_counter()
        if cli.main(args) != 0:
            raise RuntimeError(f"CLI run {out} failed")
        print(f"--- {out} ({time.perf_counter() - t0:.1f} s)\n{(work / out).read_text()}", end="",
              flush=True)

    def default_layered():
        out = "res_default_layered.txt"
        run("wifi1944", out, ["1.5", "2.51", "0.5"], "--frame-error-count", "50", "--max-frames",
            "1000000", layered=True, pallas=False)
        # the rates from the same sweep's Simulator (the CLI's defaults: seed
        # 0, no --pallas): the results file keeps a frame's time to 1 us, and
        # its row is the point's as of its last frame error
        res = Simulator(
            codes["wifi1944"], DecoderParams(iterations=50, layered=True),
            ChannelParams(seed=0, x_range=(1.5, 2.51, 0.5)),
            SimulationParams(batch_size=16384, fec=50, max_frames=1_000_000),
            device=torch.device("cuda"), verbose=False, use_pallas=False,
        ).start()
        for i, snr in enumerate(res.x_values):
            print(f"rate wifi1944 default --layer-file (exact layered, batch) BP float32 ET "
                  f"{snr:.1f} dB: {1.0 / res.time[i]:.0f} frames/s (avg_iter "
                  f"{res.avg_iter[i]:.3f}, FER {res.fer[i]:.3e}, {int(res.frames[i])} frames)",
                  flush=True)

    if sys.argv[2:] == ["default-layered"]:
        default_layered()
        return 0
    sweep = ["1.0", "2.51", "0.5"]
    cap = ["--frame-error-count", "50", "--max-frames", "1000000"]
    run("wifi1944", "res_layered.txt", sweep, "--qc-z", "81", "--frame-error-count", "50",
        "--max-frames", "4000000", layered=True)
    run("wifi1944", "res_layered_bf16.txt", sweep, "--qc-z", "81", "--message-dtype", "bfloat16",
        "--decoding", "BP", *cap, layered=True)
    run("wifi1944", "res_layered_int8.txt", sweep, "--qc-z", "81", "--message-dtype", "int8",
        "--decoding", "BP_OMS", *cap, layered=True)
    run("wifi648", "res_layered_648.txt", ["2.0", "2.01", "1"], "--frame-error-count", "50",
        "--max-frames", str(4 * 16384), layered=True)
    run("bench1152", "res_bec.txt", ["0.30", "0.451", "0.05"], "--channel", "BEC",
        "--frame-error-count", "50", "--max-frames", "2000000")
    run("wifi648", "res_layered_648_int8.txt", ["2.0", "2.01", "1"], "--message-dtype", "int8",
        "--decoding", "BP_MS", "--frame-error-count", "50", "--max-frames", str(4 * 16384),
        layered=True)
    run("bench1152", "res.txt", ["1.0", "3.01", "0.5"], "--frame-error-count", "50",
        "--max-frames", "2000000")
    for dtype, cn in (("bfloat16", "BP"), ("int8", "BP_OMS")):
        run("bench1152", f"res_{dtype}.txt", ["2.0", "2.51", "0.5"], "--message-dtype", dtype,
            "--decoding", cn, *cap)
    fixed = ["--no-early-term", "--frame-error-count", "50", "--max-frames", str(4 * 16384)]
    for dtype, cn in FIXED_FORMS:
        flags = ["--message-dtype", dtype, "--decoding", cn, *fixed]
        run("bench1152", f"res_fixed_{dtype}.txt", ["2.0", "2.01", "1"], *flags)
        run("wifi1944", f"res_layered_fixed_{dtype}.txt", ["2.0", "2.01", "1"], "--qc-z", "81",
            *flags, layered=True)
    for key, layered, snr, dtype, form in (
            ("bench1152", False, 2.0, "float32", "BP"), ("bench1152", False, 2.5, "float32", "BP"),
            ("wifi648", True, 2.0, "float32", "BP"), ("wifi648", True, 2.0, "int8", "BP_MS")):
        res = Simulator(
            codes[key], DecoderParams(iterations=50, layered=layered, type=form,
                                      message_dtype=dtype),
            ChannelParams(seed=1, x_range=(snr, snr + 0.01, 1.0)),
            SimulationParams(batch_size=16384, fec=50, max_frames=2_000_000),
            device=torch.device("cuda"), verbose=False, use_pallas=True,
        ).start()
        print(f"rate {key} {'layered' if layered else 'flooding'} {form} {dtype} ET {snr} dB: "
              f"{1.0 / res.time[0]:.0f} frames/s (avg_iter {res.avg_iter[0]:.3f}, FER "
              f"{res.fer[0]:.3e}, {int(res.frames[0])} frames)", flush=True)
    for key, layered in (("bench1152", False), ("wifi1944", True)):
        for dtype, form in FIXED_FORMS:
            res = Simulator(
                codes[key], DecoderParams(iterations=50, early_term=False, layered=layered,
                                          type=form, message_dtype=dtype),
                ChannelParams(seed=1, x_range=(2.0, 2.01, 1.0)),
                SimulationParams(batch_size=16384, fec=10**9, max_frames=8 * 16384),
                device=torch.device("cuda"), verbose=False, use_pallas=True,
            ).start()
            print(f"rate {key} {'layered-fast' if layered else 'flooding'} {form} {dtype} fixed "
                  f"50 it 2.0 dB: {1.0 / res.time[0]:.0f} frames/s (FER {res.fer[0]:.3e}, "
                  f"{int(res.frames[0])} frames)", flush=True)
    dev = torch.device("cuda")
    tables = kernel_tables(to_sorted_device(codes["bench1152"], dev))
    for eps in (0.35, 0.40):
        res = Simulator(
            codes["bench1152"], DecoderParams(iterations=50),
            ChannelParams(seed=1, x_range=(eps, eps + 0.001, 1.0), type="BEC"),
            SimulationParams(batch_size=16384, fec=10**9, max_frames=20 * 16384),
            device=dev, verbose=False, use_pallas=True,
        ).start()
        print(f"rate bench1152 BEC batch-stepped ET eps {eps}: {1.0 / res.time[0]:.0f} frames/s "
              f"(avg_iter {res.avg_iter[0]:.3f}, FER {res.fer[0]:.3e})", flush=True)
        init_fn, step_fn = make_streaming_fused_step(tables, "BEC", DecoderParams(iterations=50),
                                                     16384)
        st = init_fn()
        frames = torch.zeros((), dtype=torch.int64, device=dev)
        for step in range(10):
            if step == 2:
                torch.cuda.synchronize()
                t0, frames = time.perf_counter(), frames.zero_()
            st, acc = step_fn(st, make_generator(dev, 11, int(eps * 100), step), eps, True)
            frames += acc.frames
        n = int(frames)
        print(f"rate bench1152 BEC streaming ET eps {eps}: {n / (time.perf_counter() - t0):.0f} "
              f"frames/s ({n} frames in 8 super-steps)", flush=True)
    default_layered()
    return 0


if __name__ == "__main__":
    sys.exit(main())
