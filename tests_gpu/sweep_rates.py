"""Sweep rates over long windows, from any checkout of the port, for
comparing two commits on one card in one call.

    python3 tests_gpu/sweep_rates.py <root of a checkout> [reps] [exact|streaming|batch|default]

It imports ``libldpc_tpu_torch`` from that root.  Every point runs 50
iterations, B = 16384, seed 1, with no frame-error stop and ``max_frames``
48 batches (786,432 frames), ``reps`` times each (default 3) after one warm
run, and prints one ``rate`` line per run: the ``Simulator``'s own
frames/s (its frame clock, as in the results file), ``avg_iter``, FER, the
frame errors and the frames (every point ends by ``max_frames``, so the
frames are exactly 786,432).

* ``exact`` (the default): the n=648 802.11n code on its exact layered
  schedule (K5, batch-stepped) at 2.0 dB, ET, in float32 BP and int8
  BP_MS.
* ``streaming``: the streaming sweeps, ET: the 1152 (3,6) code on flooding
  (K2) at 1.5, 2.0 and 2.5 dB; wifi 1944 on the fast layered engine (K4)
  at 1.5 and 2.0 dB; the 1152 code in 4-ASK (Gray labels ``0 1 3 2``, the
  bits mapped consecutively, as the ``sim_cuda`` files map them) at 7.25,
  7.5 and 7.75 dB, float32 BP; then the BEC streaming step at erasure rate
  0.40 (``make_streaming_fused_step(tables, "BEC")``, host clock over 8
  super-steps after 2 warm ones), one ``stream`` line per run.
* ``batch``: the batch-stepped points, whose every batch draws a full
  channel batch (K8's ``channel_batch`` on the card): the BEC
  sweep of the 1152 code (K6, ET) at erasure rates 0.35 and 0.40, and the
  1152 flooding BPSK point at 2.0 dB without early termination (K1, BP), as
  ``--channel BEC`` and ``--no-early-term`` run them.
* ``default``: the 1152 flooding ET points at 1.5, 2.0 and 2.5 dB, float32
  BP, on the command line without ``--pallas`` (the JAX package's default
  streaming engine, its XLA super-step) and with it (the fused step), each
  point both ways in turn; a ``rate`` line names which.

Run it on two trees in turns (parent, change, change, parent).
"""

import pathlib
import sys
import time

BATCHES = 48


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    which = sys.argv[3] if len(sys.argv) > 3 else "exact"
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
    from libldpc_tpu_torch.ops.channel import make_generator
    from libldpc_tpu_torch.ops.modulation import Constellation, default_bit_mapper
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

    dev = torch.device("cuda")
    bench = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)

    def sweep(code, snr, batches, **dec):
        modulation = dec.pop("modulation", None)
        channel_type = dec.pop("channel", "AWGN")
        use_pallas = dec.pop("pallas", True)
        return Simulator(
            code, DecoderParams(iterations=50, **dec),
            ChannelParams(seed=1, x_range=(snr, snr + 0.001, 1.0), type=channel_type),
            SimulationParams(batch_size=16384, fec=10**9, max_frames=batches * 16384),
            device=dev, verbose=False, use_pallas=use_pallas, modulation=modulation,
        ).start()

    if which == "exact":
        points = [("wifi648 layered BP float32", wifi_code(648), 2.0,
                   dict(layered=True, type="BP", message_dtype="float32")),
                  ("wifi648 layered BP_MS int8", wifi_code(648), 2.0,
                   dict(layered=True, type="BP_MS", message_dtype="int8"))]
    elif which == "default":
        points = [(f"bench1152 flooding BP float32 {'--pallas' if pallas else 'default'}", bench,
                   snr, dict(type="BP", pallas=pallas))
                  for snr in (1.5, 2.0, 2.5) for pallas in (False, True)]
    elif which == "batch":
        points = ([("bench1152 BEC peeling", bench, eps, dict(channel="BEC"))
                   for eps in (0.35, 0.40)]
                  + [("bench1152 flooding BP float32 no-ET", bench, 2.0,
                      dict(type="BP", early_term=False))])
    else:
        ask4 = (Constellation.mask(4, [0, 1, 3, 2]), default_bit_mapper(2, bench.nct // 2))
        wifi = wifi_code(1944)
        points = ([("bench1152 flooding BP float32", bench, snr, dict(type="BP"))
                   for snr in (1.5, 2.0, 2.5)]
                  + [("wifi1944 layered-fast BP float32", wifi, snr,
                      dict(layered=True, type="BP")) for snr in (1.5, 2.0)]
                  + [("bench1152 4-ASK flooding BP float32", bench, snr,
                      dict(type="BP", modulation=ask4)) for snr in (7.25, 7.5, 7.75)])
    sweep(points[0][1], points[0][2], 2, **dict(points[0][3]))  # builds and loads the kernels
    for tag, code, snr, dec in points:
        for r in range(reps):
            res = sweep(code, snr, BATCHES, **dict(dec))
            unit = "" if dec.get("channel") == "BEC" else " dB"
            et = "" if dec.get("early_term", True) is False else " ET"
            print(f"rate {tag}{et} {snr}{unit} run {r}: {1.0 / res.time[0]:.0f} frames/s (avg_iter "
                  f"{res.avg_iter[0]:.4f}, FER {res.fer[0]:.4e}, frame errors {int(res.fec[0])}, "
                  f"{int(res.frames[0])} frames) [{root.name}]", flush=True)
    if which == "streaming":
        from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
        from libldpc_tpu_torch.ops.sorted import to_sorted_device
        from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step

        tables = kernel_tables(to_sorted_device(bench, dev))
        init_fn, step_fn = make_streaming_fused_step(tables, "BEC", DecoderParams(iterations=50),
                                                     16384)
        for r in range(reps):
            st = init_fn()
            for step in range(2):
                st, _ = step_fn(st, make_generator(dev, 11, 40, step), 0.40, True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = torch.zeros((), dtype=torch.int64, device=dev)
            for step in range(2, 10):
                st, acc = step_fn(st, make_generator(dev, 11, 40, step), 0.40, True)
                frames += acc.frames
            n = int(frames)  # synchronises
            print(f"stream bench1152 BEC eps 0.40 run {r}: {n / (time.perf_counter() - t0):.0f} "
                  f"frames/s ({n} frames in 8 super-steps) [{root.name}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
