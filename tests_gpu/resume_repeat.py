"""Does a streaming point that ``max_frames`` ends repeat from run to run?

    python3 tests_gpu/resume_repeat.py [runs] [grants]

On the card, with B = 16384, 50 iterations, 50 frame errors and
``max_frames`` 2,000,000 a point, seed 1: the wifi 1944 layered-fast sweep
(K4) at 1.5 and 2.0 dB and the 1152 (3,6) flooding sweep (K2) at 2.5 and
3.0 dB.  The first point of each ends by its frame errors, the second by
``max_frames``.  Each sweep runs ``runs`` times uninterrupted (default 3),
then twice stopped after its first point and resumed from the checkpoint.
Every run's rows (x, FER, BER, avg_iter, frame errors, frames) are printed,
then one ``repeat`` line per sweep and point: whether the uninterrupted
runs gave equal rows, and whether each resumed run equals the first
uninterrupted one.  If the uninterrupted runs differ at a point, a resumed
run cannot be held to equal them there.

Before the sweeps, the streaming step alone (K4 on wifi 1944 at 2.0 dB, K2 on the 1152
code at 3.0 dB), ``grants`` times (default 20) from empty streams with the
same channel draws: two super-steps under a start quota of 3 B + 5000
frames, which binds within them.  One ``grant`` line per kernel: how
many distinct outcomes (the lanes idle, their iteration counts, the pool
entries used, the counters) the repetitions gave.  With the chunks where
the quota may bind run in lane order (``ordered``) and the pool drawn by
lane (K8's Philox streams keyed by the step's generator), there is one; more
than one would mean that the block order decides which lanes start.
"""

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    grants = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    sys.path.insert(0, str(ROOT))
    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
    from libldpc_tpu_torch.ops.channel import make_generator
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import (
        ChannelParams, DecoderParams, SimulationParams, Simulator,
    )

    work = ROOT / "build" / "resume_repeat"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "ckpt.json"
    dev = torch.device("cuda")
    codes = {"wifi1944": wifi_code(1944),
             "bench1152": make_benchmark_code(1152, 3, 6, seed=0, with_G=True)}

    batch = 16384
    for key, snr, layered in (("wifi1944", 2.0, True), ("bench1152", 3.0, False)):
        tables = kernel_tables(to_sorted_device(codes[key], dev, with_layers=layered))
        init_fn, step_fn = make_streaming_fused_step(
            tables, "AWGN", DecoderParams(iterations=50, layered=layered), batch,
            max_frames=3 * batch + 5000, layered=layered)
        outcomes = {}
        for r in range(grants):
            st, totals = init_fn(), []
            for step in range(2):
                st, acc = step_fn(st, make_generator(dev, 1, 0, step), snr, True)
                totals.append(torch.stack(list(acc)).tolist())
            sig = (st.done.cpu().numpy().tobytes(), st.iters.cpu().numpy().tobytes(),
                   st.avail.cpu().numpy().tobytes(), int(st.started), str(totals))
            outcomes.setdefault(sig, []).append(r)
        print(f"grant {key} {'K4' if layered else 'K2'} {snr} dB, quota {3 * batch + 5000}: "
              f"{len(outcomes)} distinct outcome(s) in {grants} repetitions "
              f"(runs per outcome {[len(v) for v in outcomes.values()]}; frames started "
              f"{sorted({k[3] for k in outcomes})})", flush=True)

    def sim(key, x_range, layered):
        return Simulator(
            codes[key], DecoderParams(iterations=50, layered=layered),
            ChannelParams(seed=1, x_range=x_range),
            SimulationParams(batch_size=16384, fec=50, max_frames=2_000_000,
                             checkpoint_file=str(ckpt)),
            device=dev, verbose=False, use_pallas=True)

    def rows(res):  # each point's row, frame_time aside
        return np.stack([res.x_values, res.fer, res.ber, res.avg_iter, res.fec, res.frames], 1)

    for key, x_range, layered in (("wifi1944", (1.5, 2.01, 0.5), True),
                                  ("bench1152", (2.5, 3.01, 0.5), False)):
        whole, resumed = [], []
        for r in range(runs):
            ckpt.unlink(missing_ok=True)
            s = sim(key, x_range, layered)
            whole.append(rows(s.start()))
            print(f"{key} {s.schedule} uninterrupted run {r}: {whole[-1].tolist()}", flush=True)
        for r in range(2):
            ckpt.unlink(missing_ok=True)
            s = sim(key, x_range, layered)
            first = s.start(stop_flag=lambda: s.results.fec[0] >= 50)
            assert first.frames[0] > 0 and first.frames[1] == 0, "the stop did not follow point 0"
            resumed.append(rows(sim(key, x_range, layered).start(resume=True)))
            print(f"{key} {s.schedule} stopped after point 0 and resumed, run {r}: "
                  f"{resumed[-1].tolist()}", flush=True)
        for p, x in enumerate(np.arange(*x_range)):
            ended = "max_frames" if whole[0][p, 5] >= 2_000_000 else "frame errors"
            same = all(np.array_equal(w[p], whole[0][p]) for w in whole)
            res_same = [bool(np.array_equal(w[p], whole[0][p])) for w in resumed]
            print(f"repeat {key} {x:.1f} dB (ended by {ended}): {runs} uninterrupted runs "
                  f"{'equal' if same else 'DIFFER'} (avg_iter "
                  f"{sorted({float(w[p, 3]) for w in whole})}, frame errors "
                  f"{sorted({int(w[p, 4]) for w in whole})}); resumed runs equal to run 0: "
                  f"{res_same}", flush=True)
    ckpt.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
