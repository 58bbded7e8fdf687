"""The reload's burst sizes in the default sweep, and K8's two draw tilings
timed at them, on one card.

    python3 tests_gpu/reload_bursts.py [OUT.json]

Part 1: the default sweep (the ``Simulator`` without ``--pallas``: the XLA
super-step, 50 passes, B = 16384, ``gen_threshold`` B/16) of the 1152
(3,6) code, float32 BP, 50 iterations, ET, seed 1, ``max_frames`` 48
batches: BPSK at 1.0, 1.5, 2.0, 2.5 and 3.0 dB, and 4-ASK (Gray labels
``0 1 3 2``, the bits mapped consecutively, as ``sim_cuda``'s files map
them) at 7.25, 7.5 and 7.75 dB.  Every ``stream_reload`` call's granted
lanes are recorded on the device (``started`` after less before); one
``bursts`` line per point: the reloads that drew, the first fill, and the
quantiles of the others.

Part 2: the staged reload (``stream_reload(..., stage=)``, plan and draw)
timed with CUDA events (the card kept busy ahead of the start event) at a
grid of granted counts spread at random over the batch, in the pool's
tiling (``SLAB_COLS`` x ``LANE_TILE``) and the reload's
(``RELOAD_SLAB_COLS`` x ``RELOAD_LANE_TILE``), BPSK and 4-ASK; the two
tilings' staged columns must be equal.  One ``tiling`` line each.  Then,
per point, the draw time of its recorded reloads in each tiling, linearly
interpolated on the grid: one ``verdict`` line.
"""

import functools
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from libldpc_tpu_torch.models import make_benchmark_code  # noqa: E402
from libldpc_tpu_torch.ops import modulation as mod  # noqa: E402
from libldpc_tpu_torch.ops.kernels import pool_refill as pr  # noqa: E402
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables  # noqa: E402
from libldpc_tpu_torch.ops.sorted import to_sorted_device  # noqa: E402
from libldpc_tpu_torch.sim.driver import (  # noqa: E402
    ChannelParams, DecoderParams, SimulationParams, Simulator,
)

B = 16384
BATCHES = 48
GRID = (256, 512, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288, 16384)
POINTS = [("BPSK", snr) for snr in (1.0, 1.5, 2.0, 2.5, 3.0)] + [
    ("4-ASK", snr) for snr in (7.25, 7.5, 7.75)]
GRAY4 = [0, 1, 3, 2]


def timed(fn, setup, reps=20) -> float:
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bursts(code, dev, kind, snr) -> list:
    """Every reload's granted lanes in one default sweep point, in order
    (0 where the plan drew nothing)."""
    record = []
    real = pr.stream_reload

    @functools.wraps(real)  # the wrapper counts its launches on the module's name
    def spy(*a, **k):
        before = a[10].clone()  # started
        real(*a, **k)
        record.append(a[10] - before)

    modulation = None
    if kind == "4-ASK":
        modulation = (mod.Constellation.mask(4, GRAY4), mod.default_bit_mapper(2, code.nct // 2))
    pr.stream_reload = spy
    try:
        Simulator(code, DecoderParams(iterations=50, type="BP"),
                  ChannelParams(seed=1, x_range=(snr, snr + 0.001, 1.0)),
                  SimulationParams(batch_size=B, fec=10**9, max_frames=BATCHES * B),
                  device=dev, verbose=False, use_pallas=False, modulation=modulation).start()
    finally:
        pr.stream_reload = real
    return torch.cat(record).tolist()


def main() -> int:
    if not torch.cuda.is_available():
        print("reload_bursts: no CUDA device", file=sys.stderr)
        return 1
    out_path = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else None
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    code = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
    result = {"card": card, "bursts": {}, "grid": list(GRID), "times": {}, "verdict": {}}
    # -- part 1: the default sweep's reloads
    bursts(code, dev, "BPSK", 2.0)  # builds and loads the kernels
    for kind, snr in POINTS:
        got = bursts(code, dev, kind, snr)
        drew = [n for n in got if n > 0]
        rest = np.asarray(drew[1:])
        result["bursts"][f"{kind} {snr}"] = got
        q = np.percentile(rest, [0, 10, 50, 90, 100]) if rest.size else [0] * 5
        print(f"bursts bench1152 {kind} {snr} dB: {len(got)} reloads, {len(drew)} drew; first "
              f"fill {drew[0] if drew else 0}; the others min / p10 / median / p90 / max "
              f"{' / '.join(f'{v:.0f}' for v in q)} lanes, {int(rest.sum())} lanes in all "
              f"[{card}]", flush=True)
    # -- part 2: the staged reload in both tilings on a grid of granted lanes
    tb = kernel_tables(to_sorted_device(code, dev))
    sdc = tb.code
    ask4 = (mod.Constellation.mask(4, GRAY4),
            sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
    planes = dict(done=torch.zeros(B, dtype=torch.int32, device=dev),
                  llr=torch.zeros((sdc.nc, B), device=dev),
                  cw=torch.zeros((sdc.nc, B), dtype=torch.uint8, device=dev),
                  lv2c=torch.zeros((sdc.nnz, B), device=dev),
                  age=torch.zeros(B, dtype=torch.int32, device=dev),
                  iters=torch.zeros(B, dtype=torch.int32, device=dev),
                  started=torch.zeros(1, dtype=torch.int32, device=dev))
    stage = pr.ReloadStage.empty(sdc.nc, B, dev)
    on = torch.ones(1, dtype=torch.int32, device=dev)
    key = torch.tensor([99], dtype=torch.int64, device=dev)
    g = torch.Generator(device="cpu").manual_seed(3)
    for kind, modulation, x in (("BPSK", None, 2.0), ("4-ASK", ask4, 7.5)):
        pool = pr.pool_tables(sdc, "AWGN", modulation)
        tilings = {"pool": pool, "reload": pr.reload_tables(pool)}
        for n in GRID:
            idle = torch.randperm(B, generator=g)[:n].to(dev)

            def reset():
                planes["done"].zero_()
                planes["done"][idle] = 1
                planes["started"].zero_()
                stage.slot.fill_(-1)

            cols = {}
            for name, pt in tilings.items():
                def run():
                    pr.stream_reload(pt, None, x, on, planes["done"], planes["llr"], planes["cw"],
                                     planes["lv2c"], planes["age"], planes["iters"],
                                     planes["started"], 10**9, 1, key=key, stage=stage)

                ms = timed(run, reset)
                reset()
                run()
                cols[name] = (stage.slot.clone(), stage.llr[:, :n].clone(),
                              stage.cw[:, :n].clone())
                result["times"].setdefault(f"{kind} {name}", []).append(ms)
                print(f"tiling {kind} staged, {n} lanes granted of {B}: {name}'s tiling "
                      f"({pt.lane_tile} lanes x {pt.items_per_slab} items a block) {ms:.4f} ms "
                      f"[{card}]", flush=True)
            if not all(torch.equal(a, b) for a, b in zip(cols["pool"], cols["reload"])):
                print(f"tiling {kind} {n}: the two tilings' staged columns differ",
                      file=sys.stderr)
                return 1
    # -- each point's reloads, drawn in each tiling
    for kind, snr in POINTS:
        drew = np.asarray([n for n in result["bursts"][f"{kind} {snr}"] if n > 0], dtype=float)
        ms = {name: float(np.interp(drew, GRID, result["times"][f"{kind} {name}"]).sum())
              for name in ("pool", "reload")}
        result["verdict"][f"{kind} {snr}"] = ms
        print(f"verdict bench1152 {kind} {snr} dB: {drew.size} draws, in the pool's tiling "
              f"{ms['pool']:.3f} ms, in the reload's {ms['reload']:.3f} ms "
              f"({ms['reload'] / ms['pool']:.3f}x) [{card}]", flush=True)
    if out_path:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
