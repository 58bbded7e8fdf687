"""K8's reload form at each draw tiling, on one card.

    python3 tests_gpu/reload_tiling.py

The 1152 (3,6) code, BPSK at 2.0 dB, B = 16384: ``stream_reload`` timed
(CUDA events, the card kept busy ahead of the start event) in its two
forms, into the state and staged (``stage=``), with 1,536 granted lanes
spread at random over the batch (as finished frames are) and with 13,000,
for each tiling of the draw (``pool_tables``' ``slab_cols``, the columns a
block draws, and ``lane_tile``, its lanes; the pool's is ``SLAB_COLS`` x
``LANE_TILE``, the reload's ``RELOAD_SLAB_COLS`` x ``RELOAD_LANE_TILE``), and
the plan alone.  Each tiling's
reloaded planes and staged columns must equal the default tiling's (a
lane's numbers depend on the key and the lane only).  One ``tiling`` line
per case and form.
"""

import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from libldpc_tpu_torch.models import make_benchmark_code  # noqa: E402
from libldpc_tpu_torch.ops.kernels import pool_refill as pr  # noqa: E402
from libldpc_tpu_torch.ops.kernels.layout import kernel_tables  # noqa: E402
from libldpc_tpu_torch.ops.sorted import to_sorted_device  # noqa: E402

B = 16384


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


def main() -> int:
    if not torch.cuda.is_available():
        print("reload_tiling: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    tb = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev))
    sdc = tb.code
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
    default = (pr.SLAB_COLS, pr.LANE_TILE)
    ref = {}
    for n in (1536, 13000):
        idle = torch.randperm(B, generator=g)[:n].to(dev)

        def reset():
            planes["done"].zero_()
            planes["done"][idle] = 1
            planes["started"].zero_()
            stage.slot.fill_(-1)

        plan = timed(lambda: pr.reload_plan(on, planes["done"], planes["started"], 10**9, 1024),
                     reset)
        for slab_cols, lane_tile in (default, (144, 64), (72, 64), (288, 32), (144, 32),
                                     (72, 32), (288, 16), (72, 16)):
            pt = pr.pool_tables(sdc, "AWGN", slab_cols=slab_cols, lane_tile=lane_tile)

            def run(staged=False):
                pr.stream_reload(pt, None, 2.0, on, planes["done"], planes["llr"], planes["cw"],
                                 planes["lv2c"], planes["age"], planes["iters"],
                                 planes["started"], 10**9, 1024, vn_ptr=tb.vn_ptr,
                                 perm_c2v=tb.perm_c2v, key=key, stage=stage if staged else None)

            blocks = -(-n // pt.lane_tile) * (-(-pt.item_src.shape[0] // pt.items_per_slab))
            for form, staged in (("into the state", False), ("staged", True)):
                ms = timed(lambda: run(staged), reset)
                reset()
                run(staged)
                got = ((stage.slot.clone(), stage.llr[:, :n].clone(), stage.cw[:, :n].clone())
                       if staged else
                       (planes["llr"].clone(), planes["lv2c"].clone(), planes["cw"].clone()))
                if (n, form) not in ref:
                    ref[n, form] = got
                same = all(torch.equal(a, b) for a, b in zip(got, ref[n, form]))
                print(f"tiling {n} lanes granted of {B}, {form}: slab {pt.items_per_slab} items "
                      f"x {pt.lane_tile} lanes ({blocks} working blocks): {ms:.4f} ms (plan "
                      f"{plan:.4f}); equal to the default tiling's: {same} [{card}]", flush=True)
                if not same:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
