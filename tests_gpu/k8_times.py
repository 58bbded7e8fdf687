"""Device times of K8 (the channel draw: the streaming pool's refill and a
batch step's channel), of the start grant, and of the BEC batch step, from
any checkout of the port, for comparing two commits on one card in one call.

    python3 tests_gpu/k8_times.py <root of a checkout>

It imports ``libldpc_tpu_torch`` from that root and times, at B = 16384:

* the refill (``pool_refill``: its plan and its draw) of a pool with 13,000
  and with all 16,384 entries used, on the 1152 (3,6) code (BPSK at 2.0 dB,
  4-ASK at 7.5 dB with Gray labels and consecutive bits, the BSC at 0.05,
  the BEC at 0.40) and on the 802.11n n=1944 code (BPSK); where the tree
  has it, the full batch ``channel_batch``; and the plain channel batch
  (``simulate_channel``) on the same code and channel;
* the grant in lane order (``stream_grant``) over half the lanes eligible,
  and a one-element fill (a launch's floor);
* the BEC batch step (``make_sim_step``, K6 with early termination, the
  channel included) at 0.40.

Each time is given two ways: CUDA events around one call after a
synchronise (``host+device``: the host's launch work included), and the
same with the card kept busy ahead of the call (``torch.cuda._sleep``), so
that the events span the device's work alone (``device``).  One ``time``
line each, with the card's name and power limit.  Run it on two trees in
turns (parent, change, change, parent).
"""

import pathlib
import subprocess
import sys

BATCH = 16384
USED = 13000


def timed(torch, fn, reps, setup=None, busy=False):
    """Mean ms of ``fn()`` over ``reps`` runs after one warm-up; ``setup()``
    before each, outside the timing; ``busy``: the card is given ~1 ms of
    work before the start event, so that the host's launch work overlaps it."""
    total = 0.0
    for i in range(reps + 1):
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
        total += start.elapsed_time(end) if i else 0.0
    return total / reps


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
    from libldpc_tpu_torch.ops import channel
    from libldpc_tpu_torch.ops import modulation as mod
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.parallel.mesh import make_sim_step
    from libldpc_tpu_torch.sim.driver import DecoderParams

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    tables = {key: kernel_tables(to_sorted_device(code, dev)) for key, code in (
        ("bench1152", make_benchmark_code(1152, 3, 6, seed=0, with_G=True)),
        ("wifi1944", wifi_code(1944)))}
    ones = torch.ones(1, dtype=torch.int32, device=dev)

    def both(fn, reps, setup=None):
        return timed(torch, fn, reps, setup), timed(torch, fn, reps, setup, busy=True)

    def line(what, ms):
        print(f"time {what}: host+device {ms[0]:.4f} ms, device {ms[1]:.4f} ms [{card}] "
              f"[{root.name}]", flush=True)

    for key, kind, channel_type, x in (
            ("bench1152", "BPSK", "AWGN", 2.0), ("bench1152", "4-ASK", "AWGN", 7.5),
            ("bench1152", "BSC", "BSC", 0.05), ("bench1152", "BEC", "BEC", 0.40),
            ("wifi1944", "BPSK", "AWGN", 2.0)):
        sdc = tables[key].code
        modulation = None
        if kind == "4-ASK":
            modulation = (mod.Constellation.mask(4, [0, 1, 3, 2]),
                          sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
        pt = pr.pool_tables(sdc, channel_type, modulation)
        vals = torch.uint8 if channel_type == "BEC" else torch.float32
        key_t = pr.draw_keys(channel.make_generator(dev, 7), 1, dev)
        for used in (USED, BATCH):
            g = torch.Generator(device="cpu").manual_seed(3)
            avail0 = torch.ones(BATCH, dtype=torch.int32)
            avail0[torch.randperm(BATCH, generator=g)[:used]] = 0
            avail0 = avail0.to(dev)
            box = {}

            def reset():
                box["avail"] = avail0.clone()
                box["fresh"] = torch.zeros((sdc.nc, BATCH), dtype=vals, device=dev)
                box["cw"] = torch.zeros((sdc.nc, BATCH), dtype=torch.uint8, device=dev)

            ctr = torch.zeros((5, BATCH), dtype=torch.int32, device=dev)
            started = torch.zeros(1, dtype=torch.int64, device=dev)
            rem = torch.zeros(1, dtype=torch.int32, device=dev)
            line(f"K8 refill {key} {kind} {used} of {BATCH} drawn", both(
                lambda: pr.pool_refill(pt, None, x, ones, box["avail"], box["fresh"], box["cw"],
                                       ctr, started, 10**9, rem, key=key_t), 10, reset))
        if hasattr(pr, "channel_batch"):
            line(f"K8 full batch {key} {kind} {BATCH} frames",
                 both(lambda: pr.channel_batch(pt, None, BATCH, x, key=key_t), 10))
        gen = channel.make_generator(dev, 9)
        line(f"plain channel batch (simulate_channel) {key} {kind} {BATCH} frames", both(
            lambda: channel.simulate_channel(sdc, channel_type, gen, BATCH, x, modulation), 5))
    g = torch.Generator(device="cpu").manual_seed(5)
    done = (torch.rand(BATCH, generator=g) < 0.5).to(torch.int32).to(dev)
    avail = (torch.rand(BATCH, generator=g) < 0.9).to(torch.int32).to(dev)
    rem = torch.zeros(1, dtype=torch.int32, device=dev)
    line(f"stream_grant B={BATCH}", both(lambda: df.stream_grant(done, avail, ones, rem), 50,
                                         lambda: rem.fill_(BATCH // 4)))
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    line("a one-element fill (a launch's floor)", both(lambda: tiny.fill_(1), 50))
    for eps in (0.35, 0.40):
        step = make_sim_step(tables["bench1152"], "BEC", DecoderParams(iterations=50), BATCH,
                             "flooding")
        gen = channel.make_generator(dev, 10)
        line(f"BEC batch step bench1152 eps {eps} (channel and K6, ET)",
             both(lambda: step(gen, eps), 10))
    return 0


if __name__ == "__main__":
    sys.exit(main())
