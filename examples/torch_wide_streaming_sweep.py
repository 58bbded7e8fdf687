"""Point-parallel streaming sweep over a 2-D device mesh on the PyTorch /
CUDA port (``wide_streaming_sweep.py`` on :mod:`libldpc_tpu_torch`).

Two capabilities the reference lacks, composed: sweep points running
concurrently (the reference is strictly sequential per point) and
streaming early termination (device work per frame tracks ``avg_iter``).
Each point group runs its own stream at its own SNR with per-point refill
gating, drain and exact ``max_frames`` quotas.  Two points run at once
where there are two or more devices; on one card or the CPU the mesh is
``(1, 1)``.

Equivalent CLI:
    python -m libldpc_tpu_torch.cli h.txt res.txt -7 -3.9 1 -G g.txt \
        --points-parallel 2 --batch-size 4096

Pass the reference's bundled code with ``--code h.txt --gen g.txt`` (swept
at -7 .. -3.9 dB as there).  Without them it runs
``make_benchmark_code(1152, 3, 6, seed=0, with_G=True)`` over its waterfall,
1-3 dB (``sigma^2 = 10^(-snr/10)``):

    python examples/torch_wide_streaming_sweep.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libldpc_tpu_torch import (
    ChannelParams,
    DecoderParams,
    LDPCCode,
    SimulationParams,
    Simulator,
    make_benchmark_code,
)
from libldpc_tpu_torch.parallel.mesh import FRAME_AXIS, POINT_AXIS, local_devices, make_mesh


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--code", help="parity-check codefile (default: the 1152 benchmark code)")
    p.add_argument("--gen", help="generator file of --code")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   help="sweep, MAX exclusive (default -7 -3.9 1 with --code, else 1 3.01 0.5)")
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--fec", type=int, default=50, help="frame errors that end a point")
    p.add_argument("--max-frames", type=int, default=20_000)
    return p.parse_args(argv)


def main(argv=None) -> Simulator:
    """Run the sweep; returns the :class:`Simulator` (``.results``)."""
    args = parse_args(argv)
    if args.code:
        code = LDPCCode.from_files(args.code, args.gen or "")
        snr = args.snr or (-7.0, -3.9, 1.0)
    else:
        code = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
        snr = args.snr or (1.0, 3.01, 0.5)

    devs = local_devices(args.device)
    n_points_parallel = 2 if len(devs) >= 2 else 1
    n_frame_dev = len(devs) // n_points_parallel
    mesh = make_mesh(
        (n_points_parallel, n_frame_dev), (POINT_AXIS, FRAME_AXIS), devs
    )

    sim = Simulator(
        code,
        DecoderParams(iterations=50, early_term=True),
        ChannelParams(seed=0, x_range=tuple(snr), type="AWGN"),
        SimulationParams(batch_size=args.batch_per_device * n_frame_dev, fec=args.fec,
                         max_frames=args.max_frames),
        device=devs[0],
    )
    results = sim.start_wide(mesh)

    for x, fer, frames, ai in zip(
        results.x_values, results.fer, results.frames, results.avg_iter
    ):
        print(f"SNR {x:5.1f} dB   FER {fer:.3e}   avg_iter {ai:5.1f}   "
              f"({frames} frames)")
    return sim


if __name__ == "__main__":
    main()
