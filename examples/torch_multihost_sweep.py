"""Multi-device / multi-process sweep on the PyTorch / CUDA port
(``multihost_sweep.py`` on :mod:`libldpc_tpu_torch`).

Run one copy of this script per process, each with the usual
``torch.distributed`` environment (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``); without it the script runs as
one rank.  Two ranks on this host, on the CPU:

    for r in 0 1; do MASTER_ADDR=localhost MASTER_PORT=29511 RANK=$r \\
        WORLD_SIZE=2 LOCAL_RANK=$r python examples/torch_multihost_sweep.py \\
        --device cpu & done; wait

Frames shard over every process's device (a gloo group; several ranks
may share a card); the counters each absorb reads are summed over the
group, so the frame-error stopping rule reads global counts and every
process stops at the same batch with no control messages.  Only the
primary process prints and writes the results file.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from libldpc_tpu_torch import (
    ChannelParams,
    DecoderParams,
    SimulationParams,
    Simulator,
    make_benchmark_code,
)
from libldpc_tpu_torch.parallel import distributed


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   default=(1.0, 2.6, 0.5), help="sweep, MAX exclusive")
    p.add_argument("--batch-per-device", type=int, default=64)
    p.add_argument("--fec", type=int, default=100, help="frame errors that end a point")
    p.add_argument("--max-frames", type=int, default=SimulationParams.max_frames)
    p.add_argument("--result-file", default="results_multihost_torch.txt")
    return p.parse_args(argv)


def main(argv=None) -> Simulator:
    """Run the sweep on this rank; returns the :class:`Simulator`."""
    args = parse_args(argv)
    distributed.initialize()  # a single process without the environment
    mesh = distributed.global_mesh(args.device)
    primary = distributed.is_primary()
    if primary:
        print("topology:", distributed.process_info())

    code = make_benchmark_code(1024, dv=3, dc=6, seed=0, with_G=True)
    sim = Simulator(
        code,
        DecoderParams(iterations=50),
        ChannelParams(seed=0, x_range=tuple(args.snr)),
        SimulationParams(
            batch_size=args.batch_per_device * mesh.devices.size,
            fec=args.fec,
            max_frames=args.max_frames,
            result_file=(args.result_file or None) if primary else None,
        ),
        mesh=mesh,
        verbose=primary,
    )
    results = sim.start()
    if primary:
        print({k: v.tolist() for k, v in results.as_dict().items()})
    return sim


if __name__ == "__main__":
    main()
