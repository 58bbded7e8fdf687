"""Basic BER/FER sweep on the PyTorch / CUDA port — the reference's
headline use case (``basic_sweep.py`` on :mod:`libldpc_tpu_torch`).

Equivalent reference invocation:
    ./ldpcsim h.txt res.txt -7 -4.9 1 -G g.txt -i 50 -t 8

Pass the reference's bundled code with ``--code h.txt --gen g.txt`` (swept
at -7 .. -4.9 dB as there).  Without them the sweep runs
``make_benchmark_code(1152, 3, 6, seed=0, with_G=True)`` over its waterfall,
1-3 dB (``sigma^2 = 10^(-snr/10)``).  The sweep streams on the default
engine, the XLA super-step: on the card (``--device cuda``, the default) a
one-pass K2 launch and K8's reload form each pass; ``--device cpu`` runs
their plain PyTorch versions:

    python examples/torch_basic_sweep.py --device cpu --batch-size 256
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


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--code", help="parity-check codefile (default: the 1152 benchmark code)")
    p.add_argument("--gen", help="generator file of --code")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   help="sweep, MAX exclusive (default -7 -4.9 1 with --code, else 1 3.01 0.5)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--fec", type=int, default=100, help="frame errors that end a point")
    p.add_argument("--max-frames", type=int, default=SimulationParams.max_frames)
    p.add_argument("--result-file", default="results.txt")
    return p.parse_args(argv)


def main(argv=None) -> Simulator:
    """Run the sweep; returns the :class:`Simulator` (``.results``)."""
    args = parse_args(argv)
    if args.code:
        code = LDPCCode.from_files(args.code, args.gen or "")
        snr = args.snr or (-7.0, -4.9, 1.0)
    else:
        code = make_benchmark_code(1152, 3, 6, seed=0, with_G=True)
        snr = args.snr or (1.0, 3.01, 0.5)
    print(code.summary())

    sim = Simulator(
        code,
        DecoderParams(iterations=50, type="BP"),       # or BP_MS / BP_LIN / ...
        ChannelParams(seed=0, x_range=tuple(snr), type="AWGN"),
        SimulationParams(batch_size=args.batch_size, fec=args.fec,
                         max_frames=args.max_frames, result_file=args.result_file or None),
        device=args.device,
    )
    results = sim.start()

    for x, fer, ber, frames in zip(
        results.x_values, results.fer, results.ber, results.frames
    ):
        print(f"SNR {x:5.1f} dB   FER {fer:.3e}   BER {ber:.3e}   ({frames} frames)")
    return sim


if __name__ == "__main__":
    main()
