"""Quasi-cyclic (protograph) code sweep on the PyTorch / CUDA port — the
deployed-LDPC workflow (``qc_code_sweep.py`` on :mod:`libldpc_tpu_torch`).

Production LDPC codes (802.11n/ax, 802.16e, 5G-NR, DVB-S2) are
overwhelmingly quasi-cyclic: a small base matrix of cyclic-shift
coefficients expanded by a lift size Z.  Here the whole path is three
lines: expand, solve a systematic generator, sweep.  On the card
(``--device cuda``, the default) the sweep takes the fused streaming step
with bfloat16 messages (``use_pallas=True``: K2's chunk on ``Bf16Msg``);
``--device cpu`` keeps float32 without it, on the plain versions:

    python examples/torch_qc_code_sweep.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from libldpc_tpu_torch import (
    ChannelParams,
    DecoderParams,
    SimulationParams,
    Simulator,
)
from libldpc_tpu_torch.models import expand_qc, systematic_generator


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   default=(0.0, 2.1, 1.0), help="sweep, MAX exclusive")
    p.add_argument("--batch-size", type=int, help="default 4096 on the card, 256 on the CPU")
    p.add_argument("--fec", type=int, default=100, help="frame errors that end a point")
    p.add_argument("--max-frames", type=int, default=200_000)
    return p.parse_args(argv)


def main(argv=None) -> Simulator:
    """Run the sweep; returns the :class:`Simulator` (``.results``)."""
    args = parse_args(argv)
    # a small rate-1/2 protograph in the 802.11n style: -1 = zero block,
    # s >= 0 = identity right-shifted by s.  Z = 128 lifts it to n = 1536.
    base = np.array([
        [ 0, -1, 13,  7, -1,  0,  0, -1, -1, -1, -1, -1],
        [22,  0, -1,  5,  3, -1,  0,  0, -1, -1, -1, -1],
        [-1, 11,  9, -1,  0, -1, -1,  0,  0, -1, -1, -1],
        [ 4, -1, -1,  1, -1, 17, -1, -1,  0,  0, -1, -1],
        [-1,  8,  2, -1, 19, -1, -1, -1, -1,  0,  0, -1],
        [14, -1, -1,  6, -1, 21,  0, -1, -1, -1,  0,  0],
    ])
    Z = 128
    code = expand_qc(base, Z)
    G = systematic_generator(code)
    if G is not None:
        code.G = G
    print(code.summary())

    on_card = args.device.startswith("cuda")
    sim = Simulator(
        code,
        DecoderParams(iterations=50, early_term=True,
                      message_dtype="bfloat16" if on_card else "float32"),
        ChannelParams(type="AWGN", seed=0, x_range=tuple(args.snr)),
        SimulationParams(batch_size=args.batch_size or (4096 if on_card else 256),
                         max_frames=args.max_frames, fec=args.fec),
        device=args.device,
        use_pallas=on_card,
    )
    print("decode path:", sim.decode_path)
    res = sim.start()
    for i, x in enumerate(res.x_values):
        print(f"SNR {x:5.1f} dB   FER {res.fer[i]:.3e}   "
              f"avg_iter {res.avg_iter[i]:5.1f}   "
              f"({int(res.frames[i])} frames)")
    return sim


if __name__ == "__main__":
    main()
