"""A deployed code end to end on the PyTorch / CUDA port: IEEE 802.11n
LDPC (``wifi_sweep.py`` on :mod:`libldpc_tpu_torch`).

The 802.11n rate-1/2 base matrices (IEEE Std 802.11-2012 Annex F) are
built in; no codefile is needed.  The recipe:

* ``wifi_code(1944)``: n = 1944, k = 972, Z = 81, with the natural
  one-layer-per-base-row layered schedule and a systematic generator;
* offset min-sum (``BP_OMS``, offset 0.375 = 2 lattice units at the int8
  scale 0.1875);
* the layered schedule with early termination.

On the card (``--device cuda``, the default) the messages are int8 and the
sweep streams on the fast QC layered engine (``use_pallas=True``: K4's
chunk on ``Int8Msg``).  ``--device cpu`` keeps float32 without it (the
exact layered schedule, batch-stepped, on the plain versions) at one point:

    python examples/torch_wifi_sweep.py --device cpu
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
)
from libldpc_tpu_torch.models import wifi_code


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   help="sweep, MAX exclusive (default 1 2.6 0.5 on the card, 2 2.1 0.5 on "
                        "the CPU)")
    p.add_argument("--batch-size", type=int, help="default 4096 on the card, 256 on the CPU")
    p.add_argument("--fec", type=int, help="frame errors that end a point (100 / 10)")
    p.add_argument("--max-frames", type=int, help="default 500000 on the card, 512 on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> Simulator:
    """Run the sweep; returns the :class:`Simulator` (``.results``)."""
    args = parse_args(argv)
    code = wifi_code(1944)  # also built in: 648 (Z=27), 1296 (Z=54)
    print(code.summary())
    print(f"QC: Z={code.qc[0]}, {len(code.layers)} natural layers")

    on_card = args.device.startswith("cuda")
    sim = Simulator(
        code,
        DecoderParams(
            iterations=50,
            early_term=True,
            type="BP_OMS",
            ms_offset=0.375,  # 2 int8 lattice units at quant_scale 0.1875
            message_dtype="int8" if on_card else "float32",
            layered=True,
        ),
        ChannelParams(type="AWGN", seed=0,
                      x_range=tuple(args.snr or ((1.0, 2.6, 0.5) if on_card
                                                 else (2.0, 2.1, 0.5)))),
        SimulationParams(batch_size=args.batch_size or (4096 if on_card else 256),
                         max_frames=args.max_frames or (500_000 if on_card else 512),
                         fec=args.fec or (100 if on_card else 10)),
        device=args.device,
        use_pallas=on_card,
    )
    print(f"decode path: {sim.decode_path}")
    res = sim.start()
    for x, fer, ber, it in zip(res.x_values, res.fer, res.ber,
                               res.avg_iter):
        print(f"  {x:4.1f} dB  FER {fer:.3e}  BER {ber:.3e}  "
              f"avg_iter {it:.1f}")
    return sim


if __name__ == "__main__":
    main()
