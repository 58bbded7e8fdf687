"""The file-driven command line of the reference's GPU simulator
(``sim_cuda``), the port of :mod:`libldpc_tpu.sim_cuda`: ``-code``,
``-sim`` and ``-map`` are required, ``-layer`` takes the layered schedule,
``-threads`` is the device batch size, and ``-device`` (``cuda`` unless
``cpu`` is asked for) where the sweep runs.

Usage::

    python -m libldpc_tpu_torch.sim_cuda -code h.txt -sim sim.txt -map map.txt [-device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sim_cuda")
    p.add_argument("-code", required=True, help="codefile (headered dialect ok)")
    p.add_argument("-sim", required=True, help="simfile")
    p.add_argument("-map", dest="mapfile", required=True, help="mapfile")
    p.add_argument("-layer", default="", help="layerfile (layered schedule)")
    p.add_argument("-G", "--gen-matrix", default="", help="generator matrix file")
    p.add_argument("-threads", type=int, default=1024,
                   help="frames per device step (the device batch size)")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-device", default="cuda",
                   help="cuda (the CUDA kernels, default) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from .sim.gpu_compat import run_from_simfiles

    run_from_simfiles(args.code, args.sim, args.mapfile, layer_file=args.layer,
                      gen_file=args.gen_matrix, batch_size=args.threads, seed=args.seed,
                      device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
