"""The pyLDPC-style API on the PyTorch / CUDA port: threaded simulation,
one-shot encode/decode (``pyldpc_style.py`` on :mod:`libldpc_tpu_torch`).

Mirrors the reference's Python usage (pyLDPC/ldpc.py): start a simulation on
a background thread, poll live results, stop cooperatively; encode an info
word; decode LLRs (on the card, the flooding batch kernel K1); the GF(2)
rank of H (on the native host runtime where ``g++`` built it).

Pass the reference's bundled code with ``--code h.txt --gen g.txt`` (swept
at -7 .. -4.9 dB as there).  Without them it runs
``make_benchmark_code(1152, 3, 6, seed=0, with_G=True)``, swept over its
waterfall, 1-3 dB (``sigma^2 = 10^(-snr/10)``):

    python examples/torch_pyldpc_style.py --device cpu --batch-size 256
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from libldpc_tpu_torch import LDPC, make_benchmark_code


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--code", help="parity-check codefile (default: the 1152 benchmark code)")
    p.add_argument("--gen", help="generator file of --code")
    p.add_argument("--snr", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   help="sweep, MAX exclusive (default -7 -4.9 1 with --code, else 1 3.01 0.5)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--fec", type=int, default=50, help="frame errors that end a point")
    p.add_argument("--max-frames", type=int, default=int(10e9))
    p.add_argument("--polls", type=int, default=10, help="live polls before the stop")
    p.add_argument("--poll-seconds", type=float, default=2.0)
    p.add_argument("--decode-snr", type=float, default=2.0, help="SNR (dB) of the one-shot decode")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the walk-through; returns the ``LDPC`` object, the decode's
    iterations and bit errors, and H's rank."""
    args = parse_args(argv)
    if args.code:
        ldpc = LDPC(args.code, args.gen or "", device=args.device)
        snr = args.snr or (-7.0, -4.9, 1.0)
    else:
        ldpc = LDPC(code=make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
                    device=args.device)
        snr = args.snr or (1.0, 3.01, 0.5)
    print(f"n={ldpc.n} m={ldpc.m} k={ldpc.k} (transmitted n={ldpc.nct})")
    rank = ldpc.rank()
    print("rank(H) =", rank)

    # --- threaded simulation with live polling -------------------------------
    ldpc.simulate(snr=list(snr), fec=args.fec, batchSize=args.batch_size,
                  maxFrames=args.max_frames)
    for _ in range(args.polls):
        time.sleep(args.poll_seconds)
        res = ldpc.get_results()
        if res and len(res.get("frames", [])):
            print("live:", {k: np.asarray(v).round(4).tolist() for k, v in res.items()})
    ldpc.stop_simulation()
    print("final:", ldpc.get_results())

    # --- one-shot encode / decode --------------------------------------------
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2, ldpc.kct).astype(np.uint8)
    tx = ldpc.encode(u)

    sigma2 = 10 ** (-args.decode_snr / 10)
    y = (1.0 - 2.0 * tx) + rng.normal(size=tx.shape) * np.sqrt(sigma2)
    llr_out, iters = ldpc.decode(2 * y / sigma2)
    decoded = (llr_out <= 0).astype(np.uint8)
    bit_errors = int((decoded != tx).sum())
    print(f"decoded in {iters} iterations; bit errors: {bit_errors}")
    return {"ldpc": ldpc, "iterations": iters, "bit_errors": bit_errors, "rank": rank}


if __name__ == "__main__":
    main()
