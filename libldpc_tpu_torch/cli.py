"""Command-line simulator: the ``ldpcsim`` CLI of :mod:`libldpc_tpu.cli` on
PyTorch, with the decode kernels on a CUDA device.

Same flags as the JAX CLI plus ``--device`` (default ``cuda``).
``--layer-file`` loads the decoding layers and selects the layered
schedule, ``--qc-z N|auto`` declares (or finds) the code's QC lifting, and
``--pallas`` picks between the exact layered schedule and the fast QC
engine exactly as in the JAX CLI.  Flags for what the port does not cover
yet are refused with an error naming the ROADMAP item by its title; none
is silently ignored.

Usage::

    python -m libldpc_tpu_torch.cli codefile.txt results.txt 0 6 0.2 -G gen.txt
"""

from __future__ import annotations

import argparse
import os
import sys

from libldpc_tpu.cli import build_parser as _jax_parser

_CHECKPOINT = 'ROADMAP Queue 1, "Checkpoint/resume and the forensic error log"'
_MULTI_GPU = 'ROADMAP Queue 1, "Multi-GPU"'

#: flag -> (value it must keep, ROADMAP item that ports it)
_NOT_PORTED = {
    "checkpoint": ("", _CHECKPOINT),
    "resume": (False, _CHECKPOINT),
    "error_log": ("", _CHECKPOINT),
    "log_codewords": (False, _CHECKPOINT),
    "points_parallel": (1, _MULTI_GPU),
    "multihost": (False, _MULTI_GPU),
    "message_dtype": ("float32", 'ROADMAP Queue 1, "bf16/int8 message forms of kernels 1-2"'),
}


def build_parser() -> argparse.ArgumentParser:
    p = _jax_parser()
    p.prog = "ldpcsim-torch"
    p.description = "LDPC Monte-Carlo BER/FER simulator on PyTorch / CUDA"
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA decode kernels, cpu "
                        "their plain PyTorch versions. (Default: cuda)")
    for action in p._actions:
        if action.dest == "pallas":
            action.help = ("Choose the layered schedule as the JAX CLI does: with "
                           "--layer-file, a QC code on its natural layers (Z >= 64) "
                           "runs the fast layered engine, otherwise the exact "
                           "layered schedule.  Flooding runs the same CUDA kernels "
                           "with or without it.")
    return p


def refused_flags(args) -> list[str]:
    """Messages for every flag set to something the port does not run."""
    out = [
        f"--{dest.replace('_', '-')}: not ported yet ({item})"
        for dest, (keep, item) in _NOT_PORTED.items()
        if getattr(args, dest) != keep
    ]
    if args.devices not in (0, 1):
        out.append(f"--devices: multi-GPU sweeps are not ported yet ({_MULTI_GPU})")
    if args.channel == "BEC":
        out.append('--channel BEC: not ported yet (ROADMAP Queue 1, "BEC")')
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    snr = args.snr_range
    if snr[0] > snr[1]:
        print("snr min > snr max", file=sys.stderr)
        return 1
    refused = refused_flags(args)
    if refused:
        for msg in refused:
            print(msg, file=sys.stderr)
        return 2

    if args.results_dir:
        # a fresh per-run directory holding the run's output file
        if os.path.exists(args.results_dir):
            print(
                f"results dir {args.results_dir!r} already exists — "
                "refusing to overwrite a previous run",
                file=sys.stderr,
            )
            return 1
        os.makedirs(args.results_dir)
        args.output_file = os.path.join(args.results_dir, os.path.basename(args.output_file))

    from libldpc_tpu.models.code import LDPCCode
    from libldpc_tpu.utils.params import ChannelParams, DecoderParams, SimulationParams

    from .models import detect_qc
    from .sim.driver import Simulator

    code = LDPCCode.from_files(args.codefile, args.gen_matrix, args.layer_file)
    if args.qc_z:
        # raises when H is not QC at this Z (or, for 'auto', at any Z)
        detect_qc(code, None if args.qc_z == "auto" else int(args.qc_z))
        if args.qc_z == "auto":
            print(f"QC structure detected: Z = {code.qc[0]}")
    bar = "=" * 88
    print(bar)
    print(f"Parity-Check Matrix: {args.codefile}")
    print(f"Generator Matrix: {args.gen_matrix}")
    print(code.summary())
    print(bar)

    batch = args.num_threads if args.num_threads > 0 else args.batch_size
    sim = Simulator(
        code,
        DecoderParams(
            early_term=not args.no_early_term,
            iterations=args.num_iterations,
            type=args.decoding,
            layered=bool(args.layer_file),
        ),
        ChannelParams(seed=args.seed, x_range=tuple(snr), type=args.channel),
        SimulationParams(
            batch_size=batch,
            max_frames=int(args.max_frames),
            fec=args.frame_error_count,
            result_file=args.output_file,
        ),
        device=args.device,
        use_pallas=args.pallas,
    )
    print("== Decoder Parameters")
    print(f"Type: {args.decoding}\nIterations: {args.num_iterations}\n"
          f"Early Termination: {int(not args.no_early_term)}")
    print("== Channel Parameters")
    print(f"Type: {args.channel}\nSeed: {args.seed}\n"
          f"Range: [{snr[0]}, {snr[1]}], step {snr[2]}")
    print("== Simulation Parameters")
    print(f"Batch size: {batch}\nMax frames: {int(args.max_frames)}\n"
          f"Frame error count: {args.frame_error_count}\n"
          f"Result file: {args.output_file}\nDecode path: {sim.decode_path}")
    print(bar)
    try:
        sim.start()
    except KeyboardInterrupt:
        print("\ninterrupted — partial results written", file=sys.stderr)
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
