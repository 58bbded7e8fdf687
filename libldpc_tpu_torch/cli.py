"""Command-line simulator: the ``ldpcsim`` CLI of :mod:`libldpc_tpu.cli` on
PyTorch, with the decode kernels on a CUDA device.

Same flags as the JAX CLI plus ``--device`` (default ``cuda``) and
``--trace-dir DIR``, which traces the sweep (:func:`..utils.profiling.device_trace`:
``DIR/trace.json`` and ``DIR/counters.json``).
``--channel`` takes AWGN, BSC and BEC.
``--layer-file`` loads the decoding layers and selects the layered
schedule, ``--qc-z N|auto`` declares (or finds) the code's QC lifting, and
``--pallas`` picks between the exact layered schedule and the fast QC
engine exactly as in the JAX CLI.  ``--message-dtype bfloat16|int8``
(with ``--quant-scale`` for the int8 lattice) stores the decoder's
messages in that form when ``--pallas`` is given, on every schedule, as the
JAX CLI does (without it both run float32; past the JAX package's TPU
layout walls both run float32, with its ``fallback[...]`` note); int8
takes a min-sum-family
``--decoding`` (BP_MS, BP_NMS, BP_OMS).  Unlike the JAX package, int8 runs
on codes without a block-local (MXU) permutation plan, such as the
1152-node (3,6) benchmark code: that condition is a TPU transport's.
``--checkpoint FILE`` writes the sweep's checkpoint after every absorbed
batch and at every point boundary, and ``--resume`` continues from it (a
checkpoint of another experiment is ignored with a warning).
``--error-log FILE`` appends a forensic line per errored frame
(``--log-codewords`` adds both words in hex) and turns streaming off, as
in the JAX CLI; with ``--results-dir`` both files go into that directory.
``--devices N`` shards every batch's frames over the first N distinct
devices of ``--device``'s type (0: every visible card; the CPU counts as
one device), ``--points-parallel P`` runs P sweep points at once on a
``(P, devices / P)`` mesh (P must divide the devices used, as in the JAX
CLI), and ``--multihost`` joins a process group from the usual
``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``/``LOCAL_RANK``
environment (one process per device; several may share a card) and
shards over every process's device; then only rank 0 prints and writes.

Usage::

    python -m libldpc_tpu_torch.cli codefile.txt results.txt 0 6 0.2 -G gen.txt
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the JAX package's ``ldpcsim`` CLI, with its defaults
    and choices, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="ldpcsim-torch",
        description="LDPC Monte-Carlo BER/FER simulator on PyTorch / CUDA",
    )
    p.add_argument("codefile", help="LDPC parity-check matrix file containing all non-zero entries.")
    p.add_argument("output_file", metavar="output-file", help="Results output file.")
    p.add_argument("snr_range", metavar="snr-range", nargs=3, type=float,
                   help="{MIN} {MAX} {STEP}")
    p.add_argument("-G", "--gen-matrix", default="", help="Generator matrix file.")
    p.add_argument("-i", "--num-iterations", type=int, default=50,
                   help="Number of iterations for decoding. (Default: 50)")
    p.add_argument("-s", "--seed", type=int, default=0, help="RNG seed. (Default: 0)")
    p.add_argument("-t", "--num-threads", type=int, default=0,
                   help="Deprecated alias; frames are batched on device. "
                        "If set, used as the batch size.")
    p.add_argument("--batch-size", type=int, default=1024,
                   help="Frames decoded per device step. (Default: 1024)")
    p.add_argument("--channel", default="AWGN",
                   help='Specifies channel: "AWGN", "BSC", "BEC" (Default: AWGN)')
    p.add_argument("--decoding", default="BP",
                   help='Specifies decoding algorithm: "BP", "BP_MS"; also "BP_PHI", '
                        '"BP_TANH", "BP_LIN", "BP_NMS", "BP_OMS" (Default: BP)')
    p.add_argument("--max-frames", type=float, default=10e9,
                   help="Limit number of decoded frames.")
    p.add_argument("--frame-error-count", type=int, default=50,
                   help="Maximum frame errors for given simulation point.")
    p.add_argument("--no-early-term", action="store_true",
                   help="Disable early termination for decoding.")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard frames over this many devices (0 = all).")
    p.add_argument("--points-parallel", type=int, default=1,
                   help="Simulate this many sweep points concurrently over a 2-D "
                        "(points x frames) device mesh.")
    p.add_argument("--multihost", action="store_true",
                   help="Join the torch.distributed process group of the environment "
                        "(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK) and "
                        "shard over every process's device (one process per device).")
    p.add_argument("--pallas", action="store_true",
                   help="Choose the layered schedule as the JAX CLI does: with "
                        "--layer-file, a QC code on its natural layers (Z >= 64) "
                        "runs the fast layered engine, otherwise the exact "
                        "layered schedule; with --message-dtype, the decoder "
                        "stores its messages in that dtype.  Flooding and the "
                        "BEC run the same CUDA kernels with or without it.")
    p.add_argument("--message-dtype", default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="Message dtype of the decode kernels (flooding and "
                        "layered), with --pallas (int8: min-sum family only).")
    p.add_argument("--quant-scale", type=float, default=0.1875,
                   help="int8 message lattice step in LLR units.")
    p.add_argument("--layer-file", default="", help="Decoding-layer file for the layered schedule.")
    p.add_argument("--qc-z", default="",
                   help="Declare the code quasi-cyclic with this lifting size "
                        "(verified against H); 'auto' searches the divisors of "
                        "gcd(nc, mc) largest-first.")
    p.add_argument("--checkpoint", default="", help="Sweep checkpoint file (enables --resume).")
    p.add_argument("--resume", action="store_true", help="Resume from checkpoint.")
    p.add_argument("--error-log", default="", help="Per-error-frame forensic log file.")
    p.add_argument("--log-codewords", action="store_true",
                   help="Also dump the decided and true codewords per errored frame.")
    p.add_argument("--results-dir", default="",
                   help="Provision a per-run results directory (created, must not "
                        "already exist) and place the output, checkpoint and "
                        "error-log files inside it.")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the CUDA decode kernels, cpu "
                        "their plain PyTorch versions. (Default: cuda)")
    p.add_argument("--trace-dir", default="",
                   help="Trace the sweep with torch.profiler: its Chrome trace (trace.json) "
                        "and the program's counters (counters.json) are written into this "
                        "directory (by the primary process).")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    snr = args.snr_range
    if snr[0] > snr[1]:
        print("snr min > snr max", file=sys.stderr)
        return 1

    from .models import LDPCCode, detect_qc
    from .parallel import distributed
    from .parallel.mesh import POINT_AXIS, FRAME_AXIS, default_mesh, local_devices, make_mesh
    from .sim.driver import Simulator
    from .utils.params import ChannelParams, DecoderParams, SimulationParams
    from .utils.profiling import device_trace

    primary, mesh = True, None
    if args.multihost:
        distributed.initialize()
        primary = distributed.is_primary()
        mesh = distributed.global_mesh(args.device)
    out = print if primary else (lambda *a, **k: None)

    if args.results_dir:
        # a fresh per-run directory holding the run's output file (made by
        # the primary process, which alone writes into it)
        if primary and os.path.exists(args.results_dir):
            print(
                f"results dir {args.results_dir!r} already exists — "
                "refusing to overwrite a previous run",
                file=sys.stderr,
            )
            return 1
        if primary:
            os.makedirs(args.results_dir)
        args.output_file = os.path.join(args.results_dir, os.path.basename(args.output_file))
        if args.checkpoint:
            args.checkpoint = os.path.join(args.results_dir, os.path.basename(args.checkpoint))
        if args.error_log:
            args.error_log = os.path.join(args.results_dir, os.path.basename(args.error_log))

    code = LDPCCode.from_files(args.codefile, args.gen_matrix, args.layer_file)
    if args.qc_z:
        # raises when H is not QC at this Z (or, for 'auto', at any Z)
        detect_qc(code, None if args.qc_z == "auto" else int(args.qc_z))
        if args.qc_z == "auto":
            out(f"QC structure detected: Z = {code.qc[0]}")
    bar = "=" * 88
    out(bar)
    out(f"Parity-Check Matrix: {args.codefile}")
    out(f"Generator Matrix: {args.gen_matrix}")
    out(code.summary())
    out(bar)

    # every device of the job with --multihost, else this host's distinct
    # devices of --device's type
    if mesh is not None:
        devices, owners = list(mesh.devices.ravel()), mesh.processes.ravel()
    else:
        devices = local_devices(args.device)
        owners = [distributed.process_index()] * len(devices)
    wide_mesh = None
    if args.points_parallel > 1:
        use = args.devices or len(devices)
        if use % args.points_parallel:
            print(f"--points-parallel {args.points_parallel} does not divide {use} devices",
                  file=sys.stderr)
            return 1
        wide_mesh = make_mesh((args.points_parallel, use // args.points_parallel),
                              (POINT_AXIS, FRAME_AXIS), devices[:use], owners[:use])
    elif mesh is None and args.devices != 1 and len(devices) > 1:
        mesh = default_mesh(args.devices or None, args.device)

    batch = args.num_threads if args.num_threads > 0 else args.batch_size
    try:
        sim = Simulator(
            code,
            DecoderParams(
                early_term=not args.no_early_term,
                iterations=args.num_iterations,
                type=args.decoding,
                layered=bool(args.layer_file),
                message_dtype=args.message_dtype,
                quant_scale=args.quant_scale,
            ),
            ChannelParams(seed=args.seed, x_range=tuple(snr), type=args.channel),
            SimulationParams(
                batch_size=batch,
                max_frames=int(args.max_frames),
                fec=args.frame_error_count,
                result_file=args.output_file,
                checkpoint_file=args.checkpoint or None,
                error_log_file=args.error_log or None,
                error_log_codewords=args.log_codewords,
            ),
            device=args.device,
            use_pallas=args.pallas,
            mesh=mesh,
            verbose=primary,
        )
    except (NotImplementedError, ValueError) as e:
        # refused before any results file is written
        print(e, file=sys.stderr)
        return 2
    out("== Decoder Parameters")
    out(f"Type: {args.decoding}\nIterations: {args.num_iterations}\n"
        f"Early Termination: {int(not args.no_early_term)}")
    out("== Channel Parameters")
    out(f"Type: {args.channel}\nSeed: {args.seed}\n"
        f"Range: [{snr[0]}, {snr[1]}], step {snr[2]}")
    out("== Simulation Parameters")
    out(f"Batch size: {batch}\nMax frames: {int(args.max_frames)}\n"
        f"Frame error count: {args.frame_error_count}\n"
        f"Result file: {args.output_file}\nDecode path: {sim.decode_path}\n"
        f"Engine: {sim.engine}")
    out(bar)
    try:
        with device_trace(args.trace_dir if primary else None, sim.device):
            if wide_mesh is not None:
                sim.start_wide(wide_mesh, resume=args.resume)
            else:
                sim.start(resume=args.resume)
    except KeyboardInterrupt:
        # the checkpoint on disk is the last one written
        print("\ninterrupted — partial results written", file=sys.stderr)
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
