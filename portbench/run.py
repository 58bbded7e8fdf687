"""Run one cell of the benchmark of ``libldpc_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
Prints the result as one JSON line, last on standard output, and each
compared number beside its limit, last on standard error.  Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell asks
for), or when the run loads JAX or the JAX package.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench" / "cache"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import harness, spec

    cell = spec.resolve(spec.load_benchmark(ROOT), args.workload, ROOT)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {torch.cuda.device_count()} cards, the cell asks for {cell.chips}",
              file=sys.stderr)
        return 2
    return harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS, ROOT)


if __name__ == "__main__":
    sys.exit(main())
