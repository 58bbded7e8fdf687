"""The smoke run's CLI sweeps from any checkout of the port, for comparing
two commits on one card in one call.

    python3 tests_gpu/cli_sweeps.py <root of a checkout>

It imports ``libldpc_tpu_torch`` from that root, writes the code files
under ``<root>/build/sweeps/`` and runs, with ``--pallas -i 50
--batch-size 16384`` and the seeds of the defaults: the 802.11n n=1944
layered sweep (1.0-2.5 dB) in float32 BP, bfloat16 BP and int8 BP_OMS, the
n=648 exact layered point at 2.0 dB, the BEC sweep (eps 0.30-0.45) and the
flooding sweep (1.0-3.0 dB) of the 1152 (3,6) code.  Each results file is
printed after its run time.  The channel draws come from seeded
generators, so two commits that decode alike print the same rows (the
``frame_time`` column aside).
"""

import pathlib
import sys
import time


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    from libldpc_tpu_torch import cli
    from libldpc_tpu_torch.models import (
        make_benchmark_code, wifi_code, write_codefile, write_layerfile,
    )

    work = root / "build" / "sweeps"
    work.mkdir(parents=True, exist_ok=True)
    codes = {"bench1152": make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
             "wifi1944": wifi_code(1944), "wifi648": wifi_code(648)}

    def run(key, out, snrs, *flags, layered=False):
        code = codes[key]
        write_codefile(str(work / f"{key}_h.txt"), code.rows, code.cols, code.nc, code.mc)
        r, c = code.G.nonzero()
        (work / f"{key}_g.txt").write_text("".join(f"{i} {j}\n" for i, j in zip(r, c)))
        args = [str(work / f"{key}_h.txt"), str(work / out), *snrs, "-G", str(work / f"{key}_g.txt"),
                "-i", "50", "--batch-size", "16384", "--pallas", *flags]
        if layered:
            write_layerfile(str(work / f"{key}_layers.txt"), code.layers)
            args += ["--layer-file", str(work / f"{key}_layers.txt")]
        t0 = time.perf_counter()
        if cli.main(args) != 0:
            raise RuntimeError(f"CLI run {out} failed")
        print(f"--- {out} ({time.perf_counter() - t0:.1f} s)\n{(work / out).read_text()}", end="",
              flush=True)

    sweep = ["1.0", "2.51", "0.5"]
    cap = ["--frame-error-count", "50", "--max-frames", "1000000"]
    run("wifi1944", "res_layered.txt", sweep, "--qc-z", "81", "--frame-error-count", "50",
        "--max-frames", "4000000", layered=True)
    run("wifi1944", "res_layered_bf16.txt", sweep, "--qc-z", "81", "--message-dtype", "bfloat16",
        "--decoding", "BP", *cap, layered=True)
    run("wifi1944", "res_layered_int8.txt", sweep, "--qc-z", "81", "--message-dtype", "int8",
        "--decoding", "BP_OMS", *cap, layered=True)
    run("wifi648", "res_layered_648.txt", ["2.0", "2.01", "1"], "--frame-error-count", "50",
        "--max-frames", str(4 * 16384), layered=True)
    run("bench1152", "res_bec.txt", ["0.30", "0.451", "0.05"], "--channel", "BEC",
        "--frame-error-count", "50", "--max-frames", "2000000")
    run("bench1152", "res.txt", ["1.0", "3.01", "0.5"], "--frame-error-count", "50",
        "--max-frames", "2000000")
    return 0


if __name__ == "__main__":
    sys.exit(main())
