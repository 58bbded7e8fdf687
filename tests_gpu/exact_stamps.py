"""Per-phase cycles of the exact layered kernel's 4-frame tile (K5) on the
802.11n n=1944 code in float32, on the card: its index tables 16-bit and
staged in shared memory (the size rule's form), 16-bit in device memory,
and int32 in device memory (the tile as it was before its tables were
16-bit); its frames' priors staged in shared memory (the rule's form),
with the variable phase a variable's 4 frames a thread, each slot's frames
one 16-byte row (the library's), or a frame a thread, or the priors read
from device memory at every variable phase with a frame a thread (the
library's without staged priors).

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/exact_stamps.py [OUT.json]

It builds ``libldpc_tpu_torch/csrc/dev/exact_stamps.cu`` (a copy of the
tile's decode with ``clock64()`` stamps at every phase boundary) into
``build/dev/``, and runs each table form at B = 16384 on

* 1.5 dB, 50 iterations without early termination, BP and BP_MS (the
  inputs ``tests_gpu/k5_forms.py`` times), and
* 2.0 dB, at most 50 iterations with early termination, BP (the
  ``--layer-file`` sweep's point in the benchmark),

held bit for bit against the library's tile on the same inputs (the
16-bit forms forced with ``EXACT_FORM_OVERRIDE``, priors included; the
int32 row against the unstaged tile).  For each it prints
each phase's share of the summed warp time and its cycles per warp and
layer step (a warp's wait at a barrier is a phase of its own), the
stamped kernel's time and the library kernel's (CUDA events), with the
card's name and power limit.  The JSON it prints is also written to
``OUT.json`` when that argument is given.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCH = 16384
ITERS = 50
PHASES = ("entry_exit", "iteration_vote", "checks", "check_barrier", "variables",
          "syndrome_vote", "syndrome", "syndrome_barrier")
WARPS_A_BLOCK = 512 // 32
#: (label, 16-bit tables, staged, priors staged, the variable phase a
#: variable's frames a thread): the library's 16-bit forms, the priors
#: staged with a frame a thread, and int32 tables in device memory
TABLE_FORMS = (("16-bit staged, priors staged, rows", True, True, True, True),
               ("16-bit staged, priors staged, a frame a thread", True, True, True, False),
               ("16-bit staged", True, True, False, False),
               ("16-bit unstaged", True, False, False, False),
               ("int32 unstaged", False, False, False, False))
#: (label, CN form, SNR dB, early termination)
CASES = (("BP 1.5 dB no-ET", "BP", 1.5, False), ("BP_MS 1.5 dB no-ET", "BP_MS", 1.5, False),
         ("BP 2.0 dB ET", "BP", 2.0, True))


def build_stamps(build):
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libexact_stamps.so"
    src = build.CSRC / "dev" / "exact_stamps.cu"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    print(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def event_ms(fn, reps):
    fn()
    total = 0.0
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("exact_stamps: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import wifi_code
    from libldpc_tpu_torch.ops.channel import awgn_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels.decode_fused import _p, cn_mode_args
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    lib = build_stamps(build)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dev_stamped_exact_tile4.argtypes = [P] * 13 + [I] * 10 + [F, F, I, I, I, P, P]
    lib.dev_stamped_exact_tile4.restype = I
    if lib.dev_n_exact_phases() != len(PHASES):
        raise RuntimeError("exact_stamps.cu and this script name different phases")
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    tb = kernel_tables(to_sorted_device(wifi_code(1944), dev, with_layers=True))
    c = tb.code
    shape = (c.nc, c.mc, c.nnz, tb.n_layers, tb.layer_checks.shape[0], tb.layer_vars.shape[0],
             BATCH)
    result = {"card": card, "batch": BATCH, "iterations": ITERS,
              "rule": list(dl.exact_form(tb, "float32")), "cases": {}}
    out = {"post": torch.empty((c.nc, BATCH), device=dev),
           "iters": torch.empty(BATCH, dtype=torch.int32, device=dev),
           "iscw": torch.empty(BATCH, dtype=torch.int32, device=dev)}
    for label, form, snr, et in CASES:
        llr = awgn_channel(c, make_generator(dev, 7, 2, 0), BATCH, snr).llr
        mode, scale, offset = cn_mode_args(form)
        for tlabel, sixteen, stage, priors, rows in TABLE_FORMS:
            stamps = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=dev)

            def stamped():
                stamps.zero_()
                err = lib.dev_stamped_exact_tile4(
                    _p(llr), _p(out["post"]), _p(out["iters"]), _p(out["iscw"]), _p(tb.row_ptr),
                    _p(tb.col_sorted), _p(tb.vn_ptr), _p(tb.perm_c2v), _p(tb.layer_ptr),
                    _p(tb.layer_checks), _p(tb.layer_var_ptr), _p(tb.layer_vars),
                    _p(tb.exact16) if sixteen else P(None), *shape, ITERS, int(et), mode, scale,
                    offset, int(stage), int(priors), int(rows), _p(stamps), stream)
                if err:
                    raise RuntimeError(f"stamped 4-frame tile: CUDA error {err}")

            def library():
                dl.EXACT_FORM_OVERRIDE = (4, stage, priors)
                try:
                    return dl.bp_decode_layered(tb, llr, ITERS, et, form)
                finally:
                    dl.EXACT_FORM_OVERRIDE = None

            ms = event_ms(stamped, 3)
            want = library()
            torch.cuda.synchronize()
            if not (torch.equal(out["post"], want.llr_out)
                    and torch.equal(out["iters"], want.iterations)
                    and torch.equal(out["iscw"] > 0, want.is_codeword)):
                raise RuntimeError(f"{label} {tlabel}: the stamped tile and the library differ")
            vals = stamps.tolist()
            total, steps = float(sum(vals[:-1])), vals[-1]
            warp_steps = steps * WARPS_A_BLOCK
            row = {
                "stamped_ms": ms,
                "library_kernel_ms": event_ms(library, 3),
                "layer_steps": steps,
                "shares": {n: v / total for n, v in zip(PHASES, vals)},
                "cycles_per_warp_layer_step": {n: v / warp_steps for n, v in zip(PHASES, vals)},
                "avg_iter": float(want.iterations.float().mean()),
            }
            result["cases"][f"{label} {tlabel}"] = row
            print(f"stamps K5 tile4 wifi1944 f32 {label} {tlabel} B={BATCH}: stamped "
                  f"{ms:.3f} ms, library (4, {stage}, priors {priors}) "
                  f"{row['library_kernel_ms']:.3f} ms, "
                  f"{steps} layer steps; cycles a warp and layer step: "
                  + ", ".join(f"{n} {v:.0f} ({row['shares'][n]:.1%})"
                              for n, v in row["cycles_per_warp_layer_step"].items())
                  + f" [{card}]", flush=True)
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        path = pathlib.Path(sys.argv[1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
