"""Per-phase breakdown of the kernel designs that keep every message in HBM
planes (the layered streaming chunk's HBM-plane form, the byte-plane BEC
peeling decode and the flooding streaming chunk), on the card.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/phase_breakdown.py [OUT.json]

It builds ``libldpc_tpu_torch/csrc/dev/phase_stamps.cu`` (copies of the three
designs with ``clock64()`` stamps at every phase boundary) into
``build/dev/``, runs

* the layered chunk on wifi 1944, BP and BP_MS, float32, 6 passes from a
  full pool at 1.5 dB, B = 16384,
* the peeling decode on the 1152 (3,6) code at eps 0.40, 50 iterations
  without early termination, B = 16384, and
* the flooding streaming chunk on the 1152 (3,6) code, BP and BP_MS,
  float32, 6 passes from a full pool at 1.5 dB, B = 16384,

and prints each phase's share of the summed warp time (a warp's wait at a
barrier is a phase of its own), the stamped kernel's time and the library
kernel's time on the same inputs (CUDA events), with the card's name and
power limit.  The JSON it prints is also written to ``OUT.json`` when that
argument is given.
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
LAYERED_PHASES = ("entry_exit", "reload", "layer_checks", "layer_barriers", "syndrome", "counting")
BEC_PHASES = ("init", "cn_phase", "vn_phase", "barriers", "decisions")
FLOOD_PHASES = ("entry_exit", "reload", "check_phase", "variable_phase", "syndrome", "counting")


def build_stamps(build):
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libphase_stamps.so"
    src = build.CSRC / "dev" / "phase_stamps.cu"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    print(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def event_ms(fn, reps, setup):
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def shares(stamps, names):
    vals = stamps.tolist()
    total = float(sum(vals))
    return {n: v / total for n, v in zip(names, vals)}


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_breakdown: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import make_benchmark_code, wifi_code
    from libldpc_tpu_torch.ops.channel import awgn_channel, bec_channel, make_generator
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import decode_bec as db
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels import decode_layered as dl
    from libldpc_tpu_torch.ops.kernels.decode_fused import _p, cn_mode_args
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import init_state

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    lib = build_stamps(build)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dev_stamped_stream_chunk_layered_fast.argtypes = [P] * 19 + [I] * 9 + [F, F, P, P]
    lib.dev_stamped_stream_chunk_layered_fast.restype = I
    lib.dev_stamped_bec_decode_bytes.argtypes = [P] * 12 + [I] * 6 + [P, P]
    lib.dev_stamped_bec_decode_bytes.restype = I
    lib.dev_stamped_stream_chunk_flooding.argtypes = [P] * 19 + [I] * 8 + [F, F, P, P]
    lib.dev_stamped_stream_chunk_flooding.restype = I
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    result = {"card": card, "batch": BATCH}

    # ---- the layered chunk: wifi 1944, 6 passes from a full pool at 1.5 dB
    tb = kernel_tables(to_sorted_device(wifi_code(1944), dev, with_layers=True))
    sdc = tb.code
    ch = awgn_channel(sdc, make_generator(dev, 7, 2, 0), BATCH, 1.5)
    refill = torch.ones(1, dtype=torch.int32, device=dev)
    box = {}

    def reset():
        st = init_state(tb, BATCH)
        st.fresh_llr.copy_(ch.llr)
        st.fresh_cw.copy_(ch.codeword)
        st.avail.fill_(1)
        box["st"] = st
        box["rem"] = torch.full((1,), BATCH, dtype=torch.int32, device=dev)
        box["stamps"] = torch.zeros(len(LAYERED_PHASES), dtype=torch.int64, device=dev)

    for form in ("BP", "BP_MS"):
        mode, scale, offset = cn_mode_args(form)

        def stamped():
            st = box["st"]
            err = lib.dev_stamped_stream_chunk_layered_fast(
                _p(st.llr_in), _p(st.codeword), _p(st.lv2c), _p(st.done), _p(st.iters),
                _p(st.age), _p(st.avail), _p(st.ctr), _p(st.fresh_llr), _p(st.fresh_cw),
                _p(refill), _p(box["rem"]), _p(tb.row_ptr), _p(tb.col_sorted), _p(tb.vn_ptr),
                _p(tb.perm_c2v), _p(tb.layer_ptr), _p(tb.layer_checks), _p(tb.bit_pos),
                sdc.nc, sdc.mc, sdc.nnz, tb.n_layers, sdc.nct, BATCH, 6, ITERS, mode, scale,
                offset, _p(box["stamps"]), stream)
            if err:
                raise RuntimeError(f"stamped layered chunk: CUDA error {err}")

        def library():
            st = box["st"]
            dl.bp_stream_chunk_layered_fast(
                tb, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail, st.ctr,
                st.fresh_llr, st.fresh_cw, refill, box["rem"], k=6, cap=ITERS, minsum_mode=form)

        ms = event_ms(stamped, 5, reset)
        stamped_totals = box["st"].ctr.sum(1).tolist()
        row = {"stamped_ms": ms, "shares": shares(box["stamps"], LAYERED_PHASES)}
        row["library_kernel_ms"] = event_ms(library, 5, reset)
        if box["st"].ctr.sum(1).tolist() != stamped_totals and form == "BP_MS":
            raise RuntimeError("the stamped chunk and the library kernel count differently")
        row["frame_passes"] = int(box["st"].age.sum()) - int(box["st"].ctr[4].sum())
        result[f"layered_chunk wifi1944 {form} f32 6 passes 1.5 dB"] = row

    # ---- the byte-plane peeling decode: 1152 code, eps 0.40, 50 it, no ET
    tb6 = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev))
    c6 = tb6.code
    ch6 = bec_channel(c6, make_generator(dev, 8, 2, 0), BATCH, 0.40)
    out = {k: torch.empty_like(ch6.llr) for k in ("sym", "hard")}
    msgs = [torch.empty((c6.nnz, BATCH), dtype=torch.uint8, device=dev) for _ in range(2)]
    ints = [torch.empty(BATCH, dtype=torch.int32, device=dev) for _ in range(2)]
    for et in (0, 1):
        def reset6():
            box["stamps"] = torch.zeros(len(BEC_PHASES), dtype=torch.int64, device=dev)

        def stamped6():
            err = lib.dev_stamped_bec_decode_bytes(
                _p(ch6.llr), _p(ch6.codeword), _p(out["sym"]), _p(out["hard"]), _p(ints[0]),
                _p(ints[1]), _p(msgs[0]), _p(msgs[1]), _p(tb6.row_ptr), _p(tb6.col_sorted),
                _p(tb6.vn_ptr), _p(tb6.perm_c2v), c6.nc, c6.mc, c6.nnz, BATCH, ITERS, et,
                _p(box["stamps"]), stream)
            if err:
                raise RuntimeError(f"stamped peeling decode: CUDA error {err}")

        ms = event_ms(stamped6, 5, reset6)
        want = db.bec_decode_fused(tb6, ch6.llr, ch6.codeword, ITERS, bool(et))
        if not (torch.equal(out["sym"], want.symbols_out) and torch.equal(ints[0], want.iterations)):
            raise RuntimeError("the stamped peeling decode and the library kernel differ")
        result[f"bec_bytes bench1152 eps 0.40 {ITERS} it et={et}"] = {
            "stamped_ms": ms, "shares": shares(box["stamps"], BEC_PHASES),
            "library_kernel_ms": event_ms(
                lambda: db.bec_decode_fused(tb6, ch6.llr, ch6.codeword, ITERS, bool(et)), 5,
                lambda: None),
            "avg_iter": float(want.iterations.float().mean()),
        }

    # ---- the flooding streaming chunk: 1152 code, 6 passes from a full pool at 1.5 dB
    tb2 = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev))
    c2 = tb2.code
    ch2 = awgn_channel(c2, make_generator(dev, 7, 2, 0), BATCH, 1.5)
    scratch2 = {"lc2v": torch.empty((c2.nnz, BATCH), device=dev),
                "post": torch.empty((c2.nc, BATCH), device=dev)}

    def reset2():
        st = init_state(tb2, BATCH)
        st.fresh_llr.copy_(ch2.llr)
        st.fresh_cw.copy_(ch2.codeword)
        st.avail.fill_(1)
        box["st"] = st
        box["rem"] = torch.full((1,), BATCH, dtype=torch.int32, device=dev)
        box["stamps"] = torch.zeros(len(FLOOD_PHASES), dtype=torch.int64, device=dev)

    for form in ("BP", "BP_MS"):
        mode, scale, offset = cn_mode_args(form)

        def stamped2():
            st = box["st"]
            err = lib.dev_stamped_stream_chunk_flooding(
                _p(st.llr_in), _p(st.codeword), _p(st.lv2c), _p(scratch2["lc2v"]),
                _p(scratch2["post"]), _p(st.done), _p(st.iters), _p(st.age), _p(st.avail),
                _p(st.ctr), _p(st.fresh_llr), _p(st.fresh_cw), _p(refill), _p(box["rem"]),
                _p(tb2.row_ptr), _p(tb2.col_sorted), _p(tb2.vn_ptr), _p(tb2.perm_c2v),
                _p(tb2.bit_pos), c2.nc, c2.mc, c2.nnz, c2.nct, BATCH, 6, ITERS, mode, scale,
                offset, _p(box["stamps"]), stream)
            if err:
                raise RuntimeError(f"stamped flooding chunk: CUDA error {err}")

        def library2():
            st = box["st"]
            df.bp_stream_chunk_fused(
                tb2, st.llr_in, st.codeword, st.lv2c, st.done, st.iters, st.age, st.avail,
                st.ctr, st.fresh_llr, st.fresh_cw, refill, box["rem"], k=6, cap=ITERS,
                minsum_mode=form)

        ms = event_ms(stamped2, 5, reset2)
        stamped_totals = box["st"].ctr.sum(1).tolist()
        row = {"stamped_ms": ms, "shares": shares(box["stamps"], FLOOD_PHASES)}
        row["library_kernel_ms"] = event_ms(library2, 5, reset2)
        if box["st"].ctr.sum(1).tolist() != stamped_totals and form == "BP_MS":
            raise RuntimeError("the stamped flooding chunk and the library kernel count differently")
        row["frame_passes"] = int(box["st"].age.sum()) - int(box["st"].ctr[4].sum())
        row["library_form"] = df.bp_stream_chunk_fused.last_form
        result[f"flooding_chunk bench1152 {form} f32 6 passes 1.5 dB"] = row

    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
