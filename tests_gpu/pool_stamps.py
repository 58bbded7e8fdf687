"""Per-phase breakdown of K8's scalar draw (the design before the
tensor-core encode), and the redesigned draw held to it, on the card.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/pool_stamps.py [OUT.json]

It builds ``libldpc_tpu_torch/csrc/dev/pool_stamps.cu`` (the scalar draw, its
arithmetic unchanged, with ``clock64()`` stamps at every phase boundary)
into ``build/dev/``, and on the 1152 (3,6) code, for BPSK at 2.0 dB, 4-ASK
at 7.5 dB (Gray labels, consecutive bits) and the BEC at eps 0.40, with
13,000 of 16,384 pool entries used and with every entry used (a full
batch), prints each phase's share of the summed thread time, the stamped
draw's time and the library's refill (``pool_refill``: its plan and its
draw) on the same pool (CUDA events spanning the device's work alone),
with the card's name and power limit.  The library's pool, drawn from the same Philox key, must equal the
stamped draw's: bit for bit for BPSK and the BEC, within 1e-5 relative for
4-ASK (the redesign keeps the keying and the arithmetic).  With every entry
used it also times and checks the full-batch entry ``channel_batch``.  The
JSON it prints is also written to ``OUT.json`` when that argument is given.
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
PHASES = ("entry", "info_words", "barrier", "encode", "draws", "values", "stores")
CASES = (("BPSK", "AWGN", 2.0), ("4-ASK", "AWGN", 7.5), ("BEC", "BEC", 0.40))
GRAY4 = [0, 1, 3, 2]


def build_stamps(build):
    out_dir = ROOT / "build" / "dev"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "libpool_stamps.so"
    src = build.CSRC / "dev" / "pool_stamps.cu"
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    print(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(out))


def event_ms(fn, reps, setup):
    """Mean device ms of ``fn()`` (CUDA events; the card kept busy ~1 ms
    ahead of the start event, so the host's launch work overlaps it)."""
    setup()
    fn()
    total = 0.0
    for _ in range(reps):
        setup()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_stamps: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import numpy as np

    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops import channel
    from libldpc_tpu_torch.ops import modulation as mod
    from libldpc_tpu_torch.ops.kernels import build
    from libldpc_tpu_torch.ops.kernels import pool_refill as pr
    from libldpc_tpu_torch.ops.kernels.decode_fused import _p, _p_or_null
    from libldpc_tpu_torch.ops.sorted import to_sorted_device

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    lib = build_stamps(build)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dev_stamped_pool_draw.argtypes = ([I, P, I, P, P, I, I, P, P, I, P, P, P, P, I]
                                          + [P] * 6 + [I] + [F] * 6 + [P, P])
    lib.dev_stamped_pool_draw.restype = I
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    build.load()
    if build.last_build_log:  # the library's K8 kernels: registers, spills
        lines = build.last_build_log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and ("pool_" in ln or "stream_grant" in ln):
                print("\n".join(lines[i:i + 4]))
    sdc = to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True), dev)
    result = {"card": card, "batch": BATCH, "code": "make_benchmark_code(1152, 3, 6, seed=0)"}
    go = torch.ones(1, dtype=torch.int32, device=dev)
    key = torch.tensor([0x5EED_1234_5678], dtype=torch.int64, device=dev)
    box = {}
    for kind, channel_type, x in CASES:
        modulation = None
        if kind == "4-ASK":
            modulation = (mod.Constellation.mask(4, GRAY4),
                          sdc.bit_pos[: sdc.nct // 2 * 2].reshape(-1, 2).T.contiguous())
        pt = pr.pool_tables(sdc, channel_type, modulation)
        gcols = pr.pack_columns(sdc.G.cpu().numpy()).view(np.int32)
        gcols = torch.as_tensor(gcols, device=dev)
        vals = torch.uint8 if channel_type == "BEC" else torch.float32
        sigma2 = np.float32(10.0 ** (-float(x) / 10.0))
        awgn = channel_type == "AWGN"
        for used in (13000, BATCH):
            g = torch.Generator(device="cpu").manual_seed(3)
            avail0 = torch.ones(BATCH, dtype=torch.int32)
            avail0[torch.randperm(BATCH, generator=g)[:used]] = 0
            avail0 = avail0.to(dev)

            def reset():
                box["avail"] = avail0.clone()
                box["fresh"] = torch.full((sdc.nc, BATCH), 1 if channel_type == "BEC" else 123.0,
                                          dtype=vals, device=dev)
                box["cw"] = torch.full((sdc.nc, BATCH), 7, dtype=torch.uint8, device=dev)
                box["stamps"] = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)

            def stamped():
                err = lib.dev_stamped_pool_draw(
                    pt.channel, _p(gcols), gcols.shape[1], _p(pt.item_src), _p(pt.item_dst),
                    pt.item_src.shape[0], pt.item_src.shape[1], _p(pt.other_pos),
                    _p(pt.other_short), pt.other_pos.shape[0], _p(pt.points), _p(pt.logp),
                    _p(pt.label_of), _p(pt.point_of), pt.points.shape[0], _p(box["fresh"]),
                    _p(box["cw"]), _p(box["avail"]), _p(go), _p(key), _p_or_null(None), BATCH,
                    float(np.sqrt(sigma2)) if awgn else 0.0,
                    float(np.float32(1.0) / sigma2) if awgn else 0.0,
                    float(np.float32(2.0) * sigma2) if awgn else 0.0, 0.0, float(np.float32(x)),
                    float(np.float32(pr.SHORTEN_LLR)), _p(box["stamps"]), stream)
                if err:
                    raise RuntimeError(f"stamped draw: CUDA error {err}")

            def library():
                pr.pool_refill(pt, None, x, go, box["avail"], box["fresh"], box["cw"],
                               torch.zeros((5, BATCH), dtype=torch.int32, device=dev),
                               torch.zeros(1, dtype=torch.int64, device=dev), 10**9,
                               torch.zeros(1, dtype=torch.int32, device=dev), key=key)

            ms = event_ms(stamped, 5, reset)
            ref = (box["fresh"].clone(), box["cw"].clone(), box["avail"].clone())
            total = box["stamps"].double().sum()
            row = {"drawn": used, "stamped_ms": ms,
                   "shares": {n: float(v / total) for n, v in zip(PHASES, box["stamps"].double())}}
            row["library_refill_ms"] = event_ms(library, 5, reset)
            got = (box["fresh"], box["cw"], box["avail"])
            same_cw = torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
            if kind == "4-ASK":
                rel = float(((got[0] - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).max())
                row["library_vs_stamped"] = {"codewords_equal": same_cw, "max_rel": rel,
                                             "values_equal": torch.equal(got[0], ref[0])}
                ok = same_cw and rel <= 1e-5
            else:
                row["library_vs_stamped"] = {"codewords_equal": same_cw,
                                             "values_equal": torch.equal(got[0], ref[0])}
                ok = same_cw and torch.equal(got[0], ref[0])
            if used == BATCH and hasattr(pr, "channel_batch"):
                row["channel_batch_ms"] = event_ms(
                    lambda: pr.channel_batch(pt, None, BATCH, x, key=key), 5, lambda: None)
                out = pr.channel_batch(pt, None, BATCH, x, key=key)
                same = torch.equal(out.codeword, ref[1])
                same = same and (torch.equal(out.llr, ref[0]) if kind != "4-ASK" else bool(
                    ((out.llr - ref[0]).abs() / ref[0].abs().clamp(min=1.0)).max() <= 1e-5))
                row["channel_batch_vs_stamped"] = same
                ok = ok and same
            result[f"{kind} {channel_type} {x}, {used} of {BATCH} drawn"] = row
            print(json.dumps({f"{kind} {used}": row}), flush=True)
            if not ok:
                raise RuntimeError(f"{kind} {used}: the library's pool differs from the "
                                   f"stamped draw's on the same key")

    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
