"""A ``torch.profiler`` window of the flooding ET sweep's streaming
super-step on the card: where the device time goes and how busy the card is.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/profile_window.py [OUT.json]

The super-step is the one ``ldpcsim-torch`` runs for the default sweep
(``make_streaming_fused_step``: AWGN, BP, 50 iterations, early termination,
streaming) on the 1152 (3,6) code at 2.0 dB, float32 messages, B = 16384.
After 8 warm super-steps, 6 run under the profiler, ended by a
synchronise; the host clock spans the window.  It prints, per super-step,
the wall time, the device time by kernel name and by part (the streaming
kernel K2; the channel's float32 ``u G`` product, its normal draws and
its elementwise work, the pool merge included; the counters' reductions),
and the card's busy share: the union of the kernels' device intervals over
the window's span.  The window runs once for the form of the streaming
kernel that the size rule picks and once for its HBM-plane form
(``decode_fused.STREAM_FORM_OVERRIDE``).  The JSON is also written to
``OUT.json`` when given.  Card name and power limit are
printed with it.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BATCH = 16384
SNR_DB = 2.0
WARM, WINDOW = 8, 6


def part_of(name: str) -> str:
    low = name.lower()
    if "stream_chunk" in low:
        return "k2_stream_chunk"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "matmul" in low:
        return "channel_matmul"
    if "normal" in low or "philox" in low or "distribution" in low or "rand" in low:
        return "channel_randn"
    if "reduce" in low:
        return "counter_reductions"
    return "channel_elementwise"


def device_events(prof):
    """(name, start_us, end_us) of every kernel the profiler saw on the card."""
    out = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.time_range is not None:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def union_us(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window(step_fn, state, gen_seed: int):
    from libldpc_tpu_torch.ops.channel import make_generator

    dev = state.llr_in.device
    for i in range(WARM):
        state, _ = step_fn(state, make_generator(dev, gen_seed, 0, i), SNR_DB, True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        accs = []
        for i in range(WINDOW):
            state, acc = step_fn(state, make_generator(dev, gen_seed, 1, i), SNR_DB, True)
            accs.append(acc.frames)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    frames = int(sum(int(a) for a in accs))
    kernels = device_events(prof)
    by_name, by_part = {}, {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        part = part_of(name)
        by_part[part] = by_part.get(part, 0.0) + (e - s)
    span_us = (max(e for _, _, e in kernels) - min(s for _, s, _ in kernels)) if kernels else 0.0
    device_us = sum(by_part.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return state, {
        "supersteps": WINDOW,
        "wall_ms_per_superstep": wall_s * 1e3 / WINDOW,
        "frames": frames,
        "frames_per_s_host": frames / wall_s,
        "kernels_seen": len(kernels),
        "device_ms_per_superstep": device_us / 1e3 / WINDOW,
        "busy_share_of_wall": device_us / 1e6 / wall_s,
        "busy_share_of_kernel_span": union_us([(s, e) for _, s, e in kernels]) / span_us
        if span_us else None,
        "share_of_device_time": {k: v / device_us for k, v in sorted(by_part.items())}
        if device_us else {},
        "ms_per_superstep": {k: v / 1e3 / WINDOW for k, v in sorted(by_part.items())},
        "top_kernels_ms_per_superstep": [(n[:90], v / 1e3 / WINDOW) for n, v in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_window: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import DecoderParams

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    tables = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
                                            dev))
    result = {"card": card, "batch": BATCH, "snr_db": SNR_DB, "code": "bench1152 f32 BP"}
    for label, forced in (("rule", None), ("hbm-planes", (0, False))):
        df.STREAM_FORM_OVERRIDE = forced
        init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", DecoderParams(iterations=50),
                                                     BATCH)
        _, row = window(step_fn, init_fn(), 11)
        row["k2_form"] = df.bp_stream_chunk_fused.last_form
        result[f"window {label}"] = row
    df.STREAM_FORM_OVERRIDE = None
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1:
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
