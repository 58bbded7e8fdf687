"""A ``torch.profiler`` window of the flooding ET sweep's streaming
super-step on the card: where the device time goes and how busy the card is.

Run from the repo root on a machine with one NVIDIA H100:

    python3 tests_gpu/profile_window.py [OUT.json] [--root DIR]

``--root`` imports ``libldpc_tpu_torch`` from another checkout (a
``git archive`` of a parent commit), so two trees are compared in one call
by running this file, from the newer tree, on each in turns.

The super-step is the one ``ldpcsim-torch`` runs for the default sweep
(``make_streaming_fused_step``: AWGN, BP, 50 iterations, early termination,
streaming) on the 1152 (3,6) code at 2.0 dB, float32 messages, B = 16384.
After 8 warm super-steps, 6 run under the profiler, ended by a
synchronise; the host clock spans the window.  It prints, per super-step,
the wall time, the device time by kernel name and by part, and the card's
busy share: the union of the kernels' device intervals over
the window's span.  The window runs once for the form of the streaming
kernel that the size rule picks and once for its HBM-plane form
(``decode_fused.STREAM_FORM_OVERRIDE``), then once more in the rule's form
with the pool drawn through 4-ASK (Gray labels ``0 1 3 2``, the transmitted
bits mapped consecutively) at 7.5 dB, where the 1152 code's ``avg_iter``
is close to BPSK's at 2.0 dB.  Where the tree has it, one more window runs
the default sweep's engine, the JAX package's XLA super-step
(``ops.streaming.make_streaming_step``: per pass a one-pass K2 launch, then
K8's reload form, ``stream_reload``, run inside the channel's range).

A kernel's part is set by where it was launched: the pool's refill (the
streaming step's ``pool_refill``, K8, or in a tree before it its
``simulate_channel``, run inside a ``record_function`` range of its own,
whose span on the card holds the kernels launched in it) or the rest of
the super-step.  In the channel: K8's plan and draw kernels, or a channel
batch's float32 ``u G`` product, its normal draws, its reductions (4-ASK:
the labels' packing and the bitwise LLRs' logsumexps) and its elementwise
work.  Outside it: the streaming kernel K2, the grants in lane order, the
draw of K8's keys, the elementwise work (before K8: the pool merge) and
the counters' reductions; in the XLA super-step's window the reload's
plan (``reload_plan``) is a part of its own, its draw is K8's (its staged
form, where the tree has it, ``channel_k8_staged``: the draw into the
staging buffer), and the elementwise work is the super-step's own.  The JSON is also written to
``OUT.json`` when given.  Card name and power limit are
printed with it.
"""

from __future__ import annotations

import bisect
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if "--root" in sys.argv:
    ROOT = pathlib.Path(sys.argv[sys.argv.index("--root") + 1]).resolve()
sys.path.insert(0, str(ROOT))

BATCH = 16384
SNR_DB = 2.0
WARM, WINDOW = 8, 6
CHANNEL_RANGE = "profile_window.channel"  # the channel draw's record_function


def part_of(name: str, in_channel: bool) -> str:
    low = name.lower()
    if "stream_chunk" in low:
        return "k2_stream_chunk"
    if "reload_plan" in low:
        return "reload_plan"
    if "stagesink" in low:
        return "channel_k8_staged"
    if "pool_draw" in low or "pool_plan" in low:
        return "channel_k8"
    if "stream_grant" in low:
        return "ordered_grant"
    if not in_channel:
        if "reduce" in low:
            return "counter_reductions"
        if "random" in low or "philox" in low or "distribution" in low:
            return "k8_keys"
        return "pool_merge_elementwise"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "matmul" in low:
        return "channel_matmul"
    if "normal" in low or "philox" in low or "distribution" in low or "rand" in low:
        return "channel_randn"
    if "reduce" in low:
        return "channel_reductions"
    return "channel_elementwise"


def traced_channel():
    """Run the streaming step's pool refill (K8; before it, the channel
    draw) and, where the tree has it, the XLA super-step's reload
    (``pool_refill.stream_reload``) inside ``CHANNEL_RANGE``."""
    from libldpc_tpu_torch.ops import streaming_fused
    from libldpc_tpu_torch.ops.kernels import pool_refill

    name = "pool_refill" if hasattr(streaming_fused, "pool_refill") else "simulate_channel"
    sites = [(streaming_fused, name)]
    if hasattr(pool_refill, "stream_reload"):
        sites.append((pool_refill, "stream_reload"))
    for mod, attr in sites:
        draw = getattr(mod, attr)

        def traced(*args, _draw=draw, **kwargs):
            with torch.profiler.record_function(CHANNEL_RANGE):
                return _draw(*args, **kwargs)

        # a wrapper counts its launches in its own attributes (the function's
        # global name is the wrapper now)
        traced.__dict__.update(draw.__dict__)
        setattr(mod, attr, traced)


def device_events(prof):
    """``(kernels, channel spans)``: ``(name, start_us, end_us, in the
    channel)`` of every kernel the profiler saw on the card, and the card's
    spans of ``CHANNEL_RANGE`` (the profiler's device-side annotation of
    the range: from the first kernel launched inside it to the end of the
    last).  One stream runs the super-step, so a kernel is the channel's
    when it runs inside such a span."""
    spans, found = [], []
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") or e.time_range is None:
            continue
        if e.name == CHANNEL_RANGE:
            spans.append((e.time_range.start, e.time_range.end))
        elif not getattr(e, "is_user_annotation", False):
            found.append((e.name, e.time_range.start, e.time_range.end))
    spans.sort()
    starts = [a for a, _ in spans]
    out = []
    for name, s, e in found:
        i = bisect.bisect_right(starts, (s + e) / 2) - 1
        out.append((name, s, e, i >= 0 and (s + e) / 2 <= spans[i][1]))
    return out, spans


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


def window(step_fn, state, gen_seed: int, snr_db: float = SNR_DB):
    from libldpc_tpu_torch.ops.channel import make_generator

    dev = state.llr_in.device
    for i in range(WARM):
        state, _ = step_fn(state, make_generator(dev, gen_seed, 0, i), snr_db, True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        accs = []
        for i in range(WINDOW):
            state, acc = step_fn(state, make_generator(dev, gen_seed, 1, i), snr_db, True)
            accs.append(acc.frames)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    frames = int(sum(int(a) for a in accs))
    kernels, spans = device_events(prof)
    by_name, by_part = {}, {}
    for name, s, e, in_channel in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        part = part_of(name, in_channel)
        by_part[part] = by_part.get(part, 0.0) + (e - s)
    span_us = (max(e for _, _, e, _ in kernels) - min(s for _, s, _, _ in kernels)
               if kernels else 0.0)
    device_us = sum(by_part.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return state, {
        "supersteps": WINDOW,
        "wall_ms_per_superstep": wall_s * 1e3 / WINDOW,
        "frames": frames,
        "frames_per_s_host": frames / wall_s,
        "kernels_seen": len(kernels),
        "channel_spans_seen": len(spans),
        "device_ms_per_superstep": device_us / 1e3 / WINDOW,
        "busy_share_of_wall": device_us / 1e6 / wall_s,
        "busy_share_of_kernel_span": union_us([(s, e) for _, s, e, _ in kernels]) / span_us
        if span_us else None,
        "share_of_device_time": {k: v / device_us for k, v in sorted(by_part.items())}
        if device_us else {},
        "ms_per_superstep": {k: v / 1e3 / WINDOW for k, v in sorted(by_part.items())},
        "channel_share_of_device_time": sum(v for k, v in by_part.items()
                                            if k.startswith("channel")) / device_us
        if device_us else None,
        "channel_and_pool_merge_share": sum(v for k, v in by_part.items()
                                            if k.startswith("channel") or k.startswith("pool")
                                            or k.startswith("k8"))
        / device_us if device_us else None,
        "top_kernels_ms_per_superstep": [(n[:90], v / 1e3 / WINDOW) for n, v in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_window: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from libldpc_tpu_torch.models import make_benchmark_code
    from libldpc_tpu_torch.ops.kernels import decode_fused as df
    from libldpc_tpu_torch.ops.kernels.layout import kernel_tables
    from libldpc_tpu_torch.ops.modulation import Constellation
    from libldpc_tpu_torch.ops.sorted import to_sorted_device
    from libldpc_tpu_torch.ops.streaming_fused import make_streaming_fused_step
    from libldpc_tpu_torch.sim.driver import DecoderParams

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    traced_channel()
    tables = kernel_tables(to_sorted_device(make_benchmark_code(1152, 3, 6, seed=0, with_G=True),
                                            dev))
    result = {"card": card, "root": str(ROOT), "batch": BATCH, "snr_db": SNR_DB,
              "code": "bench1152 f32 BP"}
    for label, forced in (("rule", None), ("hbm-planes", (0, False))):
        df.STREAM_FORM_OVERRIDE = forced
        init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", DecoderParams(iterations=50),
                                                     BATCH)
        _, row = window(step_fn, init_fn(), 11)
        row["k2_form"] = df.bp_stream_chunk_fused.last_form
        result[f"window {label}"] = row
    df.STREAM_FORM_OVERRIDE = None
    tx = tables.code.bit_pos
    ask4 = (Constellation.mask(4, labels=[0, 1, 3, 2]), tx.reshape(-1, 2).T.contiguous())
    init_fn, step_fn = make_streaming_fused_step(tables, "AWGN", DecoderParams(iterations=50),
                                                 BATCH, modulation=ask4)
    _, row = window(step_fn, init_fn(), 11, snr_db=7.5)
    row["k2_form"] = df.bp_stream_chunk_fused.last_form
    row["snr_db"] = 7.5
    result["window rule 4-ASK"] = row
    from libldpc_tpu_torch.ops import streaming

    if hasattr(streaming, "make_streaming_step"):
        init_fn, step_fn = streaming.make_streaming_step(tables, "AWGN",
                                                         DecoderParams(iterations=50), BATCH)
        _, row = window(step_fn, init_fn(), 11)
        result["window default (XLA super-step)"] = row
    text = json.dumps(result, indent=1)
    print(text)
    if len(sys.argv) > 1 and sys.argv[1] != "--root":
        out = pathlib.Path(sys.argv[1])
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
