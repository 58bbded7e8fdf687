"""Where the card's idle time sits in the sweep's host loop, read from the
program's own spans: one traced window of a benchmark cell.

    python3 tests_gpu/loop_spans.py <cell> <seed> <seconds> OUT.json

Builds the cell's ``Simulator`` as ``portbench/run.py`` does, warms it,
and traces one window of ``seconds`` (CPU and CUDA activity).  Writes, and
prints in short:

* ``idle_by_span``: the device's idle time in the window intersected with
  each span name's intervals (the ``ldpc.loop.*`` phases do not overlap
  one another; ``ldpc.decode``/``ldpc.channel``/``ldpc.count`` nest inside
  a dispatch), and the idle time outside every ``ldpc.loop.*`` and
  ``ldpc.warmup`` span;
* ``reads``: for the ``ldpc.loop.read`` spans, how many began with the
  card busy and ended with it idle (the read waited until the card had
  run everything enqueued), the mean time from the card's last operation
  to the read's end, and the mean idle gap from the read's end to the next
  device operation;
* ``breakdown``: ``portbench.trace.breakdown`` of the same window (idle
  gaps by the host operation open at their midpoint), and ``unlabelled``:
  the gaps it leaves under "no host operation", read again (:func:`unlabelled`),
  with the host's time between consecutive loop phases and the Python
  garbage collections (each a ``python.gc`` range while the window is
  traced).
"""

import bisect
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.metrics.host_loop_idle_pct import merged, overlap  # noqa: E402

GC_RANGE = "python.gc"


def busy_and_idle(w) -> tuple:
    """The window's device intervals, merged, and the idle gaps between them."""
    lo, hi = w.start_us, w.end_us
    busy = merged([(s, e) for _, s, e in w.kernels], lo, hi)
    idle = [(e0, s1) for (_, e0), (s1, _) in zip([(lo, lo)] + busy, busy + [(hi, hi)]) if s1 > e0]
    return busy, idle


def analyse(w) -> dict:
    lo, hi = w.start_us, w.end_us
    busy, idle = busy_and_idle(w)
    spans: dict = {}
    for n, s, e in w.host_ops:
        if n.startswith("ldpc."):
            spans.setdefault(n, []).append((s, e))
    by_span = {n: overlap(idle, merged(iv, lo, hi)) * 1e-6 for n, iv in sorted(spans.items())}
    phases = merged([iv for n, ivs in spans.items() if n.startswith("ldpc.loop.")
                     or n == "ldpc.warmup" for iv in ivs], lo, hi)
    idle_s = sum(e - s for s, e in idle) * 1e-6
    by_span["outside ldpc.loop.* and ldpc.warmup"] = idle_s - overlap(idle, phases) * 1e-6

    starts = [s for s, _ in busy]
    ends = [e for _, e in busy]

    def busy_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ends[i] >= t

    def last_end_before(t):
        i = bisect.bisect_right(starts, t) - 1
        return min(ends[i], t) if i >= 0 else lo

    def next_start_after(t):
        i = bisect.bisect_right(starts, t)
        return starts[i] if i < len(starts) else hi

    reads = [(s, e) for s, e in spans.get("ldpc.loop.read", []) if lo <= s and e <= hi]
    drained = [r for r in reads if busy_at(r[0]) and not busy_at(r[1])]
    lag = [e - last_end_before(e) for _, e in reads if not busy_at(e)]
    gap = [next_start_after(e) - e for _, e in reads if not busy_at(e)]
    dur = [e - s for s, e in reads]
    return {
        "window_s": (hi - lo) * 1e-6, "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "idle_s": idle_s, "idle_by_span_s": by_span,
        "span_counts": {n: len(iv) for n, iv in sorted(spans.items())},
        "span_seconds": {n: sum(e - s for s, e in iv) * 1e-6 for n, iv in sorted(spans.items())},
        "reads": {"n": len(reads), "began_busy_ended_idle": len(drained),
                  "ended_idle": len(gap),
                  "mean_read_us": sum(dur) / max(len(dur), 1),
                  "mean_idle_before_read_end_us": sum(lag) / max(len(lag), 1),
                  "mean_idle_after_read_us": sum(gap) / max(len(gap), 1)},
    }


def unlabelled(w) -> dict:
    """The idle gaps that ``portbench.trace.breakdown`` leaves under "no
    host operation" (no host operation of the 400 that started last before
    the gap's midpoint is open there), read again against every host
    operation: the seconds by the innermost ``ldpc.*`` span open at the
    midpoint, how many host operations started between that span's start
    and the midpoint, and a few of the gaps with the operations before
    the host operations around them."""
    _, gaps = busy_and_idle(w)
    host = sorted(w.host_ops, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    ldpc = [(n, s, e) for n, s, e in host if n.startswith("ldpc.")]
    by_span, back, examples = {}, [], []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        if any(host[j][2] >= mid for j in range(i, max(-1, i - 400), -1)):
            continue
        inner = [(n, s) for n, s, e in ldpc if s <= mid <= e]
        name, s0 = max(inner, key=lambda x: x[1]) if inner else ("none", None)
        by_span[name] = by_span.get(name, 0.0) + (g1 - g0) * 1e-6
        if s0 is not None:
            back.append(i - bisect.bisect_left(starts, s0))
        if len(examples) < 4:
            examples.append({"gap_us": [g0, g1], "inside": name,
                             "around": [[n[:60], s - mid, e - mid]
                                        for n, s, e in host[max(0, i - 6):i + 4]]})
    # the host's time between consecutive loop phases, and what ran there
    phases = sorted((s, e) for n, s, e in ldpc if n.startswith("ldpc.loop."))
    holes = sorted(s1 - e0 for (_, e0), (s1, _) in zip(phases, phases[1:]) if s1 > e0)
    gc = [(s, e) for n, s, e in host if n == GC_RANGE]
    return {"seconds_by_span": by_span,
            "ops_since_span_start": [min(back), max(back)] if back else None,
            "examples": examples,
            "holes_us": {"n": len(holes), "total": sum(holes),
                         "p50": holes[len(holes) // 2] if holes else None,
                         "p90": holes[9 * len(holes) // 10] if holes else None,
                         "max": holes[-1] if holes else None},
            "gc": {"n": len(gc), "total_us": sum(e - s for s, e in gc),
                   "idle_us": overlap(merged(gc, w.start_us, w.end_us), gaps)}}


def record_gc():
    """Open a ``python.gc`` range over each garbage collection while the
    profiler records (a diagnostic of this tool, not of the program)."""
    import gc

    import torch

    open_ranges = []

    def callback(phase, info):
        if phase == "start":
            r = torch.profiler.record_function(GC_RANGE)
            r.__enter__()
            open_ranges.append(r)
        elif open_ranges:
            open_ranges.pop().__exit__(None, None, None)

    gc.callbacks.append(callback)
    return lambda: gc.callbacks.remove(callback)


def main() -> int:
    cell_name, seed, seconds, out_path = (sys.argv[1], int(sys.argv[2]), float(sys.argv[3]),
                                          sys.argv[4])
    import torch

    from libldpc_tpu_torch.utils import profiling
    from portbench import harness, spec
    from portbench import trace as tracemod
    from portbench.codes import cached_code

    cell = spec.resolve(spec.load_benchmark(ROOT), cell_name, ROOT)
    workdir = ROOT / "build" / "portbench" / cell_name
    workdir.mkdir(parents=True, exist_ok=True)
    code, files = cached_code(cell.config["code"],
                              ROOT / "build" / "portbench" / "codes" / cell.config_name)
    sim, rec = harness.build_simulator(cell, files, seed, workdir)
    harness._sweep(sim, rec, harness.SETUP_SWEEP_S)
    rec.clear()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        stop_gc = record_gc()
        with torch.profiler.record_function(tracemod.WINDOW_RANGE):
            window_s = harness._sweep(sim, rec, seconds)
        stop_gc()
    t0 = time.perf_counter()
    w = tracemod.window_of(prof)
    out = {"cell": cell_name, "seed": seed, "engine": sim.engine, "card": harness.card_line(),
           "host_window_s": window_s, "frames": sum(r[2] for r in rec.rows),
           "iter_sum": sum(r[3] for r in rec.rows), "counters": profiling.counters(),
           **analyse(w), "breakdown": tracemod.breakdown(w), "unlabelled": unlabelled(w)}
    out["analysis_s"] = time.perf_counter() - t0
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    short = {k: out[k] for k in ("cell", "engine", "card", "frames", "window_s", "idle_s",
                                 "idle_by_span_s", "reads", "counters", "unlabelled")}
    print(json.dumps(short, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
