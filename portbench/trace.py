"""The profiler window of a traced run, reduced to what the per-layer
metrics and the breakdown read.

The device-interval arithmetic is a frozen copy of
``tests_gpu/profile_window.py`` (``device_events``, ``union_us``) at commit
c083e37.  Kernels are attributed to layers by name alone; the window on
the profiler's clock is the span of the harness's own
``record_function`` around the timed call.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW_RANGE = "portbench.window"


@dataclasses.dataclass
class Window:
    kernels: list  # (name, start_us, end_us) of every device operation
    host_ops: list  # (name, start_us, end_us) of every host operation
    start_us: float  # the window on the profiler's clock
    end_us: float

    def union_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.kernels])

    def device_us_of(self, match) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n))


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


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def window_of(prof) -> Window:
    """The device operations and host operations the profiler saw, and
    the harness's window range on its clock."""
    kernels, host, start, end = [], [], None, None
    for e in prof.events():
        tr = e.time_range
        if tr is None:
            continue
        if e.name == WINDOW_RANGE:
            if not _is_device(e):
                start, end = tr.start, tr.end
            continue
        if _is_device(e):
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, float(tr.start), float(tr.end)))
        else:
            host.append((e.name, float(tr.start), float(tr.end)))
    if start is None:
        raise RuntimeError(f"the profiler holds no {WINDOW_RANGE!r} range")
    return Window(kernels, host, float(start), float(end))


def breakdown(w: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    card by the host operation running at each gap's midpoint (the one
    that started last of those running then), each ``[name, seconds]``."""
    by_name: dict = {}
    for n, s, e in w.kernels:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the card's idle gaps inside the window
    merged = []
    for s, e in sorted((s, e) for _, s, e in w.kernels):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, t = [], w.start_us
    for s, e in merged:
        if s > t:
            gaps.append((t, min(s, w.end_us)))
        t = max(t, e)
    if w.end_us > t:
        gaps.append((t, w.end_us))
    host = sorted(w.host_ops, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    by_host: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        label = "no host operation"
        for j in range(i, max(-1, i - 400), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        by_host[label] = by_host.get(label, 0.0) + (g1 - g0) * 1e-6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in device_ops],
            "idle_gaps": [[n[:160], v] for n, v in idle]}
