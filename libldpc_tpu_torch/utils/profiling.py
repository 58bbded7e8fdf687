"""Tracing and profiling utilities.

The port of :mod:`libldpc_tpu.utils.profiling`.  The reference wraps
expressions in the ``TIME_PROF`` macro, printing ``[TIMEPROF]`` lines
(``src/core/functions.h:19-50``), and measures per-frame times with
compile-time ``LOG_FRAME_TIME`` / ``LOG_TP`` switches.  Here: a
``time_prof`` context manager with the same line, a throughput meter for
frames/s accounting, and :func:`device_trace`, a ``torch.profiler`` window
(with the card's activity when there is one) written as a Chrome trace.

The program's own tracing: :func:`span` marks a phase of the sweep (a
``record_function`` range, so it lands in the profiler's host timeline on
the clock of the device operations) and :func:`count` adds to a named
counter.  Both act only while a ``torch.profiler`` profile is recording
(the profiler's own flag, read at each call); otherwise a span is one
shared no-op context and a count does nothing.  Neither launches a device
operation or reads the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}
_NO_SPAN = contextlib.nullcontext()
_counters: dict = {}


def _tracing() -> bool:
    """Whether a ``torch.profiler`` profile is recording."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context marking one phase under the constant ``name`` (a trace's
    breakdown groups idle time by name).  A span carries no argument: the
    Chrome trace does not export ``record_function``'s argument string, and
    the loop's phases run in order on one thread, so the k-th dispatch of a
    point is its step k."""
    if not _tracing():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while tracing."""
    if _tracing():
        _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> dict:
    """A copy of the counters."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


@contextlib.contextmanager
def time_prof(label: str, unit: str = "ms") -> Iterator[None]:
    """``TIME_PROF`` equivalent::

        with time_prof("decode", "ms"):
            out = decode(...)
        # prints: [TIMEPROF]: decode: 12.345 ms

    The host clock: a region that launches kernels ends with a
    synchronise for the line to hold their time."""
    scale = _UNITS.get(unit)
    if scale is None:
        unit, scale = "ns", _UNITS["ns"]
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        print(f"[TIMEPROF]: {label}: {elapsed * scale:.3f} {unit}")


class ThroughputMeter:
    """Frames/s (and bits/s) accounting for sweeps and benchmarks, the
    counterpart of the GPU stack's ``LOG_TP`` Mbits/s column, with a
    measured constant overhead per batch subtracted
    (``frame_const_time``)."""

    def __init__(self, bits_per_frame: int = 0):
        self.bits_per_frame = bits_per_frame
        self.frames = 0
        self.elapsed = 0.0
        self.const_overhead = 0.0  # seconds per batch, excluded if measured
        self.batches = 0

    def measure_overhead(self, fn, repeats: int = 5) -> float:
        """Measure the non-decoding constant time of ``fn()`` (e.g. a
        channel-only step) and subtract it per recorded batch."""
        fn()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        self.const_overhead = (time.perf_counter() - t0) / repeats
        return self.const_overhead

    @contextlib.contextmanager
    def batch(self, frames: int) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.elapsed += time.perf_counter() - t0
        self.frames += frames
        self.batches += 1

    @property
    def net_elapsed(self) -> float:
        return max(1e-12, self.elapsed - self.const_overhead * self.batches)

    @property
    def frames_per_s(self) -> float:
        return self.frames / self.net_elapsed

    @property
    def mbits_per_s(self) -> float:
        return self.frames * self.bits_per_frame / self.net_elapsed / 1e6

    def summary(self) -> str:
        s = f"{self.frames} frames in {self.net_elapsed:.3f}s = {self.frames_per_s:.0f} frames/s"
        if self.bits_per_frame:
            s += f" ({self.mbits_per_s:.1f} Mbits/s)"
        return s


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device: Optional[torch.device] = None) -> Iterator:
    """A ``torch.profiler`` window over the region when ``log_dir`` is set
    (the CPU activity, and the CUDA activity when ``device`` is a card or,
    without ``device``, when one is available), its Chrome trace written to
    ``log_dir/trace.json`` and the counters it counted (cleared on entry) to
    ``log_dir/counters.json``; yields the profiler, or None when ``log_dir``
    is unset, where nothing is traced."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda" if device is not None else torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)
