"""Tracing and profiling utilities.

The port of :mod:`libldpc_tpu.utils.profiling`.  The reference wraps
expressions in the ``TIME_PROF`` macro, printing ``[TIMEPROF]`` lines
(``src/core/functions.h:19-50``), and measures per-frame times with
compile-time ``LOG_FRAME_TIME`` / ``LOG_TP`` switches.  Here: a
``time_prof`` context manager with the same line, a throughput meter for
frames/s accounting, and :func:`device_trace`, a ``torch.profiler`` window
(with the card's activity when there is one) written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6, "ns": 1e9}


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
    ``log_dir/trace.json``; yields the profiler, or None when ``log_dir`` is
    unset, where nothing is traced."""
    if not log_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda" if device is not None else torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
