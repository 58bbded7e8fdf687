"""Simulation results container (from :mod:`libldpc_tpu.sim.results`,
ported rather than imported: that package's ``__init__`` loads jax)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SimResults:
    x_values: np.ndarray  # sweep parameter per point (SNR dB or epsilon)
    fer: np.ndarray
    ber: np.ndarray
    avg_iter: np.ndarray
    time: np.ndarray  # seconds per frame
    fec: np.ndarray  # frame error counts (int64)
    frames: np.ndarray  # frames simulated (int64)

    @classmethod
    def empty(cls, n_points: int, x_values) -> "SimResults":
        return cls(
            x_values=np.asarray(x_values, dtype=np.float64),
            fer=np.zeros(n_points),
            ber=np.zeros(n_points),
            avg_iter=np.zeros(n_points),
            time=np.zeros(n_points),
            fec=np.zeros(n_points, dtype=np.int64),
            frames=np.zeros(n_points, dtype=np.int64),
        )

    def update_point(
        self,
        i: int,
        *,
        bit_errors: int,
        frame_errors: int,
        frames: int,
        iter_sum: int,
        elapsed_s: float,
        nc: int,
    ) -> None:
        """Recompute the derived metrics for point ``i``.  BER divides by
        ``frames * nc``, all code bits including punctured ones, as the
        reference does; bit errors are counted over transmitted bits."""
        if frames == 0:
            return
        self.fer[i] = frame_errors / frames
        self.ber[i] = bit_errors / (frames * nc)
        self.avg_iter[i] = iter_sum / frames
        self.time[i] = elapsed_s / frames
        self.fec[i] = frame_errors
        self.frames[i] = frames
