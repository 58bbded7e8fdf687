"""The comparisons that decide ``correct``, each giving named numbers.

A run records, in order, every row of counters its sweep point read on the
host: per batch ``[bit_errors, frame_errors, frames, iter_sum]``, per
streaming super-step the same and the lanes in flight after it.  These are
the answers of the timed path; the reference works them out again from
the seed alone.

* A batch-stepped point (:func:`batch_numbers`): a sample of the window's
  batches, drawn from the seed, each drawn again and decoded by the
  reference; every batch's frame count is exact.
* A streaming point: the reference runs the streaming engine from empty
  over the first ``supersteps`` super-steps, on the same keys
  (:func:`stream_start`).  A super-step's rows depend on every earlier
  one, so past those the reference follows the window's end from the
  program's lanes (:func:`stream_tail`): which lanes were in flight at the
  start of the last super-step that refilled, and how many passes ago each
  was drawn.  It draws and decodes each of those frames again from its
  draw, checks the lanes' iteration counts there, follows that super-step
  (its grants by the rule) and the drain, and checks each lane's last
  frame's iteration count at the end.  The rows of both ends are compared
  together (:func:`stream_numbers`); the point ends drained (no lane in
  flight).
"""

from __future__ import annotations

import numpy as np
import torch

from .channel import FrameSource, step_keys
from . import decoders
from .decoders import Graph, StreamReference, decode_layered


def sample_indices(seed: int, n_rows: int, n: int) -> list:
    """``n`` distinct row indices of ``n_rows``, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    return sorted(rng.choice(n_rows, size=min(n, n_rows), replace=False).tolist())


def batch_numbers(rows: list, code, snr_db: float, seed: int, batch: int, iterations: int,
                  n_sample: int, device) -> tuple:
    """``(numbers, detail)`` of a batch-stepped point on the exact layered
    schedule: ``frames_gap`` (batches whose frame count is not ``batch``);
    over the sampled batches, ``iter_gap``, the mean of the departures of a
    batch's iteration sum from the reference's, per frame, and the worst,
    ``worst_iter_gap``; ``frame_error_gap`` and ``bit_error_gap``, the sums
    of the departures of the batches' frame and bit errors."""
    graph = Graph(code.rows, code.cols, code.nc, code.mc, device)
    frames = FrameSource(code.G, snr_db, device)
    lanes = torch.arange(batch, device=device)
    detail, gaps, fe_gap, be_gap = [], [], 0, 0
    for j in sample_indices(seed, len(rows), n_sample):
        key = step_keys(seed, 0, j, 1, device)[0]
        llr, cw = frames.draw(key, lanes)
        ref = decode_layered(graph, code.layers, llr, cw, iterations)
        be, fe, fr, it = rows[j][:4]
        gaps.append(abs(it - ref["iter_sum"]) / batch)
        fe_gap += abs(fe - ref["frame_errors"])
        be_gap += abs(be - ref["bit_errors"])
        detail.append({"batch": j, "program": [be, fe, fr, it],
                       "reference": [ref["bit_errors"], ref["frame_errors"], ref["frames"],
                                     ref["iter_sum"]]})
    numbers = {
        "frames_gap": sum(1 for r in rows if r[2] != batch),
        "iter_gap": float(np.mean(gaps)) if gaps else 1.0,
        "worst_iter_gap": max(gaps, default=1.0),
        "frame_error_gap": fe_gap if gaps else batch,
        "bit_error_gap": be_gap if gaps else batch * code.nc,
    }
    return numbers, detail


def stream_start(rows: list, code, snr_db: float, seed: int, batch: int, iterations: int,
                 passes: int, gen_threshold: int, quota: int, supersteps: int,
                 device) -> tuple:
    """``(pairs, detail)``: the first ``supersteps`` super-steps' rows,
    each beside the reference's, which runs the streaming engine from
    empty on the same keys."""
    graph = Graph(code.rows, code.cols, code.nc, code.mc, device)
    ref = StreamReference(graph, FrameSource(code.G, snr_db, device), batch, iterations,
                          gen_threshold, quota)
    n = min(supersteps, len(rows))
    pairs = [(list(rows[s]), ref.superstep(step_keys(seed, 0, s, passes, device), True))
             for s in range(n)]
    detail = [{"superstep": s, "program": p, "reference": r} for s, (p, r) in enumerate(pairs)]
    return pairs, detail


def stream_tail(rows: list, refill: list, snapshot, end, code, snr_db: float, seed: int,
                batch: int, iterations: int, passes: int, gen_threshold: int, quota: int,
                device, store=None) -> tuple:
    """``(pairs, numbers, detail)`` of a streaming point's end:
    ``snapshot`` is ``(s0, active, age, iters)``, the program's lanes at
    the start of super-step ``s0`` (the last that refilled), ``end``
    ``(active, iters)`` its lanes after the last super-step; ``refill``
    each super-step's refill flag.  The reference starts the lanes in
    flight again (lane ``b`` of age ``a`` drawn at pass ``s0 * passes -
    a``, on that pass's key) and follows the super-steps from ``s0`` to the
    last, whose rows ``pairs`` holds beside the program's.  ``numbers``:
    ``tail_state_gap``, the lanes whose in-flight flag or iteration count
    at ``s0`` differs from the reference's, ``tail_lane_gap``, the lanes
    whose last frame's iteration count differs at the end, each as a share
    of the lanes, and ``in_flight_at_end``, the lanes in flight after the
    last super-step.  ``store`` puts the control in the program's place:
    it restores and follows the same lanes itself, and its rows and lanes
    are judged instead."""
    if snapshot is None or end is None or not rows:
        return [], {"tail_state_gap": 1.0, "tail_lane_gap": 1.0, "in_flight_at_end": batch}, []
    s0, active, age, iters = (snapshot[0], *(t.to(device) for t in snapshot[1:]))
    graph = Graph(code.rows, code.cols, code.nc, code.mc, device)
    keys = {}

    def key_of(p: int) -> int:
        s, k = divmod(p, passes)
        if s not in keys:
            keys[s] = step_keys(seed, 0, s, passes, device)
        return keys[s][k]

    def follow(store_fn):
        ref = StreamReference(graph, FrameSource(code.G, snr_db, device), batch, iterations,
                              gen_threshold, quota, store_fn)
        lanes = active.nonzero().flatten()
        drawn = s0 * passes - age[lanes].to(torch.int64)
        ref.restore({int(p): lanes[drawn == p] for p in torch.unique(drawn).tolist()},
                    s0 * passes, key_of)
        at_s0 = (ref.active.clone(), ref.iters.clone())
        out = [ref.superstep([key_of(s * passes + k) for k in range(passes)], refill[s])
               for s in range(s0, len(refill))]
        return at_s0, out, ref.iters

    (ref_active, ref_iters), refs, ref_last = follow(decoders.identity)
    last = end[1].to(device)
    if store is not None:
        (active, iters), prog, last = follow(store)
    else:
        prog = [list(r) for r in rows[s0:len(refill)]]
    differs = (active != ref_active) | (active & (iters != ref_iters))
    numbers = {
        "tail_state_gap": int(differs.sum()) / batch,
        "tail_lane_gap": int((last != ref_last).sum()) / batch,
        "in_flight_at_end": int(prog[-1][4]) if prog else batch,
    }
    pairs = list(zip(prog, refs))
    detail = [{"superstep": s0 + i, "program": p, "reference": r}
              for i, (p, r) in enumerate(pairs)]
    detail.append({"superstep": s0, "lanes_in_flight": int(active.sum()),
                   "state_departures": int(differs.sum()),
                   "last_frame_departures": int((last != ref_last).sum())})
    return pairs, numbers, detail


def stream_numbers(start: list, tail: list, batch: int) -> dict:
    """The row numbers of a streaming point over the super-steps followed
    at its start and its end (``(program, reference)`` row pairs):
    ``frames_gap`` and ``iter_gap``, the sums of the departures of their
    stopped frames and of those frames' iterations, per frame the reference
    stopped; ``frame_error_gap``, the same sum for frame errors, as a share
    of the reference's; ``active_gap``, the worst departure of the lanes in
    flight after a super-step of the start, as a share of the lanes.  With
    either end not followed no number can pass."""
    gaps, total = np.zeros(3, dtype=np.int64), np.zeros(2, dtype=np.int64)
    for p, r in start + tail:
        gaps += [abs(p[2] - r[2]), abs(p[3] - r[3]), abs(p[1] - r[1])]
        total += [r[2], r[1]]
    if not start or not tail:
        gaps, total = np.ones(3, dtype=np.int64), np.ones(2, dtype=np.int64)
    return {
        "frames_gap": int(gaps[0]) / max(int(total[0]), 1),
        "iter_gap": int(gaps[1]) / max(int(total[0]), 1),
        "frame_error_gap": int(gaps[2]) / max(int(total[1]), 1),
        "active_gap": max((abs(p[4] - r[4]) / batch for p, r in start), default=1.0),
    }
