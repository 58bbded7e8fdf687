"""The comparisons that decide ``correct``, each giving named numbers.

A run records, in order, every row of counters its sweep point read on the
host: per batch ``[bit_errors, frame_errors, frames, iter_sum]``, per
streaming super-step the same and the lanes in flight after it.  These are
the answers of the timed path; the reference works them out again from
the seed alone.

* A batch-stepped point (:func:`batch_numbers`): a sample of the window's
  batches, drawn from the seed, each drawn again and decoded by the
  reference (:func:`decode_batch`: the exact layered schedule where the
  sweep reads a layer file, else flooding, with or without early
  termination as the sweep runs); every batch's frame count is exact.
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
* The fused pool (``--pallas``): the same start from empty, on the pool's
  semantics (:mod:`.pool`, :func:`pool_start`), and the same end
  (:func:`pool_tail`) from the lanes and the pool at the start of the last
  refilling super-step.  A lane's frame there was drawn on some chunk's
  key while it waited in its pool entry, which its age does not tell; so
  the reference reads which key from the frame's codeword (the key among
  the chunks of the super-steps before whose draw of that lane gives the
  frame's info bits, whole codeword and LLRs), draws the frame itself and
  decodes it again for its age.  A lane in flight or an unused entry
  whose frame no key draws is a departure.  That engine's lanes hold
  their APP where flooding's hold their prior, so a lane in flight is
  found by its codeword alone; an unused entry, by its LLRs too.

Each kind takes the cell's traffic mix and decodes on the pass the sweep
routes that mix to: the exact layered schedule or flooding in batches
(:func:`decode_batch`), the fast layered engine's iteration or flooding in
the fused pool (:func:`pool_pass`).

A code with punctured variables draws, decodes and counts as the program
does: priors 0 there, bit errors over the transmitted bits only
(:func:`graph_of`, :func:`frames_of`).
"""

from __future__ import annotations

import numpy as np
import torch

from .channel import FrameSource, step_keys
from . import decoders
from .decoders import (Flooding, Graph, Layered, StreamReference, decode_flooding,
                       decode_layered, identity)
from .pool import PoolReference, chunking, identify, info_columns

#: super-steps before the last refilling one whose keys may have drawn a
#: frame that is in the pool or in flight there (a frame is drawn after its
#: lane took the one before, waits while that one decodes, then decodes:
#: each at most ``iterations + 1`` passes, about a super-step, and the
#: lane's idle passes between)
POOL_LOOKBACK = 6


def graph_of(code, device) -> Graph:
    """The reference's graph of a code, counting its transmitted bits."""
    return Graph(code.rows, code.cols, code.nc, code.mc, device, code.transmitted)


def frames_of(code, snr_db: float, device) -> FrameSource:
    """The reference's frames of a code, drawing its transmitted bits."""
    return FrameSource(code.G, snr_db, device, code.transmitted)


def sample_indices(seed: int, n_rows: int, n: int) -> list:
    """``n`` distinct row indices of ``n_rows``, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    return sorted(rng.choice(n_rows, size=min(n, n_rows), replace=False).tolist())


def decode_batch(graph: Graph, code, traffic: dict, llr: torch.Tensor, cw: torch.Tensor,
                 iterations: int, store=identity) -> dict:
    """The reference's decode of one batch of a batch-stepped point of
    ``traffic``: the exact layered schedule on the code's layers where the
    sweep reads a layer file (with early termination: there is no reference
    of it without), else flooding, with early termination as the sweep
    says."""
    if traffic["layer_file"]:
        if not traffic["early_term"]:
            raise ValueError("no reference of the exact layered schedule without early "
                             "termination")
        return decode_layered(graph, code.layers, llr, cw, iterations, store)
    return decode_flooding(graph, llr, cw, iterations, bool(traffic["early_term"]), store)


def batch_numbers(rows: list, code, traffic: dict, seed: int, batch: int, iterations: int,
                  n_sample: int, device) -> tuple:
    """``(numbers, detail)`` of a batch-stepped point of ``traffic``, each
    sampled batch decoded by :func:`decode_batch`: ``frames_gap`` (batches
    whose frame count is not ``batch``); over the sampled batches,
    ``iter_gap``, the mean of the departures of a batch's iteration sum
    from the reference's, per frame, and the worst, ``worst_iter_gap``;
    ``frame_error_gap`` and ``bit_error_gap``, the sums of the departures
    of the batches' frame and bit errors."""
    graph = graph_of(code, device)
    frames = frames_of(code, traffic["snr_db"], device)
    lanes = torch.arange(batch, device=device)
    detail, gaps, fe_gap, be_gap = [], [], 0, 0
    for j in sample_indices(seed, len(rows), n_sample):
        key = step_keys(seed, 0, j, 1, device)[0]
        llr, cw = frames.draw(key, lanes)
        ref = decode_batch(graph, code, traffic, llr, cw, iterations)
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
        "bit_error_gap": be_gap if gaps else batch * code.nct,
    }
    return numbers, detail


def stream_start(rows: list, code, snr_db: float, seed: int, batch: int, iterations: int,
                 passes: int, gen_threshold: int, quota: int, supersteps: int,
                 device) -> tuple:
    """``(pairs, detail)``: the first ``supersteps`` super-steps' rows,
    each beside the reference's, which runs the streaming engine from
    empty on the same keys."""
    ref = StreamReference(graph_of(code, device), frames_of(code, snr_db, device), batch,
                          iterations, gen_threshold, quota)
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
    graph = graph_of(code, device)
    keys = {}

    def key_of(p: int) -> int:
        s, k = divmod(p, passes)
        if s not in keys:
            keys[s] = step_keys(seed, 0, s, passes, device)
        return keys[s][k]

    def follow(store_fn):
        ref = StreamReference(graph, frames_of(code, snr_db, device), batch, iterations,
                              gen_threshold, quota, store_fn)
        lanes = active.nonzero().flatten()
        drawn = s0 * passes - age[lanes].to(torch.int64)
        ref.restore({int(p): lanes[drawn == p] for p in torch.unique(drawn).tolist()},
                    s0 * passes, key_of)
        at_s0 = (ref.active.clone(), ref.iters.clone())
        out = [ref.superstep([key_of(s * passes + k) for k in range(passes)], refill[s])
               for s in range(s0, len(refill))]
        return at_s0, out, ref.iters

    ref_end = follow(decoders.identity)
    prog_end = follow(store) if store is not None else \
        ((active, iters), [list(r) for r in rows[s0:len(refill)]], end[1].to(device))
    return _tail_numbers(s0, prog_end, ref_end, batch)


def _tail_numbers(s0: int, prog_end: tuple, ref_end: tuple, batch: int, lost=None,
                  extra: dict = None) -> tuple:
    """``(pairs, numbers, detail)`` of an end followed from super-step
    ``s0``: each side's ``((active, iters) at s0, rows, each lane's last
    iterations)``; ``lost`` marks further lanes departing at ``s0``."""
    (active, iters), prog, last = prog_end
    (ref_active, ref_iters), refs, ref_last = ref_end
    differs = (active != ref_active) | (active & (iters != ref_iters))
    if lost is not None:
        differs |= lost
    numbers = {
        "tail_state_gap": int(differs.sum()) / batch,
        "tail_lane_gap": int((last != ref_last).sum()) / batch,
        "in_flight_at_end": int(prog[-1][4]) if prog else batch,
    }
    pairs = list(zip(prog, refs))
    detail = [{"superstep": s0 + i, "program": p, "reference": r}
              for i, (p, r) in enumerate(pairs)]
    detail.append({"superstep": s0, "lanes_in_flight": int(active.sum()), **(extra or {}),
                   "state_departures": int(differs.sum()),
                   "last_frame_departures": int((last != ref_last).sum())})
    return pairs, numbers, detail


def stream_numbers(start: list, tail: list, batch: int) -> dict:
    """The row numbers of a streaming point over the super-steps followed
    at its start and its end (``(program, reference)`` row pairs):
    ``frames_gap`` and ``iter_gap``, the sums of the departures of their
    stopped frames and of those frames' iterations, per frame the reference
    stopped; ``frame_error_gap``, the same sum for frame errors, as a share
    of the reference's; ``frame_error_count_gap`` and
    ``bit_error_count_gap``, the sums for frame and bit errors themselves
    (where the reference counts few errors, a share of them swings by one
    departure); ``active_gap``, the worst departure of the lanes in flight
    after a super-step of the start, as a share of the lanes.  With either
    end not followed no number can pass."""
    gaps, total = np.zeros(4, dtype=np.int64), np.zeros(2, dtype=np.int64)
    for p, r in start + tail:
        gaps += [abs(p[2] - r[2]), abs(p[3] - r[3]), abs(p[1] - r[1]), abs(p[0] - r[0])]
        total += [r[2], r[1]]
    if not start or not tail:
        gaps, total = np.full(4, batch, dtype=np.int64), np.full(2, batch, dtype=np.int64)
    return {
        "frames_gap": int(gaps[0]) / max(int(total[0]), 1),
        "iter_gap": int(gaps[1]) / max(int(total[0]), 1),
        "frame_error_gap": int(gaps[2]) / max(int(total[1]), 1),
        "frame_error_count_gap": int(gaps[2]),
        "bit_error_count_gap": int(gaps[3]),
        "active_gap": max((abs(p[4] - r[4]) / batch for p, r in start), default=1.0),
    }


def pool_pass(graph: Graph, code, traffic: dict, store=identity):
    """The fused pool's pass for ``traffic``: the fast layered engine's
    iteration on the code's layers where the mix reads a layer file (a
    fused pool runs layered only on a code declared quasi-cyclic, ``qc``:
    ``--layer-file --qc-z``), else flooding."""
    return Layered(graph, code.layers, store) if traffic["layer_file"] else Flooding(graph, store)


def pool_start(rows: list, code, traffic: dict, seed: int, batch: int, iterations: int,
               quota: int, supersteps: int, device, store=None) -> tuple:
    """``(pairs, detail)`` of the fused pool's first ``supersteps``
    super-steps: each row beside the reference's, which runs the pool from
    empty on the same keys with the pass :func:`pool_pass` gives.
    ``store`` puts the control in the program's place: its rows are judged
    instead."""
    graph = graph_of(code, device)
    _, n_outer = chunking(iterations)

    def run(store_fn):
        ref = PoolReference(graph, frames_of(code, traffic["snr_db"], device), batch,
                            iterations, quota, pool_pass(graph, code, traffic, store_fn))
        return [ref.superstep(step_keys(seed, 0, s, n_outer, device), True)
                for s in range(min(supersteps, len(rows)))]

    refs = run(decoders.identity)
    prog = [list(r) for r in rows[:len(refs)]] if store is None else run(store)
    pairs = list(zip(prog, refs))
    detail = [{"superstep": s, "program": p, "reference": r} for s, (p, r) in enumerate(pairs)]
    return pairs, detail


def pool_tail(rows: list, refill: list, snapshot, end, code, traffic: dict, seed: int,
              batch: int, iterations: int, quota: int, device, store=None) -> tuple:
    """``(pairs, numbers, detail)`` of the fused pool's end, as
    :func:`stream_tail` gives a streaming point's: ``snapshot`` is ``(s0,
    active, age, iters, avail, llr, cw, pool_llr, pool_cw, started)``, the
    program's lanes and pool at the start of super-step ``s0`` (the last
    that refilled; the planes in the code's labels), ``end`` ``(active,
    iters)`` its lanes after the last super-step.  The reference finds the
    key of each frame in flight or in an unused entry among the chunks of
    the :data:`POOL_LOOKBACK` super-steps before ``s0``
    (:func:`.pool.identify`; on the fast layered engine, whose lanes carry
    their APP, a lane in flight by its codeword alone), starts the lanes in flight
    again from its own draws for their ages with the pass :func:`pool_pass`
    gives, puts its draws in the unused entries and follows
    ``s0`` to the last super-step, drawing every refill from the seed.
    ``tail_state_gap`` counts the lanes whose in-flight flag or iteration
    count at ``s0`` differs from the reference's, or whose unused entry
    holds a frame no key draws; lanes idle at ``s0`` keep the program's
    count there (their last frame before ``s0`` is not judged)."""
    if snapshot is None or end is None or not rows:
        return [], {"tail_state_gap": 1.0, "tail_lane_gap": 1.0, "in_flight_at_end": batch}, []
    s0 = snapshot[0]
    active, age, iters, avail, llr, cw, pool_llr, pool_cw, started = (
        t.to(device) for t in snapshot[1:])
    graph = graph_of(code, device)
    frames = frames_of(code, traffic["snr_db"], device)
    app = bool(traffic["layer_file"])  # the fast layered engine's lanes hold their APP
    _, n_outer = chunking(iterations)
    keys = {s: step_keys(seed, 0, s, n_outer, device)
            for s in range(max(0, s0 - POOL_LOOKBACK), len(refill))}
    candidates = [k for s in sorted(keys) if s < s0 for k in keys[s]]
    info = info_columns(code.G)
    lanes = active.nonzero().flatten()
    found, ref_llr, ref_cw = identify(frames, candidates, lanes,
                                      None if app else llr[:, lanes], cw[:, lanes], info)
    entries = avail.nonzero().flatten()
    efound, e_llr, e_cw = identify(frames, candidates, entries, pool_llr[:, entries],
                                   pool_cw[:, entries], info)
    drawn, edrawn = found >= 0, efound >= 0

    def follow(store_fn):
        ref = PoolReference(graph, frames, batch, iterations, quota,
                            pool_pass(graph, code, traffic, store_fn))
        ref.restore(lanes[drawn], age[lanes[drawn]], ref_llr[:, drawn], ref_cw[:, drawn])
        ref.set_pool(entries[edrawn], e_llr[:, edrawn], e_cw[:, edrawn])
        ref.started = int(started.reshape(-1)[0])
        idle = ~active
        ref.iters[idle] = iters[idle].to(ref.iters.dtype)
        at_s0 = (ref.active.clone(), ref.iters.clone())
        out = [ref.superstep(keys[s], refill[s]) for s in range(s0, len(refill))]
        return at_s0, out, ref.iters

    ref_end = follow(decoders.identity)
    prog_end = follow(store) if store is not None else \
        ((active, iters), [list(r) for r in rows[s0:len(refill)]], end[1].to(device))
    lost = torch.zeros(batch, dtype=torch.bool, device=device)
    lost[entries[~edrawn]] = True
    return _tail_numbers(s0, prog_end, ref_end, batch, lost, {
        "frames_undrawn": int((~drawn).sum()), "entries_unused": int(entries.numel()),
        "entries_undrawn": int((~edrawn).sum())})
