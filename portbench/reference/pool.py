"""The fused pool of the ``--pallas`` sweep in float64: the streaming
engine of ``libldpc_tpu_torch/ops/streaming_fused.py``, worked out from
its plain chunk (``stream_chunk_plain``, ``bp_stream_chunk_fused_plain``)
and K8's ``pool_refill``.

* ``B`` lanes, each an independent stream of frames, and ``B`` pool
  entries, each a frame and an ``avail`` flag (unused).  Lane ``b`` takes
  its frames from entry ``b`` alone.
* A super-step is ``n_outer = ceil(iterations / k)`` chunks of ``k``
  passes, ``k = max(4, min(8, iterations // 8))``: 9 chunks of 6 passes,
  54 passes, at 50 iterations.  Its generator (the sweep's step generator,
  :func:`.channel.step_generator`) draws the ``n_outer`` keys in one call
  on the card (``draw_keys``: ``torch.randint(0, 2**62)``); chunk ``j``
  takes key ``j``.
* Before each chunk, when refilling and once at least ``watermark``
  entries are used (``3 B / 4``), every used entry takes a fresh frame
  drawn on the chunk's key, and every entry is unused again; otherwise
  the pool is kept.  Entry ``b``'s frame is the channel's lane ``b`` on
  that key (:mod:`.channel`): K8 seeds ``curand_init(key, b, offset)``
  with the entry's own index as the subsequence (``pool_draw_kernel``:
  ``lane = lanes[idx]``), not its rank among the entries drawn, at the
  offsets of every other draw (the info words from 0, the transmitted
  bits' normals from ``kw = 4 ceil(kc / 128)``).
* Each pass first grants, when refilling, the idle lanes whose entry is
  unused, in lane order, while the frames started stay within the quota:
  a granted lane takes its entry's frame and starts from its prior
  (``Pass.start``: for flooding, the prior as every edge's first
  message), age 1, no iterations, its entry used.  Then every lane in
  flight runs one pass (``Pass.step``): a lane of age 1 or more checks the
  decisions of its posterior (``<= 0`` decides 1), iterations count break
  before increment, and a lane finishes when its check passes or its age
  reaches ``iterations + 1``; its bit errors (over the transmitted bits),
  frame error, frame and iterations go to the super-step's counts.
* A super-step reports ``[bit_errors, frame_errors, frames, iter_sum,
  in_flight]``, the program's ``StreamDeltas`` order, with the lanes in
  flight after it.

The pass is a parameter (``Pass``: ``start(prior) -> state``, ``step(prior,
state) -> (posterior, state)``, a state a list of ``[*, L]`` tensors), so
the same pool runs flooding (:class:`.decoders.Flooding`, ``--pallas``) or
the fast layered engine's iteration (:class:`.decoders.Layered`,
``--pallas --layer-file --qc-z Z`` on a QC code's natural layers).  The
fast layered engine (``bp_stream_chunk_layered_fast`` and its plain
version) runs in the same super-step (``_shard_stepper``): the same ``k``
and ``n_outer``, the same K8 ``pool_refill`` before each chunk at the
same watermark on the same keys, the same grants; only the pass differs.
Its state differs in what it holds, not in its shapes: the program's
``llr_in`` plane carries a lane's APP, not its prior, so a lane in flight
is found by its codeword alone (:func:`identify` without LLRs), while an
unused entry still holds the raw LLRs K8 drew.
"""

from __future__ import annotations

import numpy as np
import torch

from .channel import FrameSource
from .decoders import Flooding, Graph, Lanes


def chunking(iterations: int) -> tuple:
    """``(k, n_outer)``: the passes a chunk and the chunks a super-step of
    the fused pool at the sweep's default chunk length."""
    k = max(4, min(8, iterations // 8))
    return k, max(1, -(-iterations // k))


def watermark(batch: int) -> int:
    """Used entries before a refill: ``3 B / 4``."""
    return max(1, 3 * batch // 4)


class PoolReference(Lanes):
    """The fused pool on ``B`` lanes, from empty (or from lanes and entries
    set by :meth:`restore` and :meth:`set_pool`)."""

    def __init__(self, graph: Graph, frames: FrameSource, batch: int, iterations: int,
                 quota: int, step=None):
        super().__init__(graph, batch, iterations, step if step is not None else Flooding(graph))
        dev = graph.device
        self.frames, self.quota = frames, quota
        self.k, self.n_outer = chunking(iterations)
        self.watermark = watermark(batch)
        self.pool_llr = torch.zeros((graph.nc, batch), dtype=torch.float64, device=dev)
        self.pool_cw = torch.zeros((graph.nc, batch), dtype=torch.bool, device=dev)
        self.avail = torch.zeros(batch, dtype=torch.bool, device=dev)

    def refill(self, key: int) -> None:
        """The pool's refresh before a chunk (refilling): at the watermark,
        every used entry drawn on ``key`` and every entry unused."""
        used = ~self.avail
        if int(used.sum()) < self.watermark:
            return
        lanes = used.nonzero().flatten()
        self.pool_llr[:, lanes], self.pool_cw[:, lanes] = self.frames.draw(key, lanes)
        self.avail.fill_(True)

    def grant(self) -> None:
        """A pass's starts: idle lanes with an unused entry, in lane order,
        within the quota."""
        eligible = ~self.active & self.avail
        rank = torch.cumsum(eligible.to(torch.int64), 0)
        lanes = (eligible & (self.started + rank <= self.quota)).nonzero().flatten()
        if lanes.numel():
            self._start(lanes, self.pool_llr[:, lanes], self.pool_cw[:, lanes])
            self.avail[lanes] = False

    def superstep(self, keys: list, refill: bool) -> list:
        """One super-step, a chunk on each of ``keys``: ``[bit_errors,
        frame_errors, frames, iter_sum, in_flight]``."""
        counts = np.zeros(4, dtype=np.int64)
        for key in keys:
            if refill:
                self.refill(key)
            for _ in range(self.k):
                if refill:
                    self.grant()
                counts += self._pass()
        return [int(v) for v in counts] + [int(self.active.sum())]

    def restore(self, lanes: torch.Tensor, age: torch.Tensor, llr: torch.Tensor,
                cw: torch.Tensor) -> None:
        """Lanes in flight started again: lane ``lanes[i]`` of age
        ``age[i]`` has run ``age[i] - 1`` passes since it took the frame
        ``llr[:, i]``, ``cw[:, i]``; it starts from that frame's prior and is
        decoded those passes again, nothing counted.  A lane that finishes
        on the way is left idle."""
        runs = age.to(torch.int64) - 1
        for t in range(int(runs.max()) if runs.numel() else 0, 0, -1):
            sel = runs == t
            if bool(sel.any()):
                self._start(lanes[sel], llr[:, sel], cw[:, sel])
            self._pass()
        sel = runs <= 0
        if bool(sel.any()):
            self._start(lanes[sel], llr[:, sel], cw[:, sel])

    def set_pool(self, entries: torch.Tensor, llr: torch.Tensor, cw: torch.Tensor) -> None:
        """The unused entries ``entries`` hold the frames ``llr``, ``cw``;
        every other entry is used."""
        self.avail.fill_(False)
        self.pool_llr[:, entries] = llr
        self.pool_cw[:, entries] = cw
        self.avail[entries] = True


def info_columns(G: np.ndarray) -> np.ndarray:
    """int64 ``[kc]``: for each info bit, a column of ``G`` that is its unit
    vector (the codeword carries the bit there)."""
    g = np.asarray(G) != 0
    unit = np.flatnonzero(g.sum(0) == 1)
    cols = np.full(g.shape[0], -1, dtype=np.int64)
    cols[g[:, unit].argmax(0)] = unit
    if (cols < 0).any():
        raise ValueError("G is not systematic: a frame's key cannot be read from its codeword")
    return cols


def identify(frames: FrameSource, keys: list, lanes: torch.Tensor, llr, cw: torch.Tensor,
             info_cols: np.ndarray, tol: float = 1e-3) -> tuple:
    """Which of ``keys`` drew each of the frames ``llr`` (float ``[nc,
    L]``), ``cw`` (bool) held by ``lanes``: ``(found, ref_llr, ref_cw)``,
    ``found[i]`` the index of the key whose draw of lane ``lanes[i]`` has
    the frame's info bits, its whole codeword and its LLRs within ``tol``
    (-1: none), and that draw, the reference's own (zero where none).
    ``llr`` None matches the info bits and the codeword alone."""
    dev = frames.device
    L = lanes.numel()
    found = torch.full((L,), -1, dtype=torch.int64, device=dev)
    ref_llr = torch.zeros((frames.nc, L), dtype=torch.float64, device=dev)
    ref_cw = torch.zeros((frames.nc, L), dtype=torch.bool, device=dev)
    info = cw[torch.as_tensor(info_cols, device=dev)]  # [kc, L]
    for i, key in enumerate(keys):
        todo = (found < 0).nonzero().flatten()
        if todo.numel() == 0:
            break
        u = frames.info_bits(key, lanes[todo]).t() > 0.5
        sel = todo[(u == info[:, todo]).all(dim=0)]
        if sel.numel() == 0:
            continue
        l, c = frames.draw(key, lanes[sel])
        good = (c == cw[:, sel]).all(dim=0)
        if llr is not None:
            good &= ((l - llr[:, sel].double()).abs() <= tol).all(dim=0)
        sel, l, c = sel[good], l[:, good], c[:, good]
        found[sel] = i
        ref_llr[:, sel] = l
        ref_cw[:, sel] = c
    return found, ref_llr, ref_cw
