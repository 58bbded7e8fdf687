"""Belief propagation in float64, in the code's own labels: the flooding
and fast layered passes of the streaming engines, and the batch decodes
(flooding, the exact layered schedule), with the semantics the sweep
states.

* A check's message is the box-plus of its other inputs (computed in
  Gallager's ``phi`` form), a variable's posterior its prior plus every
  incoming message.
* Early termination: a frame stops at the first check of its decisions
  (``posterior <= 0`` decides 1) that satisfies every parity check; its
  decisions are those of that check.  Iterations count break before
  increment: a frame whose first check passes reports 0, one that never
  passes reports the cap.
* The streaming engine (``StreamReference``): ``B`` lanes, each an
  independent stream of frames.  Every pass runs one flooding iteration on
  every lane in flight, counts the frames that stop (converged, or at the
  cap), and then, when refilling and at least ``gen_threshold`` lanes are
  idle, gives the idle lanes in lane order (at most ``quota - started``)
  fresh frames drawn on the pass's key; a fresh lane starts from its prior
  as every edge's first message.  A super-step is a run of passes, each
  with its own key, and reports the counts of the frames that stopped in
  it and the lanes in flight after it.
* A layer step (:func:`layer_step`, shared by :class:`Layered` and
  :func:`decode_layered`): the layer's checks update from the messages
  ``posterior - own message``, and the posteriors of their variables move
  by each new message's difference from the old one.
* The exact layered schedule (``decode_layered``): the layer steps in
  order, and a frame whose decisions then satisfy every check stops,
  mid-iteration; an iteration counts for a frame that was running both at
  its start and at its end.
* Flooding in batches (``decode_flooding``): with early termination as
  above; without it every frame runs every iteration, reports the cap and
  is judged by the decisions of its last posterior.

``store`` is the rounding applied where a decoder stores a message or a
posterior: none for the reference, bfloat16 for the control.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .channel import FrameSource


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bfloat16_store(x: torch.Tensor) -> torch.Tensor:
    """The control's storage: every stored message rounded to bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)


#: the identity of the box-plus: a slot past a check's degree holds it
PAD = 1e30


def boxplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sign(x) sign(y) min(|x|, |y|) + log(1 + e^-|x+y|) - log(1 + e^-|x-y|)``
    (the signs of signed zeros count)."""
    m = torch.copysign(torch.minimum(torch.abs(x), torch.abs(y)), x * y)
    return m + F.softplus(-torch.abs(x + y)) - F.softplus(-torch.abs(x - y))


def exclusion(M: torch.Tensor) -> torch.Tensor:
    """All-but-one box-plus along axis 1 of ``[checks, degree, B]``, from
    forward and backward prefixes (scanned together) and one box-plus of
    the pairs between them."""
    d = M.shape[1]
    if d == 1:
        return torch.full_like(M, PAD)
    acc = torch.stack([M[:, 0], M[:, d - 1]])
    fw, bw = [acc[0]], [acc[1]]
    for j in range(1, d - 1):
        acc = boxplus(acc, torch.stack([M[:, j], M[:, d - 1 - j]]))
        fw.append(acc[0])
        bw.append(acc[1])
    # fw[k] combines slots 0..k, bw[k] slots d-1-k..d-1
    parts = [bw[d - 2][:, None]]
    if d > 2:
        parts.append(boxplus(torch.stack(fw[:d - 2], dim=1),
                             torch.stack(bw[d - 3::-1], dim=1)))
    parts.append(fw[d - 2][:, None])
    return torch.cat(parts, dim=1)


class Graph:
    """The Tanner graph on a device: edges in (check, variable) order; a
    set of checks is held as ``[count, max degree]`` edge indices and a
    mask of the slots that exist.  ``transmitted``: the variables whose
    decisions count as bit errors (every one when None), as the program
    counts over ``bit_pos``."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, nc: int, mc: int, device,
                 transmitted=None):
        self.device = torch.device(device)
        self.tx = None
        if transmitted is not None and len(transmitted) < nc:
            self.tx = torch.as_tensor(np.asarray(transmitted, dtype=np.int64), device=self.device)
        order = np.lexsort((cols, rows))
        rows, cols = np.asarray(rows)[order], np.asarray(cols)[order]
        self.nc, self.mc, self.nnz = nc, mc, rows.size
        self.cols = torch.as_tensor(cols, dtype=torch.int64, device=self.device)
        self.row_ptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=mc))])
        self.all = self.checks(np.arange(mc))

    def checks(self, checks: np.ndarray):
        """``(slots, mask)`` of ``checks``: int64 ``[count, d]`` edge
        indices (0 past a check's degree) and bool ``[count, d]``."""
        deg = self.row_ptr[checks + 1] - self.row_ptr[checks]
        d = max(1, int(deg.max()))
        mask = np.arange(d)[None, :] < deg[:, None]
        slots = np.where(mask, self.row_ptr[checks][:, None] + np.arange(d)[None, :], 0)
        return (torch.as_tensor(slots, dtype=torch.int64, device=self.device),
                torch.as_tensor(mask, device=self.device))

    def messages(self, lv2c: torch.Tensor, group) -> torch.Tensor:
        """The check messages of ``group`` from the variables' messages at
        its slots (``[count, d, B]``; padding slots meaningless)."""
        slots, mask = group
        return exclusion(torch.where(mask[:, :, None], lv2c[slots], PAD))

    def cn_update(self, lv2c: torch.Tensor) -> torch.Tensor:
        slots, mask = self.all
        out = torch.empty_like(lv2c)
        out[slots[mask]] = self.messages(lv2c, self.all)[mask]
        return out

    def posterior(self, prior: torch.Tensor, lc2v: torch.Tensor) -> torch.Tensor:
        return prior.clone().index_add_(0, self.cols, lc2v)

    def bit_errors(self, post: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
        """int ``[B]``: the transmitted bits whose decision (``post <= 0``
        decides 1) is not the codeword's."""
        wrong = (post <= 0) != cw
        return (wrong if self.tx is None else wrong.index_select(0, self.tx)).sum(dim=0)

    def syndrome_ok(self, post: torch.Tensor) -> torch.Tensor:
        """bool ``[B]``: the decisions of ``post`` satisfy every check."""
        slots, mask = self.all
        bits = (post <= 0).index_select(0, self.cols)[slots] & mask[:, :, None]
        return ~(bits.sum(dim=1, dtype=torch.int32) % 2).bool().any(dim=0)


class Flooding:
    """One flooding iteration as a pass of a streaming engine: a lane
    carries its variables' messages (``[nnz, L]``, one list entry); a fresh
    lane starts from its prior as every edge's first message."""

    def __init__(self, graph: Graph, store: Callable = identity):
        self.g, self.store = graph, store

    def start(self, prior: torch.Tensor) -> list:
        return [self.store(prior.index_select(0, self.g.cols))]

    def step(self, prior: torch.Tensor, state: list) -> tuple:
        """``(posterior, state)`` after one iteration."""
        g, st = self.g, self.store
        lc2v = st(g.cn_update(state[0]))
        post = st(g.posterior(prior, lc2v))
        return post, [st(post.index_select(0, g.cols) - lc2v)]


def layer_step(g: Graph, post: torch.Tensor, lc2v: torch.Tensor, group, store: Callable,
               running: torch.Tensor = None) -> torch.Tensor:
    """One layer's checks (``group``, from :meth:`Graph.checks`) on
    ``post`` ``[nc, L]`` and ``lc2v`` ``[nnz, L]``: each check's new
    messages are the exclusion of ``post - own message`` at its slots, and
    ``lc2v`` and the posteriors of its variables move by the new messages'
    differences from the old ones (``lc2v`` in place).  Frames not
    ``running`` (bool ``[L]``; every frame when None) keep both.  Returns
    the new posterior."""
    slots, mask = group
    V = g.cols[slots]
    old = lc2v[slots]
    lv = store(torch.where(mask[:, :, None], post[V] - old, PAD))
    new = store(exclusion(lv))
    delta = torch.where(mask[:, :, None], new - old, 0.0)
    if running is not None:
        delta = delta * running.to(post.dtype)
    flat = delta.reshape(-1, delta.shape[-1])
    lc2v.index_add_(0, slots.reshape(-1), flat)
    return store(post.index_add_(0, V.reshape(-1), flat))


class Layered:
    """One iteration of the fast layered engine as a pass of a streaming
    engine (``kernel_stream_layered_qc``; the program's
    ``bp_stream_chunk_layered_fast_plain``): a lane carries its posterior,
    the APP ``[nc, L]``, and its check messages ``[nnz, L]`` (two list
    entries).

    * A fresh lane starts with the APP at its prior and every check
      message 0.
    * One pass is one iteration: the code's layers in order, each a
      :func:`layer_step` (the layer's checks update from ``APP - own
      message``, the APP of their variables moves by the new messages'
      differences from the old).
    * The decisions are checked once a pass, after its last layer, on the
      APP (by :class:`Lanes`: a lane of age 1 or more; nothing stops a
      frame between layers, unlike :func:`decode_layered`)."""

    def __init__(self, graph: Graph, layers: list, store: Callable = identity):
        self.g, self.store = graph, store
        self.groups = [graph.checks(np.asarray(l, dtype=np.int64)) for l in layers]

    def start(self, prior: torch.Tensor) -> list:
        return [self.store(prior.clone()),
                torch.zeros((self.g.nnz, prior.shape[1]), dtype=prior.dtype,
                            device=prior.device)]

    def step(self, prior: torch.Tensor, state: list) -> tuple:
        """``(posterior, state)`` after one iteration (the state's planes
        updated in place)."""
        post, lc2v = state
        for group in self.groups:
            post = layer_step(self.g, post, lc2v, group, self.store)
        return post, [post, lc2v]


class Lanes:
    """``B`` lanes of a streaming engine, each an independent stream of
    frames decoded a pass at a time by ``step`` (a pass such as
    :class:`Flooding`), with the sweep's early termination and counting;
    the engines differ in when and from where a lane starts."""

    def __init__(self, graph: Graph, batch: int, iterations: int, step):
        dev = graph.device
        self.g, self.B, self.iterations, self.step = graph, batch, iterations, step
        self.llr = torch.zeros((graph.nc, batch), dtype=torch.float64, device=dev)
        self.cw = torch.zeros((graph.nc, batch), dtype=torch.bool, device=dev)
        self.state = step.start(self.llr)
        self.active = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.age = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.iters = torch.zeros(batch, dtype=torch.int32, device=dev)
        self.started = 0

    def _start(self, lanes: torch.Tensor, llr: torch.Tensor, cw: torch.Tensor) -> None:
        """The frames ``llr``, ``cw`` into ``lanes``, each from its prior."""
        self.llr[:, lanes] = llr
        self.cw[:, lanes] = cw
        for s, v in zip(self.state, self.step.start(llr)):
            s[:, lanes] = v
        self.active[lanes] = True
        self.age[lanes] = 1
        self.iters[lanes] = 0
        self.started += int(lanes.numel())

    def _pass(self) -> list:
        """One pass on the lanes in flight (gathered where not every lane
        is): ``[bit_errors, frame_errors, frames, iter_sum]`` of the frames
        that stop in it."""
        g = self.g
        lanes = self.active.nonzero().flatten()
        if lanes.numel() == 0:
            return [0, 0, 0, 0]
        every = lanes.numel() == self.B

        def pick(t):
            return t if every else t[:, lanes]

        post, state = self.step.step(pick(self.llr), [pick(s) for s in self.state])
        age = self.age[lanes]
        checking = age >= 1
        ok = g.syndrome_ok(post)
        iters = self.iters[lanes] + (checking & ~ok).to(torch.int32)
        age = age + 1
        finished = (checking & ok) | (age >= self.iterations + 1)
        biterr = g.bit_errors(post, pick(self.cw))[finished]
        self.iters[lanes] = iters
        self.age[lanes] = age
        self.active[lanes[finished]] = False
        if every:
            self.state = state
        else:
            for s, v in zip(self.state, state):
                s[:, lanes] = v
        return [int(biterr.sum()), int((biterr > 0).sum()), int(biterr.numel()),
                int(iters[finished].sum())]


class StreamReference(Lanes):
    """The default sweep's streaming engine on ``B`` lanes, from empty (or
    from lanes started again by :meth:`restore`)."""

    def __init__(self, graph: Graph, frames: FrameSource, batch: int, iterations: int,
                 gen_threshold: int, quota: int, store: Callable = identity):
        super().__init__(graph, batch, iterations, Flooding(graph, store))
        self.frames, self.gen_threshold, self.quota = frames, gen_threshold, quota

    def _draw(self, lanes: torch.Tensor, key: int) -> None:
        """Fresh frames into ``lanes``, drawn on ``key``."""
        self._start(lanes, *self.frames.draw(key, lanes))

    def superstep(self, keys: list, refill: bool) -> list:
        """One super-step of ``len(keys)`` passes: ``[bit_errors,
        frame_errors, frames, iter_sum, in_flight]``."""
        counts = np.zeros(4, dtype=np.int64)
        for key in keys:
            counts += self._pass()
            idle = ~self.active
            if refill and int(idle.sum()) >= self.gen_threshold:
                rank = torch.cumsum(idle.to(torch.int64), 0)
                self._draw((idle & (self.started + rank <= self.quota)).nonzero().flatten(),
                           key)
        return [int(v) for v in counts] + [int(self.active.sum())]

    def restore(self, draws: dict, upto: int, key_of: Callable) -> None:
        """The lanes in flight at the start of pass ``upto``, started again
        from their draws: ``draws`` maps a pass to the lanes whose frame was
        drawn at its end (on ``key_of(pass)``), and each is decoded from
        there to ``upto``, nothing counted.  A lane that stops on the way
        is left idle."""
        for p in range(min(draws, default=upto), upto):
            self._pass()
            if p in draws:
                self._draw(draws[p], key_of(p))


def decode_layered(graph: Graph, layers: list, prior: torch.Tensor, cw: torch.Tensor,
                   iterations: int, store: Callable = identity) -> dict:
    """The exact layered schedule with early termination on a batch of
    frames (``prior`` float64 ``[nc, B]``, ``cw`` bool): ``{"bit_errors",
    "frame_errors", "frames", "iter_sum"}``.  A layer's new messages change
    the posterior of its variables by their difference from the old ones;
    the frames still running are gathered after every iteration."""
    g = graph
    layered = Layered(g, layers, store)
    B = prior.shape[1]
    P, C = prior, cw
    post, lc2v = layered.start(P)
    be = fe = it = 0
    for _ in range(iterations):
        if P.shape[1] == 0:
            break
        done = torch.zeros(P.shape[1], dtype=torch.bool, device=prior.device)
        for group in layered.groups:
            post = layer_step(g, post, lc2v, group, store, ~done)
            done = done | g.syndrome_ok(post)
        # an iteration counts for a frame running at its start and its end
        it += int((~done).sum())
        fin = done.nonzero().flatten()
        if fin.numel():
            err = g.bit_errors(post[:, fin], C[:, fin])
            be += int(err.sum())
            fe += int((err > 0).sum())
            keep = (~done).nonzero().flatten()
            P, C, post, lc2v = P[:, keep], C[:, keep], post[:, keep], lc2v[:, keep]
    if P.shape[1]:
        err = g.bit_errors(post, C)
        be += int(err.sum())
        fe += int((err > 0).sum())
    return {"bit_errors": be, "frame_errors": fe, "frames": B, "iter_sum": it}


def decode_flooding(graph: Graph, prior: torch.Tensor, cw: torch.Tensor, iterations: int,
                    early_term: bool, store: Callable = identity) -> dict:
    """Flooding on a batch of frames (``prior`` float64 ``[nc, B]``, ``cw``
    bool), as the batch step counts it (``bp_decode_fused_plain``, the
    counting of ``_sim_and_count``): ``{"bit_errors", "frame_errors",
    "frames", "iter_sum"}``.  With ``early_term`` a frame stops at the
    first check of its decisions that passes, after the pass that makes
    them (break before increment: a frame reports the passes whose check
    failed), and is judged by those decisions; the frames still running
    are gathered after every iteration.  Without it every frame runs
    ``iterations`` passes, reports ``iterations`` and is judged by the
    decisions of its last posterior.  Bit errors count the transmitted
    bits."""
    g = graph
    flooding = Flooding(g, store)
    B = prior.shape[1]
    P, C = prior, cw
    state = flooding.start(P)
    post = P
    be = fe = it = 0
    for _ in range(iterations):
        if P.shape[1] == 0:
            break
        post, state = flooding.step(P, state)
        if not early_term:
            it += P.shape[1]
            continue
        ok = g.syndrome_ok(post)
        it += int((~ok).sum())
        fin = ok.nonzero().flatten()
        if fin.numel():
            err = g.bit_errors(post[:, fin], C[:, fin])
            be += int(err.sum())
            fe += int((err > 0).sum())
            keep = (~ok).nonzero().flatten()
            P, C, post = P[:, keep], C[:, keep], post[:, keep]
            state = [s[:, keep] for s in state]
    if P.shape[1]:
        err = g.bit_errors(post, C)
        be += int(err.sum())
        fe += int((err > 0).sum())
    return {"bit_errors": be, "frame_errors": fe, "frames": B, "iter_sum": it}
