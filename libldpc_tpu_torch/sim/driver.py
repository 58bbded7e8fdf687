"""Monte-Carlo sweep driver (from :mod:`libldpc_tpu.sim.driver`), one device.

Each sweep point runs device batches until the reference's stopping rule
``fec >= minFec || frames >= maxFrames || stop`` is met, evaluated on the
host between batches.  With early termination on (the default) the point
runs on a streaming kernel; otherwise each batch is one launch of a batch
decode kernel.  The schedule (flooding, exact layered, or the fast layered
engine) is the one the JAX package runs for the same code and flags
(:func:`select_schedule`); the exact layered schedule is batch-stepped,
as there.  So is the message dtype (:func:`select_message_dtype`): with
``--pallas`` every schedule stores its messages in bfloat16 or on the int8
lattice as asked, widened to float32 where the JAX package widens it.
The BEC runs the peeling kernel, flooding and batch-stepped
always, as the JAX package's sweep does (with ``--layer-file`` that
package runs its sorted peeling decoder, which ignores the layers).  On a
CUDA device the CUDA kernels run, on the CPU their plain PyTorch versions.

Kept from the JAX driver: the sweep values (float accumulation, max
exclusive, reversed for BSC), the warm-up batch outside the frame clock,
the lookahead batch pipeline, the streaming window / absorb / drain loop
and its stall guard, the live console row, the results file rewritten on
every new frame error with the decode-path provenance line, the BER
divided by ``frames * nc``, the checkpoint (written atomically after every
absorb and at every point boundary, stamped with the experiment's
identity; ``start(resume=True)`` continues from it) and the forensic error
log (a line per errored frame; it turns streaming off, as there).
Points-parallel and multi-device sweeps are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import sys
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..models.code import LDPCCode
from ..models.io import format_result_row, write_results_file
from ..ops.channel import make_generator
from ..ops.kernels.layout import kernel_tables
from ..ops.layered import natural_qc_layers
from ..ops.messages import DTYPE_CODES, MessageForm
from ..ops.sorted import to_sorted_device
from ..ops.streaming_fused import make_streaming_fused_step
from ..parallel.mesh import make_sim_step
from ..utils.params import ChannelParams, DecoderParams, SimulationParams
from .results import SimResults

_CONSOLE_HEADER = (
    "==============================================================="
    "=============================\n"
    "  FEC   |      FRAME     |   {xval}   |    BER     |    FER     "
    "| AVGITERS  |  TIME/FRAME   \n"
    "========+================+=========+============+============+="
    "==========+=============="
)

#: Batch key of the warm-up batch (outside every point's key space).
_WARMUP_BATCH = 0x7FFFFFFF


@dataclasses.dataclass
class _PointCounters:
    """Raw accumulators of one sweep point."""

    bit_errors: int = 0
    frame_errors: int = 0
    frames: int = 0
    iter_sum: int = 0
    elapsed_s: float = 0.0
    next_batch: int = 0

    def as_list(self) -> list:
        return [self.bit_errors, self.frame_errors, self.frames, self.iter_sum, self.elapsed_s,
                self.next_batch]

    @classmethod
    def from_list(cls, vals) -> "_PointCounters":
        return cls(int(vals[0]), int(vals[1]), int(vals[2]), int(vals[3]), float(vals[4]),
                   int(vals[5]))


#: Routing constants of the JAX package's driver (``libldpc_tpu/sim/driver.py``),
#: mirrored here only so that one command line selects the same schedule in
#: both packages (:func:`select_schedule`).  There they bound what its TPU
#: kernels compile; the CUDA kernels have no such limits.
FUSED_EDGE_SPACE_LIMIT = 4096
QC_LANES_EDGE_SPACE_LIMIT = 786432
#: The qc lane layout's sub-32-bit walls: past the first, bfloat16 with the
#: BP form widens to float32; past the second, every sub-32-bit dtype does
#: (the JAX package records the widening in its provenance, as the port
#: does).  On the qc route the port computes the JAX edge space exactly.
QC_LANES_SUB32_EDGE_SPACE_LIMIT = 196608
QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT = 294912
#: The smallest of the JAX package's other sub-32-bit compile walls is its
#: Clos lane layout's 65536 padded edge slots; past it that package widens
#: messages to float32.  Off the qc route the port does not copy the lane
#: layouts that decide where a code lands, so it refuses a sub-32-bit dtype
#: on a code that could reach a wall (:func:`select_message_dtype`).
SUB32_EDGE_SPACE_LIMIT = 65536
SUB32_EDGE_LIMIT = SUB32_EDGE_SPACE_LIMIT // 2

#: CN forms other than BP (an unknown ``--decoding`` string decodes as BP)
_NON_BP_FORMS = ("BP_MS", "BP_NMS", "BP_OMS", "BP_LIN", "BP_TANH", "BP_PHI")

_SUB32_ROUTING = 'ROADMAP Queue 1, "Sub-32-bit routing past the TPU envelopes"'


def check_supported(dec: DecoderParams, ch: ChannelParams) -> None:
    """Raise for a message dtype the port does not know, and for an int8
    lattice under a CN form outside the min-sum family (``ValueError``, the
    JAX package's words); the BEC ignores the dtype."""
    if dec.message_dtype not in DTYPE_CODES:
        raise ValueError(f"message dtype {dec.message_dtype!r}: expected one of "
                         f"{list(DTYPE_CODES)}")
    if ch.type != "BEC" and dec.message_dtype != "float32":
        MessageForm(dec.message_dtype, dec.quant_scale).check_cn_mode(dec.cn_mode)


def qc_lanes_space(code: LDPCCode, use_pallas: bool, channel_type: str = "AWGN") -> Optional[int]:
    """The edge space (``n_pad``) of the JAX package's qc lane layout when its
    ``_select_layout`` puts this code there, else None: with
    ``use_pallas``, off the BEC, for a QC code with ``Z >= 64`` (the qc
    transport's 2x lane-inflation cap) whose Beneš-padded edge space passes
    ``FUSED_EDGE_SPACE_LIMIT``.  The layout gives each circulant
    ``ceil(Z / 128) * 128`` lanes.  This assumes that the layout builds,
    which holds for QC codes whose edges are listed row by row in one
    column order per base row (``expand_qc``, and ``detect_qc`` on files
    written from such codes)."""
    if not use_pallas or channel_type == "BEC" or getattr(code, "qc", None) is None:
        return None
    Z = int(code.qc[0])
    benes_pad = 1 << max(1, (max(2, code.nnz) - 1).bit_length())
    if Z < 64 or benes_pad <= FUSED_EDGE_SPACE_LIMIT:
        return None
    return code.nnz // Z * (math.ceil(Z / 128) * 128)


def select_schedule(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
                    channel_type: str = "AWGN") -> str:
    """The schedule the JAX package's ``Simulator`` decodes with for this
    code and these flags (the ``schedule=`` of its ``decode_path``).

    ``"flooding"`` without ``dec.layered``, and always for the BEC (whose
    peeling decoders in the JAX package ignore the layers, though its
    ``decode_path`` then says ``layered``).  ``"layered-fast"`` (the fast
    QC engine) where its routing reaches the lanes qc transport
    (:func:`qc_lanes_space`) within ``QC_LANES_EDGE_SPACE_LIMIT``, with
    layers that are the code's natural QC schedule
    (:func:`..ops.layered.natural_qc_layers`).  ``"layered"`` (the exact
    schedule) otherwise.  This mirrors the JAX routing only so that the
    same command line gives the same schedule (and FER)."""
    if not dec.layered or channel_type == "BEC":
        return "flooding"
    qc = qc_lanes_space(code, use_pallas, channel_type)
    if qc is not None and qc <= QC_LANES_EDGE_SPACE_LIMIT and natural_qc_layers(code):
        return "layered-fast"
    return "layered"


def qc_widening(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
                channel_type: str = "AWGN") -> Optional[str]:
    """Why the JAX package decodes a sub-32-bit ``dec.message_dtype`` in
    float32 on its qc lane layout (the provenance note), or None: past
    ``QC_LANES_SUB32_EDGE_SPACE_LIMIT`` for bfloat16 with the BP form, past
    ``QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT`` for any sub-32-bit dtype, and
    past ``QC_LANES_EDGE_SPACE_LIMIT``, where it leaves the qc layout for
    its float32 XLA decoder."""
    qc = qc_lanes_space(code, use_pallas, channel_type)
    if qc is None or dec.message_dtype == "float32":
        return None
    if qc > QC_LANES_EDGE_SPACE_LIMIT:
        limit = QC_LANES_EDGE_SPACE_LIMIT
    elif dec.message_dtype == "bfloat16" and dec.type not in _NON_BP_FORMS:
        limit = QC_LANES_SUB32_EDGE_SPACE_LIMIT
    else:
        limit = QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT
    if qc <= limit:
        return None
    return f"qc n_pad {qc} > {dec.message_dtype} envelope {limit} -> float32"


def select_message_dtype(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
                         channel_type: str = "AWGN") -> str:
    """The message dtype the JAX package's ``Simulator`` decodes with (the
    ``dtype=`` of its ``decode_path``), which the port then runs, on every
    schedule.

    * ``uint8-3state`` for the BEC, which ignores ``--message-dtype`` (the
      port's peeling kernels move 1-byte 3-state symbols);
    * ``float32`` without ``use_pallas``: the JAX package's XLA decoders
      ignore the flag;
    * on the JAX package's qc lane layout (:func:`qc_lanes_space`: the fast
      layered engine, and flooding or the exact schedule on a QC code with
      ``Z >= 64``), ``dec.message_dtype``, widened to float32 where that
      package widens it (:func:`qc_widening`);
    * otherwise ``dec.message_dtype``.  The JAX package widens a sub-32-bit
      dtype to float32 past its other TPU compile walls (the smallest at
      65536 padded slots of its Clos lane layout), and where a code lands
      depends on lane layouts the port does not copy.  Those layouts pad
      each degree class to 128 nodes and then round to a power of two, so
      an edge space may grow more than 2x: the port raises
      (``NotImplementedError``, naming the ROADMAP item) for a code past
      ``SUB32_EDGE_LIMIT`` (32768) slots, or whose class-padded edge space
      passes the wall, rather than guess.  wifi 648 has 2376 slots, the
      1152 (3,6) code 3456."""
    if channel_type == "BEC":
        return "uint8-3state"
    if not use_pallas or dec.message_dtype == "float32":
        return "float32"
    if qc_lanes_space(code, use_pallas, channel_type) is not None:
        return "float32" if qc_widening(code, dec, use_pallas, channel_type) else dec.message_dtype
    counts = np.bincount(code.rows, minlength=code.mc), np.bincount(code.cols, minlength=code.nc)
    padded = max(sum(-(-int((deg == d).sum()) // 128) * 128 * int(d) for d in np.unique(deg))
                 for deg in counts)
    if code.nnz > SUB32_EDGE_LIMIT or padded > SUB32_EDGE_SPACE_LIMIT:
        raise NotImplementedError(
            f"{dec.message_dtype} messages on a code of {code.nnz} edges "
            f"({padded} class-padded slots): {_SUB32_ROUTING}")
    return dec.message_dtype


def route(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
          channel_type: str = "AWGN") -> tuple[str, str, Optional[str]]:
    """``(schedule, message dtype, fallback)`` of a decode of ``code`` with
    these flags: :func:`select_schedule`, :func:`select_message_dtype` and
    :func:`qc_widening`.  A widening to float32 is warned about, as the JAX
    package's ``record_fallback`` does; the caller stamps ``fallback`` into
    its provenance.  The sweep and ``LDPC.decode`` both route here."""
    schedule = select_schedule(code, dec, use_pallas, channel_type)
    dtype = select_message_dtype(code, dec, use_pallas, channel_type)
    fallback = qc_widening(code, dec, use_pallas, channel_type)
    if fallback:
        warnings.warn(f"{dec.message_dtype} messages widened to float32 ({fallback}), "
                      "as the JAX package widens them", stacklevel=3)
    return schedule, dtype, fallback


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


class Simulator:
    """Drives a BER/FER sweep for one code over one channel family."""

    def __init__(
        self,
        code: LDPCCode,
        decoder_params: DecoderParams = DecoderParams(),
        channel_params: ChannelParams = ChannelParams(),
        simulation_params: SimulationParams = SimulationParams(),
        device="cuda",
        verbose: bool = True,
        use_pallas: bool = False,
    ):
        check_supported(decoder_params, channel_params)
        self._asked_dec = decoder_params  # the checkpoint's identity
        self.device = resolve_device(device)
        self.code = code
        self.ch = channel_params
        self.sim = simulation_params
        self.verbose = verbose
        # use_pallas (the JAX CLI's --pallas) chooses the layered schedule and
        # honours --message-dtype, as it does in the JAX package; the CUDA
        # kernels run either way.  A widening is stamped into the provenance.
        self.schedule, self.message_dtype, self.fallback = route(
            code, decoder_params, use_pallas, channel_params.type)
        if channel_params.type != "BEC":
            # the dtype the sweep runs (float32 where the JAX package ignores
            # the flag or widens the dtype)
            decoder_params = dataclasses.replace(decoder_params, message_dtype=self.message_dtype)
        self.dec = decoder_params
        self.tables = kernel_tables(to_sorted_device(
            code, self.device, with_layers=self.schedule != "flooding"))
        # the forensic log reports bits in the code's own labelling
        self._vn_inv = self.tables.code.vn_inv.cpu().numpy()  # original -> sorted label
        batch = simulation_params.batch_size
        # the exact layered schedule and the BEC stay batch-stepped, as in
        # the JAX package
        stream_eligible = (
            simulation_params.streaming
            and decoder_params.early_term
            and decoder_params.iterations >= 1
            and self.schedule != "layered"
            and channel_params.type != "BEC"
        )
        # the error log needs a whole batch's decisions, which the streams
        # do not surface: batch stepping instead, warned and stamped into
        # the provenance line as the JAX package does
        self._forensic_fallback = bool(stream_eligible and simulation_params.error_log_file)
        if self._forensic_fallback:
            warnings.warn(
                "forensic error logging (error_log_file) needs whole-batch per-frame decisions, "
                "which the streaming compaction pools don't surface; the streaming ET fast path "
                "is disabled for this sweep (batch stepping instead)", stacklevel=2)
        self._streaming = stream_eligible and not self._forensic_fallback
        if self._streaming:
            self._stream_init, self._stream_step = make_streaming_fused_step(
                self.tables,
                channel_params.type,
                decoder_params,
                batch,
                chunk_iters=simulation_params.streaming_chunk,
                max_frames=simulation_params.max_frames,
                layered=self.schedule == "layered-fast",
            )
            self._step = None
        else:
            self._step = make_sim_step(
                self.tables, channel_params.type, decoder_params, batch, self.schedule,
                forensics=bool(simulation_params.error_log_file))
        self.results: Optional[SimResults] = None
        self.decode_path = self._describe_decode_path()

    def _describe_decode_path(self) -> str:
        """One-line provenance of the decode path, written above the results
        file's column header."""
        bec = self.ch.type == "BEC"
        if self.device.type == "cuda":
            kernel = "cuda-bec" if bec else "cuda-fused"
        else:
            kernel = "torch-plain"
        parts = [
            f"kernel={kernel}",
            f"dtype={self.message_dtype}",
            "cn=peeling" if bec else f"cn={self.dec.type}",
            f"schedule={self.schedule}",
            f"streaming={'on' if self._streaming else 'off'}",
        ]
        if bec and self.dec.bec_ref_bug_compat:
            parts.append("bec=ref-bug-compat")
        if self.fallback:
            parts.append(f"fallback[{self.fallback}]")
        if self._forensic_fallback:
            parts.append("fallback[forensic error log -> streaming ET disabled (batch stepping)]")
        if self.device.type == "cuda":
            parts.append(f"device={torch.cuda.get_device_name(self.device).replace(' ', '_')}")
        return " ".join(parts)

    def _gen(self, point: int, batch: int) -> torch.Generator:
        return make_generator(self.device, self.ch.seed, point, batch)

    # ------------------------------------------------------------------ API

    def start(self, stop_flag: Optional[Callable[[], bool]] = None,
              resume: bool = False) -> SimResults:
        """Run the sweep; ``stop_flag`` is polled between batches.  With
        ``resume`` and a checkpoint of the same experiment on disk, the
        finished points are kept and the interrupted one continues from its
        counters (its clock from their ``elapsed_s``)."""
        x_vals = self.ch.sweep_values()
        results = SimResults.empty(len(x_vals), x_vals)
        start_point, counters = 0, _PointCounters()
        if resume:
            loaded = self._load_checkpoint(x_vals)
            if loaded is not None:
                results, start_point, counters = loaded
        self.results = results
        xval_name = "SNR" if self.ch.type == "AWGN" else "EPS"
        if self.verbose:
            print(_CONSOLE_HEADER.format(xval=xval_name))
        result_rows = [self._row(results, i) if results.frames[i] > 0 else ""
                       for i in range(len(x_vals))]

        if start_point < len(x_vals):
            # build the kernels and warm the device outside the frame clock;
            # the warm-up batch is discarded
            x0 = x_vals[start_point]
            if self._streaming:
                _, wacc = self._stream_step(
                    self._stream_init(), self._gen(_WARMUP_BATCH, 0), x0, False)
                int(wacc.frames)
            else:
                int(self._step(self._gen(_WARMUP_BATCH, 0), x0).frames)

        def should_stop() -> bool:
            return stop_flag is not None and bool(stop_flag())

        for i in range(start_point, len(x_vals)):
            c = counters if i == start_point else _PointCounters()
            if self._streaming:
                self._run_point_streaming(i, x_vals, c, results, result_rows, should_stop)
            else:
                self._run_point_batches(i, x_vals, c, results, result_rows, should_stop)
            if self.verbose:
                sys.stdout.write("\n")
            if should_stop():
                break
            # point finished: the checkpoint names the next point at batch 0
            self._save_checkpoint(x_vals, results, i + 1, _PointCounters())
        return results

    # ------------------------------------------------------------- internals

    def _absorb_counts(self, i, c: _PointCounters, results: SimResults, counts, t_point) -> None:
        for bec_, fec_, fr_, it_ in counts:
            c.bit_errors += int(bec_)
            c.frame_errors += int(fec_)
            c.frames += int(fr_)
            c.iter_sum += int(it_)
        c.elapsed_s = time.perf_counter() - t_point
        if c.frames:
            results.update_point(
                i, bit_errors=c.bit_errors, frame_errors=c.frame_errors,
                frames=c.frames, iter_sum=c.iter_sum, elapsed_s=c.elapsed_s,
                nc=self.code.nc,
            )

    def _run_point_batches(self, i, x_vals, c, results, result_rows, should_stop) -> None:
        """Batch stepping with a lookahead pipeline: ``pipeline_depth``
        batches in flight, so the host's counter read does not idle the
        device."""
        depth = max(1, self.sim.pipeline_depth)
        inflight: list = []
        last_print_fec = -1
        # rebased, so a resumed point continues its accumulated time
        t_point = time.perf_counter() - c.elapsed_s

        def can_dispatch() -> bool:
            # never launch a batch whose frames could not be counted
            return (
                c.frame_errors < self.sim.fec
                and c.frames + len(inflight) * self.sim.batch_size < self.sim.max_frames
                and not should_stop()
            )

        while (
            c.frame_errors < self.sim.fec and c.frames < self.sim.max_frames and not should_stop()
        ) or inflight:
            while len(inflight) < depth and can_dispatch():
                inflight.append(self._step(self._gen(i, c.next_batch), x_vals[i]))
                c.next_batch += 1
            if not inflight:
                break
            out = inflight.pop(0)
            counts = torch.stack(
                [out.bit_errors, out.frame_errors, out.frames, out.iter_sum]
            ).tolist()  # one host read, waits for the batch
            self._absorb_counts(i, c, results, [counts], t_point)
            t_io = time.perf_counter()
            if c.frame_errors != last_print_fec:
                last_print_fec = c.frame_errors
                result_rows[i] = self._row(results, i)
                self._emit(results, i, x_vals[i], result_rows)
            if self.sim.error_log_file and counts[0]:
                # the planes are read only for a batch with a bit error
                self._log_error_frames(out.frame_bit_errors.cpu().numpy(),
                                       out.hard.cpu().numpy(), out.codeword.cpu().numpy(),
                                       x_vals[i], c.frames)
            self._save_checkpoint(x_vals, results, i, c)
            # printing and file IO are not charged to the frame clock
            t_point += time.perf_counter() - t_io

    def _run_point_streaming(self, i, x_vals, c, results, result_rows, should_stop) -> None:
        """One sweep point on the streaming kernel.

        Super-steps run with ``refill = stopping rule unmet``; once the rule
        is met, further steps drain (``refill=False``) until no frame is in
        flight, so every started frame is counted.  Counters are absorbed
        ``window`` super-steps behind dispatch (the window slow-starts at 1
        and doubles up to ``max(4, pipeline_depth)``), with one host read per
        absorb.  A resumed point's streams count its frames as started, so
        the start quota stays exact."""
        x = float(x_vals[i])
        state = self._stream_init(started_offset=c.frames)
        pending: list = []
        last_print_fec = -1
        n_active_last: Optional[int] = None
        depth = max(4, self.sim.pipeline_depth)
        window = 1
        stall_rounds = 0
        t_point = time.perf_counter() - c.elapsed_s

        while True:
            can_refill = (
                c.frame_errors < self.sim.fec
                and c.frames < self.sim.max_frames
                and not should_stop()
            )
            if not can_refill and n_active_last == 0 and not pending:
                break  # drained
            while (can_refill or n_active_last != 0) and len(pending) < window:
                state, acc = self._stream_step(state, self._gen(i, c.next_batch), x, can_refill)
                c.next_batch += 1
                # snapshot: the next super-step reuses the counter planes
                pending.append(torch.stack(list(acc)))
            if not can_refill and n_active_last == 0:
                n = len(pending)  # draining: flush everything
            else:
                n = max(1, len(pending) - (window - 1) // 2)
            rows = torch.stack(pending[:n]).tolist()  # one host read
            del pending[:n]
            frames_before = c.frames
            self._absorb_counts(i, c, results, [r[:4] for r in rows], t_point)
            n_active_last = int(rows[-1][4])
            t_io = time.perf_counter()
            if c.frame_errors != last_print_fec and c.frames:
                last_print_fec = c.frame_errors
                result_rows[i] = self._row(results, i)
                self._emit(results, i, x, result_rows)
            self._save_checkpoint(x_vals, results, i, c)
            t_point += time.perf_counter() - t_io
            # quota-exhaustion guard: refill requested, nothing in flight and
            # no progress means the start quota is spent; treat max_frames as
            # reached instead of spinning no-op super-steps
            if can_refill and n_active_last == 0 and c.frames == frames_before:
                stall_rounds += 1
                if stall_rounds >= 3 and not pending:
                    warnings.warn(
                        "streaming point stalled with start quotas exhausted before "
                        "the stopping rule was met; treating max_frames as reached"
                    )
                    break
            else:
                stall_rounds = 0
            if can_refill:
                window = min(depth, window * 2)

    # ---------------------------------------------------------- checkpoint

    def _checkpoint_config(self) -> dict:
        """The experiment's identity, stored with every checkpoint: the
        decoder configuration as asked for, the batch size (which fixes the
        random streams) and the decode path.  ``fec`` and ``max_frames``
        are left out: raising them extends a sweep without changing what
        was counted."""
        return {
            "dec": dataclasses.asdict(self._asked_dec),
            "batch_size": self.sim.batch_size,
            "decode_path": self.decode_path,
        }

    def _check_checkpoint_config(self, state: dict) -> bool:
        """True when the checkpoint was written by this experiment; warns
        and returns False otherwise, so the sweep starts fresh instead of
        merging the statistics of two experiments."""
        stored, cur = state.get("config"), self._checkpoint_config()
        if stored == cur:
            return True
        if stored is None:
            warnings.warn("checkpoint predates config stamping (no experiment identity "
                          "recorded); refusing to resume — starting fresh")
        else:
            diffs = sorted(k for k in set(stored) | set(cur) if stored.get(k) != cur.get(k))
            warnings.warn("checkpoint was written by a different experiment configuration "
                          f"(mismatched: {', '.join(diffs)}); refusing to resume — "
                          "starting fresh")
        return False

    def _save_checkpoint(self, x_vals, results: SimResults, point: int,
                         c: _PointCounters) -> None:
        """Write the checkpoint atomically (a temporary file, then
        ``os.replace``), so an interrupted write leaves the previous one."""
        if not self.sim.checkpoint_file:
            return
        state = {
            "x_vals": list(map(float, x_vals)),
            "point": point,
            "counters": c.as_list(),
            "seed": self.ch.seed,
            "channel": self.ch.type,
            "config": self._checkpoint_config(),
            "results": json.loads(results.to_json()),
        }
        tmp = self.sim.checkpoint_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.sim.checkpoint_file)

    def _load_checkpoint(self, x_vals):
        """``(results, point, counters)`` from the checkpoint, or None when
        there is none or it belongs to another sweep (other values, seed or
        channel) or experiment."""
        path = self.sim.checkpoint_file
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if (state.get("x_vals") != list(map(float, x_vals))
                or state.get("seed") != self.ch.seed
                or state.get("channel") != self.ch.type):
            return None
        if not self._check_checkpoint_config(state):
            return None
        results = SimResults.from_json(json.dumps(state["results"]))
        return results, state["point"], _PointCounters.from_list(state["counters"])

    # ------------------------------------------------------- forensic log

    def _log_error_frames(self, frame_bit_errors: np.ndarray, hard: np.ndarray,
                          codeword: np.ndarray, x: float, frames: int) -> None:
        """Append a line per errored frame of a batch to the error log:
        its bit errors (transmitted bits), whether the decision is a
        codeword, the distances between decision and truth (``dE`` for
        BPSK, ``dH`` over all nc bits), the syndrome weight, and the failed
        bits and checks (cut at 64), in the code's original labelling; with
        ``error_log_codewords`` both words, hex-packed MSB-first.
        ``hard``/``codeword`` are u8 ``[nc, B]`` in sorted labels;
        ``frames`` counts the frames through this batch."""
        bad = np.nonzero(frame_bit_errors > 0)[0]
        if bad.size == 0:
            return
        hard_o = hard[:, bad][self._vn_inv]  # errored frames, original labels
        cw_o = codeword[:, bad][self._vn_inv]
        # H @ words over GF(2) as one float32 product: exact, since a
        # check's sum is at most its degree
        synd = (self._H_f32 @ hard_o.astype(np.float32)).astype(np.int64) % 2

        def trunc(idx):
            s = ",".join(map(str, idx[:64]))
            return s + (f",...({idx.size} total)" if idx.size > 64 else "")

        def hexpack(col):
            return np.packbits(col.astype(np.uint8)).tobytes().hex()

        first = frames - len(frame_bit_errors)
        with open(self.sim.error_log_file, "a") as f:
            for j, b in enumerate(bad):
                errs = int(frame_bit_errors[b])
                wrong = np.nonzero(hard_o[:, j] != cw_o[:, j])[0]
                failed_checks = np.nonzero(synd[:, j])[0]
                dE = 2.0 * float(np.sqrt(errs))  # BPSK: dE^2 = 4 * bit errors
                line = (
                    f"x={x:g} frame={first + int(b)} bit_errors={errs}"
                    f" is_codeword={int(failed_checks.size == 0)}"
                    f" dE={dE:.3f} dH={wrong.size}"
                    f" syndrome_weight={failed_checks.size}"
                    f" failed_bits={trunc(wrong)}"
                    f" failed_checks={trunc(failed_checks)}"
                )
                if self.sim.error_log_codewords:
                    line += f" decided_cw={hexpack(hard_o[:, j])} true_cw={hexpack(cw_o[:, j])}"
                f.write(line + "\n")

    @functools.cached_property
    def _H_f32(self) -> np.ndarray:
        return self.code.H_dense.astype(np.float32)

    def _row(self, results: SimResults, i: int) -> str:
        return format_result_row(
            results.x_values[i], results.fer[i], results.ber[i],
            int(results.frames[i]), results.avg_iter[i], results.time[i],
        )

    def _emit(self, results: SimResults, i: int, x: float, rows) -> None:
        """Console line and full results-file rewrite, reference format."""
        if self.verbose:
            sys.stdout.write(
                "\r %2d/%2d  |  %12d  |  %.3f  |  %.2e  |  %.2e  |  %.1e  |  %.3fms"
                % (
                    int(results.fec[i]), self.sim.fec, int(results.frames[i]), x,
                    results.ber[i], results.fer[i], results.avg_iter[i],
                    results.time[i] * 1e3,
                )
            )
            sys.stdout.flush()
        if self.sim.result_file:
            write_results_file(self.sim.result_file, rows, comment=self.decode_path)
