"""Monte-Carlo sweep driver (from :mod:`libldpc_tpu.sim.driver`), one device.

Each sweep point runs device batches until the reference's stopping rule
``fec >= minFec || frames >= maxFrames || stop`` is met, evaluated on the
host between batches.  With early termination on (the default) the point
runs on a streaming kernel; otherwise each batch is one launch of a batch
decode kernel.  The schedule (flooding, exact layered, or the fast layered
engine) is the one the JAX package runs for the same code and flags
(:func:`route`); the exact layered schedule is batch-stepped, as
there.  So is the message dtype (:func:`route` too): with
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
log (a line per errored frame; it turns streaming off, as there).  With
``modulation=(Constellation, bit_mapper)`` the AWGN channel is M-ASK with
bitwise LLRs (the reference GPU stack's simfile/mapfile sweep,
:mod:`.gpu_compat`); the kernels take its LLRs as they are.
Points-parallel and multi-device sweeps are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
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
from ..ops import modulation as mod
from ..ops.messages import DTYPE_CODES, MessageForm
from ..ops.sorted import to_sorted_device
from ..ops.streaming_fused import make_streaming_fused_step
from ..parallel.mesh import make_sim_step
from ..utils.params import ChannelParams, DecoderParams, SimulationParams
from . import tpu_layouts
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
#: mirrored here only so that one command line selects the same schedule and
#: message dtype in both packages (:func:`tpu_layout`).  There they bound
#: what its TPU kernels compile; the CUDA kernels have no such limits.
#: Tests lower them, in both packages, to reach every branch.
FUSED_EDGE_SPACE_LIMIT = 4096  # the edge-major layout's Beneš n_pad
LANES_EDGE_SPACE_LIMIT = 131072  # the generic lane layout's n_pad
QC_LANES_EDGE_SPACE_LIMIT = 786432  # the qc lane layout's n_pad
#: The qc lane layout's sub-32-bit walls: past the first, bfloat16 with the
#: BP form widens to float32; past the second, every sub-32-bit dtype does.
QC_LANES_SUB32_EDGE_SPACE_LIMIT = 196608
QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT = 294912
#: The Clos lane layout's walls (bfloat16 and int8 off the qc layout): its
#: class-padded fill, and its n_pad, a literal 65536 in the JAX driver.
CLOS_LANES_FILL_LIMIT = 65536
CLOS_LANES_N_PAD_LIMIT = 65536

#: CN forms other than BP (an unknown ``--decoding`` string decodes as BP)
_NON_BP_FORMS = ("BP_MS", "BP_NMS", "BP_OMS", "BP_LIN", "BP_TANH", "BP_PHI")


def check_supported(dec: DecoderParams, ch: ChannelParams) -> None:
    """Raise for a message dtype the port does not know, and for an int8
    lattice under a CN form outside the min-sum family (``ValueError``, the
    JAX package's words); the BEC ignores the dtype."""
    if dec.message_dtype not in DTYPE_CODES:
        raise ValueError(f"message dtype {dec.message_dtype!r}: expected one of "
                         f"{list(DTYPE_CODES)}")
    if ch.type != "BEC" and dec.message_dtype != "float32":
        MessageForm(dec.message_dtype, dec.quant_scale).check_cn_mode(dec.cn_mode)


def tpu_layout(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
               channel_type: str = "AWGN") -> tuple[str, str, tuple[str, ...]]:
    """``(layout, dtype, fallbacks)``: where the JAX package's
    ``_select_layout`` puts this code, the ``dtype=`` of its
    ``decode_path`` and the reasons it stamps as ``fallback[...]``.

    The layout is ``"bec"`` for the BEC (the port's peeling kernels move
    1-byte 3-state symbols and stamp no reroute), ``"xla"`` without
    ``use_pallas`` (float32) and where the JAX package drops to its XLA
    decoder, else ``"fused"`` (edge-major: a Beneš n_pad within
    ``FUSED_EDGE_SPACE_LIMIT``, or a one-hot MXU plan on a code without QC
    ``Z >= 64``), ``"qc"``, ``"clos"`` (bfloat16, int8) or ``"benes"``
    (float32) lanes.  Past their walls the qc lanes widen a sub-32-bit
    dtype to float32, the Clos lanes drop to float32 Beneš lanes, the lanes
    past their n_pad go to the XLA decoder, and so does a fixed-iteration
    job on Beneš lanes (:mod:`.tpu_layouts` sizes each).  The port decodes
    in that dtype on its own kernels."""
    if channel_type == "BEC":
        return "bec", "uint8-3state", ()
    if not use_pallas:
        return "xla", "float32", ()
    dtype, reasons = dec.message_dtype, []
    Z = int(code.qc[0]) if code.qc is not None else 0
    if (tpu_layouts.benes_size(code.nnz) <= FUSED_EDGE_SPACE_LIMIT
            or (Z < 64 and tpu_layouts.has_mxu_plan(code))):
        return "fused", dtype, ()
    qc_pad = tpu_layouts.qc_lanes_pad(code)
    if qc_pad is not None:
        layout, n_pad, limit = "qc", qc_pad, QC_LANES_EDGE_SPACE_LIMIT
    else:
        layout = "clos" if dtype in ("bfloat16", "int8") else "benes"
        fill, n_pad = tpu_layouts.lanes_space(code)
        limit = LANES_EDGE_SPACE_LIMIT
    bp_form = dec.type not in _NON_BP_FORMS
    if n_pad > limit:
        return "xla", "float32", (f"lanes n_pad {n_pad} > envelope {limit} -> xla sorted decoder",)
    if layout == "qc" and (
            (n_pad > QC_LANES_SUB32_EDGE_SPACE_LIMIT and dtype == "bfloat16" and bp_form)
            or (n_pad > QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT and dtype in ("bfloat16", "int8"))):
        lim = (QC_LANES_SUB32_EDGE_SPACE_LIMIT if dtype == "bfloat16" and bp_form
               else QC_LANES_SUB32_WIDE_EDGE_SPACE_LIMIT)
        reasons.append(f"qc n_pad {n_pad} > {dtype} envelope {lim} -> f32 qc lanes")
        dtype = "float32"
    elif layout == "clos" and (fill > CLOS_LANES_FILL_LIMIT or n_pad > CLOS_LANES_N_PAD_LIMIT):
        what = f"fill {fill}" if fill > CLOS_LANES_FILL_LIMIT else f"n_pad {n_pad}"
        reasons.append(f"clos {what} > envelope -> f32/benes lanes")
        layout, dtype = "benes", "float32"
    if layout == "benes" and not dec.early_term:
        reasons.append("fixed-iteration f32/benes lanes measured slower than xla "
                       "-> xla sorted decoder")
        return "xla", "float32", tuple(reasons)
    return layout, dtype, tuple(reasons)


def route(code: LDPCCode, dec: DecoderParams, use_pallas: bool,
          channel_type: str = "AWGN") -> tuple[str, str, tuple[str, ...]]:
    """``(schedule, message dtype, fallbacks)`` of a decode of ``code``
    with these flags, as the JAX package's ``Simulator`` decodes it (the
    ``schedule=``, ``dtype=`` and ``fallback[...]`` of its ``decode_path``).

    The schedule is ``"flooding"`` without ``dec.layered``, and always for
    the BEC (whose peeling decoders in the JAX package ignore the layers,
    though its ``decode_path`` then says ``layered``); ``"layered-fast"``
    (the fast QC engine) where :func:`tpu_layout` reaches the qc lanes,
    with layers that are the code's natural QC schedule
    (:func:`..ops.layered.natural_qc_layers`); ``"layered"`` (the exact
    schedule) otherwise.  The dtype and the fallbacks are
    :func:`tpu_layout`'s: ``uint8-3state`` for the BEC, float32 without
    ``use_pallas`` or where the JAX package widens or reroutes, else
    ``dec.message_dtype``.  A reroute is warned about, as the JAX package's
    ``record_fallback`` does; the caller stamps each reason into its
    provenance.  The sweep and ``LDPC.decode`` both route here."""
    layout, dtype, fallbacks = tpu_layout(code, dec, use_pallas, channel_type)
    if not dec.layered or channel_type == "BEC":
        schedule = "flooding"
    elif layout == "qc" and natural_qc_layers(code):
        schedule = "layered-fast"
    else:
        schedule = "layered"
    for reason in fallbacks:
        warnings.warn(f"{dec.message_dtype} messages routed as the JAX package routes them: "
                      f"{reason}" + (" (widened to float32)" if dtype != dec.message_dtype
                                     else ""), stacklevel=3)
    return schedule, dtype, fallbacks


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
        modulation=None,
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
        self._modulation, mod_for_step = self._relabel_modulation(modulation)
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
                modulation=mod_for_step,
            )
            self._step = None
        else:
            self._step = make_sim_step(
                self.tables, channel_params.type, decoder_params, batch, self.schedule,
                forensics=bool(simulation_params.error_log_file), modulation=mod_for_step)
        self.results: Optional[SimResults] = None
        self.decode_path = self._describe_decode_path()

    def _relabel_modulation(self, modulation):
        """``(host, device)`` forms of ``modulation``, ``(Constellation,
        bit_mapper)`` with the mapper ``[bits, n_sym]`` in the code's own
        labels: the mapper relabelled to sorted labels, as an int64 array
        (the forensic ``dE``) and on the device (the channel); ``(None,
        None)`` without one.  Only AWGN takes a constellation, and the
        mapper must cover the ``nct`` transmitted bits."""
        if modulation is None:
            return None, None
        if self.ch.type != "AWGN":
            raise ValueError("modulation requires the AWGN channel")
        cstl, mapper = modulation
        mapper = np.asarray(mapper, dtype=np.int64)
        if mapper.size != self.code.nct:
            raise ValueError(f"bit mapper covers {mapper.size} bits, expected "
                             f"nct={self.code.nct}")
        mapper = self._vn_inv[mapper]
        return (cstl, mapper), (cstl, torch.as_tensor(mapper, device=self.device))

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
        parts += [f"fallback[{reason}]" for reason in self.fallback]
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
        random streams), the decode path and, with a constellation, its M,
        labels and the SHA-256 of the (relabelled) mapper (the JAX package leaves the
        modulation out, so it resumes a BPSK checkpoint under 4-ASK).
        ``fec`` and ``max_frames`` are left out: raising them extends a
        sweep without changing what was counted."""
        config = {
            "dec": dataclasses.asdict(self._asked_dec),
            "batch_size": self.sim.batch_size,
            "decode_path": self.decode_path,
        }
        if self._modulation is not None:
            cstl, mapper = self._modulation
            config["modulation"] = {"M": int(cstl.M), "labels": [int(v) for v in cstl.labels],
                                    "mapper_sha256": hashlib.sha256(mapper.tobytes()).hexdigest()}
        return config

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
        codeword, the distances between decision and truth (``dE`` through
        the constellation, :meth:`_forensic_dE`; ``dH`` over all nc bits),
        the syndrome weight, and the failed bits and checks (cut at 64), in
        the code's original labelling; with ``error_log_codewords`` both
        words, hex-packed MSB-first.  ``hard``/``codeword`` are u8
        ``[nc, B]`` in sorted labels; ``frames`` counts the frames through
        this batch."""
        bad = np.nonzero(frame_bit_errors > 0)[0]
        if bad.size == 0:
            return
        hard_o = hard[:, bad][self._vn_inv]  # errored frames, original labels
        cw_o = codeword[:, bad][self._vn_inv]
        synd = self._syndromes(hard_o)

        def trunc(idx):
            s = ",".join(map(str, idx[:64]))
            return s + (f",...({idx.size} total)" if idx.size > 64 else "")

        def hexpack(col):
            return np.packbits(col.astype(np.uint8)).tobytes().hex()

        first = frames - len(frame_bit_errors)
        dEs = self._forensic_dE(hard[:, bad], codeword[:, bad], frame_bit_errors[bad])
        with open(self.sim.error_log_file, "a") as f:
            for j, b in enumerate(bad):
                errs = int(frame_bit_errors[b])
                wrong = np.nonzero(hard_o[:, j] != cw_o[:, j])[0]
                failed_checks = np.nonzero(synd[:, j])[0]
                line = (
                    f"x={x:g} frame={first + int(b)} bit_errors={errs}"
                    f" is_codeword={int(failed_checks.size == 0)}"
                    f" dE={dEs[j]:.3f} dH={wrong.size}"
                    f" syndrome_weight={failed_checks.size}"
                    f" failed_bits={trunc(wrong)}"
                    f" failed_checks={trunc(failed_checks)}"
                )
                if self.sim.error_log_codewords:
                    line += f" decided_cw={hexpack(hard_o[:, j])} true_cw={hexpack(cw_o[:, j])}"
                f.write(line + "\n")

    def _syndromes(self, words: np.ndarray) -> np.ndarray:
        """``H @ words`` over GF(2) (u8 ``[mc, n]`` of u8 ``[nc, n]`` words
        in original labels): each check's XOR over its edges, from the edge
        list, so nothing of size ``mc * nc`` is built."""
        cols, row_ids, starts = self._edges_by_row
        synd = np.zeros((self.code.mc, words.shape[1]), dtype=np.uint8)
        if cols.size:
            synd[row_ids] = np.bitwise_xor.reduceat(words[cols].astype(np.uint8), starts, axis=0)
        return synd

    @functools.cached_property
    def _edges_by_row(self):
        """``(cols, row ids, starts)``: the edges sorted by check, each
        nonempty check's id and its first edge."""
        order = np.argsort(self.code.rows, kind="stable")
        rows = self.code.rows[order]
        starts = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]]) if rows.size else rows
        return self.code.cols[order].astype(np.int64), rows[starts], starts

    def _forensic_dE(self, hard: np.ndarray, codeword: np.ndarray,
                     tx_errs: np.ndarray) -> np.ndarray:
        """Euclidean distance between the modulated decision and the
        modulated truth of each errored frame (u8 ``[nc, n]`` columns in
        sorted labels, their transmitted bit errors ``[n]``): ``2 sqrt(bit
        errors)`` for BPSK; with a constellation, each word mapped to its
        points (:func:`..ops.modulation.map_bits_to_symbols`), float64 as
        the constellation holds them."""
        if self._modulation is None:
            return 2.0 * np.sqrt(tx_errs.astype(np.float64))  # BPSK: dE^2 = 4 * bit errors
        cstl, mapper = self._modulation  # mapper [bits, n_sym], sorted labels

        def points(words):
            idx = mod.map_bits_to_symbols(cstl, torch.from_numpy(mapper),
                                          torch.from_numpy(np.ascontiguousarray(words)))
            return cstl.points[idx.numpy()]

        d = points(hard) - points(codeword)
        # each frame's squares summed along a contiguous row, as over one word
        return np.sqrt(np.ascontiguousarray((d * d).T).sum(axis=1))

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
