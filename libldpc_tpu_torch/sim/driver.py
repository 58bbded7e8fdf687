"""Monte-Carlo sweep driver (from :mod:`libldpc_tpu.sim.driver`), one device.

Each sweep point runs device batches until the reference's stopping rule
``fec >= minFec || frames >= maxFrames || stop`` is met, evaluated on the
host between batches.  With early termination on (the default) the point
streams (each lane reloads as soon as its frame is done); otherwise each
batch is one launch of a batch decode kernel.  The streaming engine is the
one the JAX package picks for the same flags: without ``--pallas`` its XLA
super-step (:func:`..ops.streaming.make_streaming_step`: a reload at the end
of every pass, in bursts, K2 and K8's reload form on the card), with
``--pallas`` the fused step (:func:`..ops.streaming_fused.make_streaming_fused_step`:
a lane reloads from its own entry of a pool refilled between chunks).  The schedule (flooding, exact layered, or the fast layered
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

Over a :class:`~..parallel.mesh.Mesh` (``Simulator(mesh=...)``) every
batch is sharded over the mesh's entries, each with its own generator, and
the counters are summed; :meth:`Simulator.start_wide` runs groups of sweep
points at once on a ``(points, frames)`` mesh, each point under the same
stopping rule, with a checkpoint of its own form.  Over several processes
(:mod:`..parallel.distributed`) every process runs the same host loop on
its own shards and the counters it reads are summed over the process
group, so every process sees the same global counters (and a stop flag
raised in any of them) after every absorb and all stop at the same batch;
only the primary process writes the console, the results file, the
checkpoint and the error log.
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
from ..ops.streaming import make_streaming_multipoint_step, make_streaming_step
from ..ops.streaming_fused import make_streaming_fused_multipoint_step, make_streaming_fused_step
from ..parallel import distributed
from ..parallel.mesh import (
    FRAME_AXIS, POINT_AXIS, make_multipoint_sim_step, make_sim_step, shard_generators,
)
from ..utils.params import ChannelParams, DecoderParams, SimulationParams
from ..utils.profiling import span
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
        mesh=None,
    ):
        check_supported(decoder_params, channel_params)
        self._asked_dec = decoder_params  # the checkpoint's identity
        self.mesh = mesh
        if mesh is not None:
            # the mesh's devices replace ``device``; every entry is a frame shard
            for d in mesh.devices.ravel():
                resolve_device(d)
            if simulation_params.batch_size % mesh.size:
                raise ValueError(f"batch_size {simulation_params.batch_size} not divisible by "
                                 f"{mesh.size} mesh devices")
            device = mesh.local_shards()[0].device
        self.device = resolve_device(device)
        self.code = code
        self.ch = channel_params
        self.sim = simulation_params
        # only the primary process prints and writes files
        self._primary = distributed.is_primary()
        self.verbose = verbose and self._primary
        self._stop_flag: Optional[Callable[[], bool]] = None
        self._stopped = False  # the stop flag as last reduced over the processes
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
        self._mod_for_step = mod_for_step
        batch = simulation_params.batch_size // (1 if mesh is None else mesh.size)
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
        # the JAX driver's engines: its XLA super-step without --pallas,
        # the fused (Pallas) step with it.  The provenance line keeps the
        # JAX driver's fields (its streaming=on covers both); the CLI's
        # console names the engine.
        self.engine = (("xla-superstep" if not use_pallas else "fused-pool")
                       if self._streaming else "batch")
        if self.engine == "xla-superstep":
            self._stream_init, self._stream_step = make_streaming_step(
                self.tables,
                channel_params.type,
                decoder_params,
                batch,
                mesh=mesh,
                modulation=mod_for_step,
                chunk_iters=simulation_params.streaming_chunk,
                max_frames=simulation_params.max_frames,
            )
            self._step = None
        elif self._streaming:
            self._stream_init, self._stream_step = make_streaming_fused_step(
                self.tables,
                channel_params.type,
                decoder_params,
                batch,
                chunk_iters=simulation_params.streaming_chunk,
                max_frames=simulation_params.max_frames,
                layered=self.schedule == "layered-fast",
                modulation=mod_for_step,
                mesh=mesh,
            )
            self._step = None
        else:
            self._step = make_sim_step(
                self.tables, channel_params.type, decoder_params, batch, self.schedule,
                forensics=bool(simulation_params.error_log_file), modulation=mod_for_step,
                mesh=mesh)
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

    def _gen(self, point: int, batch: int):
        """The generator of a batch; over a mesh, one per local shard (the
        same key with the shard's index appended)."""
        if self.mesh is not None:
            return shard_generators(self.mesh, self.ch.seed, point, batch)
        return make_generator(self.device, self.ch.seed, point, batch)

    def _should_stop(self) -> bool:
        """The stop flag: polled directly by a lone process; over several,
        as last reduced (:meth:`_read`), so every process sees the same."""
        if distributed.process_count() > 1:
            return self._stopped
        return self._stop_flag is not None and bool(self._stop_flag())

    def _read(self, values: torch.Tensor) -> list:
        """One host read of int64 counters, as nested lists; over several
        processes, summed over every process, with this process's stop
        flag reduced alongside (every process then stops at the same
        absorb).  Every process calls it at the same points of the same
        host loop."""
        if distributed.process_count() == 1:
            return values.tolist()
        local_stop = self._stop_flag is not None and bool(self._stop_flag())
        flat = torch.cat([values.reshape(-1).to("cpu", torch.int64),
                          torch.tensor([int(local_stop)], dtype=torch.int64)])
        flat = distributed.all_sum(flat)
        self._stopped = self._stopped or bool(flat[-1])
        return flat[:-1].reshape(values.shape).tolist()

    def _read_planes(self, *planes: torch.Tensor) -> list:
        """The forensic planes as NumPy arrays; over several processes the
        sum over every process (each holds zeros where another process's
        shards are, so the sum is every frame once)."""
        out = []
        for t in planes:
            host = t.cpu()
            if distributed.process_count() > 1:
                host = distributed.all_sum(host.to(torch.int64)).to(t.dtype)
            out.append(host.numpy())
        return out

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
        self._stop_flag, self._stopped = stop_flag, False
        if resume:
            loaded = distributed.broadcast_object(
                self._load_checkpoint(x_vals) if self._primary else None)
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
            with span("ldpc.warmup"):
                if self._streaming:
                    _, wacc = self._stream_step(
                        self._stream_init(), self._gen(_WARMUP_BATCH, 0), x0, False)
                    int(wacc.frames)
                else:
                    int(self._step(self._gen(_WARMUP_BATCH, 0), x0).frames)

        should_stop = self._should_stop
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
                with span("ldpc.loop.dispatch"):
                    inflight.append(self._step(self._gen(i, c.next_batch), x_vals[i]))
                c.next_batch += 1
            if not inflight:
                break
            out = inflight.pop(0)
            with span("ldpc.loop.read"):
                counts = self._read(torch.stack(
                    [out.bit_errors, out.frame_errors, out.frames, out.iter_sum]
                ))  # one host read, waits for the batch
            with span("ldpc.loop.absorb"):
                self._absorb_counts(i, c, results, [counts], t_point)
            with span("ldpc.loop.io"):
                t_io = time.perf_counter()
                if c.frame_errors != last_print_fec:
                    last_print_fec = c.frame_errors
                    result_rows[i] = self._row(results, i)
                    self._emit(results, i, x_vals[i], result_rows)
                if self.sim.error_log_file and counts[0]:
                    # the planes are read only for a batch with a bit error
                    self._log_error_frames(*self._read_planes(out.frame_bit_errors, out.hard,
                                                              out.codeword), x_vals[i], c.frames)
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
                with span("ldpc.loop.dispatch"):
                    state, acc = self._stream_step(state, self._gen(i, c.next_batch), x,
                                                   can_refill)
                    # snapshot: the next super-step reuses the counter planes
                    pending.append(torch.stack(list(acc)))
                c.next_batch += 1
            if not can_refill and n_active_last == 0:
                n = len(pending)  # draining: flush everything
            else:
                n = max(1, len(pending) - (window - 1) // 2)
            first = c.next_batch - len(pending)
            with span("ldpc.loop.read"):
                rows = self._read(torch.stack(pending[:n]))  # one host read
            del pending[:n]
            frames_before = c.frames
            with span("ldpc.loop.absorb"):
                self._absorb_counts(i, c, results, [r[:4] for r in rows], t_point)
                n_active_last = int(rows[-1][4])
            with span("ldpc.loop.io"):
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

    # ------------------------------------------------------------ wide sweep

    def start_wide(self, mesh, stop_flag: Optional[Callable[[], bool]] = None,
                   resume: bool = False) -> SimResults:
        """Point-parallel sweep over a 2-D ``(points, frames)`` mesh:
        groups of ``mesh.shape['points']`` points run at once, frames
        sharded within each point (``batch_size`` frames a point), the last
        group padded by repeating its last point (whose duplicate counts
        are discarded).  A group runs until every point in it meets the
        stopping rule; a finished point's further batches are discarded
        (streaming: it stops refilling and drains).  Same stopping rule per
        point, results file, console rows and checkpoint/resume as
        :meth:`start` (the checkpoint in its wide form)."""
        n_pts_parallel = mesh.shape[POINT_AXIS]
        n_frame_dev = mesh.shape[FRAME_AXIS]
        if self.sim.batch_size % n_frame_dev:
            raise ValueError(f"batch_size {self.sim.batch_size} not divisible by "
                             f"{n_frame_dev} frame-axis devices")
        for d in mesh.devices.ravel():
            resolve_device(d)
        per_shard = self.sim.batch_size // n_frame_dev
        stream_bundle = step = None
        if self.engine == "xla-superstep":
            stream_bundle = make_streaming_multipoint_step(
                self.tables, self.ch.type, self.dec, per_shard, mesh,
                modulation=self._mod_for_step, chunk_iters=self.sim.streaming_chunk,
                max_frames=self.sim.max_frames)
        elif self._streaming:
            stream_bundle = make_streaming_fused_multipoint_step(
                self.tables, self.ch.type, self.dec, per_shard, mesh,
                chunk_iters=self.sim.streaming_chunk, max_frames=self.sim.max_frames,
                layered=self.schedule == "layered-fast", modulation=self._mod_for_step)
        else:
            step = make_multipoint_sim_step(
                self.tables, self.ch.type, self.dec, per_shard, self.schedule, mesh,
                forensics=bool(self.sim.error_log_file), modulation=self._mod_for_step)
        x_vals = self.ch.sweep_values()
        results = SimResults.empty(len(x_vals), x_vals)
        group_start, resumed_counters, resumed_batch = 0, {}, 0
        self._stop_flag, self._stopped = stop_flag, False
        if resume:
            loaded = distributed.broadcast_object(
                self._load_checkpoint_wide(x_vals) if self._primary else None)
            if loaded is not None:
                results, group_start, resumed_counters, resumed_batch = loaded
        self.results = results
        if self.verbose:
            print(_CONSOLE_HEADER.format(xval="SNR" if self.ch.type == "AWGN" else "EPS"))

        def emit_rows():
            if self.sim.result_file and self._primary:
                rows = [self._row(results, i) if results.frames[i] else ""
                        for i in range(len(x_vals))]
                write_results_file(self.sim.result_file, rows, comment=self.decode_path)

        def gens(g0: int, batch_idx: int):
            return shard_generators(mesh, self.ch.seed, g0, batch_idx)

        if group_start < len(x_vals):
            # build the kernels and warm the devices outside the frame clock
            xw = [x_vals[group_start]] * n_pts_parallel
            with span("ldpc.warmup"):
                if stream_bundle is not None:
                    init_fn, step_fn = stream_bundle
                    _, wacc = step_fn(init_fn(), gens(_WARMUP_BATCH, 0), xw,
                                      [False] * n_pts_parallel)
                    wacc.frames.tolist()
                else:
                    step(gens(_WARMUP_BATCH, 0), xw).frames.tolist()

        for g0 in range(group_start, len(x_vals), n_pts_parallel):
            group = list(range(g0, min(g0 + n_pts_parallel, len(x_vals))))
            padded = group + [group[-1]] * (n_pts_parallel - len(group))
            xg = [x_vals[i] for i in padded]
            if g0 == group_start and resumed_counters:
                c = {i: resumed_counters.get(i, _PointCounters()) for i in group}
                batch_idx = resumed_batch
            else:
                c = {i: _PointCounters() for i in group}
                batch_idx = 0
            t_start = time.perf_counter() - max((cc.elapsed_s for cc in c.values()), default=0.0)
            if stream_bundle is not None:
                if self._wide_group_streaming(stream_bundle, group, padded, x_vals, c, results,
                                              gens, g0, batch_idx, t_start, emit_rows):
                    return results
                self._print_rows(results, group)
                self._save_checkpoint_wide(x_vals, results, g0 + n_pts_parallel, {}, 0)
                continue
            done_printed: set = set()

            def finished(i):
                return c[i].frame_errors >= self.sim.fec or c[i].frames >= self.sim.max_frames

            while True:
                if self._should_stop():
                    return results
                for i in group:
                    if finished(i) and i not in done_printed:
                        done_printed.add(i)
                        self._print_rows(results, [i])
                if all(finished(i) for i in group):
                    break
                with span("ldpc.loop.dispatch"):
                    out = step(gens(g0, batch_idx), xg)
                with span("ldpc.loop.read"):
                    bec, fec, frames, iters = self._read(torch.stack(
                        [out.bit_errors, out.frame_errors, out.frames, out.iter_sum]))
                batch_idx += 1
                elapsed = time.perf_counter() - t_start
                t_io = time.perf_counter()
                planes = None  # read once per batch, by every process alike
                with span("ldpc.loop.absorb"):
                    for slot, i in enumerate(group):
                        cc = c[i]
                        if finished(i):
                            continue
                        cc.bit_errors += bec[slot]
                        cc.frame_errors += fec[slot]
                        cc.frames += frames[slot]
                        cc.iter_sum += iters[slot]
                        if self.sim.error_log_file and bec[slot]:
                            # finished slots are skipped above, so the logged
                            # frames are exactly the counted ones
                            if planes is None:
                                planes = self._read_planes(out.frame_bit_errors, out.hard,
                                                           out.codeword)
                            self._log_error_frames(planes[0][slot], planes[1][slot],
                                                   planes[2][slot], x_vals[i], cc.frames)
                        # a point's clock is the group's wall clock while it is live
                        cc.elapsed_s = elapsed
                        results.update_point(
                            i, bit_errors=cc.bit_errors, frame_errors=cc.frame_errors,
                            frames=cc.frames, iter_sum=cc.iter_sum, elapsed_s=cc.elapsed_s,
                            nc=self.code.nc)
                with span("ldpc.loop.io"):
                    self._print_status(x_vals, group, c)
                    emit_rows()
                    self._save_checkpoint_wide(x_vals, results, g0, c, batch_idx)
                    # printing and file IO are not charged to the group's clock
                    t_start += time.perf_counter() - t_io
            self._save_checkpoint_wide(x_vals, results, g0 + n_pts_parallel, {}, 0)
        emit_rows()
        return results

    def _wide_group_streaming(self, bundle, group, padded, x_vals, c, results, gens, g0,
                              batch_idx, t_start, emit_rows) -> bool:
        """One point group of :meth:`start_wide` on the streaming kernels:
        refill gated per point, drains, and the stall guard, with the
        window, absorb and drain of :meth:`_run_point_streaming`.  Returns
        True when the stop flag was raised (the caller abandons the
        sweep)."""
        init_fn, step_fn = bundle
        n_slots, n_real = len(padded), len(group)
        xg = [x_vals[i] for i in padded]
        state = init_fn(started_offset=[c[padded[s]].frames if s < n_real else 0
                                        for s in range(n_slots)])
        pending: list = []
        n_active = [-1] * n_slots  # -1: unknown yet
        depth = max(4, self.sim.pipeline_depth)
        window = 1
        stall_rounds = 0

        def finished(i):
            return c[i].frame_errors >= self.sim.fec or c[i].frames >= self.sim.max_frames

        while True:
            if self._should_stop():
                return True
            all_fin = all(finished(i) for i in group)
            drained = all(n_active[s] == 0 for s in range(n_real))
            if all_fin and drained and not pending:
                return False
            while len(pending) < window and not (all_fin and drained):
                refill = [s < n_real and not finished(padded[s]) for s in range(n_slots)]
                with span("ldpc.loop.dispatch"):
                    state, acc = step_fn(state, gens(g0, batch_idx), xg, refill)
                    pending.append(torch.stack(list(acc)))
                batch_idx += 1
            if not pending:
                continue
            n = len(pending) if (all_fin and drained) else max(1, len(pending) - (window - 1) // 2)
            if not all_fin:
                window = min(depth, window * 2)
            first = batch_idx - len(pending)
            with span("ldpc.loop.read"):
                vals = self._read(torch.stack(pending[:n]))  # one host read
            del pending[:n]
            elapsed = time.perf_counter() - t_start
            frames_before = sum(c[i].frames for i in group)
            with span("ldpc.loop.absorb"):
                for bec, fec, fr, it, na in vals:
                    for s in range(n_real):
                        cc = c[padded[s]]
                        was_live = not finished(padded[s])
                        cc.bit_errors += bec[s]
                        cc.frame_errors += fec[s]
                        cc.frames += fr[s]
                        cc.iter_sum += it[s]
                        # a point's clock runs while it is live or still draining
                        if was_live or fr[s]:
                            cc.elapsed_s = elapsed
                    n_active = na
                for i in group:
                    if c[i].frames:
                        results.update_point(
                            i, bit_errors=c[i].bit_errors, frame_errors=c[i].frame_errors,
                            frames=c[i].frames, iter_sum=c[i].iter_sum,
                            elapsed_s=c[i].elapsed_s, nc=self.code.nc)
            with span("ldpc.loop.io"):
                t_io = time.perf_counter()
                self._print_status(x_vals, group, c)
                emit_rows()
                self._save_checkpoint_wide(x_vals, results, g0, c, batch_idx)
                t_start += time.perf_counter() - t_io
            # quota-exhaustion guard (see _run_point_streaming)
            if (not all(finished(i) for i in group)
                    and all(n_active[s] == 0 for s in range(n_real))
                    and sum(c[i].frames for i in group) == frames_before):
                stall_rounds += 1
                if stall_rounds >= 3 and not pending:
                    warnings.warn("wide streaming group stalled with start quotas exhausted "
                                  "before the stopping rule was met; treating max_frames as "
                                  "reached")
                    return False
            else:
                stall_rounds = 0

    def _print_rows(self, results: SimResults, points) -> None:
        """The console row of each finished point of a wide group."""
        if self.verbose:
            for i in points:
                if results.frames[i]:
                    sys.stdout.write("\r" + " " * 100 + "\r" + self._row(results, i) + "\n")
            sys.stdout.flush()

    def _print_status(self, x_vals, group, c) -> None:
        """The live status line of a wide group: each point's frame errors."""
        if self.verbose:
            status = "  ".join(f"x={x_vals[i]:g}:{c[i].frame_errors}/{self.sim.fec}"
                               for i in group)
            sys.stdout.write(f"\r {status}"[:100].ljust(100))
            sys.stdout.flush()

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
        if not self.sim.checkpoint_file or not self._primary:
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

    def _save_checkpoint_wide(self, x_vals, results: SimResults, group_start: int,
                              counters: dict, batch_idx: int) -> None:
        """The wide sweep's checkpoint: the group to resume at, its batch
        index and its points' counters (atomically, as
        :meth:`_save_checkpoint`)."""
        if not self.sim.checkpoint_file or not self._primary:
            return
        state = {
            "wide": True,
            "x_vals": list(map(float, x_vals)),
            "group_start": group_start,
            "batch_idx": batch_idx,
            "counters": {str(i): cc.as_list() for i, cc in counters.items()},
            "seed": self.ch.seed,
            "channel": self.ch.type,
            "config": self._checkpoint_config(),
            "results": json.loads(results.to_json()),
        }
        tmp = self.sim.checkpoint_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.sim.checkpoint_file)

    def _load_checkpoint_wide(self, x_vals):
        """``(results, group_start, counters, batch_idx)`` from a wide
        checkpoint of this sweep and experiment, or None."""
        path = self.sim.checkpoint_file
        if not path or not os.path.exists(path):
            return None
        with open(path) as f:
            state = json.load(f)
        if (not state.get("wide")
                or state.get("x_vals") != list(map(float, x_vals))
                or state.get("seed") != self.ch.seed
                or state.get("channel") != self.ch.type):
            return None
        if not self._check_checkpoint_config(state):
            return None
        results = SimResults.from_json(json.dumps(state["results"]))
        counters = {int(i): _PointCounters.from_list(v) for i, v in state["counters"].items()}
        return results, state["group_start"], counters, state["batch_idx"]

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
        if bad.size == 0 or not self._primary:
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
        if self.sim.result_file and self._primary:
            write_results_file(self.sim.result_file, rows, comment=self.decode_path)
