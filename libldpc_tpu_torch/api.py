"""The ``LDPC`` class: the pyLDPC-style surface of :mod:`libldpc_tpu.api`
on PyTorch, with the decodes on the CUDA kernels.

``encode / decode / simulate / stop_simulation / get_results / wait /
rank / syndrome`` with the JAX class's names and defaults.  ``decode``
routes a call as the sweep does (:func:`~.sim.driver.route`) and
launches the batch kernel of that schedule (K1 flooding, K3 the fast
layered engine, K5 the exact layered schedule) on raw LLRs; on ``device="cpu"`` their plain versions
run.  The simulation runs on a background thread with cooperative
cancellation, and ``get_results`` reads its live results.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .models.code import LDPCCode
from .ops.kernels.layout import KernelTables, kernel_tables
from .ops.sorted import to_sorted_device
from .parallel.mesh import batch_decoder
from .sim.driver import Simulator, check_supported, resolve_device, route
from .utils.params import ChannelParams, DecoderParams, SimulationParams

_SIM_DEFAULTS = {
    "earlyTerm": True,
    "iterations": 50,
    "decoding": "BP",
    "seed": 0,
    "snr": [],
    "channel": "AWGN",
    "maxFrames": int(10e9),
    "fec": 50,
    "batchSize": 1024,
    "resultFile": None,
    "checkpointFile": None,
    "mesh": None,
    "usePallas": False,
    "messageDtype": "float32",
    "layered": False,
    "modulation": None,
    "pointsParallel": 0,
    "errorLogFile": None,
    "quantScale": 0.1875,
}

_MULTI_GPU = 'ROADMAP Queue 1, "Multi-GPU"'


class LDPC:
    """An LDPC code with encode, decode and simulate.

    Args:
      pc_file: parity-check codefile path.
      gen_file: optional generator matrix file (enables encoding and
        random-codeword simulation; without it the all-zero codeword is
        simulated).
      code: alternatively, a built :class:`LDPCCode`.
      device: where decodes and simulations run: ``"cuda"`` (the CUDA
        kernels) unless the caller asks for ``"cpu"`` (their plain
        versions).  A CUDA device without a GPU raises.
    """

    def __init__(self, pc_file: str = "", gen_file: str = "",
                 code: Optional[LDPCCode] = None, device="cuda"):
        if code is None:
            if not pc_file:
                raise ValueError("need pc_file or code")
            code = LDPCCode.from_files(pc_file, gen_file)
        self.code = code
        self.pc_file = pc_file
        self.gen_file = gen_file
        self.device = resolve_device(device)

        self.n = code.nc
        self.m = code.mc
        self.k = code.kc
        self.nct = code.nct
        self.mct = code.mct
        self.kct = code.kct

        #: (use_pallas, message dtype, layered, CN form) -> (schedule, dtype)
        self._routes: dict = {}
        #: with_layers -> the kernels' tables on ``device``
        self._tables: dict[bool, KernelTables] = {}
        self.sim_params = dict(_SIM_DEFAULTS)
        self.results: dict = {}
        self._sim_thread: Optional[threading.Thread] = None
        self._sim_error: Optional[BaseException] = None
        self._stop_event = threading.Event()
        self._simulator: Optional[Simulator] = None

    # ------------------------------------------------------------- one-shots

    def encode(self, info_word: np.ndarray) -> np.ndarray:
        """Encode a binary info word (G's row count) and return the
        transmitted codeword bits (length ``nct``)."""
        if self.code.G is None:
            raise RuntimeError("No generator matrix provided for encoding")
        return self.code.encode(np.asarray(info_word))[self.code.bit_pos]

    def _route(self, dec: DecoderParams, use_pallas: bool) -> tuple[str, str]:
        """``(schedule, message dtype)`` of a decode, as the sweep routes it.
        The cache keys on every input of the routing: the dtype's widening
        depends on the CN form, so the form is part of the key."""
        key = (bool(use_pallas), dec.message_dtype, bool(dec.layered), dec.type)
        if key not in self._routes:
            check_supported(dec, ChannelParams())
            self._routes[key] = route(self.code, dec, use_pallas)[:2]
        return self._routes[key]

    def _tables_for(self, schedule: str) -> KernelTables:
        with_layers = schedule != "flooding"
        if with_layers not in self._tables:
            self._tables[with_layers] = kernel_tables(
                to_sorted_device(self.code, self.device, with_layers=with_layers))
        return self._tables[with_layers]

    def decode(
        self,
        llr_in: np.ndarray,
        early_term: bool = True,
        iters: int = 50,
        dec_type: str = "BP",
        usePallas: bool = False,
        messageDtype: str = "float32",
        layered: bool = False,
        quantScale: float = 0.1875,
    ):
        """Decode transmitted-position LLRs.

        Accepts ``[nct]`` (one frame) or ``[batch, nct]``; punctured
        positions enter the decoder with LLR 0 and are stripped from the
        output.  Returns ``(llr_out, iterations)`` with shapes matching the
        input.  ``usePallas`` / ``messageDtype`` / ``layered`` /
        ``quantScale`` pick the schedule and the message form as the sweep's
        flags do; any batch size runs as is."""
        llr_in = np.asarray(llr_in, dtype=np.float32)
        single = llr_in.ndim == 1
        if single:
            llr_in = llr_in[None, :]
        if llr_in.ndim != 2 or llr_in.shape[1] != self.nct:
            raise ValueError(f"llr_in has shape {llr_in.shape}, expected [nct] or "
                             f"[batch, nct] with nct={self.nct}")
        dec = DecoderParams(early_term=early_term, iterations=iters, type=dec_type,
                            layered=layered, message_dtype=messageDtype, quant_scale=quantScale)
        schedule, dtype = self._route(dec, usePallas)
        tables = self._tables_for(schedule)
        tx = tables.code.bit_pos  # sorted labels of the transmitted bits, in their order
        llr_t = torch.from_numpy(llr_in).to(self.device)
        full = torch.zeros((self.code.nc, llr_in.shape[0]), dtype=torch.float32,
                           device=self.device)
        full[tx] = llr_t.T
        out = batch_decoder(tables, schedule)(
            tables, full, iterations=iters, early_term=early_term, minsum_mode=dec.cn_mode,
            message_dtype=dtype, quant_scale=quantScale)
        llr_out = out.llr_out.index_select(0, tx).T.cpu().numpy()
        iterations = out.iterations.cpu().numpy()
        if single:
            return llr_out[0], int(iterations[0])
        return llr_out, iterations

    def rank(self) -> int:
        """GF(2) rank of H."""
        return self.code.rank()

    def syndrome(self, v: np.ndarray) -> np.ndarray:
        """Syndrome of a length-``n`` word."""
        return self.code.syndrome(np.asarray(v))

    # ------------------------------------------------------------- simulation

    def simulate(self, blocking: bool = False, **kwargs) -> None:
        """Start a BER/FER simulation on the object's device (threaded
        unless ``blocking``).

        Keyword names and defaults follow the JAX class: ``earlyTerm,
        iterations, decoding, seed, snr=[MIN, MAX, STEP], channel,
        maxFrames, fec, batchSize, resultFile, checkpointFile, usePallas,
        messageDtype, layered, modulation, errorLogFile, quantScale``
        (``threads`` is accepted and ignored); ``modulation`` is a
        ``(Constellation, bit_mapper)`` pair for M-ASK over AWGN, the mapper
        ``[bits, n_sym]`` in the code's own bit labels.  ``mesh`` and
        ``pointsParallel > 1`` raise ``NotImplementedError``: they are not
        ported yet."""
        kwargs.pop("threads", None)
        p = {**self.sim_params, **kwargs}
        if not p["snr"]:
            raise ValueError("snr=[MIN, MAX, STEP] is required")
        if p["mesh"] is not None or int(p["pointsParallel"] or 0) > 1:
            raise NotImplementedError(f"mesh / pointsParallel: not ported yet ({_MULTI_GPU})")
        self.sim_params = p
        sim = Simulator(
            self.code,
            DecoderParams(
                early_term=p["earlyTerm"],
                iterations=p["iterations"],
                type=p["decoding"],
                message_dtype=p["messageDtype"],
                layered=p["layered"],
                quant_scale=p["quantScale"],
            ),
            ChannelParams(seed=p["seed"], x_range=tuple(p["snr"]), type=p["channel"]),
            SimulationParams(
                batch_size=p["batchSize"],
                max_frames=int(p["maxFrames"]),
                fec=int(p["fec"]),
                result_file=p["resultFile"],
                error_log_file=p["errorLogFile"],
                checkpoint_file=p["checkpointFile"],
            ),
            device=self.device,
            use_pallas=p["usePallas"],
            modulation=p["modulation"],
            verbose=False,
        )
        self._simulator = sim
        self._sim_error = None
        self._stop_event.clear()

        def run():
            try:
                sim.start(stop_flag=self._stop_event.is_set)
            except Exception as e:  # kept for wait() to raise in the caller's thread
                self._sim_error = e
                raise

        if blocking:
            sim.start(stop_flag=self._stop_event.is_set)
        else:
            self._sim_thread = threading.Thread(target=run, daemon=True)
            self._sim_thread.start()

    def stop_simulation(self) -> None:
        """Stop a running simulation cooperatively; its results so far stay
        readable through :meth:`get_results`."""
        if not self._stop_event.is_set():
            self.results = self.get_results()
            self._stop_event.set()
        if self._sim_thread is not None:
            self._sim_thread.join(timeout=60)
            self._sim_thread = None

    def get_results(self) -> dict:
        """Live simulation results: a dict of arrays trimmed to the points
        with frames > 0."""
        if self._stop_event.is_set():
            return self.results
        if self._simulator is None or self._simulator.results is None:
            return {}
        return self._simulator.results.as_dict(trim=True)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until a threaded simulation finishes; raise what it
        raised."""
        if self._sim_thread is not None:
            self._sim_thread.join(timeout)
        if self._sim_error is not None:
            raise self._sim_error
