"""The file-driven sweep of the reference's GPU simulator: simfile +
mapfile (+ layerfile), the port of :mod:`libldpc_tpu.sim.gpu_compat`.

* **simfile**: results file name, constellation size M, bits per symbol,
  labels, SNRs, max frames, min frame errors, BP iterations, early
  termination (:func:`..models.io.parse_simfile`);
* **mapfile**: the ``[bits, n_sym]`` map of codeword-bit positions to
  symbols (:func:`..models.io.parse_mapfile`);
* **layerfile**: the checks of each layer, for the layered schedule.

The sweep is M-ASK over AWGN with the BP form.  It runs on ``device``
(``cuda`` unless the caller asks for ``cpu``); with ``use_pallas`` False,
as in the JAX package, a layerfile takes the exact layered schedule and no
layerfile streams on flooding.
"""

from __future__ import annotations

from ..models.code import LDPCCode
from ..models.io import parse_mapfile, parse_simfile
from ..ops.modulation import Constellation
from ..utils.params import ChannelParams, DecoderParams, SimulationParams
from .driver import Simulator
from .results import SimResults

_MULTI_GPU = 'ROADMAP Queue 1, "Multi-GPU"'


def build_simulator_from_files(
    code_file: str,
    sim_file: str,
    map_file: str,
    layer_file: str = "",
    gen_file: str = "",
    batch_size: int = 1024,
    seed: int = 0,
    mesh=None,
    use_pallas: bool = False,
    verbose: bool = True,
    device="cuda",
) -> Simulator:
    """The :class:`Simulator` of a simfile and mapfile sweep.  ``mesh``
    (a multi-device sweep) raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(f"mesh: not ported yet ({_MULTI_GPU})")
    code = LDPCCode.from_files(code_file, gen_file, layer_file)
    sf = parse_simfile(sim_file)
    if code.nct % sf.bits != 0:
        raise ValueError("Chosen setting m with n_c does not work. Please correct.")
    mapper = parse_mapfile(map_file, sf.bits, code.nct // sf.bits)
    return Simulator(
        code,
        DecoderParams(early_term=sf.early_term, iterations=sf.bp_iter, type="BP",
                      layered=layer_file != ""),
        ChannelParams(seed=seed, x_values=tuple(sf.snrs), type="AWGN"),
        SimulationParams(batch_size=batch_size, max_frames=sf.max_frames, fec=sf.min_fec,
                         result_file=sf.name or None),
        device=device,
        verbose=verbose,
        use_pallas=use_pallas,
        modulation=(Constellation.mask(sf.M, labels=sf.labels), mapper),
    )


def run_from_simfiles(
    code_file: str,
    sim_file: str,
    map_file: str,
    layer_file: str = "",
    gen_file: str = "",
    batch_size: int = 1024,
    seed: int = 0,
    stop_flag=None,
    verbose: bool = True,
    device="cuda",
) -> SimResults:
    """Build the sweep (:func:`build_simulator_from_files`) and run it."""
    sim = build_simulator_from_files(code_file, sim_file, map_file, layer_file=layer_file,
                                     gen_file=gen_file, batch_size=batch_size, seed=seed,
                                     verbose=verbose, device=device)
    return sim.start(stop_flag=stop_flag)
