"""One run of one cell: set-up, the timed window, the optional trace, the
comparison that decides ``correct``, and the result line.

The entry the window drives is the sweep of ``ldpcsim-torch``:
``Simulator.start`` on a ``Simulator`` built as the command-line tool
builds it for the cell's command line (the code from its files, the
decoder, channel and simulation parameters, ``--pallas``), with one sweep
point at the cell's SNR, the stopping rule's frame-error count and frame
limit out of reach, and a stop flag raised once the window's seconds have
passed (a streaming point then drains its lanes in flight, and those
frames count).  The window is the host clock around that whole call; it
holds the point's own discarded warm-up step.

Set-up builds the code from its definition and writes its files (both
kept in the checkout for its later runs), builds the ``Simulator`` (which
loads the kernel library from ``build/kernels/``, built there at the first
run of a checkout) and runs one short ``start`` so that every kernel and
table of the cell's path is loaded and warm.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time
from typing import Callable

import torch

from . import spec as specmod
from . import trace as tracemod
from .codes import cached_code
from .reference import checks
from .reference.channel import step_keys
from .reference.checks import frames_of, graph_of
from .reference.decoders import StreamReference, bfloat16_store

#: the stopping rule's frame-error count, never reached in a window
FEC_OUT_OF_REACH = 2**62
#: the sweep's frame limit: the command line's default (10e9)
MAX_FRAMES = int(10e9)
#: the modules no run may hold once its window has closed (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "libldpc_tpu")
#: seconds of the set-up's short sweep
SETUP_SWEEP_S = 0.5
#: a streaming window's lanes are kept at each super-step of its last
#: second (or half), for the reference to follow its end from
TAIL_S = 1.0
DEVICE = torch.device("cuda")


def _stream_lanes(st) -> tuple:
    return st.active.clone(), st.age.clone(), st.iters.clone()


def _stream_end(st) -> tuple:
    return st.active, st.iters


@dataclasses.dataclass
class Recorder:
    """What the timed path hands the host: every counter row it read, the
    steps dispatched, each streaming step's refill flag and, from
    ``tail_from`` on the host clock, the lanes at the start of the latest
    streaming super-step that refills (``lanes_of``: in flight, age,
    iterations; the fused pool's also its pool and its frames); and the
    state the last streaming step returned, whose lanes :meth:`close` keeps
    once the window has closed (``end_of``: in flight, each lane's last
    frame's iterations)."""

    rows: list = dataclasses.field(default_factory=list)
    dispatches: int = 0
    refill: list = dataclasses.field(default_factory=list)
    tail_from: float = float("inf")
    snapshots: dict = dataclasses.field(default_factory=dict)
    last_state: object = None
    end: tuple = None
    lanes_of: Callable = _stream_lanes
    end_of: Callable = _stream_end

    def clear(self):
        self.rows, self.dispatches, self.refill, self.snapshots = [], 0, [], {}
        self.last_state, self.end = None, None

    def close(self):
        """Keep the last state's lanes on the host and let the state go."""
        if self.last_state is not None:
            self.end = tuple(t.cpu() for t in self.end_of(self.last_state))
        self.last_state = None

    def tail(self):
        """``(s0, active, age, iters)`` on the host: the lanes at the start
        of the last super-step that refilled, or None where they were not
        kept."""
        refill = self.refill[1:]  # the first dispatch is the point's warm-up step
        drain = next((s for s, f in enumerate(refill) if not f), len(refill))
        lanes = self.snapshots.get(drain - 1)
        if drain == 0 or lanes is None:
            return None
        return (drain - 1, *(t.cpu() for t in lanes))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def build_simulator(cell: specmod.Cell, files: dict, seed: int, workdir):
    """The ``Simulator`` of the cell's command line, its counter reads and
    steps recorded (the recording appends to lists and, over the window's
    last second, copies on the card the lanes' state at each refilling
    super-step: three small planes, and for the fused pool its pool and
    the frames in flight too, ~190 MB at n = 1152).  A mix's ``qc`` true
    declares the code quasi-cyclic at its configuration's lifting ``Z``, as
    ``--qc-z`` does (``detect_qc``, which raises where H is not): with
    ``--pallas --layer-file`` the sweep then routes to the fast layered
    engine."""
    from libldpc_tpu_torch.models import LDPCCode, detect_qc
    from libldpc_tpu_torch.sim.driver import Simulator
    from libldpc_tpu_torch.utils.params import ChannelParams, DecoderParams, SimulationParams

    cfg, tr = cell.config, cell.traffic
    layer_file = files["layerfile"] if tr["layer_file"] else ""
    pcode = LDPCCode.from_files(files["codefile"], files["genfile"], layer_file)
    if tr.get("qc"):
        if "Z" not in cfg["code"]:
            raise ValueError(f"the mix declares {cell.config_name} quasi-cyclic; its code has no Z")
        detect_qc(pcode, int(cfg["code"]["Z"]))
    snr = float(tr["snr_db"])
    sim = Simulator(
        pcode,
        DecoderParams(early_term=tr["early_term"], iterations=cfg["iterations"],
                      type=cfg["decoding"], layered=bool(layer_file),
                      message_dtype=cfg["message_dtype"], quant_scale=cfg["quant_scale"]),
        ChannelParams(seed=int(seed), x_range=(snr, snr + 0.5, 1.0), type=tr["channel"]),
        SimulationParams(batch_size=cfg["batch_size"], max_frames=MAX_FRAMES,
                         fec=FEC_OUT_OF_REACH, result_file=str(workdir / "results.txt")),
        device=DEVICE, use_pallas=tr["pallas"], verbose=True)
    rec = Recorder()
    read, stream_step, step = sim._read, getattr(sim, "_stream_step", None), sim._step

    def recording_read(values):
        out = read(values)
        if sim.engine == "batch":
            rec.rows.append([int(v) for v in out])
        else:
            rec.rows.extend([int(v) for v in r] for r in out)
        return out

    sim._read = recording_read
    if sim.engine == "fused-pool":
        rec.lanes_of = _pool_lanes(sim.tables.code.vn_inv.long())
        rec.end_of = lambda st: (st.done == 0, st.iters)
    if sim.engine == "batch":
        def recording_step(*a, **k):
            rec.dispatches += 1
            return step(*a, **k)

        sim._step = recording_step
    else:
        def recording_stream_step(state, gen, x, refill):
            if refill and time.perf_counter() >= rec.tail_from:
                # the point's super-step (its first dispatch is the warm-up step)
                rec.snapshots = {rec.dispatches - 1: rec.lanes_of(state)}
            rec.dispatches += 1
            rec.refill.append(bool(refill))
            state, acc = stream_step(state, gen, x, refill)
            rec.last_state = state
            return state, acc

        sim._stream_step = recording_stream_step
    return sim, rec


def _pool_lanes(inv: torch.Tensor):
    """The fused pool's lanes as the recorder keeps them: in flight, age,
    iterations, entry unused, the frames in flight and in the pool (LLRs,
    codewords) and the frames started.  The program keeps its planes in its
    sorted labels; row ``inv[v]`` is the code's variable ``v``."""
    def lanes_of(st):
        return (st.done == 0, st.age.clone(), st.iters.clone(), st.avail != 0,
                st.llr_in[inv], st.codeword[inv] != 0, st.fresh_llr[inv], st.fresh_cw[inv] != 0,
                st.started.clone())
    return lanes_of


def _sweep(sim, rec: Recorder, seconds: float):
    """``Simulator.start`` with a stop flag raised after ``seconds``; the
    console goes to standard error.  Returns the call's wall seconds."""
    t_end = [0.0]

    def stop():
        return time.perf_counter() >= t_end[0]

    with contextlib.redirect_stdout(sys.stderr):
        t0 = time.perf_counter()
        t_end[0] = t0 + seconds
        rec.tail_from = t_end[0] - min(TAIL_S, seconds / 2)
        sim.start(stop_flag=stop)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    return t1 - t0


def _stream_reference(cell, code, store):
    cfg = cell.config
    B = cfg["batch_size"]
    return StreamReference(graph_of(code, DEVICE), frames_of(code, cell.traffic["snr_db"], DEVICE),
                           B, cfg["iterations"], *_stream_rule(B), store)


def _stream_rule(batch: int) -> tuple:
    """The streaming engine's refill threshold and start quota at the
    sweep's settings."""
    return max(1, batch // 16), min(MAX_FRAMES, 2**31 - 2**20)


def compare(cell, code, rec: Recorder, seed: int, store=None) -> tuple:
    """The cell's numbers: the reference against the recorded rows, or with
    ``store``, against the control's (the reference with that storage, put
    in the program's place on the same frames)."""
    cfg, tr, chk = cell.config, cell.traffic, cell.check
    B, its = cfg["batch_size"], cfg["iterations"]
    if chk["kind"] == "batch":
        rows = rec.rows
        if store is not None:
            graph = graph_of(code, DEVICE)
            frames = frames_of(code, tr["snr_db"], DEVICE)
            rows = [[0, 0, B, 0] for _ in rec.rows]
            for j in checks.sample_indices(seed, len(rec.rows), chk["sample"]):
                key = step_keys(seed, 0, j, 1, DEVICE)[0]
                llr, cw = frames.draw(key, torch.arange(B, device=DEVICE))
                r = checks.decode_batch(graph, code, tr, llr, cw, its, store)
                rows[j] = [r["bit_errors"], r["frame_errors"], r["frames"], r["iter_sum"]]
        return checks.batch_numbers(rows, code, tr, seed, B, its, chk["sample"], DEVICE)
    refill = rec.refill[1:]  # the first dispatch is the point's warm-up step
    leading = next((s for s, f in enumerate(refill) if not f), len(refill))
    n = min(chk["supersteps"], leading)
    if chk["kind"] == "pool":
        quota = _stream_rule(B)[1]
        start, detail = checks.pool_start(rec.rows, code, tr, seed, B, its, quota, n, DEVICE,
                                          store)
        tail, numbers, tail_detail = checks.pool_tail(rec.rows, refill, rec.tail(), rec.end,
                                                      code, tr, seed, B, its, quota, DEVICE,
                                                      store)
        return {**checks.stream_numbers(start, tail, B), **numbers}, detail + tail_detail
    rows = rec.rows
    if store is not None:
        ctl = _stream_reference(cell, code, store)
        rows = [ctl.superstep(step_keys(seed, 0, s, its, DEVICE), True) for s in range(n)]
    args = (code, tr["snr_db"], seed, B, its, its, *_stream_rule(B))
    start, detail = checks.stream_start(rows, *args, n, DEVICE)
    tail, numbers, tail_detail = checks.stream_tail(rec.rows, refill, rec.tail(), rec.end,
                                                    *args, DEVICE, store)
    return {**checks.stream_numbers(start, tail, B), **numbers}, detail + tail_detail


def run(cell_name: str, seed: int, seconds: float, traced: bool, t_process: float,
        root: pathlib.Path = specmod.ROOT) -> int:
    """One run; prints the result line last on standard output and the
    compared numbers last on standard error.  Returns the exit code."""
    bench = specmod.load_benchmark(root)
    cell = specmod.resolve(bench, cell_name, root)
    workdir = root / "build" / "portbench" / cell_name
    workdir.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    code, files = cached_code(cell.config["code"],
                              root / "build" / "portbench" / "codes" / cell.config_name)
    sim, rec = build_simulator(cell, files, seed, workdir)
    _sweep(sim, rec, SETUP_SWEEP_S)  # loads and warms the cell's own path
    rec.clear()

    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    setup_s = time.perf_counter() - t_process
    with torch.profiler.record_function(tracemod.WINDOW_RANGE) if traced else \
            contextlib.nullcontext():
        window_s = _sweep(sim, rec, seconds)
    if prof is not None:
        prof.__exit__(None, None, None)
    rec.close()
    peak = torch.cuda.max_memory_allocated()

    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the run holds {found} once its window has closed", file=sys.stderr)
        return 3

    frames = sum(r[2] for r in rec.rows)
    iter_sum = sum(r[3] for r in rec.rows)
    fe = sum(r[1] for r in rec.rows)
    be = sum(r[0] for r in rec.rows)
    batch = cell.config["batch_size"]
    if sim.engine == "batch":
        dispatched = (rec.dispatches - 1) * batch  # less the point's warm-up batch
        frames_drawn = rec.dispatches * batch
        failed = max(0, dispatched - frames)
    else:
        frames_drawn = frames
        failed = int(rec.rows[-1][4]) if rec.rows else 0
    print(f"portbench: cell {cell.name} seed {seed} engine={sim.engine} schedule={sim.schedule} "
          f"dtype={sim.message_dtype} decode_path={sim.decode_path}", file=sys.stderr)
    print(f"portbench: frames {frames} frame_errors {fe} bit_errors {be} "
          f"FER {fe / max(frames, 1):.6e} BER {be / max(frames * code.nct, 1):.6e} "
          f"avg_iter {iter_sum / max(frames, 1):.6f} window_s {window_s:.6f} rows {len(rec.rows)}",
          file=sys.stderr)

    out = {"correct": False, "attempted": frames + failed, "failed": failed, "metrics": {},
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(DEVICE),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if traced:
        w = tracemod.window_of(prof)
        out["device"]["busy_s"] = w.union_us() * 1e-6
        out["device"]["window_s"] = window_s
        ctx = {"trace": w, "window_s": window_s, "frames": frames, "iter_sum": iter_sum,
               "frames_drawn": frames_drawn, "code": code, "config": cell.config,
               "traffic": cell.traffic}
        for m in cell.per_layer:
            v = specmod.metric_reader(m["name"])(ctx)
            if v is None:
                print(f"portbench: {m['name']}: nothing to read in this run", file=sys.stderr)
            else:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        other = w.device_us_of(lambda n: True)
        print(f"portbench: device ops {len(w.kernels)}, device seconds {other * 1e-6:.6f}, "
              f"busy {w.union_us() * 1e-6:.6f} of {window_s:.6f}", file=sys.stderr)
        out["breakdown"] = tracemod.breakdown(w)
        del prof, w, ctx
    else:
        for m in cell.end_to_end:
            if m["name"] == "frames_per_s":
                out["metrics"]["frames_per_s"] = {"value": frames / window_s, "unit": m["unit"]}
            elif m["name"] == "setup_s":
                out["metrics"]["setup_s"] = {"value": setup_s, "unit": m["unit"]}
    print(f"portbench: card {card_line()}", file=sys.stderr)

    # the program's state is freed before the reference runs on the card
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers, detail = compare(cell, code, rec, seed)
    for d in detail:
        print(f"portbench: check {json.dumps(d)}", file=sys.stderr)
    print(f"portbench: reference took {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = cell.check["limits"]
    for k in sorted(set(numbers) - set(limits)):
        print(f"portbench: not compared {k} {numbers[k]!r}", file=sys.stderr)
    out["correct"] = bool(rec.rows) and all(numbers[k] <= limits[k] for k in limits)
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    print(json.dumps(out))
    sys.stdout.flush()
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    return 0


def readings(cell_name: str, seeds: list, seconds: float, control: int,
             root: pathlib.Path = specmod.ROOT) -> list:
    """For each seed, the program's numbers from a window of ``seconds``
    and, for the first ``control`` seeds, the control's (the reference with
    every stored message in bfloat16, put in the program's place on the
    same frames): the readings the limits are set from, in one process."""
    bench = specmod.load_benchmark(root)
    cell = specmod.resolve(bench, cell_name, root)
    workdir = root / "build" / "portbench" / cell_name
    workdir.mkdir(parents=True, exist_ok=True)
    code, files = cached_code(cell.config["code"],
                              root / "build" / "portbench" / "codes" / cell.config_name)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        sim, rec = build_simulator(cell, files, seed, workdir)
        _sweep(sim, rec, SETUP_SWEEP_S)
        rec.clear()
        _sweep(sim, rec, seconds)
        rec.close()
        del sim
        gc.collect()
        t1 = time.perf_counter()
        numbers, detail = compare(cell, code, rec, seed)
        t2 = time.perf_counter()
        row = {"seed": seed, "program": numbers, "seconds": [t1 - t0, t2 - t1],
               "detail": detail}
        if len(out) < control:
            row["control"], row["control_detail"] = compare(cell, code, rec, seed,
                                                            bfloat16_store)
            row["seconds"].append(time.perf_counter() - t2)
        print(f"portbench: readings {json.dumps(row)}", file=sys.stderr)
        out.append(row)
    return out
