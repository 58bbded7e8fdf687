"""The per-batch simulation step, on one device or over a mesh of devices
(from :mod:`libldpc_tpu.parallel.mesh`).

Without a mesh the step runs on the tables' device: channel simulation ->
decode -> error counting.  With a :class:`Mesh` it is the counterpart of
the JAX package's ``shard_map``: every entry of the mesh (a shard)
simulates and decodes its own sub-batch of frames with its own generator
(:func:`shard_generators`, the counterpart of ``fold_in(key,
axis_index)``), and the counters are the int64 sums of the shards' counters
on the first device (the counterpart of ``psum``).  A mesh may repeat a
device: its shards then run one after another on that device's stream,
which is how a test builds a ``(2, 4)`` mesh from ``"cpu"`` and how one
card runs a ``(2, 2)`` mesh.  Each entry belongs to one process
(:mod:`.distributed`); a process runs only its own shards and its counters
are partial sums, which the sweep driver reduces over the process group
when it reads them.

:func:`make_multipoint_sim_step` is the 2-D ``(points, frames)`` form:
several sweep points at once, each point's counters summed over its frame
shards.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.bec import bec_decode, bec_decode_plain
from ..ops.channel import make_generator
from ..ops.decoder import bp_decode, bp_decode_plain
from ..ops.device import DeviceCode
from ..ops.kernels.decode_bec import bec_decode_fused, bec_decode_fused_plain
from ..ops.kernels.decode_fused import bp_decode_fused, bp_decode_fused_plain
from ..ops.kernels.decode_layered import (
    bp_decode_layered, bp_decode_layered_fast, bp_decode_layered_fast_plain,
    bp_decode_layered_plain,
)
from ..ops.kernels.layout import KernelTables
from ..ops.kernels.pool_refill import PoolTables, channel_batch, pool_tables
from ..utils.profiling import span

FRAME_AXIS = "frames"
POINT_AXIS = "points"


class StepCounters(NamedTuple):
    """Counters of one decoded batch, as int64 device scalars (with a
    leading points axis from :func:`make_multipoint_sim_step`)."""

    bit_errors: torch.Tensor  # wrong transmitted bits
    frame_errors: torch.Tensor  # frames with >= 1 bit error
    frames: torch.Tensor
    iter_sum: torch.Tensor  # sum of per-frame iterations


class ForensicStepCounters(NamedTuple):
    """:class:`StepCounters` plus the per-frame planes of the forensic error
    log, in sorted VN labels; made only when asked for, so the ordinary
    batch step carries no extra plane.  Over a mesh the planes hold every
    shard's frames in frame order, each frame once."""

    bit_errors: torch.Tensor
    frame_errors: torch.Tensor
    frames: torch.Tensor
    iter_sum: torch.Tensor
    frame_bit_errors: torch.Tensor  # int64 [B] wrong transmitted bits per frame
    hard: torch.Tensor  # u8 [nc, B] decided bits
    codeword: torch.Tensor  # u8 [nc, B] true codeword


# ------------------------------------------------------------------ the mesh


class Shard(NamedTuple):
    """One entry of a :class:`Mesh`."""

    index: int  # flat position, points-major (frame order within a point)
    point: int  # coordinate on the points axis (0 on a 1-D mesh)
    frame: int  # coordinate on the frames axis
    device: torch.device


class Mesh:
    """Devices on named axes, ``FRAME_AXIS`` last: the port's counterpart
    of ``jax.sharding.Mesh``.  ``devices`` is an object array of
    ``torch.device`` (entries may repeat a device), ``processes`` the rank
    that owns each entry (every entry this process's when not given)."""

    def __init__(self, devices, axis_names: Sequence[str], processes=None):
        given = np.asarray(devices, dtype=object)
        arr = np.empty(given.shape, dtype=object)
        for idx, d in np.ndenumerate(given):
            arr[idx] = canonical_device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or self.axis_names[-1] != FRAME_AXIS:
            raise ValueError(f"mesh axes {self.axis_names} for devices of shape {arr.shape}: "
                             f"one name per axis, {FRAME_AXIS!r} last")
        self.devices = arr
        if processes is None:
            from .distributed import process_index

            processes = np.full(arr.shape, process_index(), dtype=np.int64)
        self.processes = np.asarray(processes, dtype=np.int64).reshape(arr.shape)

    @property
    def shape(self) -> dict:
        """Axis name -> size (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def n_points(self) -> int:
        return self.shape.get(POINT_AXIS, 1)

    @property
    def n_frame_shards(self) -> int:
        """Entries per point: every entry of a mesh without a points axis."""
        return self.size // self.n_points

    def shards(self) -> list[Shard]:
        """Every entry, points-major."""
        n_f = self.n_frame_shards
        return [Shard(i, i // n_f, i % n_f, d) for i, d in enumerate(self.devices.ravel())]

    def local_shards(self) -> list[Shard]:
        """The entries this process runs."""
        from .distributed import process_index

        rank = process_index()
        return [s for s, p in zip(self.shards(), self.processes.ravel()) if p == rank]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.ravel()]})"


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def _object_array(items) -> np.ndarray:
    """A 1-D object array of ``items`` (devices or device strings)."""
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], devices,
              processes=None) -> Mesh:
    """A mesh of ``devices`` (taken in order) reshaped to ``shape``, as
    ``jax.make_mesh``; the entries may repeat a device.  ``processes``:
    the owning rank of each device (this process's by default)."""
    devices = list(devices)
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"mesh of shape {tuple(shape)} needs {n} devices, got {len(devices)}")
    if processes is not None:
        processes = np.asarray(processes, dtype=np.int64)[:n]
    return Mesh(_object_array(devices[:n]).reshape(tuple(shape)), axis_names, processes)


def local_devices(device="cuda") -> list[torch.device]:
    """The distinct devices of ``device``'s type on this host: every
    visible card for ``cuda``, one for the CPU (how the JAX CLI counts
    ``jax.devices()``).  A CUDA device without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() is False")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def default_mesh(max_devices: Optional[int] = None, device="cuda") -> Mesh:
    """A 1-D frames mesh over every (or the first ``max_devices``) distinct
    device of ``device``'s type."""
    devs = local_devices(device)
    if max_devices is not None:
        devs = devs[:max_devices]
    return Mesh(_object_array(devs), (FRAME_AXIS,))


def shard_generators(mesh: Mesh, *key: int) -> list[torch.Generator]:
    """One generator per local shard (in :meth:`Mesh.local_shards` order),
    on its device: ``make_generator`` of ``key`` with the shard's mesh
    coordinates appended (its frame index on a 1-D mesh, ``(point,
    frame)`` on a 2-D one), the counterpart of ``fold_in`` with the axis
    indices."""
    two_d = POINT_AXIS in mesh.shape
    return [make_generator(s.device, *key, *((s.point, s.frame) if two_d else (s.frame,)))
            for s in mesh.local_shards()]


def on_device(device: torch.device):
    """Context that makes ``device`` current for the launches inside it
    (a CUDA kernel launches on the current device's stream)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class Replicas:
    """The tables (the device form of a modulation's bit mapper, and the
    channel draw's tables of ``channel_type``) of one code on each device
    of a mesh, each built once per device.  ``code_of(tables)`` is the code
    a channel batch is drawn for: the kernel tables' sorted code by
    default."""

    def __init__(self, tables: KernelTables, modulation=None, channel_type: Optional[str] = None,
                 code_of: Callable = lambda tables: tables.code):
        self._tables = {tables.device: tables}
        self._modulation = modulation
        self._channel_type = channel_type
        self._code_of = code_of
        self._pools = {}

    def tables(self, device: torch.device) -> KernelTables:
        device = canonical_device(device)
        if device not in self._tables:
            self._tables[device] = next(iter(self._tables.values())).to(device)
        return self._tables[device]

    def modulation(self, device: torch.device):
        if self._modulation is None:
            return None
        cstl, mapper = self._modulation
        return cstl, mapper.to(device)

    def pool(self, device: torch.device) -> PoolTables:
        """The channel draw's tables on ``device`` (:func:`pool_tables`),
        built at the first call."""
        device = canonical_device(device)
        if device not in self._pools:
            self._pools[device] = pool_tables(self._code_of(self.tables(device)),
                                              self._channel_type, self.modulation(device))
        return self._pools[device]


# ----------------------------------------------------------- the batch step


def batch_decoder(tables: KernelTables, schedule: str, plain: bool = False):
    """The batch kernel of a schedule (``"flooding"``, ``"layered"`` or
    ``"layered-fast"``), or with ``plain`` its plain PyTorch version.  The
    exact layered schedule with fewer than two layers is flooding, as in
    the JAX decoders."""
    if schedule == "layered-fast":
        return bp_decode_layered_fast_plain if plain else bp_decode_layered_fast
    if schedule == "layered" and tables.n_layers > 1:
        return bp_decode_layered_plain if plain else bp_decode_layered
    return bp_decode_fused_plain if plain else bp_decode_fused


def batch_decode(tables, channel_type: str, dec, schedule: str, plain: bool = False) -> Callable:
    """``decode(tables, channel) -> output``: the batch decoder of a step
    on ``tables``, which are the sorted layout's kernel tables, decoded by
    the schedule's batch kernel in ``dec.message_dtype`` (the BEC: the
    peeling kernel, flooding), or a :class:`DeviceCode` (the JAX step's
    padded branch), decoded by the padded :func:`bp_decode` (layered as
    ``dec.layered`` says; float32 messages) or :func:`bec_decode`, which
    run K1/K5/K6 on the card, ``schedule`` not used.  ``plain`` takes the
    plain versions (on any device, on the same draws: the card's checks
    hold a kernel step against it)."""
    stale = 0 if dec.bec_ref_bug_compat else None
    if isinstance(tables, DeviceCode):
        if channel_type == "BEC":
            bec = bec_decode_plain if plain else bec_decode
            return lambda tb, ch: bec(tb, ch.llr, ch.codeword, iterations=dec.iterations,
                                      early_term=dec.early_term, degree1_stale_byte=stale)
        bp = bp_decode_plain if plain else bp_decode
        return lambda tb, ch: bp(tb, ch.llr, iterations=dec.iterations,
                                 early_term=dec.early_term, minsum_mode=dec.cn_mode,
                                 layered=dec.layered)
    if channel_type == "BEC":
        bec = bec_decode_fused_plain if plain else bec_decode_fused
        return lambda tb, ch: bec(tb, ch.llr, ch.codeword, iterations=dec.iterations,
                                  early_term=dec.early_term, degree1_stale_byte=stale)
    bp = batch_decoder(tables, schedule, plain)
    return lambda tb, ch: bp(tb, ch.llr, iterations=dec.iterations, early_term=dec.early_term,
                             minsum_mode=dec.cn_mode, message_dtype=dec.message_dtype,
                             quant_scale=dec.quant_scale)


def _sim_and_count(
    tables: KernelTables,
    pool: PoolTables,
    gen: torch.Generator,
    x_value: float,
    batch: int,
    decode: Callable,
    forensics: bool = False,
):
    """Draw a channel batch with K8 (:func:`channel_batch` on ``pool``, the
    channel's and modulation's tables; on the CPU the plain channel),
    decode it with ``decode`` (:func:`batch_decode`), count from its
    decisions.  Bit errors count the transmitted bits (the drawn code's
    ``bit_pos``) only.  ``forensics`` returns
    :class:`ForensicStepCounters`, else :class:`StepCounters`."""
    with span("ldpc.channel"):
        ch = channel_batch(pool, gen, batch, x_value)
    with span("ldpc.decode"):
        out = decode(tables, ch)
    with span("ldpc.count"):
        bit_pos = pool.code.bit_pos
        frame_errs = (
            out.hard.index_select(0, bit_pos).bool()
            != ch.codeword.index_select(0, bit_pos).bool()
        ).sum(0)
        base = StepCounters(
            bit_errors=frame_errs.sum(),
            frame_errors=(frame_errs > 0).sum(),
            frames=torch.full((), batch, dtype=torch.int64, device=ch.codeword.device),
            iter_sum=out.iterations.sum(dtype=torch.int64),
        )
    if forensics:
        return ForensicStepCounters(*base, frame_bit_errors=frame_errs,
                                    hard=out.hard.to(torch.uint8), codeword=ch.codeword)
    return base


class ShardedStep:
    """The batch step over a mesh: ``step(gens, x)`` with one generator per
    local shard (:func:`shard_generators`) and one x-value per point.
    :meth:`per_shard` gives each local shard's own counters."""

    def __init__(self, replicas: Replicas, mesh: Mesh, count: Callable):
        self.mesh = mesh
        self._shards = mesh.local_shards()
        if not self._shards:
            raise ValueError(f"{mesh} has no entry of this process")
        self._replicas = replicas
        self._count = count
        self.device = self._shards[0].device
        for s in self._shards:  # build every device's tables up front
            replicas.tables(s.device)

    def per_shard(self, gens: Sequence[torch.Generator], x_values: Sequence[float]) -> list:
        """Each local shard's counters, on its device, in shard order."""
        if len(gens) != len(self._shards):
            raise ValueError(f"{len(gens)} generators for {len(self._shards)} local shards")
        out = []
        for s, gen in zip(self._shards, gens):
            with on_device(s.device):
                out.append(self._count(self._replicas.tables(s.device),
                                       self._replicas.pool(s.device), gen,
                                       float(x_values[s.point])))
        return out

    def reduce(self, parts: list):
        """Per-point int64 sums of the shards' counters on the first local
        device, ``[n_points]`` each; the forensic planes ``[n_points, ...,
        frames of a point]`` in frame order (zeros for another process's
        shards)."""
        n_p, n_f = self.mesh.n_points, self.mesh.n_frame_shards
        dev = self.device
        sums = [torch.zeros(n_p, dtype=torch.int64, device=dev) for _ in range(4)]
        for s, c in zip(self._shards, parts):
            for acc, v in zip(sums, c[:4]):
                acc[s.point] += v.to(dev, torch.int64)
        if not isinstance(parts[0], ForensicStepCounters):
            return StepCounters(*sums)
        b = parts[0].frame_bit_errors.shape[0]
        nc = parts[0].hard.shape[0]
        fbe = torch.zeros((n_p, n_f * b), dtype=torch.int64, device=dev)
        hard = torch.zeros((n_p, nc, n_f * b), dtype=torch.uint8, device=dev)
        cw = torch.zeros_like(hard)
        for s, c in zip(self._shards, parts):
            cols = slice(s.frame * b, (s.frame + 1) * b)
            fbe[s.point, cols] = c.frame_bit_errors.to(dev, torch.int64)
            hard[s.point, :, cols] = c.hard.to(dev)
            cw[s.point, :, cols] = c.codeword.to(dev)
        return ForensicStepCounters(*sums, frame_bit_errors=fbe, hard=hard, codeword=cw)

    def __call__(self, gens, x_values):
        if len(x_values) != self.mesh.n_points:
            raise ValueError(f"x_values has {len(x_values)} points, mesh expects "
                             f"{self.mesh.n_points}")
        return self.reduce(self.per_shard(gens, x_values))


def make_sim_step(
    tables, channel_type: str, dec, batch: int, schedule: str = "flooding",
    forensics: bool = False, modulation=None, mesh: Optional[Mesh] = None, plain: bool = False,
) -> Callable:
    """``step(gen, x_value) -> StepCounters`` on ``tables``' device
    (:class:`ForensicStepCounters` with ``forensics``); ``modulation`` as
    :func:`~..ops.channel.simulate_channel` takes it, ``batch`` the frames
    of one shard.  ``tables`` is the sorted layout's
    :class:`~..ops.kernels.layout.KernelTables` (the sweep's), decoded on
    ``schedule``'s kernel, or a :class:`DeviceCode` (the library's padded
    layout, in the code's labelling), decoded by the padded decoders
    (:func:`batch_decode`).

    With a ``mesh`` the step is ``step(gens, x_value)``: one generator per
    local shard (:func:`shard_generators`), each shard ``batch`` frames on
    its device, the counters summed over the shards (every entry of the
    mesh is a frame shard), the forensic planes ``[nc, shards * batch]`` in
    frame order.  ``plain`` decodes with the plain versions."""

    decode = batch_decode(tables, channel_type, dec, schedule, plain)

    def count(tb, pool, gen, x):
        return _sim_and_count(tb, pool, gen, x, batch, decode, forensics)

    # a DeviceCode is drawn for in its own labelling
    replicas = Replicas(tables, modulation, channel_type,
                        **({"code_of": lambda dc: dc} if isinstance(tables, DeviceCode) else {}))
    if mesh is None:
        def step(gen: torch.Generator, x_value: float):
            return count(tables, replicas.pool(tables.device), gen, x_value)

        return step
    flat = Mesh(mesh.devices.reshape(-1), (FRAME_AXIS,), mesh.processes.reshape(-1))
    sharded = ShardedStep(replicas, flat, count)

    def step(gens, x_value: float):
        out = sharded(gens, [x_value])
        return type(out)(*(v[0] for v in out))

    step.per_shard = lambda gens, x_value: sharded.per_shard(gens, [x_value])
    return step


def make_multipoint_sim_step(
    tables: KernelTables, channel_type: str, dec, batch: int, schedule: str, mesh: Mesh,
    forensics: bool = False, modulation=None, plain: bool = False,
) -> ShardedStep:
    """Sweep point x frame parallelism over a 2-D ``(points, frames)``
    mesh: ``step(gens, x_values[n_points])`` returns counters with a
    leading ``n_points`` axis, each summed over its point's frame shards
    (``batch`` frames each), and with ``forensics`` the planes
    ``[n_points, nc, frames of a point]``."""
    mesh.shape[POINT_AXIS]  # a points axis is required

    decode = batch_decode(tables, channel_type, dec, schedule, plain)

    def count(tb, pool, gen, x):
        return _sim_and_count(tb, pool, gen, x, batch, decode, forensics)

    return ShardedStep(Replicas(tables, modulation, channel_type), mesh, count)
