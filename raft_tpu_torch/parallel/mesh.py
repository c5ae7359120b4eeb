"""Meshes, sharded tensors and ``shard_map`` (counterpart of
``raft_tpu.parallel.mesh``).

The JAX package is single-controller: a ``Mesh`` is a grid of devices,
and a ``shard_map`` body runs once per mesh position, where ``Comms``
collectives are valid. The port keeps that shape:

* :class:`Mesh` — a named grid of ``torch.device``s. A device may
  repeat: eight **logical ranks** may share one card (or the CPU, as
  the tests do). Each rank is one position of the grid.
* :class:`Sharded` — a tensor split into equal row blocks over one mesh
  axis (the role of a ``jax.Array`` with ``NamedSharding(mesh,
  P(axis))``): one block per position along the axis, on that rank's
  device.
* :func:`shard_map` — runs ``fn`` once per rank, each on a worker thread
  of its own that the mesh keeps; on CUDA each worker works on a stream
  of its own on its rank's device. Inputs made on the caller's stream
  are waited for by every rank stream, and the caller's stream waits
  for every rank stream before the results come back.
* Collectives meet at an in-process rendezvous with a timeout. A rank
  that raises aborts the rendezvous, so every other rank's pending
  collective raises :class:`CollectiveAborted` instead of hanging, and
  :func:`shard_map` re-raises the first rank's own error (the JAX
  package's "a lost participant hangs" turned into its ABORT).

A **process mesh** (``make_mesh`` after
``comms.initialize_distributed``) holds one rank per process: this
process runs only its own rank, on the calling thread, and ``Comms``
collectives go through ``torch.distributed`` (NCCL on the card, gloo on
the CPU).

:func:`make_mesh` with no ``devices`` takes every visible card, one
rank each, and raises on a host without one: a CPU mesh exists only
when the caller names CPU devices.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import LogicError, expects

__all__ = ["CollectiveAborted", "CollectiveError", "CollectiveTimeout",
           "Mesh", "P", "PartitionSpec", "Sharded", "make_mesh",
           "replicate", "shard_map", "shard_map_compat", "shard_rows"]


class CollectiveError(RuntimeError):
    """A collective could not complete."""


class CollectiveAborted(CollectiveError):
    """A peer rank failed, so this rank's collective was abandoned."""


class CollectiveTimeout(CollectiveError):
    """Not every member of a collective arrived within its timeout."""

    def __init__(self, message: str, missing=()):
        super().__init__(message)
        self.missing = tuple(missing)


class PartitionSpec(tuple):
    """How an argument or result lies over the mesh: ``P()`` replicated,
    ``P(axis)`` / ``P(axis, None, ...)`` row blocks over ``axis``."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


class Mesh:
    """A named grid of ``torch.device``s (a device may repeat).

    ``shape`` maps each axis name to its size, as a ``jax`` mesh's does;
    ``devices`` is the numpy object array of the grid. Positions are
    flattened in C order into ranks ``0 .. size - 1``."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("data",),
                 process_rank: Optional[int] = None):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        flat = [torch.device(d) for d in np.asarray(
            devices, dtype=object).reshape(-1)]
        arr.reshape(-1)[:] = flat
        axis_names = tuple(axis_names)
        expects(arr.ndim == len(axis_names),
                "Mesh: %d axis names for a %d-d device grid",
                len(axis_names), arr.ndim)
        self.devices = arr
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, arr.shape))
        self.size = int(arr.size)
        # a process mesh: this process owns exactly this rank
        self.process_rank = process_rank
        self._pool: Optional["_RankPool"] = None
        self._pool_lock = threading.Lock()

    @property
    def devices_flat(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    @property
    def is_process_mesh(self) -> bool:
        return self.process_rank is not None

    def coords(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_ranks(self, rank: int, axis: str) -> Tuple[int, ...]:
        """The flat ranks along ``axis`` that share ``rank``'s other
        coordinates, in axis order."""
        expects(axis in self.shape, "mesh: no axis %r in %s", axis,
                self.axis_names)
        idx = list(np.unravel_index(rank, self.devices.shape))
        a = self.axis_names.index(axis)
        out = []
        for p in range(self.devices.shape[a]):
            idx[a] = p
            out.append(int(np.ravel_multi_index(idx, self.devices.shape)))
        return tuple(out)

    def _rank_pool(self) -> "_RankPool":
        with self._pool_lock:
            if self._pool is None:
                self._pool = _RankPool(self.devices_flat)
            return self._pool

    def close(self) -> None:
        """Stop the mesh's rank workers (they are daemon threads; a
        closed mesh starts them again at its next ``shard_map``)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()

    def __repr__(self) -> str:
        devs = self.devices_flat
        kinds = sorted({str(d) for d in devs})
        return (f"Mesh({dict(self.shape)}, devices={kinds}"
                + (f", process_rank={self.process_rank}"
                   if self.process_rank is not None else "") + ")")


# the process world bound by comms.bootstrap.initialize_distributed:
# (world size, this process's rank, its device)
_PROCESS_WORLD: Optional[Tuple[int, int, torch.device]] = None


def _set_process_world(world) -> None:
    global _PROCESS_WORLD
    _PROCESS_WORLD = world


def process_world():
    """``(world_size, rank, device)`` of the bound process world, or
    None."""
    return _PROCESS_WORLD


def _default_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise LogicError(
            "make_mesh: no CUDA device; name the devices to build a mesh "
            "on the CPU (devices=[torch.device('cpu')] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("data",),
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices``. With no ``devices``: the
    bound process world (one rank a process), else every visible card,
    one rank each; a host with no card raises."""
    world = _PROCESS_WORLD
    if devices is None and world is not None:
        size, rank, dev = world
        if shape is None:
            shape = (size,) + (1,) * (len(axis_names) - 1)
        expects(int(np.prod(shape)) == size,
                "make_mesh: shape %s != %d processes", shape, size)
        return Mesh(np.asarray([dev] * size, dtype=object).reshape(shape),
                    axis_names, process_rank=rank)
    devs = ([torch.device(d) for d in devices] if devices is not None
            else _default_devices())
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axis_names) - 1)
    expects(int(np.prod(shape)) == len(devs),
            "make_mesh: shape %s != %d devices", shape, len(devs))
    return Mesh(np.asarray(devs, dtype=object).reshape(shape), axis_names)


class Sharded:
    """A tensor in equal row blocks over ``mesh[axis]`` (block ``p`` on
    the device of position ``p`` along the axis). ``shape`` is the whole
    tensor's; ``gather`` (or ``numpy()``) puts it back together."""

    def __init__(self, blocks: Sequence[torch.Tensor], mesh: Mesh,
                 axis: str = "data"):
        expects(len(blocks) == mesh.shape[axis],
                "Sharded: %d blocks over an axis of %d", len(blocks),
                mesh.shape[axis])
        b0 = blocks[0]
        for b in blocks:
            expects(tuple(b.shape) == tuple(b0.shape) and b.dtype == b0.dtype,
                    "Sharded: blocks differ in shape or dtype")
        self.blocks = list(blocks)
        self.mesh = mesh
        self.axis = axis

    @property
    def shape(self) -> Tuple[int, ...]:
        b = self.blocks[0]
        return (b.shape[0] * len(self.blocks),) + tuple(b.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        """The first block's device (the device a gather defaults to)."""
        return self.blocks[0].device

    def gather(self, device=None) -> torch.Tensor:
        dev = torch.device(device) if device is not None else self.device
        return torch.cat([b.to(dev) for b in self.blocks])

    def numpy(self) -> np.ndarray:
        return np.concatenate([b.detach().cpu().numpy()
                               for b in self.blocks])

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, dtype={self.dtype}, "
                f"axis={self.axis!r}, blocks={len(self.blocks)})")


def shard_rows(x, mesh: Mesh, axis: str = "data"):
    """``x`` in equal row blocks over ``mesh[axis]`` → ``(Sharded,
    pad)``: rows zero-padded to a multiple of the axis size (callers
    that care mask the pad rows)."""
    x = torch.as_tensor(x)
    n = mesh.shape[axis]
    pad = (-x.shape[0]) % n
    if pad:
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device)])
    return _split(x, mesh, axis), pad


def _split(x: torch.Tensor, mesh: Mesh, axis: str) -> Sharded:
    n = mesh.shape[axis]
    expects(x.shape[0] % n == 0,
            "shard: %d rows not divisible by the %d ranks of axis %r",
            x.shape[0], n, axis)
    devs = _axis_devices(mesh, axis)
    rows = x.shape[0] // n
    return Sharded([x[p * rows:(p + 1) * rows].to(devs[p])
                    for p in range(n)], mesh, axis)


def _axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The device of each position along ``axis`` (other coordinates
    0)."""
    return [mesh.devices_flat[r] for r in mesh.axis_ranks(0, axis)]


def replicate(x, mesh: Mesh):
    """``x`` as every rank sees a ``P()`` argument: on a mesh of one
    device type, a tensor on the first rank's device (ranks on other
    devices copy it at their ``shard_map``)."""
    x = torch.as_tensor(x)
    return x.to(mesh.devices_flat[0])


# ---------------------------------------------------------------------------
# the rank context: which rank the calling thread runs, and its rendezvous


class _RankContext:
    __slots__ = ("mesh", "rank", "device", "rdv", "seq", "count",
                 "process")

    def __init__(self, mesh, rank, device, rdv, count, process=False):
        self.mesh = mesh
        self.rank = rank
        self.device = device
        self.rdv = rdv
        self.seq = 0
        self.count = count      # collectives counted in this run
        self.process = process  # collectives over torch.distributed


_tls = threading.local()


def current_rank_context() -> Optional[_RankContext]:
    """The calling thread's rank context inside a ``shard_map`` body,
    else None."""
    return getattr(_tls, "ctx", None)


class _Rendezvous:
    """Where the ranks of one ``shard_map`` run meet: each collective is
    a slot keyed by (the rank's collective sequence number, its group);
    values come back in group order. ``abort`` wakes every waiter with
    the error."""

    def __init__(self):
        self._cond = threading.Condition()
        self._slots: Dict[tuple, dict] = {}
        self._abort: Optional[BaseException] = None

    def abort(self, exc: BaseException) -> None:
        with self._cond:
            if self._abort is None:
                self._abort = exc
            self._cond.notify_all()

    def exchange(self, key, group: Tuple[int, ...], rank: int, value,
                 timeout_s: float) -> list:
        with self._cond:
            if self._abort is not None:
                raise CollectiveAborted(
                    f"collective abandoned: {self._abort!r}")
            slot = self._slots.setdefault(key, {"vals": {},
                                                "left": len(group)})
            slot["vals"][rank] = value
            if len(slot["vals"]) == len(group):
                self._cond.notify_all()
            deadline = time.monotonic() + timeout_s
            while len(slot["vals"]) < len(group):
                if self._abort is not None:
                    raise CollectiveAborted(
                        f"collective abandoned: {self._abort!r}")
                rem = deadline - time.monotonic()
                if rem <= 0:
                    missing = tuple(g for g in group
                                    if g not in slot["vals"])
                    err = CollectiveTimeout(
                        f"collective timed out after {timeout_s:g} s: "
                        f"ranks {missing} never arrived", missing)
                    self._abort = self._abort or err
                    self._cond.notify_all()
                    raise err
                self._cond.wait(rem)
            vals = [slot["vals"][g] for g in group]
            slot["left"] -= 1
            if slot["left"] == 0:
                del self._slots[key]
            return vals


def publish(value):
    """A value leaving this rank for its peers: a CUDA tensor carries an
    event recorded on the rank's stream (its readers wait for it)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(value.device))
        return (value, ev)
    return (value, None)


def receive(item, device: torch.device):
    """A peer's published value, safe to read on this rank's stream (and
    device)."""
    value, ev = item
    if not isinstance(value, torch.Tensor):
        return value
    if ev is not None:
        if value.device != device:
            ev.synchronize()
            return value.to(device)
        cur = torch.cuda.current_stream(device)
        cur.wait_event(ev)
        # the peer may drop its reference while this stream still reads
        value.record_stream(cur)
        return value
    return value.to(device) if value.device != device else value


# ---------------------------------------------------------------------------
# the rank workers


class _RankPool:
    """One daemon worker thread a rank, each with a job queue and, on
    CUDA, a stream of its own. Jobs are enqueued to every rank under one
    lock, so every rank runs the mesh's jobs in the same order."""

    def __init__(self, devices: List[torch.device]):
        self.devices = devices
        self._queues = [queue.Queue() for _ in devices]
        self.enqueue_lock = threading.Lock()
        self._threads = []
        for r, dev in enumerate(devices):
            t = threading.Thread(target=self._loop, args=(r, dev),
                                 daemon=True, name=f"raft-mesh-rank-{r}")
            t.start()
            self._threads.append(t)

    def _loop(self, rank: int, dev: torch.device) -> None:
        stream = None
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            stream = torch.cuda.Stream(dev)

        while True:
            job = self._queues[rank].get()
            if job is None:
                return
            if stream is not None:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    job(rank, dev)
            else:
                job(rank, dev)
            # an idle worker must not keep the last run's tensors alive
            del job

    def submit(self, job) -> None:
        with self.enqueue_lock:
            for q in self._queues:
                q.put(job)

    def close(self) -> None:
        for q in self._queues:
            q.put(None)


class _Job:
    """One ``shard_map`` run over every rank of the pool."""

    def __init__(self, body, n_ranks: int, count_rank: Optional[int]):
        self.body = body
        self.rdv = _Rendezvous()
        self.results: List[Any] = [None] * n_ranks
        self.errors: List[Optional[BaseException]] = [None] * n_ranks
        self.left = n_ranks
        self.done = threading.Event()
        self.lock = threading.Lock()
        self.count_rank = count_rank
        self.mesh = None
        self.start_events: Dict[torch.device, Any] = {}
        self.end_events: List[Any] = [None] * n_ranks

    def __call__(self, rank: int, dev: torch.device) -> None:
        ctx = _RankContext(self.mesh, rank, dev, self.rdv,
                           rank == self.count_rank)
        _tls.ctx = ctx
        try:
            ev = self.start_events.get(dev)
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
            self.results[rank] = self.body(rank, dev)
        except BaseException as e:  # every failure reaches the caller
            self.errors[rank] = e
            self.rdv.abort(e)
        finally:
            _tls.ctx = None
            if dev.type == "cuda":
                end = torch.cuda.Event()
                end.record(torch.cuda.current_stream(dev))
                self.end_events[rank] = end
            with self.lock:
                self.left -= 1
                if self.left == 0:
                    self.done.set()


def _cuda_tensors(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _cuda_tensors(t)


def _run_on_ranks(mesh: Mesh, body, count: bool):
    """Run ``body(rank, device)`` once per rank on the mesh's workers →
    per-rank results; re-raises the first rank's own error."""
    if current_rank_context() is not None:
        raise LogicError("shard_map: called inside a shard_map body")
    pool = mesh._rank_pool()
    job = _Job(body, mesh.size, 0 if count else None)
    job.mesh = mesh
    for dev in set(mesh.devices_flat):
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            job.start_events[dev] = ev
    pool.submit(job)
    job.done.wait()
    for r, ev in enumerate(job.end_events):
        if ev is not None:
            torch.cuda.current_stream(mesh.devices_flat[r]).wait_event(ev)
    for res in job.results:
        # results made on a rank stream and read on the caller's: their
        # memory must not return to the rank stream's pool under it
        for t in _cuda_tensors(res):
            t.record_stream(torch.cuda.current_stream(t.device))
    job.body = None
    errs = [(r, e) for r, e in enumerate(job.errors) if e is not None]
    if errs:
        own = [e for _, e in errs if not isinstance(e, CollectiveAborted)]
        raise (own[0] if own else errs[0][1])
    return job.results


def _spec_axis(spec) -> Optional[str]:
    """The axis a spec shards rows over, or None when replicated."""
    if spec is None:
        return None
    spec = tuple(spec)
    if not spec or spec[0] is None:
        expects(all(s is None for s in spec),
                "shard_map: only leading-dim sharding is supported, got %s",
                spec)
        return None
    expects(all(s is None for s in spec[1:]),
            "shard_map: only leading-dim sharding is supported, got %s",
            spec)
    return spec[0]


def _normalize_specs(specs, n: int):
    if isinstance(specs, PartitionSpec) or specs is None:
        return (specs,) * n if n != 1 else (specs,)
    specs = tuple(specs)
    expects(len(specs) == n, "shard_map: %d specs for %d values",
            len(specs), n)
    return specs


class _ShardMapped:
    """``fn`` over every rank of ``mesh``: the callable
    :func:`shard_map` returns. Collectives are counted on rank 0 of a
    run with a new input signature (the JAX package counts them once
    per trace)."""

    def __init__(self, fn, mesh: Mesh, in_specs, out_specs):
        self.fn = fn
        self.mesh = mesh
        self.in_specs = in_specs
        self.out_specs = out_specs
        self._seen = set()

    def _signature(self, args) -> tuple:
        sig = []
        for a in args:
            if isinstance(a, (torch.Tensor, Sharded)):
                sig.append((tuple(a.shape), str(a.dtype)))
            else:
                sig.append(type(a).__name__)
        return tuple(sig)

    def __call__(self, *args):
        mesh = self.mesh
        specs = _normalize_specs(self.in_specs, len(args))
        sig = self._signature(args)
        count = sig not in self._seen
        self._seen.add(sig)
        if mesh.is_process_mesh:
            return self._run_process(args, specs, count)
        # per-argument views: a Sharded's blocks, a split tensor, or the
        # replicated value (copied once per device that needs it)
        per_arg = []
        for a, spec in zip(args, specs):
            axis = _spec_axis(spec)
            if axis is not None:
                sh = a if isinstance(a, Sharded) else _split(
                    torch.as_tensor(a), mesh, axis)
                expects(sh.axis == axis,
                        "shard_map: argument sharded over %r, spec says %r",
                        sh.axis, axis)
                per_arg.append(("sharded", axis, sh.blocks))
            else:
                per_arg.append(("replicated", None, a))
        copies: Dict[Tuple[int, torch.device], Any] = {}
        for i, (kind, _, a) in enumerate(per_arg):
            if kind == "replicated" and isinstance(a, torch.Tensor):
                for dev in set(mesh.devices_flat):
                    copies[(i, dev)] = a if a.device == dev else a.to(dev)

        def body(rank: int, dev: torch.device):
            coords = mesh.coords(rank)
            vals = []
            for i, (kind, axis, a) in enumerate(per_arg):
                if kind == "sharded":
                    vals.append(a[coords[axis]])
                elif isinstance(a, torch.Tensor):
                    vals.append(copies[(i, dev)])
                else:
                    vals.append(a)
            return self.fn(*vals)

        results = _run_on_ranks(mesh, body, count)
        return self._assemble(results)

    def _assemble(self, results):
        mesh = self.mesh
        first = results[0]
        single = not isinstance(first, tuple)
        outs = [(r,) if single else tuple(r) for r in results]
        specs = _normalize_specs(self.out_specs, len(outs[0]))
        assembled = []
        for j, spec in enumerate(specs):
            axis = _spec_axis(spec)
            if axis is None:
                assembled.append(outs[0][j])
            else:
                ranks = mesh.axis_ranks(0, axis)
                assembled.append(Sharded([outs[r][j] for r in ranks],
                                         mesh, axis))
        return assembled[0] if single else tuple(assembled)

    def _run_process(self, args, specs, count: bool):
        """A process mesh: this process's rank, on the calling thread."""
        mesh = self.mesh
        rank = mesh.process_rank
        dev = mesh.devices_flat[rank]
        coords = mesh.coords(rank)
        vals = []
        for a, spec in zip(args, specs):
            axis = _spec_axis(spec)
            if axis is None:
                vals.append(a.to(dev) if isinstance(a, torch.Tensor) else a)
            elif isinstance(a, Sharded):
                vals.append(a.blocks[coords[axis]])
            else:
                t = torch.as_tensor(a)
                n = mesh.shape[axis]
                expects(t.shape[0] % n == 0,
                        "shard: %d rows not divisible by %d ranks",
                        t.shape[0], n)
                rows = t.shape[0] // n
                p = coords[axis]
                vals.append(t[p * rows:(p + 1) * rows].to(dev))
        ctx = _RankContext(mesh, rank, dev, None, count, process=True)
        _tls.ctx = ctx
        try:
            return self.fn(*vals)
        finally:
            _tls.ctx = None


def shard_map(fn, mesh: Mesh, in_specs, out_specs):
    """``fn`` run once per rank of ``mesh``. ``in_specs``/``out_specs``
    (one :class:`PartitionSpec` per argument / result): ``P()``
    replicated (a result: rank 0's, which every rank computed alike),
    ``P(axis)`` row blocks over ``axis`` (an argument: a
    :class:`Sharded` or a tensor split evenly; a result: a
    :class:`Sharded` of each position's value along the axis)."""
    return _ShardMapped(fn, mesh, in_specs, out_specs)


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """:func:`shard_map` under the JAX package's name for its
    cross-version shim."""
    return shard_map(f, mesh, in_specs, out_specs)
