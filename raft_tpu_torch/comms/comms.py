"""The communicator (counterpart of ``raft_tpu.comms.comms``).

A :class:`Comms` is a value object bound to a mesh axis (and, after
:meth:`Comms.comm_split`, to subgroups of it), as in the JAX package.
Its collectives are valid only inside a ``parallel.mesh.shard_map``
body, where the calling thread knows its rank:

* on an in-process mesh (logical ranks, one worker thread each) the
  ranks meet at the run's rendezvous; every reduction adds the members'
  values **in rank order** on every rank, so two runs give the same
  bits whatever the threads' timing;
* on a process mesh (one rank a process, ``initialize_distributed``)
  ``bcast``, ``allgather``, ``alltoall`` and the ``allreduce``s whose
  result no order can change (integers, MIN, MAX) go through the
  matching ``torch.distributed`` calls (NCCL on the card, gloo on the
  CPU); the other collectives, float sums and products among them,
  gather the members' values through it and finish locally, in rank
  order, so they give the in-process mesh's bits. Every
  ``torch.distributed`` call waits at most ``abort_timeout_s``.

Every collective waits at most ``abort_timeout_s``: a member that never
arrives raises ``CollectiveTimeout``, a member that failed makes its
peers raise ``CollectiveAborted`` (``parallel.mesh``), never a hang.
:meth:`Comms.dispatch_checked` maps those to ``Status.ABORT`` and any
other error to ``Status.ERROR``.

The ``raft.comms.collective.{calls,bytes}`` counters keep the JAX
package's meaning: counted once per compiled program there (at trace
time), once per ``shard_map`` callable and input signature here — the
cached plans of ``parallel.ivf`` count on their first run only.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.parallel import mesh as mesh_mod
from raft_tpu_torch.parallel.mesh import (CollectiveError,
                                          CollectiveTimeout)

__all__ = ["Comms", "ReduceOp", "Status", "build_comms", "inject_comms"]


def _count_collective(op: str, x) -> None:
    """Call count and payload bytes of one collective, on the counting
    rank of a run (see the module note)."""
    ctx = mesh_mod.current_rank_context()
    if ctx is None or not ctx.count:
        return
    obs.counter("raft.comms.collective.calls", op=op).inc()
    if isinstance(x, torch.Tensor):
        obs.counter("raft.comms.collective.bytes", op=op).inc(
            float(x.numel() * x.element_size()))


class Status(enum.IntEnum):
    """reference core/comms.hpp:33 status_t."""

    SUCCESS = 0
    ERROR = 1
    ABORT = 2


class ReduceOp(enum.IntEnum):
    """reference core/comms.hpp:28 op_t."""

    SUM = 0
    PROD = 1
    MIN = 2
    MAX = 3


def _reduce_list(vals: List[torch.Tensor], op: ReduceOp) -> torch.Tensor:
    """Fold ``vals`` in list (rank) order."""
    acc = vals[0].clone()
    for v in vals[1:]:
        if op == ReduceOp.SUM:
            acc = acc + v
        elif op == ReduceOp.PROD:
            acc = acc * v
        elif op == ReduceOp.MIN:
            acc = torch.minimum(acc, v)
        elif op == ReduceOp.MAX:
            acc = torch.maximum(acc, v)
        else:
            raise ValueError(f"unsupported op {op}")
    return acc


# torch.distributed subgroups, keyed by the split's groups (global ranks)
_DIST_GROUPS: Dict[tuple, Dict[tuple, object]] = {}


def _dist_wait(work, timeout_s: float, op: str) -> None:
    """Wait for an async ``torch.distributed`` call, at most
    ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not work.is_completed():
        if time.monotonic() >= deadline:
            raise CollectiveTimeout(
                f"torch.distributed {op} did not complete within "
                f"{timeout_s:g} s")
        time.sleep(0.0005)
    work.wait()


@dataclass(frozen=True)
class Comms:
    """Communicator bound to a mesh axis (or axes).

    ``n_ranks``/``axis_name`` describe the collective group;
    ``axis_index_groups`` (optional) restricts collectives to subgroups —
    the product of :meth:`comm_split`.
    """

    axis_name: str = "data"
    n_ranks: int = 1
    axis_index_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    # how long a collective (and sync_stream) waits before ABORT
    abort_timeout_s: float = 60.0

    # -- topology ----------------------------------------------------------
    def get_size(self) -> int:
        if self.axis_index_groups is not None:
            return len(self.axis_index_groups[0])
        return self.n_ranks

    def _ctx(self):
        ctx = mesh_mod.current_rank_context()
        if ctx is None:
            raise LogicError("Comms: collectives are valid only inside a "
                             "shard_map body")
        return ctx

    def _axis_pos(self, ctx) -> int:
        return ctx.mesh.coords(ctx.rank)[self.axis_name]

    def _group(self, ctx) -> Tuple[Tuple[int, ...], int]:
        """(the flat ranks of this rank's group in group order, this
        rank's position in it)."""
        axis = ctx.mesh.axis_ranks(ctx.rank, self.axis_name)
        pos = axis.index(ctx.rank)
        if self.axis_index_groups is None:
            return axis, pos
        for grp in self.axis_index_groups:
            if pos in grp:
                return tuple(axis[g] for g in grp), grp.index(pos)
        raise LogicError(f"Comms: axis position {pos} is in no subgroup")

    def get_rank(self) -> int:
        """This rank's index along the comm axis (inside a body); with
        subgroups, its position within its subgroup."""
        return self._group(self._ctx())[1]

    # -- split (core/comms.hpp comm_split; std_comms.hpp:124) --------------
    def comm_split(self, colors: Sequence[int],
                   keys: Optional[Sequence[int]] = None) -> "Comms":
        """Split into sub-communicators by color; rank order within each
        subgroup follows ``keys`` (default: existing rank order). Colors
        are host-known per global rank."""
        n = self.n_ranks
        expects(len(colors) == n, "comm_split: need one color per rank")
        if keys is None:
            keys = list(range(n))
        groups: Dict[int, List[int]] = {}
        for r in range(n):
            groups.setdefault(colors[r], []).append(r)
        ordered = []
        sizes = set()
        for color in sorted(groups):
            members = sorted(groups[color], key=lambda r: (keys[r], r))
            ordered.append(tuple(members))
            sizes.add(len(members))
        expects(len(sizes) == 1,
                "comm_split: subgroups must have equal sizes (got sizes %s)",
                sizes)
        return replace(self, axis_index_groups=tuple(ordered))

    # -- the exchange every collective rests on ----------------------------
    def _exchange(self, x) -> Tuple[list, int]:
        """Every group member's ``x`` in group order, and this rank's
        position."""
        ctx = self._ctx()
        group, pos = self._group(ctx)
        if ctx.process:
            return self._dist_allgather_list(ctx, group, x), pos
        ctx.seq += 1
        vals = ctx.rdv.exchange((ctx.seq, group), group, ctx.rank,
                                mesh_mod.publish(x), self.abort_timeout_s)
        return [v[0] if i == pos else mesh_mod.receive(v, ctx.device)
                for i, v in enumerate(vals)], pos

    # -- torch.distributed (process mesh) ----------------------------------
    def _dist_group(self, ctx, group: Tuple[int, ...]):
        import torch.distributed as dist
        if len(group) == ctx.mesh.size:
            return None
        # every subgroup of this comm's layout, created in one order on
        # every process (new_group is collective over the world)
        key = (ctx.mesh.size, self.axis_name, self.axis_index_groups,
               tuple(ctx.mesh.shape.items()))
        table = _DIST_GROUPS.get(key)
        if table is None:
            table = {}
            seen = set()
            for r in range(ctx.mesh.size):
                axis = ctx.mesh.axis_ranks(r, self.axis_name)
                grps = ([axis] if self.axis_index_groups is None else
                        [tuple(axis[g] for g in grp)
                         for grp in self.axis_index_groups])
                for g in grps:
                    if g not in seen:
                        seen.add(g)
                        table[g] = dist.new_group(list(g))
            _DIST_GROUPS[key] = table
        return table[group]

    def _dist_allgather_list(self, ctx, group, x) -> list:
        import torch.distributed as dist
        t = torch.as_tensor(x).to(ctx.device).contiguous()
        outs = [torch.empty_like(t) for _ in group]
        work = dist.all_gather(outs, t, group=self._dist_group(ctx, group),
                               async_op=True)
        _dist_wait(work, self.abort_timeout_s, "all_gather")
        return outs

    def _dist_native(self, kind: str, x, **kw):
        """``allreduce``/``bcast``/``allgather``/``alltoall`` through
        the matching ``torch.distributed`` call, or None off a process
        mesh and for a float SUM or PROD (the library adds in its own
        order: those fold in rank order after an allgather)."""
        ctx = self._ctx()
        if not ctx.process:
            return None
        t = torch.as_tensor(x)
        if (kind == "allreduce" and t.is_floating_point()
                and kw["op"] in (ReduceOp.SUM, ReduceOp.PROD)):
            return None
        import torch.distributed as dist
        group, pos = self._group(ctx)
        g = self._dist_group(ctx, group)
        t = t.to(ctx.device).contiguous()
        if kind == "allreduce":
            red = {ReduceOp.SUM: dist.ReduceOp.SUM,
                   ReduceOp.PROD: dist.ReduceOp.PRODUCT,
                   ReduceOp.MIN: dist.ReduceOp.MIN,
                   ReduceOp.MAX: dist.ReduceOp.MAX}[kw["op"]]
            out = t.clone()
            work = dist.all_reduce(out, op=red, group=g, async_op=True)
        elif kind == "bcast":
            out = t.clone()
            work = dist.broadcast(out, src=group[kw["root"]], group=g,
                                  async_op=True)
        elif kind == "allgather":
            outs = [torch.empty_like(t) for _ in group]
            work = dist.all_gather(outs, t, group=g, async_op=True)
            _dist_wait(work, self.abort_timeout_s, kind)
            return torch.stack(outs)
        elif kind == "alltoall":
            out = torch.empty_like(t)
            work = dist.all_to_all_single(out, t, group=g, async_op=True)
        else:
            raise ValueError(kind)
        _dist_wait(work, self.abort_timeout_s, kind)
        return out

    # -- device collectives (valid inside shard_map) -----------------------
    def allreduce(self, x, op: ReduceOp = ReduceOp.SUM):
        _count_collective("allreduce", x)
        out = self._dist_native("allreduce", x, op=ReduceOp(op))
        if out is not None:
            return out
        vals, _ = self._exchange(x)
        return _reduce_list(vals, ReduceOp(op))

    def bcast(self, x, root: int = 0):
        """Every rank receives root's value (root is the in-group rank)."""
        _count_collective("bcast", x)
        out = self._dist_native("bcast", x, root=root)
        if out is not None:
            return out
        vals, pos = self._exchange(x)
        return vals[root] if pos == root else vals[root].clone()

    def reduce(self, x, root: int = 0, op: ReduceOp = ReduceOp.SUM):
        """Reduction valid on ``root``; other ranks receive zeros."""
        red = self.allreduce(x, op)
        return red if self.get_rank() == root else torch.zeros_like(red)

    def allgather(self, x):
        """(group size, ...) stack of every member's ``x``."""
        _count_collective("allgather", x)
        out = self._dist_native("allgather", x)
        if out is not None:
            return out
        vals, _ = self._exchange(x)
        return torch.stack(vals)

    def allgatherv(self, x, counts: Sequence[int]):
        """Variable-size allgather: ranks pad to max(counts) then gather;
        rows past ``counts[r]`` in shard r's slice are padding."""
        max_c = max(counts)
        pad = max_c - x.shape[0]
        expects(pad >= 0, "allgatherv: local rows %d exceed max(counts) %d",
                x.shape[0], max_c)
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                          dtype=x.dtype, device=x.device)])
        return self.allgather(x)

    def gather(self, x, root: int = 0):
        g = self.allgather(x)
        return g if self.get_rank() == root else torch.zeros_like(g)

    def gatherv(self, x, counts: Sequence[int], root: int = 0):
        g = self.allgatherv(x, counts)
        return g if self.get_rank() == root else torch.zeros_like(g)

    def reducescatter(self, x, op: ReduceOp = ReduceOp.SUM):
        """Input length divisible by the group size; rank r receives the
        r-th chunk of the elementwise sum (added in rank order)."""
        expects(op == ReduceOp.SUM, "reducescatter: SUM only")
        _count_collective("reducescatter", x)
        n = self.get_size()
        expects(x.shape[0] % n == 0,
                "reducescatter: leading dim %d not divisible by %d ranks",
                x.shape[0], n)
        c = x.shape[0] // n
        vals, pos = self._exchange(x)
        return _reduce_list([v[pos * c:(pos + 1) * c] for v in vals],
                            ReduceOp.SUM)

    # -- p2p ----------------------------------------------------------------
    def ring_permute(self, x, shift: int = 1):
        """Rank p receives rank (p - shift)'s value, around the ring
        (within each subgroup for a split comm)."""
        _count_collective("ring_permute", x)
        vals, pos = self._exchange(x)
        n = len(vals)
        return vals[(pos - shift) % n]

    def device_send_recv(self, x, perm: Sequence[Tuple[int, int]]):
        """Explicit (src, dst) permutation of axis positions; a rank no
        pair sends to receives zeros."""
        _count_collective("device_send_recv", x)
        ctx = self._ctx()
        axis_vals, _ = replace(self, axis_index_groups=None)._exchange(x)
        me = self._axis_pos(ctx)
        srcs = [s for s, d in perm if d == me]
        return (axis_vals[srcs[0]] if srcs else torch.zeros_like(x))

    def group_start(self) -> None:
        """A no-op: each collective here completes in its call, so
        there is nothing to batch; kept so reference-shaped code ports
        without edits."""

    def group_end(self) -> None:
        """A no-op — see :meth:`group_start`."""

    def multicast_sendrecv(self, x, dests_table: Sequence[Sequence[int]]):
        """Grouped multi-destination p2p: round ``r`` sends each rank's
        ``x`` to ``dests_table[rank][r]`` (collision-free rounds) →
        (rounds, ...) stack of what this rank received."""
        n = self.n_ranks
        expects(len(dests_table) == n,
                "multicast_sendrecv: need one dest list per rank")
        rounds = len(dests_table[0])
        expects(rounds > 0, "multicast_sendrecv: empty dest lists")
        _count_collective("multicast_sendrecv", x)
        expects(all(len(d) == rounds for d in dests_table),
                "multicast_sendrecv: ragged dest lists (pad with self)")
        for r in range(rounds):
            dsts = [dests_table[i][r] for i in range(n)]
            expects(len(set(dsts)) == n,
                    "multicast_sendrecv: round %d has colliding "
                    "destinations — interleave the rounds", r)
        outs = []
        for r in range(rounds):
            outs.append(self.device_send_recv(
                x, [(i, dests_table[i][r]) for i in range(n)]))
        return torch.stack(outs)

    def alltoall(self, x):
        """All-to-all over the leading axis: rank p receives chunk p of
        every member, concatenated in member order."""
        n = self.get_size()
        expects(x.shape[0] % n == 0,
                "alltoall: leading dim %d not divisible by %d ranks",
                x.shape[0], n)
        _count_collective("alltoall", x)
        out = self._dist_native("alltoall", x)
        if out is not None:
            return out
        c = x.shape[0] // n
        vals, pos = self._exchange(x)
        return torch.cat([v[pos * c:(pos + 1) * c] for v in vals])

    def allreduce_quantized(self, x, bits: int = 8):
        """Bandwidth-compressed SUM allreduce (EQuARX-style): int8 blocks
        with f32 per-block max-abs scales on both wire stages — stage 1
        an all-to-all of each rank's copy of every block, a local
        dequantize-sum; stage 2 the partial requantized and allgathered.
        Relative error ~n_ranks/2^(bits-1) worst case."""
        expects(bits == 8, "allreduce_quantized: int8 wire format only")
        _count_collective("allreduce_quantized", x)
        n = self.get_size()
        shape = x.shape
        flat = x.float().reshape(-1)
        expects(flat.shape[0] % n == 0,
                "allreduce_quantized: %d elements not divisible by %d "
                "ranks", flat.shape[0], n)
        blocks = flat.reshape(n, -1)

        def quant(v):
            s = v.abs().max(dim=-1, keepdim=True).values / 127.0
            s = torch.where(s == 0.0, torch.ones_like(s), s)
            q = torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)
            return q, s[..., 0]

        q1, s1 = quant(blocks)                            # (n, blk), (n,)
        # row r of qx: rank r's quantized copy of this rank's block
        qv, pos = self._exchange(q1)
        sv, _ = self._exchange(s1)
        qx = torch.stack([v[pos] for v in qv])            # (n, blk)
        sx = torch.stack([v[pos] for v in sv])            # (n,)
        part = (qx.float() * sx[:, None]).sum(dim=0)
        q2, s2 = quant(part[None, :])
        g = self.allgather(q2[0])
        sg = self.allgather(s2)
        out = (g.float() * sg.reshape(-1, 1)).reshape(-1)
        return out.reshape(shape).to(x.dtype)

    def barrier_value(self):
        """Device-side barrier: an allreduce of a scalar every rank must
        reach."""
        ctx = self._ctx()
        return self.allreduce(torch.ones((), dtype=torch.int32,
                                         device=ctx.device))

    # -- host-side sync with failure semantics -----------------------------
    def dispatch_checked(self, fn, *args, monitor=None,
                         timeout_s: Optional[float] = None):
        """Run a collective computation with failure semantics →
        ``(status, result_or_None)``: a collective that timed out or was
        abandoned → ``ABORT``; any other error → ``ERROR`` (its
        traceback logged); a result that does not complete within the
        timeout → ``ABORT`` (:meth:`sync_stream`). ``monitor`` refreshes
        ``last_suspects``."""
        try:
            out = fn(*args)
        except CollectiveError:
            if monitor is not None:
                monitor.suspect_ranks()
            return Status.ABORT, None
        except Exception:
            import traceback
            from raft_tpu_torch.core.logger import logger
            logger.error("dispatch_checked: dispatch raised\n%s",
                         traceback.format_exc())
            if monitor is not None:
                monitor.suspect_ranks()
            return Status.ERROR, None
        return (self.sync_stream(out, timeout_s=timeout_s,
                                 monitor=monitor), out)

    def sync_stream(self, *arrays, timeout_s: Optional[float] = None,
                    monitor=None) -> Status:
        """Wait until the given results are complete; ABORT on timeout.
        CUDA tensors are waited for by an event on their device's
        current stream, anything with ``is_ready()`` is polled; readiness
        is checked before the deadline, so finished work never reports a
        false ABORT. ``monitor`` aborts early when a peer's heartbeat
        goes stale and names the suspects."""
        from raft_tpu_torch.obs import spans
        t0 = time.monotonic()
        with spans.span("raft.comms.sync_stream") as sp:
            status = self._sync_stream(*arrays, timeout_s=timeout_s,
                                       monitor=monitor)
            sp.set_attr("status", status.name.lower())
        obs.counter("raft.comms.sync_stream.status",
                    status=status.name.lower()).inc()
        obs.histogram("raft.comms.sync_stream.seconds").observe(
            time.monotonic() - t0)
        return status

    def _sync_stream(self, *arrays, timeout_s: Optional[float] = None,
                     monitor=None) -> Status:
        timeout_s = timeout_s if timeout_s is not None else self.abort_timeout_s
        pollers = []
        for leaf in _leaves(arrays):
            if hasattr(leaf, "is_ready"):
                pollers.append(leaf.is_ready)
            elif isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(leaf.device))
                pollers.append(ev.query)
        deadline = time.monotonic() + timeout_s
        next_health = time.monotonic()
        while True:
            try:
                if all(p() for p in pollers):
                    return Status.SUCCESS
            except Exception as e:
                from raft_tpu_torch.core.logger import logger
                logger.error("sync_stream: result poll raised %r", e)
                if monitor is not None:
                    monitor.suspect_ranks()
                return Status.ERROR
            now = time.monotonic()
            if monitor is not None and now >= next_health:
                next_health = now + max(monitor.interval_s, 0.05)
                if monitor.suspect_ranks():
                    return Status.ABORT
            if now >= deadline:
                if monitor is not None:
                    monitor.suspect_ranks()
                return Status.ABORT
            time.sleep(0.001)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    elif isinstance(tree, mesh_mod.Sharded):
        yield from tree.blocks
    elif tree is not None:
        yield tree


def build_comms(mesh, axis_name: str = "data",
                abort_timeout_s: float = 60.0) -> Comms:
    """A communicator over one mesh axis (the role of
    build_comms_nccl_only, reference comms/helper.hpp:42)."""
    expects(axis_name in mesh.axis_names,
            "build_comms: axis %s not in mesh %s", axis_name, mesh.axis_names)
    return Comms(axis_name=axis_name, n_ranks=mesh.shape[axis_name],
                 abort_timeout_s=abort_timeout_s)


def inject_comms(res, comms: Comms) -> None:
    """Attach to a Resources (reference inject_comms_on_handle)."""
    res.set_comms(comms)
