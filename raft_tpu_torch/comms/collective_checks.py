"""In-library collective tests (counterpart of
``raft_tpu.comms.collective_checks``; reference ``comms/comms_test.hpp``).

Each function runs a ``shard_map`` over the given mesh, checks the
collective's result on every rank, and returns ``True`` only when every
rank agreed — a smoke test a deployment runs on its real mesh (eight
logical ranks on one card, one rank a card, or the CPU).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.comms import build_comms
from raft_tpu_torch.parallel.mesh import P, shard_map

__all__ = ["test_collective_allgather", "test_collective_allreduce",
           "test_collective_broadcast", "test_collective_gather",
           "test_collective_reduce", "test_collective_reducescatter",
           "test_commsplit", "test_pointToPoint_simple_send_recv"]


def _dev():
    from raft_tpu_torch.parallel.mesh import current_rank_context
    return current_rank_context().device


def _all_ranks(mesh, comms, ok_fn) -> bool:
    """Every rank's ``ok_fn()`` (a bool tensor), allreduced: True when
    all ``n`` ranks of the comm agree."""
    n = comms.get_size()

    def body():
        ok = ok_fn()
        return comms.allreduce(ok.to(torch.int32).reshape(1))

    out = shard_map(body, mesh, (), P(comms.axis_name))()
    return bool(torch.all(out.gather("cpu") == n))


def test_collective_allreduce(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()
    return _all_ranks(mesh, comms, lambda: comms.allreduce(
        torch.ones((), device=_dev())) == n)


def test_collective_broadcast(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)

    def ok():
        r = comms.get_rank()
        val = torch.tensor(42.0 if r == 0 else 0.0, device=_dev())
        return comms.bcast(val, root=0) == 42.0

    return _all_ranks(mesh, comms, ok)


def test_collective_reduce(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()

    def ok():
        red = comms.reduce(torch.ones((), device=_dev()), root=0)
        return (red == n) if comms.get_rank() == 0 else (red == 0.0)

    return _all_ranks(mesh, comms, ok)


def test_collective_allgather(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()

    def ok():
        g = comms.allgather(torch.tensor(float(comms.get_rank()),
                                         device=_dev()))
        return torch.all(g == torch.arange(n, dtype=torch.float32,
                                           device=_dev()))

    return _all_ranks(mesh, comms, ok)


def test_collective_gather(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()

    def ok():
        g = comms.gather(torch.tensor(float(comms.get_rank()),
                                      device=_dev()), root=0)
        if comms.get_rank() == 0:
            return torch.all(g == torch.arange(n, dtype=torch.float32,
                                               device=_dev()))
        return torch.all(g == 0.0)

    return _all_ranks(mesh, comms, ok)


def test_collective_reducescatter(mesh, axis_name: str = "data") -> bool:
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()
    return _all_ranks(mesh, comms, lambda: torch.all(comms.reducescatter(
        torch.ones((n,), device=_dev())) == n))


def test_pointToPoint_simple_send_recv(mesh, axis_name: str = "data"
                                       ) -> bool:
    """Ring permute check (reference test_pointToPoint_simple_send_recv)."""
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()

    def ok():
        r = comms.get_rank()
        recv = comms.ring_permute(torch.tensor(float(r), device=_dev()), 1)
        return recv == float((r - 1) % n)

    return _all_ranks(mesh, comms, ok)


def test_commsplit(mesh, axis_name: str = "data") -> bool:
    """Split into two halves; allreduce within each subgroup (reference
    test_commsplit)."""
    comms = build_comms(mesh, axis_name)
    n = comms.get_size()
    if n < 2 or n % 2 != 0:
        return True
    sub = comms.comm_split([0 if r < n // 2 else 1 for r in range(n)])
    return _all_ranks(mesh, comms, lambda: torch.all(sub.allreduce(
        torch.ones((1,), device=_dev())) == n // 2))
