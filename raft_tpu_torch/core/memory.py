"""Device memory helpers (counterpart of ``raft_tpu.core.memory``; the
original's RMM role, ``util/cudart_utils.hpp:490``).

PyTorch's caching allocator owns the card's memory, so what carries
over is observability: per-device allocation stats in the JAX package's
key names. The JAX package's ``donate`` (jit with buffer donation) has
no counterpart: torch ops run eagerly and write where the caller says,
so :func:`donate` keeps the signature and returns ``fn`` as it is.
"""

from __future__ import annotations

from typing import Dict

import torch

from raft_tpu_torch.core.resources import Resources


def memory_stats(device=None) -> Dict[str, int]:
    """Allocation stats of a device in bytes, under the JAX package's
    keys: ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching
    allocator's allocated bytes, now and at peak) and ``bytes_limit``
    (the card's total memory, ``torch.cuda.mem_get_info``). ``device``
    defaults to ``cuda``; a CPU device has no allocator stats, and its
    answer is an empty dict."""
    dev = Resources(device).device
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
    }


def hbm_stats(device=None) -> Dict[str, int]:
    """Normalised allocator stats of one device, the JAX package's
    sampling contract: ``{"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit", "source"}``, with ``source: "torch_cuda"`` on the card.
    On a CPU device this is ``{}``: that is the CPU's answer, not a
    fallback (the JAX package sums its live arrays there; torch keeps no
    registry of live tensors)."""
    stats = memory_stats(device)
    if not stats:
        return {}
    return {**stats, "source": "torch_cuda"}


def donate(fn, *donate_argnums: int):
    """``fn`` unchanged. The JAX package wraps it in jit with buffer
    donation so that outputs reuse the donated inputs' memory; torch
    runs eagerly, and a caller who wants that reuse writes in place
    (``out=`` or an in-place op) instead."""
    return fn
