"""The quantized cross-shard merge codec (counterpart of
``raft_tpu.serve.merge``).

The cross-shard top-k merge is the one payload distributed serving moves
per batch: every shard's ``(nq, k)`` (distance, id) candidates. The f32
merge (``parallel.ivf._global_merge``) allgathers both at full
precision. The compressed merge restructures the collective and shrinks
the payload, as the JAX package's does, bit for bit on the CPU:

* **two stages** — stage A ``alltoall``s each query block's candidates
  to one owner rank, which dequantizes and merges its ``nq / n_shards``
  slice; stage B allgathers the merged, re-quantized slices;
* **int8 blockwise affine distances** — per-query scale and zero point,
  the invalid slots (id < 0) outside the range, coded at the top;
* **packed words** — when ids fit 24 bits (``size`` <
  :data:`PACK_ID_SENTINEL`), each (distance, id) pair rides as one
  32-bit word: biased distance byte high, id low. The port carries the
  word in an int32 tensor (the same 32 bits as the JAX package's
  uint32); bigger corpora use the split layout (int8 + int32).

The owner's merge selects with kernel 2's payload select on the card
(ties to the lower column, as ``lax.top_k``); these passes are torch
elementwise ops (the JAX package has no Pallas kernel here).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

__all__ = [
    "PACK_ID_SENTINEL",
    "compressed_merge",
    "dequantize_rows",
    "merge_mode",
    "merge_wire_bytes",
    "pack_pairs",
    "quantize_rows",
    "unpack_pairs",
]

_QMAX = 127.0
# 24-bit id space; the all-ones pattern is the invalid-slot sentinel
PACK_ID_SENTINEL = (1 << 24) - 1


def merge_mode(default: str = "int8") -> str:
    """The cross-shard merge wire format from ``RAFT_TPU_DIST_MERGE``
    (``f32`` | ``int8``), else ``default``: the serving tier compresses
    by default, the library searches merge exactly."""
    v = os.environ.get("RAFT_TPU_DIST_MERGE", "").strip().lower()
    if v in ("f32", "int8"):
        return v
    return default


def quantize_rows(d, i) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise affine int8 quantization, one block per query row:
    ``(nq, k) f32 -> (nq, k) int8 + (nq,) f32 scale + (nq,) f32 zero``.
    The range is ``[row_min, row_max]`` of the valid slots; invalid
    slots (``i < 0``) code to the top and come back as +inf."""
    d = torch.as_tensor(d, dtype=torch.float32)
    i = torch.as_tensor(i)
    valid = i >= 0
    inf = torch.full_like(d, float("inf"))
    hi = torch.where(valid, d, -inf).max(dim=1).values
    lo = torch.where(valid, d, inf).min(dim=1).values
    zero_f = torch.zeros_like(hi)
    hi = torch.where(torch.isfinite(hi), hi, zero_f)
    lo = torch.where(torch.isfinite(lo), lo, zero_f)
    scale = torch.where(hi > lo, (hi - lo) / (2.0 * _QMAX),
                        torch.ones_like(hi))
    zero = lo
    q = torch.clamp(torch.round((d - zero[:, None]) / scale[:, None]) - _QMAX,
                    -_QMAX, _QMAX)
    q = torch.where(valid, q, torch.full_like(q, _QMAX)).to(torch.int8)
    return q, scale, zero


def dequantize_rows(q, scale, zero, i):
    """Inverse of :func:`quantize_rows` (``scale``/``zero`` broadcastable
    to ``q``): codes back to f32 distances, invalid ids back to +inf."""
    q = torch.as_tensor(q)
    d = (q.float() + _QMAX) * torch.as_tensor(scale) + torch.as_tensor(zero)
    return torch.where(torch.as_tensor(i) >= 0, d,
                       torch.full_like(d, float("inf")))


def pack_pairs(q, i):
    """One 32-bit word per candidate (int32 carrying the bits): biased
    distance byte high, 24-bit id low; invalid ids (< 0) carry
    :data:`PACK_ID_SENTINEL`."""
    q = torch.as_tensor(q)
    i = torch.as_tensor(i)
    b = q.to(torch.int64) + 128
    idw = torch.where(i >= 0, i.to(torch.int64),
                      torch.full_like(i, PACK_ID_SENTINEL, dtype=torch.int64))
    w = (b << 24) | (idw & PACK_ID_SENTINEL)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def unpack_pairs(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_pairs`, bit-exact: the distance byte and
    the id round-trip unchanged, the sentinel maps back to -1."""
    w = torch.as_tensor(w).to(torch.int64) & 0xFFFFFFFF
    q = ((w >> 24) - 128).to(torch.int8)
    idw = w & PACK_ID_SENTINEL
    return q, torch.where(idw == PACK_ID_SENTINEL, -1, idw).to(torch.int32)


def merge_wire_bytes(nq: int, k: int, n_shards: int, mode: str,
                     size: int = 0) -> Tuple[int, int]:
    """Analytic per-rank received bytes of one cross-shard merge →
    ``(f32_bytes, mode_bytes)``: the ``raft.serve.dist.merge.bytes_*``
    counters' accounting."""
    if n_shards <= 1:
        return 0, 0
    f32 = (n_shards - 1) * nq * k * 8          # allgather of f32 d + i32 i
    if mode == "f32":
        return f32, f32
    blk = -(-nq // n_shards)
    pair = 4 if 0 < size < PACK_ID_SENTINEL else 5   # packed | split
    # + 8 B/row: the f32 (scale, zero) affine metadata
    per_stage = (n_shards - 1) * blk * (k * pair + 8)
    return f32, 2 * per_stage


def _select(cat_d, cat_i, k: int):
    """The k smallest per row by (value, column): kernel 2's payload
    select (its plain version on the CPU), a stable sort above k = 256."""
    from raft_tpu_torch.ops.select_k import select_k_payload_any
    return select_k_payload_any(cat_d.contiguous(), cat_i.contiguous(), k)


def compressed_merge(comms, d, i, k: int, size: int):
    """The int8 two-stage cross-shard top-k merge, inside a
    ``shard_map`` body; every rank returns the same full ``(nq, k)``
    result. Scales are per row and each query's candidates are the
    shards' top-k of that row, so a query's result does not depend on
    the batch it rode in."""
    n = comms.get_size()
    nq = d.shape[0]
    blk = -(-nq // n)
    pad = blk * n - nq
    if pad:
        d = torch.cat([d, torch.full((pad, k), float("inf"),
                                     device=d.device)])
        i = torch.cat([i, torch.full((pad, k), -1, dtype=i.dtype,
                                     device=i.device)])
    packed = 0 < size < PACK_ID_SENTINEL

    # stage A: each query block's candidates to its owner rank
    qz, s, z = quantize_rows(d, i)
    if packed:
        rw = comms.alltoall(pack_pairs(qz, i)).reshape(n, blk, k)
        rq, ri = unpack_pairs(rw)
    else:
        rq = comms.alltoall(qz).reshape(n, blk, k)
        ri = comms.alltoall(i.to(torch.int32)).reshape(n, blk, k)
    meta = comms.alltoall(torch.stack([s, z], dim=1)).reshape(n, blk, 2)
    rd = dequantize_rows(rq, meta[..., 0:1], meta[..., 1:2], ri)

    # the owner's merge of its slice: n * k candidates a query
    cat_d = rd.permute(1, 0, 2).reshape(blk, n * k)
    cat_i = ri.permute(1, 0, 2).reshape(blk, n * k)
    md, mi = _select(cat_d, cat_i, k)

    # stage B: re-quantize the merged slice, allgather, dequantize
    qz2, s2, z2 = quantize_rows(md, mi)
    if packed:
        gq, gi = unpack_pairs(comms.allgather(pack_pairs(qz2, mi)))
    else:
        gq = comms.allgather(qz2)
        gi = comms.allgather(mi)
    gm = comms.allgather(torch.stack([s2, z2], dim=1))   # (n, blk, 2)
    fd = dequantize_rows(gq, gm[..., 0:1], gm[..., 1:2],
                         gi).reshape(n * blk, k)[:nq]
    fi = gi.reshape(n * blk, k)[:nq]
    return fd, fi
