"""Set-associative device vector cache (counterpart of
``raft_tpu.util.cache``; the original's ``util/cache.cuh:110`` ``class
Cache``, which caches vectors by integer key in GPU memory for
SVM-style workloads).

Keys hash to a set (``key % n_sets``), LRU within the set's
``associativity`` ways by a logical clock; the caller splits a key batch
into hits and misses, computes the misses and stores them back. The
layout is the JAX package's: ``keys (n_sets, ways)`` int32 (-1 empty),
``time (n_sets, ways)`` int32 last-use clock, ``vecs (n_sets, ways,
n_vec)``, ``clock ()`` int32, all tensors on one device. Operations are
functional as there: :meth:`VecCache.lookup` and :meth:`VecCache.store`
return a new cache and leave the old one as it was. Of two writes to
one way in a batch the later wins, on every device (each slot gathers
from its last writer, so no two writes race).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from raft_tpu_torch.core.resources import Resources


def _set_last(dst: torch.Tensor, flat: torch.Tensor, src: torch.Tensor):
    """A copy of ``dst`` (viewed as ``(n_sets * ways, ...)``) with slot
    ``flat[j]`` set to ``src[j]``, the largest ``j`` winning a slot."""
    n = dst.shape[0] * dst.shape[1]
    pos = torch.arange(flat.shape[0], device=flat.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=flat.device)
    last = last.scatter_reduce(0, flat, pos, reduce="amax")
    out = dst.reshape((n,) + tuple(dst.shape[2:])).clone()
    hit = last >= 0
    out[hit] = src[last[hit]].to(dst.dtype)
    return out.reshape(dst.shape)


@dataclass
class VecCache:
    keys: torch.Tensor     # (n_sets, ways) int32, -1 = empty
    time: torch.Tensor     # (n_sets, ways) int32 last-use clock
    vecs: torch.Tensor     # (n_sets, ways, n_vec)
    clock: torch.Tensor    # () int32

    @property
    def n_sets(self) -> int:
        return self.keys.shape[0]

    @property
    def associativity(self) -> int:
        return self.keys.shape[1]

    @property
    def n_vec(self) -> int:
        return self.vecs.shape[2]

    @classmethod
    def create(cls, n_vec: int, n_sets: int, associativity: int = 32,
               dtype=torch.float32, device="cuda") -> "VecCache":
        """Empty cache holding up to ``n_sets * associativity`` vectors of
        length ``n_vec`` on ``device``."""
        dev = Resources(device).device
        return cls(
            keys=torch.full((n_sets, associativity), -1, dtype=torch.int32,
                            device=dev),
            time=torch.zeros((n_sets, associativity), dtype=torch.int32,
                             device=dev),
            vecs=torch.zeros((n_sets, associativity, n_vec), dtype=dtype,
                             device=dev),
            clock=torch.zeros((), dtype=torch.int32, device=dev))

    def _set_of(self, keys: torch.Tensor) -> torch.Tensor:
        return (keys % self.n_sets).long()

    def lookup(self, query_keys):
        """(vectors (m, n_vec), hit (m,) bool, state') — hits also bump
        their LRU time."""
        q = torch.as_tensor(query_keys, device=self.keys.device)
        s = self._set_of(q)                                 # (m,)
        match = self.keys[s] == q[:, None]                  # (m, ways)
        hit = match.any(dim=1)
        way = match.to(torch.int32).argmax(dim=1)           # first match
        out = self.vecs[s, way]
        out = torch.where(hit[:, None], out, torch.zeros_like(out))
        # bump the time of hits only (a max with 0 changes nothing)
        bump = torch.where(hit, self.clock + 1,
                           torch.zeros_like(self.clock)).to(torch.int32)
        new_time = self.time.flatten().scatter_reduce(
            0, s * self.associativity + way, bump, reduce="amax")
        return out, hit, VecCache(self.keys,
                                  new_time.reshape(self.time.shape),
                                  self.vecs, self.clock + 1)

    def store(self, new_keys, new_vecs):
        """Insert (m, n_vec) vectors under (m,) keys, each into the LRU way
        of its set, chosen against the state before the batch (the
        original's single-pass AssignCacheIdx + StoreVecs). Returns the
        new state. Keys of one batch that meet in one way: the last
        wins."""
        k = torch.as_tensor(new_keys, device=self.keys.device)
        v = torch.as_tensor(new_vecs, device=self.keys.device)
        s = self._set_of(k)
        lru_way = self.time[s].argmin(dim=1)                # first minimum
        flat = s * self.associativity + lru_way
        keys = _set_last(self.keys, flat, k.to(torch.int32))
        time = _set_last(self.time, flat, (self.clock + 1).expand(k.shape))
        vecs = _set_last(self.vecs, flat, v)
        return VecCache(keys, time, vecs, self.clock + 1)
