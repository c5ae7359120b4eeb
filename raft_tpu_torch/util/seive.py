"""Sieve of Eratosthenes (counterpart of ``raft_tpu.util.seive``; the
original's ``util/seive.hpp`` ``class Seive``, a host-side helper there
too; numpy suffices)."""

from __future__ import annotations

import numpy as np


class Seive:
    """Primality for integers in [0, num]: ``Seive(100).is_prime(97)``.
    (Reference spelling preserved.)"""

    def __init__(self, num: int):
        self._n = int(num)
        sieve = np.ones(self._n + 1, dtype=bool)
        sieve[:2] = False
        for p in range(2, int(self._n ** 0.5) + 1):
            if sieve[p]:
                sieve[p * p:: p] = False
        self._sieve = sieve

    def is_prime(self, num: int) -> bool:
        if num < 0 or num > self._n:
            raise ValueError(f"Seive: {num} outside [0, {self._n}]")
        return bool(self._sieve[num])
