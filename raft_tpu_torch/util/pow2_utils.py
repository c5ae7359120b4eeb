"""Power-of-two arithmetic helpers (counterpart of
``raft_tpu.util.pow2_utils``; the original's ``util/pow2_utils.cuh:29``
``Pow2<Value>``: roundUp/roundDown/mod/div by masks). Host-side sizing
math for tile and padding calculations; pure Python."""

from __future__ import annotations

from dataclasses import dataclass


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def round_up_pow2(v: int, m: int) -> int:
    """Smallest multiple of power-of-two ``m`` ≥ ``v``."""
    if not is_pow2(m):
        raise ValueError(f"round_up_pow2: {m} is not a power of two")
    return (v + m - 1) & ~(m - 1)


def round_down_pow2(v: int, m: int) -> int:
    if not is_pow2(m):
        raise ValueError(f"round_down_pow2: {m} is not a power of two")
    return v & ~(m - 1)


@dataclass(frozen=True)
class Pow2:
    """The reference's ``Pow2<Value>`` as a small value object:
    ``Pow2(128).round_up(x)``, ``.mod(x)``, ``.div(x)``."""

    value: int

    def __post_init__(self):
        if not is_pow2(self.value):
            raise ValueError(f"Pow2: {self.value} is not a power of two")

    @property
    def mask(self) -> int:
        return self.value - 1

    @property
    def log2(self) -> int:
        return self.value.bit_length() - 1

    def round_up(self, v: int) -> int:
        return round_up_pow2(v, self.value)

    def round_down(self, v: int) -> int:
        return round_down_pow2(v, self.value)

    def mod(self, v: int) -> int:
        return v & self.mask

    def div(self, v: int) -> int:
        return v >> self.log2

    def is_multiple(self, v: int) -> bool:
        return self.mod(v) == 0
