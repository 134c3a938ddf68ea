"""[The benchmark's frozen copy of ethproof_tpu_torch/tables/common.py.]

Shared helpers for zkEVM tables: limb words, column allocation.

Counterpart: ethproof_tpu/tables/common.py:1 (a copy).
"""

from __future__ import annotations

from typing import List

N_LIMBS = 16  # 256-bit word = 16 x 16-bit limbs, little-endian
LIMB_BITS = 16
LIMB_BASE = 1 << LIMB_BITS


def int_to_limbs(v: int, n: int = N_LIMBS) -> List[int]:
    assert 0 <= v < 1 << (LIMB_BITS * n)
    return [(v >> (LIMB_BITS * i)) & (LIMB_BASE - 1) for i in range(n)]


def limbs_to_int(limbs) -> int:
    out = 0
    for i, l in enumerate(limbs):
        out |= int(l) << (LIMB_BITS * i)
    return out


class Cols:
    """Sequential column-index allocator; makes wide layouts readable."""

    def __init__(self):
        self._next = 0

    def one(self) -> int:
        i = self._next
        self._next += 1
        return i

    def many(self, k: int) -> List[int]:
        out = list(range(self._next, self._next + k))
        self._next += k
        return out

    @property
    def count(self) -> int:
        return self._next
