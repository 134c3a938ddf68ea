"""The `keccak` configuration's plain reference and trace maker.

The table is `keccak_table.KeccakStark` (a frozen copy of the program's):
one keccak-f[1600] round per row, 24 rows a permutation; its CTLs are the
looked sides of sponge -> keccak input and output. A trace holds
floor(2^log_rows * fill / 24) permutations of seeded 1600-bit states, the
rest real zero-state padding blocks, as the table's own generator lays
them out. The mix is not used: every row is a permutation round.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import keccak_table as T


def reference_stark() -> T.KeccakStark:
    return T.KeccakStark()


def reference_ctl_specs(stark) -> List:
    """The table's CTL specs in the program's `build_ctls` order."""
    return [stark.input_ctl_spec(), stark.output_ctl_spec()]


class Maker:
    def __init__(self, rng: np.random.Generator, log_rows: int, fill: float,
                 mix: Optional[Dict[str, float]] = None):
        self.rng = rng
        self.n = 1 << log_rows
        self.perms = int(fill * self.n) // T.NUM_ROUNDS
        if self.perms < 1:
            raise ValueError(f"fill {fill} of {self.n} rows holds no permutation")

    def trace(self) -> np.ndarray:
        states = self.rng.integers(0, 1 << 64, size=(self.perms, 5, 5), dtype=np.uint64)
        return T.generate_trace(list(states), self.n)


def maker(rng: np.random.Generator, log_rows: int, fill: float,
          mix: Optional[Dict[str, float]] = None) -> Maker:
    return Maker(rng, log_rows, fill, mix)
