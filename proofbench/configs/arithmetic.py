"""The `arithmetic` configuration's plain reference and trace maker.

The table is `arithmetic_table.ArithmeticStark` (a frozen copy of the
program's); its one CTL is the looked side of cpu <-> arithmetic.

Rows: the fixed range column counts min(row, 2^16 - 1), so a table of
2^log_rows rows range-checks every limb cell below min(2^log_rows, 2^16).
At the 2^16 rows of the source's floor that is the full 16-bit bound; at
fewer rows it is the row count, and a row whose range-checked cells do not
all fit is no valid witness. So the maker draws rows into a pool: for each,
an op from the mix, then operands whose every limb is uniform below the
bound, redrawn until the row's range-checked cells fit. An operand's
length in limbs follows the traffic's `operand_limbs` for its op (counted
from a real transaction's requests by `count_traffic.py`; a shift count,
byte index or sign-extension byte below 257, a modulus nonzero); without
them, a 256-bit word of 1 to 16 limbs (shift counts up to 300, byte
indices up to 40). Each trace is 2^log_rows * fill rows drawn from
the pool with replacement in a seeded order, then the logUp multiplicity
column recounted: every trace is distinct and valid.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import arithmetic_table as T

OPS: Dict[str, int] = {
    "ADD": T.OP_ADD, "SUB": T.OP_SUB, "LT": T.OP_LT, "MUL": T.OP_MUL,
    "DIV": T.OP_DIV, "MOD": T.OP_MOD, "SHR": T.OP_SHR, "SHL": T.OP_SHL,
    "BYTE": T.OP_BYTE, "ADDMOD": T.OP_ADDMOD, "MULMOD": T.OP_MULMOD,
    "SLT": T.OP_SLT, "SAR": T.OP_SAR, "SEXT": T.OP_SEXT,
}
_RC = np.asarray(T.RANGE_CHECKED, dtype=np.intp)
_TRIES = 10_000


def reference_stark() -> T.ArithmeticStark:
    return T.ArithmeticStark()


def reference_ctl_specs(stark) -> List:
    """The table's CTL specs in the program's `build_ctls` order."""
    return [stark.ctl_spec]


def _word(rng: np.random.Generator, limbs: int, bound: int) -> int:
    vals = rng.integers(0, bound, size=limbs)
    return sum(int(v) << (16 * i) for i, v in enumerate(vals))


def _length(rng: np.random.Generator, lengths) -> int:
    """A limb count drawn from (counts, probabilities)."""
    return int(rng.choice(lengths[0], p=lengths[1]))


def _request(rng: np.random.Generator, op: int, bound: int, lengths=None):
    """A request of `op`; its operands' limb counts are drawn from `lengths`
    ({"a": ..., "b": ...} as `_length` takes them) where given, else uniform."""
    if lengths is not None:
        la, lb = _length(rng, lengths["a"]), _length(rng, lengths["b"])
        small = op in (T.OP_SHR, T.OP_SHL, T.OP_SAR, T.OP_BYTE, T.OP_SEXT)
        req = (op, _word(rng, la, bound), _word(rng, lb, min(bound, 257) if small else bound))
        if op in (T.OP_ADDMOD, T.OP_MULMOD):
            req += (_word(rng, max(lb, 1), bound) | 1,)
        return req
    la = int(rng.integers(1, T.N_LIMBS + 1))
    a = _word(rng, la, bound)
    if op in (T.OP_SHR, T.OP_SHL, T.OP_SAR):
        return (op, a, int(rng.integers(0, 301)))
    if op in (T.OP_BYTE, T.OP_SEXT):
        return (op, a, int(rng.integers(0, 41)))
    b = _word(rng, int(rng.integers(1, la + 1)), bound)
    if op in (T.OP_ADDMOD, T.OP_MULMOD):
        return (op, a, b, _word(rng, int(rng.integers(1, la + 1)), bound) | 1)
    return (op, a, b)


def _valid_row(rng: np.random.Generator, op: int, bound: int, lengths=None) -> np.ndarray:
    col = np.zeros((T.NUM_COLUMNS, 1), dtype=np.uint64)
    for _ in range(_TRIES):
        col[:] = 0
        T.fill_row(col, 0, _request(rng, op, bound, lengths))
        if int(col[_RC, 0].max()) < bound:
            return col[:, 0].copy()
    raise RuntimeError(f"no row of op {op} fits the range bound {bound} in {_TRIES} draws")


class Maker:
    """Fresh valid traces of 2^log_rows rows from one seeded stream."""

    def __init__(self, rng: np.random.Generator, log_rows: int, fill: float,
                 mix: Optional[Dict[str, float]], pool_rows: int,
                 operand_limbs: Optional[Dict[str, Dict[str, Dict[str, int]]]] = None):
        self.rng = rng
        self.n = 1 << log_rows
        self.bound = min(self.n, T.RANGE_BOUND)
        self.used = int(fill * self.n)
        if not 1 <= self.used <= self.n:
            raise ValueError(f"fill {fill} leaves no row of {self.n} to fill")
        weights = mix or {name: 1.0 for name in OPS}
        names = sorted(weights)
        p = np.asarray([weights[k] for k in names], dtype=np.float64)
        lengths = {op: {side: (np.asarray([int(k) for k in c]),
                               np.asarray(list(c.values()), dtype=np.float64)
                               / sum(c.values())) for side, c in sides.items()}
                   for op, sides in (operand_limbs or {}).items()}
        ops = rng.choice(len(names), size=pool_rows, p=p / p.sum())
        self.pool = np.stack([_valid_row(rng, OPS[names[i]], self.bound, lengths.get(names[i]))
                              for i in ops], axis=1)

    def trace(self) -> np.ndarray:
        tr = np.zeros((T.NUM_COLUMNS, self.n), dtype=np.uint64)
        tr[:, : self.used] = self.pool[:, self.rng.integers(0, self.pool.shape[1], self.used)]
        vals = tr[_RC]
        if int(vals.max()) >= self.bound:
            raise AssertionError("a range-checked cell exceeds the table's bound")
        tr[T.RC_MULT] = np.bincount(vals.ravel().astype(np.int64), minlength=self.n)[: self.n]
        return tr


def maker(rng: np.random.Generator, log_rows: int, fill: float,
          mix: Optional[Dict[str, float]] = None, pool_rows: int = 1024,
          operand_limbs: Optional[Dict[str, Dict[str, Dict[str, int]]]] = None) -> Maker:
    return Maker(rng, log_rows, fill, mix, pool_rows, operand_limbs)
