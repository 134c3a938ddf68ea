"""[The benchmark's frozen copy of ethproof_tpu_torch/hash/keccak.py, without
`keccak256`.]

Keccak-f[1600] and Ethereum keccak256 (host, numpy uint64).

Counterpart: ethproof_tpu/hash/keccak.py:1 (`keccak_f`, `keccak_f_trace`,
`keccak256`). The counterpart's numpy rounds on a 5 x 5 array become the
same rounds on python-int lanes, about four times faster on the host; the
JAX package's optional C extension is not carried over.

Host-side by design: witness generation and MPT hashing are sequential
pointer-chasing; the Keccak table proves the permutation, it does not
execute it. `keccak_f_trace` returns all 25 round states for that table's
trace generator.
"""

from __future__ import annotations

from typing import List

import numpy as np

U64 = np.uint64

ROUND_CONSTANTS = np.array(
    [
        0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
        0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
        0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
        0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
        0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
        0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
        0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
        0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
    ],
    dtype=U64,
)

# rotation offsets r[x][y]
ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


_M64 = (1 << 64) - 1
_RC_INTS = [int(v) for v in ROUND_CONSTANTS]
# rho + pi on lanes indexed x + 5y: (source, target, rotation)
_RHO_PI = [(x + 5 * y, y + 5 * ((2 * x + 3 * y) % 5), ROTATIONS[x][y])
           for x in range(5) for y in range(5)]
# chi on lanes indexed x + 5y: (lane, lane x+1, lane x+2) in the same row y
_CHI = [(i, i - i % 5 + (i + 1) % 5, i - i % 5 + (i + 2) % 5) for i in range(25)]


def _rounds(a: List[int]):
    """Yield the state after each of the 24 rounds, as python-int lanes
    indexed x + 5y (theta, rho + pi, chi, iota; no numpy per-call cost)."""
    for rc in _RC_INTS:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63)) & _M64)
             for x in range(5)]
        b = [0] * 25
        for src, dst, r in _RHO_PI:
            v = a[src] ^ d[src % 5]
            b[dst] = ((v << r) | (v >> (64 - r))) & _M64 if r else v
        a = [b[i] ^ (~b[j] & b[k]) for i, j, k in _CHI]
        a[0] ^= rc
        yield a


def _lanes(state: np.ndarray) -> List[int]:
    """(5, 5) uint64 state[x, y] -> python-int lanes indexed x + 5y."""
    return [int(v) for v in state.T.ravel()]


def _state(lanes: List[int]) -> np.ndarray:
    return np.asarray(lanes, dtype=U64).reshape(5, 5).T.copy()


def keccak_f(state: np.ndarray) -> np.ndarray:
    """Full 24-round permutation on a (5, 5) uint64 state (state[x, y])."""
    *_, out = _rounds(_lanes(state))
    return _state(out)


def keccak_f_trace(state: np.ndarray) -> List[np.ndarray]:
    """All 25 states (input + after each round) — for STARK trace gen."""
    return [state.copy()] + [_state(a) for a in _rounds(_lanes(state))]
