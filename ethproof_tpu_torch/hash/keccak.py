"""Keccak-f[1600] and Ethereum keccak256 (host, numpy uint64).

Counterpart: ethproof_tpu/hash/keccak.py:1 (a copy of its numpy path; the
JAX package's optional C extension is not carried over).

Host-side by design: witness generation and MPT hashing are sequential
pointer-chasing. (`keccak_f_trace`, the round states for the Keccak table's
trace generator, comes with that table.)
"""

from __future__ import annotations

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


def _rotl(v: np.ndarray, n: int) -> np.ndarray:
    n %= 64
    if n == 0:
        return v
    return (v << U64(n)) | (v >> U64(64 - n))


def keccak_round(state: np.ndarray, rc: int) -> np.ndarray:
    """One round on a (5, 5) uint64 state (state[x, y] layout)."""
    a = state
    # theta
    c = np.bitwise_xor.reduce(a, axis=1)
    d = np.empty(5, dtype=U64)
    for x in range(5):
        d[x] = c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1)
    a = a ^ d[:, None]
    # rho + pi
    b = np.zeros((5, 5), dtype=U64)
    for x in range(5):
        for y in range(5):
            b[y, (2 * x + 3 * y) % 5] = _rotl(a[x, y], ROTATIONS[x][y])
    # chi
    out = np.zeros((5, 5), dtype=U64)
    for x in range(5):
        for y in range(5):
            out[x, y] = b[x, y] ^ ((~b[(x + 1) % 5, y]) & b[(x + 2) % 5, y])
    # iota
    out[0, 0] ^= U64(rc)
    return out


def keccak_f(state: np.ndarray) -> np.ndarray:
    """Full 24-round permutation on a (5, 5) uint64 state."""
    s = state.copy()
    for r in range(24):
        s = keccak_round(s, int(ROUND_CONSTANTS[r]))
    return s


def _state_from_bytes(b: bytes) -> np.ndarray:
    """200 bytes -> (5,5) state, lane (x,y) = little-endian u64 at 8*(x+5y)."""
    lanes = np.frombuffer(b, dtype="<u8").copy()
    s = np.zeros((5, 5), dtype=U64)
    for y in range(5):
        for x in range(5):
            s[x, y] = lanes[x + 5 * y]
    return s


def _state_to_bytes(s: np.ndarray) -> bytes:
    lanes = np.zeros(25, dtype="<u8")
    for y in range(5):
        for x in range(5):
            lanes[x + 5 * y] = s[x, y]
    return lanes.tobytes()


def keccak256(data: bytes) -> bytes:
    """Ethereum keccak256: rate 136, pad 0x01 ... 0x80 (pre-NIST padding)."""
    rate = 136
    state = np.zeros((5, 5), dtype=U64)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for off in range(0, len(padded), rate):
        block = bytes(padded[off : off + rate]) + b"\x00" * (200 - rate)
        state = state ^ _state_from_bytes(block)
        state = keccak_f(state)
    return _state_to_bytes(state)[:32]
