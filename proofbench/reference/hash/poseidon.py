"""[The benchmark's frozen copy of ethproof_tpu_torch/hash/poseidon.py.]

Poseidon permutation and sponge hash over Goldilocks (plain PyTorch).

Counterpart: ethproof_tpu/hash/poseidon.py:123-309. Width 12, S-box x^7,
the MDS matrix and round constants of constants.py, round order
constant_layer -> sbox_layer -> mds_layer, and ALL 30 rounds full (the
counterpart's schedule, not plonky2's 4+22+4).

A batch of N states is a (12, ...) int64 tensor; every op is elementwise
over the trailing axes. The MDS layer is one exact float64 matrix product
per 32-bit limb: entries are < 2^6 and rows sum to < 2^9, so each limb sum
is an integer < 2^41, exact in float64 whatever the summation order; one
fold mod p per output lane follows. The counterpart's one-hot round
constant selection exists for XLA and is not ported; its leaf blocking is
`merkle.build`'s.

The `*_host` functions are the python-int versions the Challenger and the
host verifier use.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..gf import field as gfp
from . import constants as C

SPONGE_WIDTH = C.WIDTH  # 12
SPONGE_RATE = 8
SPONGE_CAPACITY = 4
HASH_OUT = 4

_MDS = C.mds_matrix()  # (12, 12) uint64
# The float type of the MDS matmul: float64 is exact (every limb sum is an
# integer below 2^41); the control sets float32, one precision below.
MATMUL_DTYPE = torch.float64
_RC = C.ALL_ROUND_CONSTANTS.reshape(C.N_ROUNDS, C.WIDTH)  # (30, 12) uint64
_M32 = 0xFFFFFFFF


def _mds_layer(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j MDS[i][j] * state[j] mod p over the lane axis."""
    rest = state.shape[1:]
    s = state.reshape(SPONGE_WIDTH, -1)
    n = s.shape[1]
    limbs = torch.cat([s & _M32, (s >> 32) & _M32], dim=1).to(MATMUL_DTYPE)
    sums = torch.matmul(mds.to(MATMUL_DTYPE), limbs).to(torch.int64)  # (12, 2n), each < 2^41
    return gfp.reduce_wide(sums[:, n:], sums[:, :n]).reshape((SPONGE_WIDTH,) + rest)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = gfp.mul(x, x)
    x3 = gfp.mul(x2, x)
    x4 = gfp.mul(x2, x2)
    return gfp.mul(x3, x4)


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation. state: (12, ...) int64 -> same shape."""
    dev = state.device
    rc = torch.from_numpy(_RC.view(np.int64).copy()).to(dev)
    rc = rc.reshape((C.N_ROUNDS, SPONGE_WIDTH) + (1,) * (state.dim() - 1))
    mds = torch.from_numpy(_MDS.astype(np.float64)).to(dev)
    for r in range(C.N_ROUNDS):
        state = _mds_layer(_sbox(gfp.add(state, rc[r])), mds)
    return state


def hash_n_to_m_no_pad(inputs: torch.Tensor, m: int = HASH_OUT) -> torch.Tensor:
    """Sponge with no padding (plonky2 `hash_n_to_m_no_pad` semantics).

    inputs: (L, ...) — L field elements per lane. Absorb in chunks of
    SPONGE_RATE (overwriting the rate part), permute after each chunk;
    squeeze the first m elements."""
    length = inputs.shape[0]
    state = torch.zeros((SPONGE_WIDTH,) + tuple(inputs.shape[1:]), dtype=torch.int64,
                        device=inputs.device)
    for start in range(0, length, SPONGE_RATE):
        chunk = min(SPONGE_RATE, length - start)
        state = torch.cat([inputs[start : start + chunk], state[chunk:]])
        state = permute(state)
    return state[:m]


def hash_or_noop(inputs: torch.Tensor) -> torch.Tensor:
    """<= 4 inputs: zero-padded copy (no permutation); else sponge hash."""
    length = inputs.shape[0]
    if length <= HASH_OUT:
        pad = torch.zeros((HASH_OUT - length,) + tuple(inputs.shape[1:]), dtype=torch.int64,
                          device=inputs.device)
        return torch.cat([inputs, pad])
    return hash_n_to_m_no_pad(inputs, HASH_OUT)


def two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Compress two (4, ...) digests -> one (Merkle node)."""
    cap = torch.zeros((SPONGE_CAPACITY,) + tuple(left.shape[1:]), dtype=torch.int64,
                      device=left.device)
    return permute(torch.cat([left, right, cap]))[:HASH_OUT]


def tree_digest(inputs: torch.Tensor) -> torch.Tensor:
    """Leaf digest of (L, ...) rows: a balanced two_to_one tree over
    zero-padded 4-element groups; L <= 4 is a padded copy."""
    length = inputs.shape[0]
    if length <= HASH_OUT:
        return hash_or_noop(inputs)
    k = (length + 3) // 4
    rest = tuple(inputs.shape[1:])
    pad = torch.zeros((4 * k - length,) + rest, dtype=torch.int64, device=inputs.device)
    d = torch.cat([inputs, pad]).reshape((k, 4) + rest).movedim(1, 0)  # (4, k, ...)
    while k > 1:
        half = k // 2
        merged = two_to_one(d[:, :half], d[:, half : 2 * half])
        if k & 1:
            merged = torch.cat([merged, d[:, -1:]], dim=1)
            k = half + 1
        else:
            k = half
        d = merged
    return d[:, 0]


# -- host (python int) versions ---------------------------------------------------

_P = C.P
_RC_ROWS = [[int(v) for v in row] for row in _RC]  # python ints: numpy scalars are slow
# The MDS matrix is circulant plus a diagonal (constants.mds_matrix):
# out_i = sum_k CIRC[k] * s[(i + k) % 12] + DIAG[i] * s[i]. One big-int product
# gives every cyclic sum: the state packed in 80-bit slots times CIRC packed
# in reversed slot order holds lane i's sum split over slots i and i + 12;
# each slot stays < 12 * 2^6 * 2^64 < 2^80, so no carry crosses a slot.
_SLOT_BYTES = 10
_CIRC_PACKED = sum(int(c) << (8 * _SLOT_BYTES * ((SPONGE_WIDTH - k) % SPONGE_WIDTH))
                   for k, c in enumerate(C.MDS_MATRIX_CIRC))
_DIAG = [int(d) for d in C.MDS_MATRIX_DIAG]


def _mds_host(s: list) -> list:
    packed = int.from_bytes(b"".join(x.to_bytes(_SLOT_BYTES, "little") for x in s), "little")
    t = (packed * _CIRC_PACKED).to_bytes(2 * SPONGE_WIDTH * _SLOT_BYTES, "little")
    w = _SLOT_BYTES
    return [(int.from_bytes(t[w * i : w * (i + 1)], "little")
             + int.from_bytes(t[w * (i + SPONGE_WIDTH) : w * (i + SPONGE_WIDTH + 1)], "little")
             + d * x) % _P for i, (d, x) in enumerate(zip(_DIAG, s))]


def permute_host(state: Sequence[int]) -> list:
    s = [x % _P for x in state]
    for rc in _RC_ROWS:
        s = _mds_host([pow(x + c, C.SBOX_EXP, _P) for x, c in zip(s, rc)])
    return s


def hash_n_to_m_no_pad_host(inputs: Sequence[int], m: int = HASH_OUT) -> list:
    state = [0] * SPONGE_WIDTH
    xs = [x % _P for x in inputs]
    for start in range(0, len(xs), SPONGE_RATE):
        chunk = xs[start : start + SPONGE_RATE]
        state[: len(chunk)] = chunk
        state = permute_host(state)
    return state[:m]


def two_to_one_host(left: Sequence[int], right: Sequence[int]) -> list:
    return permute_host(list(left) + list(right) + [0] * SPONGE_CAPACITY)[:HASH_OUT]


def tree_digest_host(inputs) -> list:
    xs = [x % _P for x in inputs]
    if len(xs) <= HASH_OUT:
        return xs + [0] * (HASH_OUT - len(xs))
    k = (len(xs) + 3) // 4
    xs = xs + [0] * (4 * k - len(xs))
    ds = [xs[4 * i : 4 * i + 4] for i in range(k)]
    while len(ds) > 1:
        half = len(ds) // 2
        nxt = [two_to_one_host(ds[i], ds[half + i]) for i in range(half)]
        if len(ds) & 1:
            nxt.append(ds[-1])
        ds = nxt
    return ds[0]
