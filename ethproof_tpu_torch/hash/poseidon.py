"""Poseidon permutation and sponge hash over Goldilocks.

Counterpart: ethproof_tpu/hash/poseidon.py:123-309. Width 12, S-box x^7,
the MDS matrix and round constants of constants.py, round order
constant_layer -> sbox_layer -> mds_layer, and ALL 30 rounds full (the
counterpart's schedule, not plonky2's 4+22+4).

A batch of N states is a (12, ...) int64 tensor. On a CUDA tensor
`permute` and the tree levels launch csrc/poseidon.cu, one thread a
permutation: `permute` is one launch, `leaf_level`, `node_level` and
`merkle_level` one launch each, so a leaf digest is one launch per level
of its tree. On a CPU tensor they take the plain PyTorch path
(`permute_plain`, `_level_plain`), which is also the kernel's oracle in
the card tests: every op elementwise over the trailing axes, the MDS
layer one exact float64 matrix product per 32-bit limb (entries are
< 2^6 and rows sum to < 2^9, so each limb sum is an integer < 2^41, exact
in float64 whatever the summation order; one fold mod p per output lane
follows). Both give the same canonical bits, for inputs >= p too. The
counterpart's one-hot round constant selection exists for XLA and is not
ported; its leaf blocking is `merkle.build`'s.

`CENSUS` counts the kernel's launches and permutations by entry point
(`("permute", "launches")`, `("leaf_level", "permutations")`, ...; a
Merkle level counts as a `node_level`) and the plain path's permutations
by device type (`("plain", "cpu")`).

The `*_host` functions are the python-int versions the Challenger and the
host verifier use.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
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
_RC = C.ALL_ROUND_CONSTANTS.reshape(C.N_ROUNDS, C.WIDTH)  # (30, 12) uint64
_M32 = 0xFFFFFFFF

CENSUS: Counter = Counter()


def _mds_layer(state: torch.Tensor, mds: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_j MDS[i][j] * state[j] mod p over the lane axis."""
    rest = state.shape[1:]
    s = state.reshape(SPONGE_WIDTH, -1)
    n = s.shape[1]
    limbs = torch.cat([s & _M32, (s >> 32) & _M32], dim=1).to(torch.float64)
    sums = torch.matmul(mds, limbs).to(torch.int64)  # (12, 2n), each < 2^41
    return gfp.reduce_wide(sums[:, n:], sums[:, :n]).reshape((SPONGE_WIDTH,) + rest)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = gfp.mul(x, x)
    x3 = gfp.mul(x2, x)
    x4 = gfp.mul(x2, x2)
    return gfp.mul(x3, x4)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation in plain PyTorch. state: (12, ...) int64 -> same shape."""
    CENSUS[("plain", state.device.type)] += state[0].numel()
    dev = state.device
    rc = torch.from_numpy(_RC.view(np.int64).copy()).to(dev)
    rc = rc.reshape((C.N_ROUNDS, SPONGE_WIDTH) + (1,) * (state.dim() - 1))
    mds = torch.from_numpy(_MDS.astype(np.float64)).to(dev)
    for r in range(C.N_ROUNDS):
        state = _mds_layer(_sbox(gfp.add(state, rc[r])), mds)
    return state


# -- the kernel (csrc/poseidon.cu) -------------------------------------------------


@lru_cache(maxsize=None)
def _kernel(entry: str):
    """The C entry point `ethproof_poseidon_<entry>`, built and loaded at its first use."""
    from .. import kernels

    fn = getattr(kernels.load("poseidon"), f"ethproof_poseidon_{entry}")
    i64, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = {
        "permute": [ptr, i64, i64, ptr, i64, ptr],
        "level": [ptr, i64, i64, i64, i64, i64, i64, ctypes.c_int, i64, ptr, i64, ptr],
    }[entry]
    fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, src: torch.Tensor, *args) -> None:
    """Launch on the tensor's card and on its current stream (a mesh block
    may lie on another card than the current one)."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = _kernel(entry)(src.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"poseidon {entry} kernel launch failed: cudaError {err}")


def _count(entry: str, permutations: int) -> None:
    CENSUS[(entry, "launches")] += 1
    CENSUS[(entry, "permutations")] += permutations


def _on_card(x: torch.Tensor, what: str) -> bool:
    """Whether `x` takes the kernel (a CUDA tensor, which must be int64)."""
    if not x.is_cuda:
        return False
    if x.dtype != torch.int64:
        raise TypeError(f"poseidon.{what} takes int64 field tensors, got {x.dtype}")
    return True


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon permutation. state: (12, ...) int64 -> same shape, canonical:
    the kernel on a CUDA tensor, `permute_plain` elsewhere."""
    if not _on_card(state, "permute"):
        return permute_plain(state)
    x = state.reshape(SPONGE_WIDTH, -1)
    n = x.shape[1]
    out = torch.empty((SPONGE_WIDTH, n), dtype=torch.int64, device=x.device)
    if n:
        _launch("permute", x, x.stride(0), x.stride(1), out.data_ptr(), n)
        _count("permute", n)
    return out.reshape(state.shape)


def _level_kernel(entry: str, x: torch.Tensor, lane: int, gstride: int, nstride: int,
                  elems: int, half: int, pairs: int, carry: int, cols: int) -> torch.Tensor:
    """One level on the card (csrc/poseidon.cu, `ethproof_poseidon_level`)
    -> (4, pairs + carry, cols)."""
    out = torch.empty((HASH_OUT, pairs + carry, cols), dtype=torch.int64, device=x.device)
    if out.numel():
        _launch("level", x, lane, gstride, nstride, elems, half, pairs, carry, cols,
                out.data_ptr(), (pairs + carry) * cols)
        _count(entry, pairs * cols)
    return out


def _level_plain(d: torch.Tensor) -> torch.Tensor:
    """(4, k, ...) digests -> (4, ceil(k/2), ...): digest i of the next level
    is two_to_one(d[:, i], d[:, half + i]), half = k // 2; an odd k carries
    d[:, k - 1] up as it is."""
    k = d.shape[1]
    half = k // 2
    merged = two_to_one(d[:, :half], d[:, half : 2 * half])
    if k & 1:
        merged = torch.cat([merged, d[:, -1:]], dim=1)
    return merged


def leaf_level(rows: torch.Tensor) -> torch.Tensor:
    """The first level of `tree_digest`: (L, ...) rows, L > 4, as k =
    ceil(L/4) groups of four (zero past L) -> (4, ceil(k/2), ...), that is
    `_level_plain` of the groups. The kernel reads the rows where they lie
    and pads in registers."""
    length = rows.shape[0]
    k = (length + 3) // 4
    rest = tuple(rows.shape[1:])
    if not _on_card(rows, "leaf_level"):
        pad = torch.zeros((4 * k - length,) + rest, dtype=torch.int64, device=rows.device)
        return _level_plain(torch.cat([rows, pad]).reshape((k, 4) + rest).movedim(1, 0))
    x = rows.reshape(length, -1)
    half = k // 2
    out = _level_kernel("leaf_level", x, x.stride(0), 4 * x.stride(0), x.stride(1), length,
                        half, half, k & 1, x.shape[1])
    return out.reshape((HASH_OUT, half + (k & 1)) + rest)


def node_level(d: torch.Tensor) -> torch.Tensor:
    """A level of `tree_digest` above the first: (4, k, ...) digests ->
    (4, ceil(k/2), ...), as `_level_plain`."""
    if not _on_card(d, "node_level"):
        return _level_plain(d)
    k = d.shape[1]
    rest = tuple(d.shape[2:])
    x = d.reshape(HASH_OUT, k, -1)
    half = k // 2
    out = _level_kernel("node_level", x, x.stride(0), x.stride(1), x.stride(2), 4 * k, half,
                        half, k & 1, x.shape[2])
    return out.reshape((HASH_OUT, half + (k & 1)) + rest)


def merkle_level(d: torch.Tensor) -> torch.Tensor:
    """A Merkle tree level: (4, M) digests, M even -> (4, M/2), digest j the
    two_to_one of siblings 2j and 2j + 1."""
    if not _on_card(d, "merkle_level"):
        return two_to_one(d[:, 0::2], d[:, 1::2])
    m = d.shape[1]
    assert m % 2 == 0, "a Merkle level has an even number of digests"
    out = _level_kernel("node_level", d, d.stride(0), d.stride(1), 2 * d.stride(1), 8, 1, 1, 0,
                        m // 2)
    return out.reshape(HASH_OUT, m // 2)


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
    zero-padded 4-element groups, digest i of a level paired with digest
    half + i (`leaf_level`, then `node_level` to one digest); L <= 4 is a
    padded copy."""
    if inputs.shape[0] <= HASH_OUT:
        return hash_or_noop(inputs)
    d = leaf_level(inputs)
    while d.shape[1] > 1:
        d = node_level(d)
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
