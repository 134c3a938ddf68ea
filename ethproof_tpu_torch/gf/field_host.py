"""Exact host-side (python int / numpy) Goldilocks arithmetic.

Counterpart: ethproof_tpu/gf/field_host.py:1 (a copy; the port imports nothing of the JAX package).

Used for twiddle and root-table precomputation, Poseidon constants, and
anywhere the host needs exact field math. Python ints are arbitrary
precision, so this module is trivially correct; the tensor implementation
in field.py is tested against it.

Reference equivalent: `plonky2_field::goldilocks_field`.
"""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1  # 2^64 mod p

# Generator of the full multiplicative group (order p-1).
MULT_GROUP_GEN = 7
TWO_ADICITY = 32


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def primitive_root_of_unity(n_log: int) -> int:
    """Generator of the order-2^n_log subgroup (matches plonky2's
    `power_of_two_generator` derivation: g^((p-1) / 2^n_log))."""
    if n_log > TWO_ADICITY:
        raise ValueError(f"two-adicity exceeded: {n_log} > {TWO_ADICITY}")
    return pow(MULT_GROUP_GEN, (P - 1) >> n_log, P)


def roots_of_unity(n_log: int) -> list[int]:
    """All 2^n_log roots of unity in order [1, w, w^2, ...]."""
    w = primitive_root_of_unity(n_log)
    out = [1] * (1 << n_log)
    for i in range(1, 1 << n_log):
        out[i] = out[i - 1] * w % P
    return out


def ntt_host(vals: list[int], inverse: bool = False) -> list[int]:
    """Iterative radix-2 NTT over H (python ints, O(n log n)).

    Used by the STARK verifier to turn fixed-column values into
    coefficients once per (table, n) — small n, host-exact.
    """
    n = len(vals)
    assert n & (n - 1) == 0
    log_n = n.bit_length() - 1
    a = list(vals)
    # bit-reverse
    for i in range(n):
        r = 0
        for b in range(log_n):
            r = (r << 1) | ((i >> b) & 1)
        if i < r:
            a[i], a[r] = a[r], a[i]
    for s in range(1, log_n + 1):
        m = 1 << s
        w_m = primitive_root_of_unity(s)
        if inverse:
            w_m = inv(w_m)
        for start in range(0, n, m):
            w = 1
            for j in range(m // 2):
                t = w * a[start + j + m // 2] % P
                u = a[start + j]
                a[start + j] = (u + t) % P
                a[start + j + m // 2] = (u - t) % P
                w = w * w_m % P
    if inverse:
        n_inv = inv(n)
        a = [x * n_inv % P for x in a]
    return a


def to_u32_pairs(vals, reduce: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """int sequence / uint64 ndarray -> (lo, hi) uint32 ndarrays.

    By default values are reduced mod p so constructed GF elements always
    satisfy the canonical invariant (add/sub assume inputs < p)."""
    arr = np.asarray(vals, dtype=np.object_) if not isinstance(vals, np.ndarray) else vals
    if arr.dtype == np.uint64:
        if reduce:
            arr = arr % np.uint64(P)
        lo = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        hi = (arr >> np.uint64(32)).astype(np.uint32)
        return lo, hi
    flat = [int(v) % P if reduce else int(v) for v in np.ravel(arr)]
    lo = np.array([v & 0xFFFFFFFF for v in flat], dtype=np.uint32).reshape(arr.shape)
    hi = np.array([v >> 32 for v in flat], dtype=np.uint32).reshape(arr.shape)
    return lo, hi


def from_u32_pairs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) uint32 ndarrays -> object ndarray of python ints (exact)."""
    lo_ = np.asarray(lo)
    hi_ = np.asarray(hi)
    out = np.empty(lo_.shape, dtype=np.object_)
    it = np.nditer(lo_, flags=["multi_index", "refs_ok"])
    for _ in it:
        idx = it.multi_index
        out[idx] = (int(hi_[idx]) << 32) | int(lo_[idx])
    return out
