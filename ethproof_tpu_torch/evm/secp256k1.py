"""secp256k1 ECDSA public-key recovery (host, pure python).

Counterpart: ethproof_tpu/evm/secp256k1.py:1 (a copy).

Reference equivalent: the ecrecover the zkEVM kernel performs in-circuit
and ethers performs host-side [dep: from knowledge]. Used to derive a
transaction's sender address from its signature.
"""

from __future__ import annotations

from typing import Optional, Tuple

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

Point = Optional[Tuple[int, int]]  # None = infinity


def _inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def _add(p1: Point, p2: Point) -> Point:
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _mul(k: int, p: Point) -> Point:
    acc: Point = None
    while k:
        if k & 1:
            acc = _add(acc, p)
        p = _add(p, p)
        k >>= 1
    return acc


def recover_pubkey(msg_hash: bytes, r: int, s: int, recid: int) -> Tuple[int, int]:
    """-> (x, y) of the signer's public key. recid in {0, 1} (y parity)."""
    assert 1 <= r < N and 1 <= s < N and recid in (0, 1)
    x = r  # ignore the r >= P - N edge case (astronomically unlikely)
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        raise ValueError("invalid signature: r not on curve")
    if y % 2 != recid:
        y = P - y
    z = int.from_bytes(msg_hash, "big") % N
    r_inv = _inv(r, N)
    u1 = (-z * r_inv) % N
    u2 = (s * r_inv) % N
    q = _add(_mul(u1, (GX, GY)), _mul(u2, (x, y)))
    assert q is not None, "invalid signature: point at infinity"
    return q


def recover_address(msg_hash: bytes, r: int, s: int, recid: int) -> bytes:
    from ..hash.keccak import keccak256

    x, y = recover_pubkey(msg_hash, r, s, recid)
    pub = x.to_bytes(32, "big") + y.to_bytes(32, "big")
    return keccak256(pub)[12:]
