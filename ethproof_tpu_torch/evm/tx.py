"""Transaction decoding + sender recovery (types 0/1/2).

Counterpart: ethproof_tpu/evm/tx.py:1 (a copy).

Reference equivalent: ethers' transaction types + the kernel's in-circuit
tx parsing [dep: from knowledge]. Covers legacy/EIP-155 (type 0),
EIP-2930 access-list txs (type 1) and EIP-1559 dynamic-fee txs (type 2)
— the reference's own witness path notes type-0 chain-id quirks
(leader/src/lib.rs:194-195) and its RPC layer fetches
typed txs transparently.

Fee semantics (consensus, EIP-1559):
  effective_gas_price = legacy/2930: gas_price
                        1559: min(max_fee, base_fee + max_priority_fee)
  the sender pays effective_gas_price * gas_used;
  the miner receives (effective_gas_price - base_fee) * gas_used;
  base_fee * gas_used is burned. Pre-London witnesses carry
  block_base_fee = 0, making the tip equal the full fee.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from ..hash.keccak import keccak256
from ..trie import rlp
from . import secp256k1

# (address20, (storage_key32, ...)) per EIP-2930 access-list entry
AccessList = Tuple[Tuple[bytes, Tuple[bytes, ...]], ...]


def _check_sig(s: int) -> None:
    # consensus validity (EIP-2): s must be in the low half of the
    # order; r, s in [1, N) is asserted inside recovery
    assert 1 <= s <= secp256k1.N // 2, "EIP-2: high-s signature"


def _access_list_rlp(al: AccessList) -> list:
    return [[addr, [k for k in keys]] for addr, keys in al]


def _decode_access_list(items) -> AccessList:
    out = []
    for entry in items:
        assert isinstance(entry, list) and len(entry) == 2, "bad access-list entry"
        addr, keys = entry
        assert len(addr) == 20
        out.append((addr, tuple(keys)))
    return tuple(out)


@dataclass
class LegacyTx:
    nonce: int
    gas_price: int
    gas_limit: int
    to: bytes  # 20 bytes (empty = create)
    value: int
    data: bytes
    v: int
    r: int
    s: int

    tx_type = 0
    access_list: AccessList = ()

    @property
    def chain_id(self) -> Optional[int]:
        if self.v in (27, 28):
            return None
        return (self.v - 35) // 2

    def effective_gas_price(self, base_fee: int) -> int:
        return self.gas_price

    def miner_tip_per_gas(self, base_fee: int) -> int:
        assert self.gas_price >= base_fee, "gas price below base fee"
        return self.gas_price - base_fee

    def signing_hash(self) -> bytes:
        fields = [
            rlp.int_to_bytes(self.nonce),
            rlp.int_to_bytes(self.gas_price),
            rlp.int_to_bytes(self.gas_limit),
            self.to,
            rlp.int_to_bytes(self.value),
            self.data,
        ]
        cid = self.chain_id
        if cid is not None:
            fields += [rlp.int_to_bytes(cid), b"", b""]
        return keccak256(rlp.encode(fields))

    def recid(self) -> int:
        if self.v in (27, 28):
            return self.v - 27
        assert self.v >= 35, f"invalid legacy v {self.v}"
        return (self.v - 35) % 2

    def sender(self) -> bytes:
        _check_sig(self.s)
        return secp256k1.recover_address(
            self.signing_hash(), self.r, self.s, self.recid()
        )


@dataclass
class Eip2930Tx:
    """Type-1 access-list transaction (EIP-2930)."""

    chain_id: int
    nonce: int
    gas_price: int
    gas_limit: int
    to: bytes
    value: int
    data: bytes
    access_list: AccessList
    y_parity: int
    r: int
    s: int

    tx_type = 1

    def effective_gas_price(self, base_fee: int) -> int:
        return self.gas_price

    def miner_tip_per_gas(self, base_fee: int) -> int:
        assert self.gas_price >= base_fee, "gas price below base fee"
        return self.gas_price - base_fee

    def _payload(self) -> list:
        return [
            rlp.int_to_bytes(self.chain_id),
            rlp.int_to_bytes(self.nonce),
            rlp.int_to_bytes(self.gas_price),
            rlp.int_to_bytes(self.gas_limit),
            self.to,
            rlp.int_to_bytes(self.value),
            self.data,
            _access_list_rlp(self.access_list),
        ]

    def signing_hash(self) -> bytes:
        return keccak256(b"\x01" + rlp.encode(self._payload()))

    def sender(self) -> bytes:
        _check_sig(self.s)
        assert self.y_parity in (0, 1), "invalid y_parity"
        return secp256k1.recover_address(
            self.signing_hash(), self.r, self.s, self.y_parity
        )


@dataclass
class Eip1559Tx:
    """Type-2 dynamic-fee transaction (EIP-1559)."""

    chain_id: int
    nonce: int
    max_priority_fee_per_gas: int
    max_fee_per_gas: int
    gas_limit: int
    to: bytes
    value: int
    data: bytes
    access_list: AccessList
    y_parity: int
    r: int
    s: int

    tx_type = 2

    def effective_gas_price(self, base_fee: int) -> int:
        assert self.max_fee_per_gas >= base_fee, "max fee below base fee"
        return min(
            self.max_fee_per_gas, base_fee + self.max_priority_fee_per_gas
        )

    def miner_tip_per_gas(self, base_fee: int) -> int:
        return self.effective_gas_price(base_fee) - base_fee

    def _payload(self) -> list:
        return [
            rlp.int_to_bytes(self.chain_id),
            rlp.int_to_bytes(self.nonce),
            rlp.int_to_bytes(self.max_priority_fee_per_gas),
            rlp.int_to_bytes(self.max_fee_per_gas),
            rlp.int_to_bytes(self.gas_limit),
            self.to,
            rlp.int_to_bytes(self.value),
            self.data,
            _access_list_rlp(self.access_list),
        ]

    def signing_hash(self) -> bytes:
        return keccak256(b"\x02" + rlp.encode(self._payload()))

    def sender(self) -> bytes:
        _check_sig(self.s)
        assert self.y_parity in (0, 1), "invalid y_parity"
        return secp256k1.recover_address(
            self.signing_hash(), self.r, self.s, self.y_parity
        )


Transaction = "LegacyTx | Eip2930Tx | Eip1559Tx"


def decode_tx(raw: bytes):
    """Decode a raw signed tx of type 0 (legacy RLP), 1 (0x01-prefixed
    EIP-2930 envelope) or 2 (0x02-prefixed EIP-1559 envelope)."""
    assert raw, "empty tx"
    if raw[0] >= 0xC0:
        return decode_legacy_tx(raw)
    t = raw[0]
    items = rlp.decode(raw[1:])
    assert isinstance(items, list), "typed tx payload must be a list"
    if t == 0x01:
        assert len(items) == 11, "not an EIP-2930 tx"
        return Eip2930Tx(
            chain_id=rlp.bytes_to_int(items[0]),
            nonce=rlp.bytes_to_int(items[1]),
            gas_price=rlp.bytes_to_int(items[2]),
            gas_limit=rlp.bytes_to_int(items[3]),
            to=items[4],
            value=rlp.bytes_to_int(items[5]),
            data=items[6],
            access_list=_decode_access_list(items[7]),
            y_parity=rlp.bytes_to_int(items[8]),
            r=rlp.bytes_to_int(items[9]),
            s=rlp.bytes_to_int(items[10]),
        )
    if t == 0x02:
        assert len(items) == 12, "not an EIP-1559 tx"
        return Eip1559Tx(
            chain_id=rlp.bytes_to_int(items[0]),
            nonce=rlp.bytes_to_int(items[1]),
            max_priority_fee_per_gas=rlp.bytes_to_int(items[2]),
            max_fee_per_gas=rlp.bytes_to_int(items[3]),
            gas_limit=rlp.bytes_to_int(items[4]),
            to=items[5],
            value=rlp.bytes_to_int(items[6]),
            data=items[7],
            access_list=_decode_access_list(items[8]),
            y_parity=rlp.bytes_to_int(items[9]),
            r=rlp.bytes_to_int(items[10]),
            s=rlp.bytes_to_int(items[11]),
        )
    raise AssertionError(f"unsupported tx type {t:#x}")


def decode_legacy_tx(raw: bytes) -> LegacyTx:
    items = rlp.decode(raw)
    assert isinstance(items, list) and len(items) == 9, "not a legacy tx"
    return LegacyTx(
        nonce=rlp.bytes_to_int(items[0]),
        gas_price=rlp.bytes_to_int(items[1]),
        gas_limit=rlp.bytes_to_int(items[2]),
        to=items[3],
        value=rlp.bytes_to_int(items[4]),
        data=items[5],
        v=rlp.bytes_to_int(items[6]),
        r=rlp.bytes_to_int(items[7]),
        s=rlp.bytes_to_int(items[8]),
    )


def _ecdsa_sign(msg_hash: bytes, private_key: int) -> Tuple[int, int, int]:
    """-> (r, s, recid) with low-s normalization (EIP-2). Deterministic
    nonce k via keccak (RFC6979-ish; fine for fixtures)."""
    z = int.from_bytes(msg_hash, "big") % secp256k1.N
    k = (
        int.from_bytes(
            keccak256(private_key.to_bytes(32, "big") + z.to_bytes(32, "big")),
            "big",
        )
        % secp256k1.N
    )
    R = secp256k1._mul(k, (secp256k1.GX, secp256k1.GY))
    assert R is not None
    r = R[0] % secp256k1.N
    s = secp256k1._inv(k, secp256k1.N) * (z + r * private_key) % secp256k1.N
    recid = R[1] % 2
    if s > secp256k1.N // 2:  # low-s normalization flips parity
        s = secp256k1.N - s
        recid ^= 1
    return r, s, recid


def sign_legacy_tx(
    nonce: int,
    gas_price: int,
    gas_limit: int,
    to: bytes,
    value: int,
    data: bytes,
    private_key: int,
    chain_id: Optional[int] = None,
) -> bytes:
    """Create a signed raw legacy tx (test fixtures / integration)."""
    fields = [
        rlp.int_to_bytes(nonce),
        rlp.int_to_bytes(gas_price),
        rlp.int_to_bytes(gas_limit),
        to,
        rlp.int_to_bytes(value),
        data,
    ]
    if chain_id is not None:
        presign = fields + [rlp.int_to_bytes(chain_id), b"", b""]
    else:
        presign = fields
    r, s, recid = _ecdsa_sign(keccak256(rlp.encode(presign)), private_key)
    v = (35 + 2 * chain_id + recid) if chain_id is not None else (27 + recid)
    signed = fields + [rlp.int_to_bytes(v), rlp.int_to_bytes(r), rlp.int_to_bytes(s)]
    return rlp.encode(signed)


def sign_eip2930_tx(
    chain_id: int,
    nonce: int,
    gas_price: int,
    gas_limit: int,
    to: bytes,
    value: int,
    data: bytes,
    private_key: int,
    access_list: AccessList = (),
) -> bytes:
    payload = [
        rlp.int_to_bytes(chain_id),
        rlp.int_to_bytes(nonce),
        rlp.int_to_bytes(gas_price),
        rlp.int_to_bytes(gas_limit),
        to,
        rlp.int_to_bytes(value),
        data,
        _access_list_rlp(access_list),
    ]
    r, s, recid = _ecdsa_sign(keccak256(b"\x01" + rlp.encode(payload)), private_key)
    signed = payload + [
        rlp.int_to_bytes(recid),
        rlp.int_to_bytes(r),
        rlp.int_to_bytes(s),
    ]
    return b"\x01" + rlp.encode(signed)


def sign_eip1559_tx(
    chain_id: int,
    nonce: int,
    max_priority_fee_per_gas: int,
    max_fee_per_gas: int,
    gas_limit: int,
    to: bytes,
    value: int,
    data: bytes,
    private_key: int,
    access_list: AccessList = (),
) -> bytes:
    payload = [
        rlp.int_to_bytes(chain_id),
        rlp.int_to_bytes(nonce),
        rlp.int_to_bytes(max_priority_fee_per_gas),
        rlp.int_to_bytes(max_fee_per_gas),
        rlp.int_to_bytes(gas_limit),
        to,
        rlp.int_to_bytes(value),
        data,
        _access_list_rlp(access_list),
    ]
    r, s, recid = _ecdsa_sign(keccak256(b"\x02" + rlp.encode(payload)), private_key)
    signed = payload + [
        rlp.int_to_bytes(recid),
        rlp.int_to_bytes(r),
        rlp.int_to_bytes(s),
    ]
    return b"\x02" + rlp.encode(signed)


def private_key_to_address(private_key: int) -> bytes:
    q = secp256k1._mul(private_key, (secp256k1.GX, secp256k1.GY))
    assert q is not None
    pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
    return keccak256(pub)[12:]
