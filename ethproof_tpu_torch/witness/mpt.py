"""State-trie account codec.

Counterpart: ethproof_tpu/witness/mpt.py:40 and :127-145
(`EMPTY_CODE_HASH`, `decode_account`, `encode_account`, copied). The RPC
proof-node reconstruction and diff application of that module are not
ported.
"""

from __future__ import annotations

from ..hash.keccak import keccak256
from ..trie import rlp

EMPTY_CODE_HASH = keccak256(b"")


def decode_account(data: bytes):
    items = rlp.decode(data)
    return {
        "nonce": rlp.bytes_to_int(items[0]),
        "balance": rlp.bytes_to_int(items[1]),
        "storage_root": items[2],
        "code_hash": items[3],
    }


def encode_account(acc: dict) -> bytes:
    return rlp.encode(
        [
            rlp.int_to_bytes(acc["nonce"]),
            rlp.int_to_bytes(acc["balance"]),
            acc["storage_root"],
            acc["code_hash"],
        ]
    )
