"""Witness data model: the per-transaction proving input contract.

Counterpart: ethproof_tpu/witness/types.py:1 (a copy).

Reference equivalent: `evm_arithmetization::generation::GenerationInputs`
and its component types, exactly as constructed by the reference witness
generator (leader/src/lib.rs:445-467: signed_txn, tries,
withdrawals, contract_code, block_metadata, block_hashes,
gas_used_before/after, checkpoint_state_trie_root, trie_roots_after,
txn_number_before; BlockMetadata fields per leader/src/lib.rs:142-152).

JSON schema: this framework's canonical serialization (documented here,
round-trip tested). Tries serialize as recursive node objects — partial
(Hash-stub) structure preserved. The reference's serde encoding of
`HashedPartialTrie` is a rust-internal detail; witnesses produced by this
framework's `rpc` command are consumed by its `prove` command, mirroring
the reference's file-based workflow (README.md:36-64).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..trie import trie as t
from ..trie.nibbles import Nibbles


def _hex(b: bytes) -> str:
    return "0x" + b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


# -- trie (de)serialization --------------------------------------------------


def trie_to_json(node: t.Node) -> dict:
    if isinstance(node, t.Empty):
        return {"type": "empty"}
    if isinstance(node, t.Hash):
        return {"type": "hash", "hash": _hex(node.h)}
    if isinstance(node, t.Leaf):
        return {
            "type": "leaf",
            "key": "".join(f"{v:x}" for v in node.key.vals),
            "value": _hex(node.value),
        }
    if isinstance(node, t.Extension):
        return {
            "type": "ext",
            "key": "".join(f"{v:x}" for v in node.key.vals),
            "child": trie_to_json(node.child),
        }
    if isinstance(node, t.Branch):
        return {
            "type": "branch",
            "children": [trie_to_json(c) for c in node.children],
            "value": _hex(node.value),
        }
    raise TypeError(node)


def trie_from_json(d: dict) -> t.Node:
    k = d["type"]
    if k == "empty":
        return t.EMPTY
    if k == "hash":
        return t.Hash(_unhex(d["hash"]))
    if k == "leaf":
        return t.Leaf(Nibbles(tuple(int(c, 16) for c in d["key"])), _unhex(d["value"]))
    if k == "ext":
        return t.Extension(
            Nibbles(tuple(int(c, 16) for c in d["key"])), trie_from_json(d["child"])
        )
    if k == "branch":
        return t.Branch(
            tuple(trie_from_json(c) for c in d["children"]), _unhex(d["value"])
        )
    raise ValueError(k)


# -- data classes ------------------------------------------------------------


@dataclass
class TrieInputs:
    state_trie: t.PartialTrie = field(default_factory=t.PartialTrie)
    transactions_trie: t.PartialTrie = field(default_factory=t.PartialTrie)
    receipts_trie: t.PartialTrie = field(default_factory=t.PartialTrie)
    storage_tries: List[Tuple[bytes, t.PartialTrie]] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "state_trie": trie_to_json(self.state_trie.root),
            "transactions_trie": trie_to_json(self.transactions_trie.root),
            "receipts_trie": trie_to_json(self.receipts_trie.root),
            "storage_tries": [
                [_hex(h), trie_to_json(tr.root)] for h, tr in self.storage_tries
            ],
        }

    @classmethod
    def from_json(cls, d: dict) -> "TrieInputs":
        return cls(
            state_trie=t.PartialTrie(trie_from_json(d["state_trie"])),
            transactions_trie=t.PartialTrie(trie_from_json(d["transactions_trie"])),
            receipts_trie=t.PartialTrie(trie_from_json(d["receipts_trie"])),
            storage_tries=[
                (_unhex(h), t.PartialTrie(trie_from_json(tr)))
                for h, tr in d["storage_tries"]
            ],
        )


@dataclass
class BlockMetadata:
    block_beneficiary: bytes = b"\x00" * 20
    block_timestamp: int = 0
    block_number: int = 0
    block_difficulty: int = 0
    block_gaslimit: int = 0
    block_chain_id: int = 1
    block_base_fee: int = 0
    block_gas_used: int = 0
    block_random: bytes = b"\x00" * 32
    block_bloom: Tuple[int, ...] = (0,) * 8  # 8 x U256, reference convert_bloom

    def to_json(self) -> dict:
        return {
            "block_beneficiary": _hex(self.block_beneficiary),
            "block_timestamp": hex(self.block_timestamp),
            "block_number": hex(self.block_number),
            "block_difficulty": hex(self.block_difficulty),
            "block_gaslimit": hex(self.block_gaslimit),
            "block_chain_id": hex(self.block_chain_id),
            "block_base_fee": hex(self.block_base_fee),
            "block_gas_used": hex(self.block_gas_used),
            "block_random": _hex(self.block_random),
            "block_bloom": [hex(x) for x in self.block_bloom],
        }

    @classmethod
    def from_json(cls, d: dict) -> "BlockMetadata":
        return cls(
            block_beneficiary=_unhex(d["block_beneficiary"]),
            block_timestamp=int(d["block_timestamp"], 16),
            block_number=int(d["block_number"], 16),
            block_difficulty=int(d["block_difficulty"], 16),
            block_gaslimit=int(d["block_gaslimit"], 16),
            block_chain_id=int(d["block_chain_id"], 16),
            block_base_fee=int(d["block_base_fee"], 16),
            block_gas_used=int(d["block_gas_used"], 16),
            block_random=_unhex(d["block_random"]),
            block_bloom=tuple(int(x, 16) for x in d["block_bloom"]),
        )


@dataclass
class BlockHashes:
    prev_hashes: List[bytes] = field(default_factory=list)  # 256 ancestors
    cur_hash: bytes = b"\x00" * 32

    def to_json(self) -> dict:
        return {
            "prev_hashes": [_hex(h) for h in self.prev_hashes],
            "cur_hash": _hex(self.cur_hash),
        }

    @classmethod
    def from_json(cls, d: dict) -> "BlockHashes":
        return cls([_unhex(h) for h in d["prev_hashes"]], _unhex(d["cur_hash"]))


@dataclass
class TrieRoots:
    state_root: bytes = b"\x00" * 32
    transactions_root: bytes = b"\x00" * 32
    receipts_root: bytes = b"\x00" * 32

    def to_json(self) -> dict:
        return {
            "state_root": _hex(self.state_root),
            "transactions_root": _hex(self.transactions_root),
            "receipts_root": _hex(self.receipts_root),
        }

    @classmethod
    def from_json(cls, d: dict) -> "TrieRoots":
        return cls(
            _unhex(d["state_root"]),
            _unhex(d["transactions_root"]),
            _unhex(d["receipts_root"]),
        )


@dataclass
class GenerationInputs:
    """One transaction's proving input (reference leader/src/lib.rs:445-467)."""

    txn_number_before: int = 0
    gas_used_before: int = 0
    gas_used_after: int = 0
    signed_txn: Optional[bytes] = None  # None for padding dummies
    withdrawals: List[Tuple[bytes, int]] = field(default_factory=list)
    tries: TrieInputs = field(default_factory=TrieInputs)
    trie_roots_after: TrieRoots = field(default_factory=TrieRoots)
    checkpoint_state_trie_root: bytes = b"\x00" * 32
    contract_code: Dict[bytes, bytes] = field(default_factory=dict)  # hash->code
    block_metadata: BlockMetadata = field(default_factory=BlockMetadata)
    block_hashes: BlockHashes = field(default_factory=BlockHashes)

    def to_json(self) -> dict:
        return {
            "txn_number_before": hex(self.txn_number_before),
            "gas_used_before": hex(self.gas_used_before),
            "gas_used_after": hex(self.gas_used_after),
            "signed_txn": _hex(self.signed_txn) if self.signed_txn is not None else None,
            "withdrawals": [[_hex(a), hex(v)] for a, v in self.withdrawals],
            "tries": self.tries.to_json(),
            "trie_roots_after": self.trie_roots_after.to_json(),
            "checkpoint_state_trie_root": _hex(self.checkpoint_state_trie_root),
            "contract_code": {_hex(h): _hex(c) for h, c in self.contract_code.items()},
            "block_metadata": self.block_metadata.to_json(),
            "block_hashes": self.block_hashes.to_json(),
        }

    @classmethod
    def from_json(cls, d: dict) -> "GenerationInputs":
        return cls(
            txn_number_before=int(d["txn_number_before"], 16),
            gas_used_before=int(d["gas_used_before"], 16),
            gas_used_after=int(d["gas_used_after"], 16),
            signed_txn=_unhex(d["signed_txn"]) if d["signed_txn"] is not None else None,
            withdrawals=[(_unhex(a), int(v, 16)) for a, v in d["withdrawals"]],
            tries=TrieInputs.from_json(d["tries"]),
            trie_roots_after=TrieRoots.from_json(d["trie_roots_after"]),
            checkpoint_state_trie_root=_unhex(d["checkpoint_state_trie_root"]),
            contract_code={
                _unhex(h): _unhex(c) for h, c in d["contract_code"].items()
            },
            block_metadata=BlockMetadata.from_json(d["block_metadata"]),
            block_hashes=BlockHashes.from_json(d["block_hashes"]),
        )


def witness_to_json(inputs: List[GenerationInputs]) -> list:
    return [gi.to_json() for gi in inputs]


def witness_from_json(data: list) -> List[GenerationInputs]:
    return [GenerationInputs.from_json(d) for d in data]
