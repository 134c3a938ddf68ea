"""Reconstructing partial tries from RPC proof nodes, applying tx diffs,
and the state-trie account codec.

Counterpart: ethproof_tpu/witness/mpt.py:1 (a copy): `Mpt` (a pool of
RLP nodes re-rooted into a `PartialTrie`), the key and slot helpers,
`decode_account`/`encode_account`, `has_storage_deletion`, `apply_diffs`
and `trim`. Semantics kept exactly, including the counterpart's quirks:
- `Mpt` also inserts every nibble-suffix variant of 2-item (short) nodes,
  so orphaned siblings created by key deletion resolve.
- storage slot sanity check: the pre-state value read from the trie must
  RLP-decode to the tracer's pre value.
- `trim` skips storage trimming entirely when a storage deletion occurred.
Branch children embedded inline (<32-byte RLP) are handled structurally.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..hash.keccak import keccak256
from ..trie import rlp
from ..trie.nibbles import Nibbles
from ..trie.trie import (
    EMPTY_TRIE_HASH,
    Branch,
    Empty,
    Extension,
    Hash,
    Leaf,
    Node,
    PartialTrie,
)

EMPTY_CODE_HASH = keccak256(b"")


class Mpt:
    """A pool of RLP trie nodes keyed by keccak, plus a root hash."""

    def __init__(self) -> None:
        self.nodes: Dict[bytes, bytes] = {}
        self.root: bytes = b"\x00" * 32

    def insert_proof(self, proof: List[bytes]) -> None:
        for node in proof:
            self._insert_node(node)

    def _insert_node(self, rlp_node: bytes) -> None:
        self.nodes[keccak256(rlp_node)] = rlp_node
        items = rlp.decode(rlp_node)
        if isinstance(items, list) and len(items) == 2 and isinstance(items[0], bytes):
            prefix, payload = items[0], items[1]
            flag = prefix[0] >> 4
            if flag > 3:
                return
            is_leaf = flag >= 2
            nibs, _ = Nibbles.from_hex_prefix(prefix)
            # every suffix variant, so orphaned siblings resolve
            while True:
                enc = rlp.encode([nibs.to_hex_prefix(is_leaf), payload])
                self.nodes[keccak256(enc)] = enc
                if len(nibs) == 0:
                    break
                nibs = nibs[1:]

    def to_partial_trie(self) -> PartialTrie:
        node = self._resolve_hash(self.root)
        if isinstance(node, Hash) and node.h == EMPTY_TRIE_HASH:
            return PartialTrie()
        return PartialTrie(node)

    def _resolve_hash(self, h: bytes) -> Node:
        data = self.nodes.get(h)
        if data is None:
            return Hash(h)
        return self._decode(rlp.decode(data))

    def _decode(self, items) -> Node:
        if isinstance(items, bytes):
            # a child reference: 32-byte hash or empty
            if len(items) == 0:
                return Empty()
            assert len(items) == 32, f"bad child ref length {len(items)}"
            return self._resolve_hash(items)
        assert isinstance(items, list)
        if len(items) == 17:
            children = tuple(self._decode(c) for c in items[:16])
            return Branch(children, items[16])
        assert len(items) == 2, f"bad node arity {len(items)}"
        nibs, is_leaf = Nibbles.from_hex_prefix(items[0])
        if is_leaf:
            return Leaf(nibs, items[1])
        return Extension(nibs, self._decode(items[1]))


# -- diff application --------------------------------------------------------


def _hash_key(b: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(b))


def _slot_bytes(slot_hex: str) -> bytes:
    return bytes.fromhex(slot_hex[2:].rjust(64, "0"))


def _addr_bytes(addr_hex: str) -> bytes:
    return bytes.fromhex(addr_hex[2:].rjust(40, "0"))


def _u256_rlp(v: int) -> bytes:
    return rlp.encode(rlp.int_to_bytes(v))


def _int_of(x) -> int:
    if isinstance(x, int):
        return x
    return int(x, 16)


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


def has_storage_deletion(diff: dict) -> bool:
    """An account vanished, or a pre storage slot is missing from post."""
    pre, post = diff.get("pre", {}), diff.get("post", {})
    for addr, old in pre.items():
        if addr not in post:
            return True
        new_storage = post[addr].get("storage") or {}
        for k in (old.get("storage") or {}):
            if k not in new_storage:
                return True
    return False


def apply_diffs(
    state: PartialTrie,
    storage: Dict[bytes, PartialTrie],
    contract_code: Dict[bytes, bytes],
    diff: dict,
) -> Tuple[PartialTrie, Dict[bytes, PartialTrie]]:
    """Replay a tx's prestate-diff onto state + storage tries.

    `diff`: {"pre": {addr: {balance, nonce, code, storage{slot: val}}},
             "post": {...}} — geth prestate tracer diff-mode JSON.
    Returns fresh tries (inputs are not mutated).
    """
    state = state.copy()
    storage = {k: v.copy() for k, v in storage.items()}
    pre, post = diff.get("pre", {}), diff.get("post", {})

    # storage updates for surviving/deleted accounts
    for addr, old in pre.items():
        key = keccak256(_addr_bytes(addr))
        if addr not in post:
            storage.pop(key, None)
            continue
        new = post[addr]
        old_st = old.get("storage") or {}
        new_st = new.get("storage") or {}
        if not old_st and not new_st:
            continue
        trie = storage[key]
        for k, v in old_st.items():
            if k not in new_st:
                trie.delete(_hash_key(_slot_bytes(k)))
            else:
                sanity = trie.get(_hash_key(_slot_bytes(k)))
                assert sanity is not None and rlp.bytes_to_int(rlp.decode(sanity)) == _int_of(v), (
                    f"storage sanity mismatch at {addr}:{k}"
                )
                trie.insert(_hash_key(_slot_bytes(k)), _u256_rlp(_int_of(new_st[k])))
        for k, v in new_st.items():
            if k not in old_st:
                trie.insert(_hash_key(_slot_bytes(k)), _u256_rlp(_int_of(v)))
        storage[key] = trie

    # storage tries for brand-new accounts
    for addr, new in post.items():
        if addr not in pre:
            key = keccak256(_addr_bytes(addr))
            trie = PartialTrie()
            for k, v in (new.get("storage") or {}).items():
                trie.insert(_hash_key(_slot_bytes(k)), _u256_rlp(_int_of(v)))
            storage[key] = trie

    # account deletions
    for addr in pre:
        if addr not in post:
            state.delete(_hash_key(_addr_bytes(addr)))

    empty_root = PartialTrie().hash()

    def code_hash_of(acc: dict, fallback: bytes) -> bytes:
        code = acc.get("code")
        if code is None:
            return fallback
        if code in ("", "0x"):
            return EMPTY_CODE_HASH
        code_bytes = bytes.fromhex(code[2:] if code.startswith("0x") else code)
        h = keccak256(code_bytes)
        contract_code[h] = code_bytes
        return h

    # account upserts
    for addr, acc in post.items():
        key = _hash_key(_addr_bytes(addr))
        skey = keccak256(_addr_bytes(addr))
        if addr not in pre:
            account = {
                "nonce": _int_of(acc.get("nonce", 0)),
                "balance": _int_of(acc.get("balance", 0)),
                "storage_root": storage.get(skey, PartialTrie()).hash(),
                "code_hash": code_hash_of(acc, EMPTY_CODE_HASH),
            }
        else:
            old_data = state.get(key)
            old = (
                decode_account(old_data)
                if old_data is not None
                else {
                    "nonce": 0,
                    "balance": 0,
                    "storage_root": empty_root,
                    "code_hash": EMPTY_CODE_HASH,
                }
            )
            account = {
                "nonce": _int_of(acc["nonce"]) if "nonce" in acc and acc["nonce"] is not None else old["nonce"],
                "balance": _int_of(acc["balance"]) if "balance" in acc and acc["balance"] is not None else old["balance"],
                "storage_root": storage[skey].hash() if skey in storage else old["storage_root"],
                "code_hash": code_hash_of(acc, old["code_hash"]),
            }
        state.insert(key, encode_account(account))

    return state, storage


def trim(
    state: PartialTrie,
    storage: Dict[bytes, PartialTrie],
    touched: Dict[str, dict],
    storage_deletion: bool,
) -> Tuple[PartialTrie, Dict[bytes, PartialTrie]]:
    """Minimal subset tries covering the touched accounts/slots."""
    keys = [_hash_key(_addr_bytes(a)) for a in touched]
    new_state = state.subset(keys)
    out: Dict[bytes, PartialTrie] = {}
    if storage_deletion:
        return new_state, dict(storage)
    hashed_to_addr = {keccak256(_addr_bytes(a)): a for a in touched}
    for k, t in storage.items():
        if k not in hashed_to_addr:
            out[k] = PartialTrie(Hash(t.hash()))
        else:
            acc = touched[hashed_to_addr[k]]
            slot_keys = [
                _hash_key(_slot_bytes(s)) for s in (acc.get("storage") or {})
            ]
            try:
                out[k] = t.subset(slot_keys)
            except ValueError:
                out[k] = t.copy()
    return new_state, out
