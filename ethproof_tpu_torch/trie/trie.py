"""Hashed partial Merkle-Patricia trie.

Counterpart: ethproof_tpu/trie/trie.py:1 (a copy).

Reference equivalent: `mpt_trie::partial_trie::HashedPartialTrie` (pin
Cargo.lock:2846): node kinds Empty / Hash / Leaf /
Extension / Branch, keccak-RLP root hashing with <32-byte inline node
embedding, insert/get/delete, and `create_trie_subset`-style trimming
(used by leader/src/mpt.rs:322-359). Hash nodes stand in
for unvisited subtrees — the defining feature of a *partial* trie witness.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from ..hash.keccak import keccak256
from . import rlp
from .nibbles import Nibbles

EMPTY_TRIE_HASH = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)


class Node:
    __slots__ = ()


@dataclass(frozen=True)
class Empty(Node):
    pass


@dataclass(frozen=True)
class Hash(Node):
    """An unresolved subtree, known only by its keccak root."""

    h: bytes


@dataclass(frozen=True)
class Leaf(Node):
    key: Nibbles
    value: bytes


@dataclass(frozen=True)
class Extension(Node):
    key: Nibbles
    child: Node


@dataclass(frozen=True)
class Branch(Node):
    children: Tuple[Node, ...]  # 16
    value: bytes


EMPTY = Empty()


class PartialTrie:
    def __init__(self, root: Node = EMPTY):
        self.root = root

    # -- hashing -------------------------------------------------------------

    def hash(self) -> bytes:
        ref = _node_ref(self.root)
        if isinstance(ref, bytes) and len(ref) == 32:
            return ref
        # small root: hash its RLP anyway (root is always hashed)
        return keccak256(_node_rlp_encoded(self.root))

    # -- queries -------------------------------------------------------------

    def get(self, key: Nibbles) -> Optional[bytes]:
        return _get(self.root, key)

    def insert(self, key: Nibbles, value: bytes) -> None:
        self.root = _insert(self.root, key, value)

    def delete(self, key: Nibbles) -> None:
        self.root = _delete(self.root, key)

    def insert_hash(self, key: Nibbles, h: bytes) -> None:
        """Insert a hash (unresolved subtree) at a key prefix."""
        self.root = _insert_node(self.root, key, Hash(h))

    def items(self) -> List[Tuple[Nibbles, bytes]]:
        out: List[Tuple[Nibbles, bytes]] = []
        _walk(self.root, Nibbles(), out)
        return out

    def copy(self) -> "PartialTrie":
        return PartialTrie(self.root)  # nodes are immutable

    def subset(self, keys: List[Nibbles]) -> "PartialTrie":
        """Minimal trie containing `keys`; other subtrees become Hash stubs.

        Mirrors `create_trie_subset` (reference leader/src/mpt.rs:330).
        Subset root hash ALWAYS equals the full root hash (asserted by the
        reference at leader/src/lib.rs:404 — callers should re-check).
        """
        return PartialTrie(_trim(self.root, keys))

    def prove(self, key: Nibbles) -> List[bytes]:
        """Merkle proof: the RLP encodings of all HASHED nodes on the path
        to `key`, root first — the shape `eth_getProof` returns. Embedded
        (<32-byte) nodes live inside their parent's RLP and are not listed.
        """
        out: List[bytes] = []
        node = self.root
        while True:
            if isinstance(node, (Empty, Hash)):
                return out
            enc = _node_rlp_encoded(node)
            if len(enc) >= 32:
                out.append(enc)
            if isinstance(node, Leaf):
                return out
            if isinstance(node, Extension):
                if not key.starts_with(node.key):
                    return out
                key = key[len(node.key) :]
                node = node.child
            elif isinstance(node, Branch):
                if len(key) == 0:
                    return out
                node, key = node.children[key[0]], key[1:]


# -- internals ---------------------------------------------------------------


def _walk(node: Node, prefix: Nibbles, out) -> None:
    if isinstance(node, Leaf):
        out.append((prefix + node.key, node.value))
    elif isinstance(node, Extension):
        _walk(node.child, prefix + node.key, out)
    elif isinstance(node, Branch):
        if node.value:
            out.append((prefix, node.value))
        for i, c in enumerate(node.children):
            _walk(c, prefix + Nibbles((i,)), out)


def _get(node: Node, key: Nibbles) -> Optional[bytes]:
    if isinstance(node, Empty) or isinstance(node, Hash):
        return None
    if isinstance(node, Leaf):
        return node.value if node.key == key else None
    if isinstance(node, Extension):
        if key.starts_with(node.key):
            return _get(node.child, key[len(node.key) :])
        return None
    if isinstance(node, Branch):
        if len(key) == 0:
            return node.value or None
        return _get(node.children[key[0]], key[1:])
    raise TypeError(node)


def _insert(node: Node, key: Nibbles, value: bytes) -> Node:
    return _insert_node(node, key, Leaf(Nibbles(), value))


def _insert_node(node: Node, key: Nibbles, new: Node) -> Node:
    """Insert `new` (Leaf with empty key, or Hash) at path `key`."""
    if isinstance(node, Empty):
        return _attach(key, new)
    if isinstance(node, Hash):
        raise ValueError("cannot insert below an unresolved Hash node")
    if isinstance(node, Leaf):
        cp = node.key.common_prefix_len(key)
        if cp == len(node.key) == len(key):
            if isinstance(new, Leaf):
                return Leaf(key, new.value)  # overwrite
            raise ValueError("hash insert collides with existing leaf")
        kids: List[Node] = [EMPTY] * 16
        bval = b""
        rest_old = node.key[cp:]
        if len(rest_old) == 0:
            bval = node.value
        else:
            kids[rest_old[0]] = Leaf(rest_old[1:], node.value)
        bval, kids = _place_new(key[cp:], new, bval, kids)
        return _prefix(key[:cp], Branch(tuple(kids), bval))
    if isinstance(node, Extension):
        cp = node.key.common_prefix_len(key)
        if cp == len(node.key):
            return Extension(node.key, _insert_node(node.child, key[cp:], new))
        kids = [EMPTY] * 16
        rest_old = node.key[cp:]
        kids[rest_old[0]] = _reattach(rest_old[1:], node.child)
        bval, kids = _place_new(key[cp:], new, b"", kids)
        return _prefix(key[:cp], Branch(tuple(kids), bval))
    if isinstance(node, Branch):
        if len(key) == 0:
            if isinstance(new, Leaf) and len(new.key) == 0:
                return Branch(node.children, new.value)
            raise ValueError("cannot place non-value node at branch point")
        i = key[0]
        kids = list(node.children)
        kids[i] = _insert_node(kids[i], key[1:], new)
        return Branch(tuple(kids), node.value)
    raise TypeError(node)


def _place_new(rest: Nibbles, new: Node, bval: bytes, kids: List[Node]):
    if len(rest) == 0:
        if not isinstance(new, Leaf):
            raise ValueError("cannot place hash at branch value slot")
        return new.value, kids
    kids[rest[0]] = _attach(rest[1:], new)
    return bval, kids


def _attach(key: Nibbles, new: Node) -> Node:
    """Place `new` at depth `key` under nothing (build Leaf/Ext as needed)."""
    if isinstance(new, Leaf):
        return Leaf(key + new.key, new.value)
    if len(key) == 0:
        return new
    return Extension(key, new)


def _reattach(key: Nibbles, tail: Node) -> Node:
    if isinstance(tail, Leaf):
        return Leaf(key + tail.key, tail.value)
    if isinstance(tail, Extension):
        return Extension(key + tail.key, tail.child) if len(key) else tail
    if len(key) == 0:
        return tail
    return Extension(key, tail)


def _prefix(key: Nibbles, node: Node) -> Node:
    if len(key) == 0:
        return node
    if isinstance(node, Extension):
        return Extension(key + node.key, node.child)
    if isinstance(node, Leaf):
        return Leaf(key + node.key, node.value)
    return Extension(key, node)


def _delete(node: Node, key: Nibbles) -> Node:
    if isinstance(node, (Empty, Hash)):
        return node  # absent (or unresolvable) — no-op like mpt_trie
    if isinstance(node, Leaf):
        return EMPTY if node.key == key else node
    if isinstance(node, Extension):
        if not key.starts_with(node.key):
            return node
        child = _delete(node.child, key[len(node.key) :])
        if isinstance(child, Empty):
            return EMPTY
        return _collapse_ext(node.key, child)
    if isinstance(node, Branch):
        if len(key) == 0:
            node = Branch(node.children, b"")
        else:
            i = key[0]
            kids = list(node.children)
            kids[i] = _delete(kids[i], key[1:])
            node = Branch(tuple(kids), node.value)
        return _collapse_branch(node)
    raise TypeError(node)


def _collapse_ext(key: Nibbles, child: Node) -> Node:
    if isinstance(child, Leaf):
        return Leaf(key + child.key, child.value)
    if isinstance(child, Extension):
        return Extension(key + child.key, child.child)
    return Extension(key, child)


def _collapse_branch(node: Branch) -> Node:
    live = [(i, c) for i, c in enumerate(node.children) if not isinstance(c, Empty)]
    if node.value:
        if not live:
            return Leaf(Nibbles(), node.value)
        return node
    if len(live) == 0:
        return EMPTY
    if len(live) == 1:
        i, c = live[0]
        return _collapse_ext(Nibbles((i,)), c)
    return node


# -- RLP / hashing -----------------------------------------------------------


def _node_rlp(node: Node) -> rlp.Item:
    if isinstance(node, Empty):
        return b""
    if isinstance(node, Hash):
        return node.h
    if isinstance(node, Leaf):
        return [node.key.to_hex_prefix(True), node.value]
    if isinstance(node, Extension):
        return [node.key.to_hex_prefix(False), _node_ref(node.child)]
    if isinstance(node, Branch):
        return [_node_ref(c) for c in node.children] + [node.value]
    raise TypeError(node)


def _node_rlp_encoded(node: Node) -> bytes:
    return rlp.encode(_node_rlp(node))


def _node_ref(node: Node) -> rlp.Item:
    """Child reference: inline if encoded < 32 bytes, else keccak hash."""
    if isinstance(node, Empty):
        return b""
    if isinstance(node, Hash):
        return node.h
    enc = _node_rlp_encoded(node)
    if len(enc) < 32:
        return _node_rlp(node)
    return keccak256(enc)


# -- subset trimming ---------------------------------------------------------


def _trim(node: Node, keys: List[Nibbles]) -> Node:
    if isinstance(node, (Empty, Hash, Leaf)):
        return node if _any_relevant(node, keys) else _to_hash(node)
    if isinstance(node, Extension):
        sub_keys = [k[len(node.key):] for k in keys if k.starts_with(node.key)]
        if not sub_keys:
            return _to_hash(node)
        return Extension(node.key, _trim(node.child, sub_keys))
    if isinstance(node, Branch):
        if not keys:
            return _to_hash(node)
        kids = []
        for i, c in enumerate(node.children):
            sub_keys = [k[1:] for k in keys if len(k) and k[0] == i]
            kids.append(_trim(c, sub_keys))
        return Branch(tuple(kids), node.value)
    raise TypeError(node)


def _any_relevant(node: Node, keys: List[Nibbles]) -> bool:
    if isinstance(node, (Empty, Hash)):
        return True  # nothing to save by stubbing
    if isinstance(node, Leaf):
        return any(k == node.key for k in keys)
    return bool(keys)


def _to_hash(node: Node) -> Node:
    if isinstance(node, (Empty, Hash)):
        return node
    enc = _node_rlp_encoded(node)
    if len(enc) < 32:
        return node  # embedded nodes stay inline
    return Hash(keccak256(enc))
