"""Merkle-Patricia trie layer (host-side). Counterpart: ethproof_tpu/trie/__init__.py:1."""

from . import nibbles, rlp, trie  # noqa: F401
from .trie import EMPTY_TRIE_HASH, PartialTrie  # noqa: F401
