"""Witness data model and generation (host-side). Counterpart:
ethproof_tpu/witness/__init__.py:1 (the types, the account codec and
partial-trie reconstruction, padding, RPC gathering)."""

from . import mpt, types  # noqa: F401
from .types import BlockHashes, BlockMetadata, GenerationInputs, TrieInputs, TrieRoots  # noqa: F401
