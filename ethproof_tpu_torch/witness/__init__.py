"""Witness data model (host-side). Counterpart: ethproof_tpu/witness/__init__.py:1
(the types and the account codec; RPC gathering is not ported)."""

from . import mpt, types  # noqa: F401
from .types import BlockHashes, BlockMetadata, GenerationInputs, TrieInputs, TrieRoots  # noqa: F401
