"""Dummy-payload padding and withdrawal attachment.

Counterpart: ethproof_tpu/witness/padding.py:1 (a copy). Aggregation needs
>= 2 leaves (the aggregation monoid has no identity), so:

- 0 txs -> two dummies over the final tries
- 1 tx, no withdrawals -> dummy PREPENDED over the initial tries
- 1 tx, withdrawals -> dummy APPENDED over the final tries

Withdrawals always land on the LAST payload, crediting balances in the
final state trie and updating its trie_roots_after.state_root. Dummy
tries are fully-hashed-out subsets (just the root hash).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from ..hash.keccak import keccak256
from ..trie import rlp
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from .types import BlockHashes, BlockMetadata, GenerationInputs, TrieInputs, TrieRoots


@dataclass
class PartialTrieState:
    """The tries of one point of a block: state, txn, receipt, storage."""

    state: PartialTrie = field(default_factory=PartialTrie)
    txn: PartialTrie = field(default_factory=PartialTrie)
    receipt: PartialTrie = field(default_factory=PartialTrie)
    storage: Dict[bytes, PartialTrie] = field(default_factory=dict)


@dataclass
class ExtraBlockData:
    checkpoint_state_trie_root: bytes = b"\x00" * 32
    txn_number_before: int = 0
    txn_number_after: int = 0
    gas_used_before: int = 0
    gas_used_after: int = 0


def fully_hashed_out(trie: PartialTrie) -> PartialTrie:
    """Subset over no keys: a single Hash (or inline) root stub."""
    return trie.subset([])


def create_dummy_gen_input(
    b_meta: BlockMetadata,
    b_hashes: BlockHashes,
    extra: ExtraBlockData,
    tries: PartialTrieState,
) -> GenerationInputs:
    assert extra.txn_number_before == extra.txn_number_after
    assert extra.gas_used_before == extra.gas_used_after
    sub = TrieInputs(
        state_trie=fully_hashed_out(tries.state),
        transactions_trie=fully_hashed_out(tries.txn),
        receipts_trie=fully_hashed_out(tries.receipt),
        storage_tries=[
            (addr, fully_hashed_out(st)) for addr, st in tries.storage.items()
        ],
    )
    roots = TrieRoots(
        state_root=sub.state_trie.hash(),
        transactions_root=sub.transactions_trie.hash(),
        receipts_root=sub.receipts_trie.hash(),
    )
    return GenerationInputs(
        signed_txn=None,
        tries=sub,
        trie_roots_after=roots,
        checkpoint_state_trie_root=extra.checkpoint_state_trie_root,
        block_metadata=b_meta,
        block_hashes=b_hashes,
        txn_number_before=extra.txn_number_before,
        gas_used_before=extra.gas_used_before,
        gas_used_after=extra.gas_used_after,
        contract_code={},
        withdrawals=[],
    )


def pad_gen_inputs_with_dummy_inputs_if_needed(
    gen_inputs: List[GenerationInputs],
    b_meta: BlockMetadata,
    b_hashes: BlockHashes,
    final_extra: ExtraBlockData,
    initial_extra: ExtraBlockData,
    initial_tries: PartialTrieState,
    final_tries: PartialTrieState,
    has_withdrawals: bool,
) -> None:
    if len(gen_inputs) == 0:
        gen_inputs.extend(
            [
                create_dummy_gen_input(b_meta, b_hashes, final_extra, final_tries),
                create_dummy_gen_input(b_meta, b_hashes, final_extra, final_tries),
            ]
        )
    elif len(gen_inputs) == 1:
        if not has_withdrawals:
            gen_inputs.insert(
                0, create_dummy_gen_input(b_meta, b_hashes, initial_extra, initial_tries)
            )
        else:
            gen_inputs.append(
                create_dummy_gen_input(b_meta, b_hashes, final_extra, final_tries)
            )


def decode_account_rlp(data: bytes) -> Tuple[int, int, bytes, bytes]:
    """-> (nonce, balance, storage_root, code_hash)."""
    items = rlp.decode(data)
    return (
        rlp.bytes_to_int(items[0]),
        rlp.bytes_to_int(items[1]),
        items[2],
        items[3],
    )


def encode_account_rlp(nonce: int, balance: int, storage_root: bytes, code_hash: bytes) -> bytes:
    return rlp.encode(
        [rlp.int_to_bytes(nonce), rlp.int_to_bytes(balance), storage_root, code_hash]
    )


def add_withdrawals_to_txns(
    txn_ir: List[GenerationInputs],
    final_trie_state: PartialTrieState,
    withdrawals: List[Tuple[bytes, int]],
) -> None:
    if not withdrawals:
        return
    for addr, amt in withdrawals:
        h_addr = keccak256(addr)
        key = Nibbles.from_bytes(h_addr)
        acc = final_trie_state.state.get(key)
        assert acc is not None, "withdrawal target missing from state trie"
        nonce, balance, sroot, chash = decode_account_rlp(acc)
        final_trie_state.state.insert(
            key, encode_account_rlp(nonce, balance + amt, sroot, chash)
        )
    last = txn_ir[-1]
    last.withdrawals = list(withdrawals)
    last.trie_roots_after.state_root = final_trie_state.state.hash()
