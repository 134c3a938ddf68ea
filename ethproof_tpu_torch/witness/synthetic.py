"""Synthetic value-transfer witnesses, built from a seed.

The JAX package has no counterpart module: its tests build the CPU tier's
transfer by hand (tests/test_transfer_e2e.py:67, `make_transfer_witness`).
`small_transfer` is that witness with its defaults; `seeded_transfer` is a
mainnet-shaped EIP-1559 transfer over a seeded state trie. Both are
`GenerationInputs` of one 21000-gas transfer, with the post-state root
computed from the same accounts.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..evm.secp256k1 import N
from ..evm.tx import private_key_to_address, sign_eip1559_tx, sign_legacy_tx
from ..hash.keccak import keccak256
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from .mpt import EMPTY_CODE_HASH, encode_account
from .types import BlockMetadata, GenerationInputs, TrieInputs, TrieRoots

GAS = 21000  # intrinsic gas of an empty-data transfer
# the private key of tests/test_transfer_e2e.py:49
SMALL_KEY = 0x1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF1234567890ABCDEF

Accounts = Dict[bytes, Tuple[int, int]]  # address -> (nonce, balance)


def _state_trie(accounts: Accounts) -> PartialTrie:
    trie = PartialTrie()
    for addr, (nonce, balance) in accounts.items():
        trie.insert(Nibbles.from_bytes(keccak256(addr)), encode_account({
            "nonce": nonce, "balance": balance,
            "storage_root": PartialTrie().hash(), "code_hash": EMPTY_CODE_HASH,
        }))
    return trie


def transfer_inputs(raw_tx: bytes, pre: Accounts, post: Accounts, miner: bytes,
                    base_fee: int) -> GenerationInputs:
    """GenerationInputs of the first transfer of a block: the state trie
    holds `pre`, the post-state root is that of `post`."""
    state = _state_trie(pre)
    return GenerationInputs(
        txn_number_before=0, gas_used_before=0, gas_used_after=GAS, signed_txn=raw_tx,
        tries=TrieInputs(state_trie=state),
        trie_roots_after=TrieRoots(state_root=_state_trie(post).hash()),
        checkpoint_state_trie_root=state.hash(),
        block_metadata=BlockMetadata(block_beneficiary=miner, block_chain_id=1,
                                     block_base_fee=base_fee),
    )


def small_transfer(recipient_post_extra: int = 0, *, sender_bal: int = 40, gas_price: int = 0,
                   recipient_is_sender: bool = False, miner_is_sender: bool = False,
                   miner_is_recipient: bool = False) -> GenerationInputs:
    """The CPU tier's transfer: a legacy transfer of 3 wei from a 40-wei
    sender at gas price 0 (values this small fit the 2^6-row range tables).
    `recipient_post_extra` credits the recipient that many more wei in the
    post state (a tampered post root). The keywords are those of
    tests/test_transfer_e2e.py:67: the sender's balance, the gas price, and
    the parties' overlap (the recipient or the miner is the sender, or the
    miner is the recipient)."""
    sender = private_key_to_address(SMALL_KEY)
    recipient = sender if recipient_is_sender else b"\xbb" * 20
    miner = sender if miner_is_sender else recipient if miner_is_recipient else b"\xcc" * 20
    raw = sign_legacy_tx(4, gas_price, GAS, recipient, 3, b"", SMALL_KEY, chain_id=1)
    pre = {sender: (4, sender_bal)}
    pre.setdefault(recipient, (0, 30))
    pre.setdefault(miner, (0, 7))
    balance = {addr: bal for addr, (_, bal) in pre.items()}
    balance[sender] -= 3 + gas_price * GAS
    balance[recipient] += 3 + recipient_post_extra
    balance[miner] += gas_price * GAS
    post = {addr: (nonce + (addr == sender), balance[addr]) for addr, (nonce, _) in pre.items()}
    return transfer_inputs(raw, pre, post, miner, 0)


def seeded_transfer(n_accounts: int, seed: int) -> GenerationInputs:
    """An EIP-1559 transfer of about 1 ether (base fee about 12 gwei,
    priority fee 2 gwei) from a seeded key to another account of a seeded
    state trie of `n_accounts` accounts; the block's miner is a third."""
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    sender = private_key_to_address(key)
    pre = {sender: (int(rng.integers(0, 1000)), 5 * 10**18 + int(rng.integers(0, 10**18)))}
    while len(pre) < n_accounts:
        pre[rng.bytes(20)] = (int(rng.integers(0, 1000)), int(rng.integers(0, 10**18)) * 100)
    recipient, miner = list(pre)[1:3]
    base_fee = 12 * 10**9 + int(rng.integers(0, 10**9))
    priority, max_fee = 2 * 10**9, 40 * 10**9
    value = 10**18 + int(rng.integers(0, 10**17))
    effective = min(max_fee, base_fee + priority)
    fee, tip = effective * GAS, (effective - base_fee) * GAS
    raw = sign_eip1559_tx(1, pre[sender][0], priority, max_fee, GAS, recipient, value, b"", key)
    post = dict(pre)
    post[sender] = (pre[sender][0] + 1, pre[sender][1] - value - fee)
    post[recipient] = (pre[recipient][0], pre[recipient][1] + value)
    post[miner] = (pre[miner][0], pre[miner][1] + tip)
    return transfer_inputs(raw, pre, post, miner, base_fee)
