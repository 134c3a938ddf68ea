"""Synthetic transaction witnesses, built from a seed.

The JAX package has no counterpart module: its tests build the CPU tier's
witnesses by hand (tests/test_transfer_e2e.py:67, `make_transfer_witness`;
tests/test_contract_call.py:39, `make_erc20_witness`).
- `small_transfer` is the first with its defaults; `seeded_transfer` is a
  mainnet-shaped EIP-1559 transfer over a seeded state trie. Both are
  `GenerationInputs` of one 21000-gas transfer, with the post-state root
  computed from the same accounts.
- `small_erc20_transfer` is the second with its keywords;
  `seeded_erc20_transfer` is an EIP-1559 call of `transfer(to, amount)` on
  the token contract `evm.erc20.transfer_runtime()` over a seeded state
  trie and a seeded token storage trie. Their post-state and receipts
  roots are computed from the accounts, the balance slots and the
  receipt, not by the prover.
- The recursion ladder's fixtures: `transfer_chain(n_txs)` is
  tests/test_succinct_block.py:73-118 (`make_transfer_chain`),
  `noop_dummy(n_txs)` the no-op padding dummy at that chain's post state
  (tests/test_succinct_dummy.py:29-52), and `withdrawal_dummy(withdrawals,
  tamper_root)` tests/test_dummy_proofs.py:72-94 (`make_dummy`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..evm import erc20
from ..evm.secp256k1 import N
from ..evm.tx import private_key_to_address, sign_eip1559_tx, sign_legacy_tx
from ..hash.keccak import keccak256
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from .mpt import EMPTY_CODE_HASH, decode_account, encode_account
from ..trie import rlp
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


# -- ERC-20 transfers -------------------------------------------------------------

TOKEN = b"\xee" * 20  # the token's address in the small witness
ERC20_GAS_LIMIT = 100000


def _slot_key(slot: int) -> Nibbles:
    return Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big")))


def _slot_value(v: int) -> bytes:
    """Storage leaf value: RLP of the minimal big-endian integer."""
    return rlp.encode(rlp.int_to_bytes(v))


def _bloom(entries) -> bytes:
    """2048-bit logs bloom: three bits per entry from keccak(entry)."""
    bloom = bytearray(256)
    for e in entries:
        h = keccak256(e)
        for k in (0, 2, 4):
            bit = ((h[k] << 8) | h[k + 1]) & 2047
            bloom[255 - bit // 8] |= 1 << (bit % 8)
    return bytes(bloom)


def _account(nonce: int, balance: int, storage_root: bytes = None,
             code_hash: bytes = EMPTY_CODE_HASH) -> bytes:
    return encode_account({
        "nonce": nonce, "balance": balance,
        "storage_root": storage_root or PartialTrie().hash(), "code_hash": code_hash,
    })


def erc20_inputs(raw_tx: bytes, key: int, accounts: Accounts, token: bytes, token_nonce: int,
                 holders: Dict[int, int], recipient: bytes, amount: int, miner: bytes,
                 base_fee: int, effective_price: int, tamper_root: bool = False
                 ) -> GenerationInputs:
    """GenerationInputs of the first transaction of a block: `raw_tx`
    (signed by `key`) calls `transfer(recipient, amount)` on the token at
    `token`, whose balance slots hold `holders` (holder -> tokens). The
    state trie holds `accounts` (EOAs: address -> (nonce, balance)) and the
    token. The consensus gas comes from a run of the machine's interpreter
    on the witness; the post-state root applies the fee (the miner gets
    the tip above `base_fee`), the sender's nonce and, when the sender
    holds `amount`, the two balance slots; the receipts root holds the
    receipt with its Transfer log."""
    from ..evm.contract import consensus_gas_used

    sender = private_key_to_address(key)
    code = erc20.transfer_runtime()
    code_hash = keccak256(code + b"\0" * (len(code) % 2))
    strie = PartialTrie()
    for holder, tokens in holders.items():
        strie.insert(_slot_key(erc20.balance_slot(holder)), _slot_value(tokens))
    state = PartialTrie()
    for addr, (nonce, balance) in accounts.items():
        state.insert(Nibbles.from_bytes(keccak256(addr)), _account(nonce, balance))
    state.insert(Nibbles.from_bytes(keccak256(token)),
                 _account(token_nonce, 0, strie.hash(), code_hash))
    meta = BlockMetadata(block_beneficiary=miner, block_chain_id=1, block_base_fee=base_fee)

    def inputs(gas_used: int, roots: TrieRoots) -> GenerationInputs:
        return GenerationInputs(
            txn_number_before=0, gas_used_before=0, gas_used_after=gas_used,
            signed_txn=raw_tx,
            tries=TrieInputs(state_trie=state, receipts_trie=PartialTrie(),
                             storage_tries=[(keccak256(token), strie)]),
            trie_roots_after=roots, checkpoint_state_trie_root=state.hash(),
            block_metadata=meta, contract_code={code_hash: code},
        )

    gas_used = consensus_gas_used(inputs(0, TrieRoots()))
    s_int, r_int = int.from_bytes(sender, "big"), int.from_bytes(recipient, "big")
    ok = holders.get(s_int, 0) >= amount
    post_strie = strie.copy()
    logs, entries = [], []
    if ok:
        post_strie.insert(_slot_key(erc20.balance_slot(s_int)),
                          _slot_value(holders[s_int] - amount))
        post_strie.insert(_slot_key(erc20.balance_slot(r_int)),
                          _slot_value(holders.get(r_int, 0) + amount
                                      - (amount if r_int == s_int else 0)))
        topics = [erc20.TRANSFER_TOPIC.to_bytes(32, "big"), s_int.to_bytes(32, "big"),
                  r_int.to_bytes(32, "big")]
        logs = [[token, topics, amount.to_bytes(32, "big")]]
        entries = [token] + topics
    receipt = rlp.encode([rlp.int_to_bytes(int(ok)), rlp.int_to_bytes(gas_used),
                          _bloom(entries), logs])
    tx_type = raw_tx[0] if raw_tx[0] < 0x7F else 0
    receipts = PartialTrie()
    receipts.insert(Nibbles.from_bytes(rlp.encode(rlp.int_to_bytes(0))),
                    (bytes([tx_type]) + receipt) if tx_type else receipt)
    post = state.copy()
    nonce, balance = accounts[sender]
    post.insert(Nibbles.from_bytes(keccak256(sender)),
                _account(nonce + 1, balance - effective_price * gas_used))
    post.insert(Nibbles.from_bytes(keccak256(token)),
                _account(token_nonce, 0, post_strie.hash(), code_hash))
    m_nonce, m_balance = accounts.get(miner, (0, 0))
    post.insert(Nibbles.from_bytes(keccak256(miner)),
                _account(m_nonce, m_balance + (effective_price - base_fee) * gas_used))
    root = keccak256(b"wrong") if tamper_root else post.hash()
    return inputs(gas_used, TrieRoots(state_root=root, receipts_root=receipts.hash()))


def small_erc20_transfer(amount: int = 30, sender_tokens: int = 100, bob_tokens: int = 5,
                         tamper_root: bool = False, gas_price: int = 0) -> GenerationInputs:
    """The CPU tier's ERC-20 call (the keywords of
    tests/test_contract_call.py:39): the sender (4, 50 wei) sends `amount`
    of its `sender_tokens` to bob (`bob_tokens`) in a legacy transaction;
    the miner holds 7 wei. `tamper_root` replaces the post-state root."""
    sender = private_key_to_address(SMALL_KEY)
    bob, miner = b"\xbb" * 20, b"\xcc" * 20
    calldata = erc20.transfer_calldata(int.from_bytes(bob, "big"), amount)
    raw = sign_legacy_tx(4, gas_price, ERC20_GAS_LIMIT, TOKEN, 0, calldata, SMALL_KEY,
                         chain_id=1)
    holders = {int.from_bytes(sender, "big"): sender_tokens, int.from_bytes(bob, "big"): bob_tokens}
    return erc20_inputs(raw, SMALL_KEY, {sender: (4, 50), miner: (0, 7)}, TOKEN, 1, holders,
                        bob, amount, miner, 0, gas_price, tamper_root)


def seeded_erc20_transfer(n_accounts: int = 1000, n_holders: int = 1000, seed: int = 5,
                          tamper_root: bool = False) -> GenerationInputs:
    """An EIP-1559 token transfer (base fee about 12 gwei, priority fee 2
    gwei) from a seeded key to another holder, over a seeded state trie of
    `n_accounts` accounts (the sender, the token, the miner and other
    EOAs) and a token storage trie of `n_holders` balance slots (the
    sender and the recipient among them). `tamper_root` replaces the
    post-state root."""
    rng = np.random.default_rng(seed)
    key = int.from_bytes(rng.bytes(32), "big") % (N - 1) + 1
    sender = private_key_to_address(key)
    accounts = {sender: (int(rng.integers(0, 1000)), 10**18 + int(rng.integers(0, 10**18)))}
    token = rng.bytes(20)
    miner = rng.bytes(20)
    accounts[miner] = (int(rng.integers(0, 1000)), int(rng.integers(0, 10**18)) * 100)
    while len(accounts) < n_accounts - 1:
        accounts[rng.bytes(20)] = (int(rng.integers(0, 1000)), int(rng.integers(0, 10**18)) * 100)
    holders = {int.from_bytes(sender, "big"): 10**24 + int(rng.integers(0, 10**18))}
    while len(holders) < n_holders:
        holders[int.from_bytes(rng.bytes(20), "big")] = int(rng.integers(1, 10**18)) * 10**6
    recipient = list(holders)[1].to_bytes(20, "big")
    amount = 10**21 + int(rng.integers(0, 10**18))
    base_fee = 12 * 10**9 + int(rng.integers(0, 10**9))
    priority, max_fee = 2 * 10**9, 40 * 10**9
    calldata = erc20.transfer_calldata(int.from_bytes(recipient, "big"), amount)
    raw = sign_eip1559_tx(1, accounts[sender][0], priority, max_fee, ERC20_GAS_LIMIT, token, 0,
                          calldata, key)
    return erc20_inputs(raw, key, accounts, token, 1, holders, recipient, amount, miner,
                        base_fee, min(max_fee, base_fee + priority), tamper_root)


def _acct_key(addr: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr))


def _plain_account(nonce: int, balance: int) -> bytes:
    return encode_account({"nonce": nonce, "balance": balance,
                           "storage_root": PartialTrie().hash(), "code_hash": EMPTY_CODE_HASH})


def _chain(n_txs: int) -> Tuple[List[GenerationInputs], PartialTrie]:
    """`transfer_chain`'s witnesses and the state after its last one."""
    sender = private_key_to_address(SMALL_KEY)
    recipient, miner = b"\xbb" * 20, b"\xcc" * 20
    state = PartialTrie()
    # all balances stay < 2^6: the transfer kernel range-checks values
    # against the arithmetic table (the fixture's arithmetic size is 2^6)
    sender_bal, recv_bal, nonce = 40, 10, 4
    state.insert(_acct_key(sender), _plain_account(nonce, sender_bal))
    state.insert(_acct_key(recipient), _plain_account(0, recv_bal))
    state.insert(_acct_key(miner), _plain_account(0, 7))
    gis, gas = [], 0
    for i in range(n_txs):
        value = 3 + i
        raw = sign_legacy_tx(nonce, 0, GAS, recipient, value, b"", SMALL_KEY, chain_id=1)
        post = state.copy()
        sender_bal -= value
        recv_bal += value
        nonce += 1
        post.insert(_acct_key(sender), _plain_account(nonce, sender_bal))
        post.insert(_acct_key(recipient), _plain_account(0, recv_bal))
        gis.append(GenerationInputs(
            txn_number_before=i, gas_used_before=gas, gas_used_after=gas + GAS,
            signed_txn=raw, tries=TrieInputs(state_trie=state.copy()),
            trie_roots_after=TrieRoots(state_root=post.hash()),
            checkpoint_state_trie_root=state.hash(),
            block_metadata=BlockMetadata(block_beneficiary=miner, block_chain_id=1,
                                         block_base_fee=0),
        ))
        gas += GAS
        state = post
    return gis, state


def transfer_chain(n_txs: int = 2) -> List[GenerationInputs]:
    """A block of `n_txs` chained zero-fee legacy transfers from one
    sender (tests/test_succinct_block.py:73-118): txn numbers, gas counters
    and state roots are continuous across the seams (what the agg circuit
    proves)."""
    return _chain(n_txs)[0]


def noop_dummy(n_txs: int = 2) -> GenerationInputs:
    """The no-op padding dummy that follows `transfer_chain(n_txs)`: its
    state is the chain's post state, its gas flat
    (tests/test_succinct_dummy.py:29-52)."""
    gis, state = _chain(n_txs)
    last = gis[-1]
    return GenerationInputs(
        txn_number_before=n_txs, gas_used_before=last.gas_used_after,
        gas_used_after=last.gas_used_after, signed_txn=None,
        tries=TrieInputs(state_trie=state.copy()),
        trie_roots_after=TrieRoots(state_root=state.hash()),
        checkpoint_state_trie_root=gis[0].tries.state_trie.hash(),
        block_metadata=last.block_metadata,
    )


def withdrawal_dummy(withdrawals: Sequence[Tuple[bytes, int]] = (),
                     tamper_root: bool = False) -> GenerationInputs:
    """A padding dummy over a three-account state that credits
    `withdrawals` ((address, amount) pairs) in its post state
    (tests/test_dummy_proofs.py:72-94); `tamper_root` claims a wrong post
    state root."""
    state = PartialTrie()
    for addr, nonce, bal in ((b"\xaa" * 20, 4, 100), (b"\xbb" * 20, 0, 30),
                             (b"\xcc" * 20, 1, 7)):
        state.insert(_acct_key(addr), _plain_account(nonce, bal))
    post = state.copy()
    for addr, amt in withdrawals:
        acc = decode_account(post.get(_acct_key(addr)))
        acc["balance"] += amt
        post.insert(_acct_key(addr), encode_account(acc))
    root_after = keccak256(b"bad") if tamper_root else post.hash()
    return GenerationInputs(
        txn_number_before=2, gas_used_before=50000, gas_used_after=50000, signed_txn=None,
        tries=TrieInputs(state_trie=state), trie_roots_after=TrieRoots(state_root=root_after),
        checkpoint_state_trie_root=state.hash(), block_metadata=BlockMetadata(block_chain_id=1),
        withdrawals=list(withdrawals),
    )
