"""Witness gathering, partial-trie reconstruction and padding: the port vs
the JAX package.

Both packages' `gather_witness` run against tests/test_witness.py's fake
RPC chains (`FakeRpc`, `FakeRpc2Tx`, `FakeRpcTyped`; no network) and give
equal `witness_to_json`. `Mpt`, `has_storage_deletion`, `apply_diffs` and
`trim` give equal tries on the same proof nodes and diff (storage slots
updated, deleted and added, an account deleted and one created with code).
Padding of 0, 1 and 1-with-withdrawals payloads gives equal witnesses.
"""

import json

import pytest
import torch

from ethproof_tpu.hash.keccak import keccak256
from ethproof_tpu.trie import rlp as jrlp
from ethproof_tpu.trie.nibbles import Nibbles as JNibbles
from ethproof_tpu.trie.trie import PartialTrie as JPartialTrie
from ethproof_tpu.witness import gather as jgather
from ethproof_tpu.witness import mpt as jmpt
from ethproof_tpu.witness import padding as jpad
from ethproof_tpu.witness import types as jtypes
from ethproof_tpu_torch.trie.nibbles import Nibbles as TNibbles
from ethproof_tpu_torch.trie.trie import PartialTrie as TPartialTrie
from ethproof_tpu_torch.witness import gather as tgather
from ethproof_tpu_torch.witness import mpt as tmpt
from ethproof_tpu_torch.witness import padding as tpad
from ethproof_tpu_torch.witness import synthetic
from ethproof_tpu_torch.witness import types as ttypes
from test_witness import FakeRpc, FakeRpc2Tx, FakeRpcTyped

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

A = "0x" + "aa" * 20
B = "0x" + "bb" * 20
C = "0x" + "c0" * 20
D = "0x" + "dd" * 20
SLOTS = {"0x1": 5, "0x2": 7, "0x3": 0x1234}


@pytest.mark.parametrize("fake", [FakeRpc, FakeRpc2Tx, FakeRpcTyped])
def test_gather_witness_equals_reference(fake):
    chain = fake()
    tx_hash = chain.tx2_hash if fake is FakeRpc2Tx else chain.tx_hash
    want = jgather.gather_witness(
        tx_hash, jgather.RpcClient("fake://", transport=chain.transport))
    got = tgather.gather_witness(
        tx_hash, tgather.RpcClient("fake://", transport=chain.transport))
    assert json.dumps(ttypes.witness_to_json(got)) == json.dumps(jtypes.witness_to_json(want))
    assert len(got) == 2


def test_rpc_client_reports_rpc_errors():
    client = tgather.RpcClient("fake://", transport=lambda p: {"error": {"code": -32000}})
    with pytest.raises(RuntimeError, match="rpc error on eth_chainId"):
        client.chain_id()
    bloom = bytes(range(256))
    assert tgather.convert_bloom(bloom) == jgather.convert_bloom(bloom)
    receipt = FakeRpcTyped()._eth_getTransactionReceipt("0x")
    receipt["logs"] = [{"address": B, "topics": ["0x" + "11" * 32], "data": "0x0102"}]
    assert tgather._encode_receipt(receipt) == jgather._encode_receipt(receipt)


def _slot_key(slot):
    return JNibbles.from_bytes(keccak256(bytes.fromhex(slot[2:].rjust(64, "0"))))


def _acct_key(addr):
    return JNibbles.from_bytes(keccak256(bytes.fromhex(addr[2:])))


def _reference_state():
    """(state, storage) tries in the reference's types: A with three
    storage slots, B and C plain."""
    storage = JPartialTrie()
    for slot, v in SLOTS.items():
        storage.insert(_slot_key(slot), jrlp.encode(jrlp.int_to_bytes(v)))
    state = JPartialTrie()
    for addr, (nonce, bal, sroot) in {A: (4, 10**18, storage.hash()), B: (0, 5, None),
                                      C: (1, 9, None)}.items():
        state.insert(_acct_key(addr), jmpt.encode_account({
            "nonce": nonce, "balance": bal,
            "storage_root": sroot or JPartialTrie().hash(), "code_hash": jmpt.EMPTY_CODE_HASH}))
    return state, {keccak256(bytes.fromhex(A[2:])): storage}


DIFF = {
    "pre": {A: {"balance": hex(10**18), "nonce": 4, "storage": {"0x1": "0x5", "0x2": "0x7"}},
            B: {"balance": "0x5"}, C: {"balance": "0x9", "nonce": 1}},
    "post": {A: {"balance": hex(10**18 - 99), "nonce": 5,
                 "storage": {"0x1": "0x9", "0x4": "0x44"}},
             B: {"balance": "0x68"},
             D: {"balance": "0x1", "code": "0x6001600055", "storage": {"0x1": "0x1"}}},
}


def _tries_json(state, storage, types):
    return json.dumps([types.trie_to_json(state.root),
                       sorted((k.hex(), types.trie_to_json(t.root)) for k, t in storage.items())])


def test_mpt_apply_diffs_and_trim_equal_reference():
    state, storage = _reference_state()
    # Mpt: the proof nodes of every account (and slot), re-rooted
    j_mpt, t_mpt = jmpt.Mpt(), tmpt.Mpt()
    j_smpt, t_smpt = jmpt.Mpt(), tmpt.Mpt()
    for addr in (A, B, C):
        for m in (j_mpt, t_mpt):
            m.insert_proof(state.prove(_acct_key(addr)))
    (a_storage,) = storage.values()
    for slot in SLOTS:
        for m in (j_smpt, t_smpt):
            m.insert_proof(a_storage.prove(_slot_key(slot)))
    for m, root in ((j_mpt, state.hash()), (t_mpt, state.hash()),
                    (j_smpt, a_storage.hash()), (t_smpt, a_storage.hash())):
        m.root = root
    assert t_mpt.nodes == j_mpt.nodes and t_smpt.nodes == j_smpt.nodes
    j_state, t_state = j_mpt.to_partial_trie(), t_mpt.to_partial_trie()
    assert t_state.hash() == j_state.hash() == state.hash()
    assert (json.dumps(ttypes.trie_to_json(t_state.root))
            == json.dumps(jtypes.trie_to_json(j_state.root)))
    t_storage = {k: t_smpt.to_partial_trie() for k in storage}
    j_storage = {k: j_smpt.to_partial_trie() for k in storage}
    empty = tmpt.Mpt()
    empty.root = TPartialTrie().hash()
    assert empty.to_partial_trie().hash() == TPartialTrie().hash()

    assert tmpt.has_storage_deletion(DIFF) is jmpt.has_storage_deletion(DIFF) is True
    no_deletion = {"pre": {B: {"balance": "0x5"}}, "post": {B: {"balance": "0x6"}}}
    assert tmpt.has_storage_deletion(no_deletion) is jmpt.has_storage_deletion(no_deletion) is False

    j_code, t_code = {}, {}
    j_next = jmpt.apply_diffs(j_state, j_storage, j_code, DIFF)
    t_next = tmpt.apply_diffs(t_state, t_storage, t_code, DIFF)
    assert _tries_json(*t_next, ttypes) == _tries_json(*j_next, jtypes)
    assert t_code == j_code and len(t_code) == 1
    assert t_state.hash() == state.hash()  # the inputs are not mutated

    touched = {A: {"storage": {"0x1": "0x5"}}, B: {}}
    for deletion in (False, True):
        got = tmpt.trim(t_state, t_storage, touched, deletion)
        want = jmpt.trim(j_state, j_storage, touched, deletion)
        assert _tries_json(*got, ttypes) == _tries_json(*want, jtypes)
        assert got[0].hash() == state.hash()


def _padding_case(n_payloads, withdrawals):
    """Both packages' padded payload lists for a block of `n_payloads`
    transfers (0 or 1), with `withdrawals` credited on the last one."""
    out = []
    for pkg, types, trie_cls, nibbles in ((jpad, jtypes, JPartialTrie, JNibbles),
                                          (tpad, ttypes, TPartialTrie, TNibbles)):
        gis = [types.GenerationInputs.from_json(synthetic.small_transfer().to_json())
               for _ in range(n_payloads)]
        if gis:
            initial = trie_cls(gis[0].tries.state_trie.root)
            final = trie_cls(gis[0].tries.state_trie.root)
            for addr, _ in withdrawals:  # the targets exist in the final state
                key = nibbles.from_bytes(keccak256(addr))
                if final.get(key) is None:
                    final.insert(key, jmpt.encode_account({
                        "nonce": 0, "balance": 3, "storage_root": JPartialTrie().hash(),
                        "code_hash": jmpt.EMPTY_CODE_HASH}))
        else:
            initial = final = trie_cls()
            if withdrawals:
                return None
        last = gis[-1] if gis else None
        initial_extra = pkg.ExtraBlockData(checkpoint_state_trie_root=initial.hash())
        final_extra = pkg.ExtraBlockData(
            checkpoint_state_trie_root=initial.hash(),
            txn_number_before=1 if last else 0, txn_number_after=1 if last else 0,
            gas_used_before=last.gas_used_after if last else 0,
            gas_used_after=last.gas_used_after if last else 0)
        meta = gis[0].block_metadata if gis else types.BlockMetadata()
        hashes = gis[0].block_hashes if gis else types.BlockHashes()
        final_tries = pkg.PartialTrieState(state=final)
        pkg.pad_gen_inputs_with_dummy_inputs_if_needed(
            gis, meta, hashes, final_extra, initial_extra,
            pkg.PartialTrieState(state=initial), final_tries, bool(withdrawals))
        pkg.add_withdrawals_to_txns(gis, final_tries, list(withdrawals))
        out.append(json.dumps(types.witness_to_json(gis)))
    return out


@pytest.mark.parametrize("n_payloads,withdrawals", [
    (0, []), (1, []), (1, [(b"\xbb" * 20, 11), (b"\x99" * 20, 5)])],
    ids=["empty_block", "one_tx", "one_tx_with_withdrawals"])
def test_padding_equals_reference(n_payloads, withdrawals):
    want, got = _padding_case(n_payloads, withdrawals)
    assert got == want
    gis = ttypes.witness_from_json(json.loads(got))
    assert len(gis) == 2
    dummies = [gi for gi in gis if gi.signed_txn is None]
    assert len(dummies) == 2 - n_payloads
    if n_payloads == 1:
        # the dummy goes in front, or after the tx when there are withdrawals
        assert (gis[0].signed_txn is None) == (not withdrawals)
        assert gis[-1].withdrawals == withdrawals
    for gi in dummies:
        assert gi.tries.state_trie.hash() == gi.trie_roots_after.state_root or gi.withdrawals
