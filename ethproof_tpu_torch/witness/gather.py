"""Witness generation from a live Ethereum JSON-RPC node.

Counterpart: ethproof_tpu/witness/gather.py:52-432 (a copy: `RpcClient`
with its `transport=` seam, `convert_bloom`, `get_block_metadata`,
`get_block_hashes`, `_encode_receipt`, `gather_witness`), itself the
upstream leader's `gather_witness` and RPC client (leader/src/lib.rs:
158-535, rpc.rs). Workflow:

1. fetch target tx + enclosing block + chain id
2. prestate-trace every tx up to and including the target; merge touched
   accounts/slots (lib.rs:189-232)
3. eth_getProof for every touched account at block N-1 AND N; absorb the
   RLP nodes into hash-keyed pools (lib.rs:234-271)
4. diff-trace every tx and absorb pre+post proof nodes (lib.rs:273-325)
5. withdrawal-address proofs (lib.rs:327-333)
6. re-root the state pool at the parent block's stateRoot (lib.rs:339)
7. block metadata (+ optional clique signer, rpc.rs:156-181) and the 256
   previous block hashes, fetched two-per-request by exploiting each
   response's parentHash (rpc.rs:63-105)
8. per tx: apply diffs, trim to the touched subset (sanity: trimmed root
   == full root, lib.rs:404), grow txn/receipt tries, emit a
   GenerationInputs; final tx takes the header's roots (lib.rs:432-444)
9. pad with dummies and attach withdrawals — including the upstream's
   Alchemy quirk of withdrawal amounts arriving in gwei (lib.rs:358)

Transport: urllib (stdlib). The transport is injectable, so tests drive
the whole pipeline against a synthetic chain with proofs generated from
the repository's own tries, and never reach a network.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Tuple

from ..hash.keccak import keccak256
from ..trie import rlp
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from . import mpt as mptmod
from .mpt import Mpt, apply_diffs, has_storage_deletion, trim
from .padding import (
    ExtraBlockData,
    PartialTrieState,
    add_withdrawals_to_txns,
    pad_gen_inputs_with_dummy_inputs_if_needed,
)
from .types import BlockHashes, BlockMetadata, GenerationInputs, TrieInputs, TrieRoots

ZERO32 = b"\x00" * 32


def _unhex(s: str) -> bytes:
    s = s[2:] if s.startswith("0x") else s
    if len(s) % 2:
        s = "0" + s
    return bytes.fromhex(s)


def _int_of(x, default=0) -> int:
    if x is None:
        return default
    if isinstance(x, int):
        return x
    return int(x, 16)


class RpcClient:
    """Minimal JSON-RPC client (the upstream rpc.rs and ethers provider
    calls). `transport(payload) -> response` replaces the HTTP POST."""

    def __init__(self, url: str, transport=None):
        self.url = url
        self._transport = transport or self._http_post

    def _http_post(self, payload: dict) -> dict:
        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def call(self, method: str, params: list):
        out = self._transport(
            {"jsonrpc": "2.0", "method": method, "params": params, "id": 1}
        )
        if "error" in out and out["error"]:
            raise RuntimeError(f"rpc error on {method}: {out['error']}")
        return out["result"]

    # -- typed helpers -------------------------------------------------------

    def chain_id(self) -> int:
        return _int_of(self.call("eth_chainId", []))

    def get_transaction(self, tx_hash: str) -> dict:
        return self.call("eth_getTransactionByHash", [tx_hash])

    def get_block(self, number: int, full: bool = False) -> dict:
        return self.call("eth_getBlockByNumber", [hex(number), full])

    def get_receipt(self, tx_hash: str) -> dict:
        return self.call("eth_getTransactionReceipt", [tx_hash])

    def get_raw_transaction(self, tx_hash: str) -> bytes:
        return _unhex(self.call("eth_getRawTransactionByHash", [tx_hash]))

    def get_proof(self, address: str, slots: List[str], number: int) -> dict:
        return self.call("eth_getProof", [address, slots, hex(number)])

    def trace_prestate(self, tx_hash: str) -> dict:
        return self.call(
            "debug_traceTransaction",
            [tx_hash, {"tracer": "prestateTracer"}],
        )

    def trace_diff(self, tx_hash: str) -> dict:
        return self.call(
            "debug_traceTransaction",
            [tx_hash, {"tracer": "prestateTracer", "tracerConfig": {"diffMode": True}}],
        )

    def clique_signer(self, block_hash: str) -> str:
        return self.call("clique_getSignersAtHash", [block_hash])


def convert_bloom(bloom: bytes) -> Tuple[int, ...]:
    """256-byte bloom -> 8 x U256 (upstream lib.rs:111-117)."""
    assert len(bloom) == 256
    return tuple(int.from_bytes(bloom[i * 32 : (i + 1) * 32], "big") for i in range(8))


def get_block_metadata(
    client: RpcClient, block_number: int, chain_id: int, clique: bool
) -> Tuple[BlockMetadata, bytes]:
    block = client.get_block(block_number)
    beneficiary = (
        _unhex(client.clique_signer(block["hash"]))
        if clique
        else _unhex(block["miner"])
    )
    meta = BlockMetadata(
        block_beneficiary=beneficiary,
        block_timestamp=_int_of(block["timestamp"]),
        block_number=block_number,
        block_difficulty=_int_of(block.get("difficulty")),
        block_gaslimit=_int_of(block["gasLimit"]),
        block_chain_id=chain_id,
        block_base_fee=_int_of(block.get("baseFeePerGas")),
        block_gas_used=_int_of(block["gasUsed"]),
        block_random=_unhex(block.get("mixHash") or "0x" + "00" * 32).rjust(32, b"\x00"),
        block_bloom=convert_bloom(_unhex(block["logsBloom"]).rjust(256, b"\x00")),
    )
    return meta, _unhex(block["stateRoot"])


def get_block_hashes(client: RpcClient, block_number: int) -> BlockHashes:
    """256 previous hashes, two per request via parentHash, the requests
    sent concurrently in order (the upstream FuturesOrdered batching,
    rpc.rs:63-105 + :84-89)."""
    cur = client.get_block(block_number)
    if block_number == 0:
        return BlockHashes([ZERO32] * 256, _unhex(cur["hash"]))
    hashes: List[bytes] = []
    start = max(block_number - 256, 0)
    hashes.extend([ZERO32] * (256 - (block_number - start)))
    from concurrent.futures import ThreadPoolExecutor

    nums = list(range(start, block_number + 1, 2))
    with ThreadPoolExecutor(max_workers=min(8, len(nums))) as pool:
        blocks = list(pool.map(client.get_block, nums))
    for blk in blocks:
        n = _int_of(blk["number"])
        if n == block_number:
            hashes.append(_unhex(blk["parentHash"]))
            continue
        if n != start:
            hashes.append(_unhex(blk["parentHash"]))
        hashes.append(_unhex(blk["hash"]))
    hashes = hashes[-256:] if block_number >= 256 else hashes[:256]
    return BlockHashes(hashes, _unhex(cur["hash"]))


def _encode_receipt(receipt: dict) -> bytes:
    """Consensus receipt encoding, typed receipts prefixed (lib.rs:417-421)."""
    status = _int_of(receipt.get("status"), 1)
    logs = [
        [
            _unhex(log["address"]),
            [_unhex(t) for t in log["topics"]],
            _unhex(log.get("data") or "0x"),
        ]
        for log in receipt.get("logs", [])
    ]
    payload = rlp.encode(
        [
            rlp.int_to_bytes(status),
            rlp.int_to_bytes(_int_of(receipt["cumulativeGasUsed"])),
            _unhex(receipt["logsBloom"]).rjust(256, b"\x00"),
            logs,
        ]
    )
    tx_type = _int_of(receipt.get("type"), 0)
    if tx_type != 0:
        payload = bytes([tx_type]) + payload
    return payload


def _merge_touched(state: Dict[str, dict], accounts: Dict[str, dict]) -> None:
    for address, account in accounts.items():
        if address in state:
            acc = dict(state[address])
            store = dict(acc.get("storage") or {})
            store.update(account.get("storage") or {})
            acc["storage"] = store or None
            state[address] = acc
        else:
            state[address] = account


def gather_witness(
    tx_hash: str, client: RpcClient, clique: bool = False
) -> List[GenerationInputs]:
    tx = client.get_transaction(tx_hash)
    block_number = _int_of(tx["blockNumber"])
    tx_index = _int_of(tx["transactionIndex"])
    block = client.get_block(block_number)
    chain_id = client.chain_id()

    state_mpt = Mpt()
    contract_codes: Dict[bytes, bytes] = {keccak256(b""): b""}
    storage_mpts: Dict[bytes, Mpt] = {}
    txn_rlps: List[bytes] = []
    txns_info: List[dict] = []
    traces: List[dict] = []
    merged: Dict[str, dict] = {}

    from concurrent.futures import ThreadPoolExecutor

    tx_hashes = block["transactions"][: tx_index + 1]
    # per-tx fetches in flight together, results consumed in tx order
    # (the upstream leader/src/rpc.rs:84-89 FuturesOrdered semantics)
    with ThreadPoolExecutor(max_workers=8) as pool:
        per_tx = list(
            pool.map(
                lambda h: (
                    client.get_transaction(h),
                    client.trace_prestate(h),
                    client.get_raw_transaction(h),
                ),
                tx_hashes,
            )
        )
    for txn, accounts, raw in per_tx:
        traces.append(accounts)
        _merge_touched(merged, accounts)
        txn_rlps.append(raw)
        txns_info.append(txn)

    # proofs at N-1 and N for all touched accounts (batched; absorbed in
    # deterministic (address, number) order)
    proof_jobs = []
    for address in sorted(merged):
        storage_keys = sorted((merged[address].get("storage") or {}).keys())
        for number in (block_number - 1, block_number):
            proof_jobs.append((address, storage_keys, number))
    with ThreadPoolExecutor(max_workers=8) as pool:
        proof_results = list(
            pool.map(lambda j: client.get_proof(j[0], j[1], j[2]), proof_jobs)
        )
    for (address, storage_keys, number), res in zip(proof_jobs, proof_results):
        account = merged[address]
        state_mpt.insert_proof([_unhex(p) for p in res["accountProof"]])
        key = keccak256(_unhex(address).rjust(20, b"\x00"))
        if account.get("storage"):
            smpt = storage_mpts.setdefault(key, Mpt())
            if number == block_number - 1:
                smpt.root = _unhex(res["storageHash"])
            for sp in res.get("storageProof", []):
                smpt.insert_proof([_unhex(p) for p in sp["proof"]])
    for address in sorted(merged):
        code = merged[address].get("code")
        if code:
            code_bytes = _unhex(code)
            contract_codes[keccak256(code_bytes)] = code_bytes

    # diff traces: absorb pre+post proofs too
    diffs: List[dict] = []
    for h in tx_hashes:
        diff = client.trace_diff(h)
        diffs.append(diff)
        for side in (diff.get("pre", {}), diff.get("post", {})):
            for address, account in side.items():
                storage_keys = sorted((account.get("storage") or {}).keys())
                for number in (block_number - 1, block_number):
                    res = client.get_proof(address, storage_keys, number)
                    state_mpt.insert_proof([_unhex(p) for p in res["accountProof"]])
                    key = keccak256(_unhex(address).rjust(20, b"\x00"))
                    if storage_keys:
                        smpt = storage_mpts.setdefault(key, Mpt())
                        for sp in res.get("storageProof", []):
                            smpt.insert_proof([_unhex(p) for p in sp["proof"]])

    # withdrawal address proofs
    wds_raw = block.get("withdrawals") or []
    for w in wds_raw:
        res = client.get_proof(w["address"], [], block_number - 1)
        state_mpt.insert_proof([_unhex(p) for p in res["accountProof"]])

    prev_block = client.get_block(block_number - 1)
    state_mpt.root = _unhex(prev_block["stateRoot"])

    block_metadata, _ = get_block_metadata(client, block_number, chain_id, clique)
    block_hashes = get_block_hashes(client, block_number)

    state_trie = state_mpt.to_partial_trie()
    storage_tries = {k: m.to_partial_trie() for k, m in storage_mpts.items()}
    txns_trie = PartialTrie()
    receipts_trie = PartialTrie()
    gas_used = 0

    # gwei quirk (lib.rs:358)
    wds = [(_unhex(w["address"]), _int_of(w["amount"]) * 1_000_000_000) for w in wds_raw]

    proof_gen_ir: List[GenerationInputs] = []
    prev_state_root = _unhex(prev_block["stateRoot"])
    num_block_txs = len(block["transactions"])
    for i, (txn, touched, signed_txn) in enumerate(zip(txns_info, traces, txn_rlps)):
        last_tx = i == num_block_txs - 1
        diff = diffs[i]
        storage_deletion = has_storage_deletion(diff)
        next_state, next_storage = apply_diffs(
            state_trie, storage_tries, contract_codes, diff
        )
        touched = dict(touched)
        if last_tx:
            for addr, _amt in wds:
                hx = "0x" + addr.hex()
                touched.setdefault(hx, {})
        trimmed_state, trimmed_storage = trim(
            state_trie, storage_tries, touched, storage_deletion
        )
        assert trimmed_state.hash() == state_trie.hash(), "trimmed root mismatch"

        receipt = client.get_receipt(txn["hash"])
        idx_key = Nibbles.from_bytes(rlp.encode(rlp.int_to_bytes(i)))
        new_txns = txns_trie.copy()
        new_txns.insert(idx_key, signed_txn)
        new_receipts = receipts_trie.copy()
        new_receipts.insert(idx_key, _encode_receipt(receipt))

        if last_tx:
            roots_after = TrieRoots(
                state_root=_unhex(block["stateRoot"]),
                transactions_root=_unhex(block["transactionsRoot"]),
                receipts_root=_unhex(block["receiptsRoot"]),
            )
        else:
            roots_after = TrieRoots(
                state_root=next_state.hash(),
                transactions_root=new_txns.hash(),
                receipts_root=new_receipts.hash(),
            )

        proof_gen_ir.append(
            GenerationInputs(
                signed_txn=signed_txn,
                tries=TrieInputs(
                    state_trie=trimmed_state,
                    transactions_trie=txns_trie.copy(),
                    receipts_trie=receipts_trie.copy(),
                    storage_tries=sorted(trimmed_storage.items()),
                ),
                withdrawals=[],
                contract_code=dict(contract_codes),
                block_metadata=block_metadata,
                block_hashes=block_hashes,
                gas_used_before=gas_used,
                gas_used_after=gas_used + _int_of(receipt["gasUsed"]),
                checkpoint_state_trie_root=prev_state_root,
                trie_roots_after=roots_after,
                txn_number_before=i,
            )
        )

        state_trie = next_state
        storage_tries = next_storage
        gas_used += _int_of(receipt["gasUsed"])
        assert gas_used == _int_of(receipt["cumulativeGasUsed"]), "gas cross-check"
        txns_trie = new_txns
        receipts_trie = new_receipts

    initial_tries = (
        PartialTrieState(
            state=proof_gen_ir[0].tries.state_trie,
            txn=proof_gen_ir[0].tries.transactions_trie,
            receipt=proof_gen_ir[0].tries.receipts_trie,
            storage=dict(proof_gen_ir[0].tries.storage_tries),
        )
        if proof_gen_ir
        else PartialTrieState(
            state=PartialTrie(mptmod.Hash(_unhex(block["stateRoot"]))),
        )
    )
    final_tries = PartialTrieState(
        state=state_trie, txn=txns_trie, receipt=receipts_trie, storage=storage_tries
    )
    initial_extra = ExtraBlockData(checkpoint_state_trie_root=prev_state_root)
    if proof_gen_ir:
        last = proof_gen_ir[-1]
        final_extra = ExtraBlockData(
            checkpoint_state_trie_root=prev_state_root,
            txn_number_before=last.txn_number_before,
            txn_number_after=last.txn_number_before,
            gas_used_before=last.gas_used_after,
            gas_used_after=last.gas_used_after,
        )
    else:
        final_extra = initial_extra

    pad_gen_inputs_with_dummy_inputs_if_needed(
        proof_gen_ir,
        block_metadata,
        block_hashes,
        final_extra,
        initial_extra,
        initial_tries,
        final_tries,
        bool(wds),
    )
    add_withdrawals_to_txns(proof_gen_ir, final_tries, wds)
    return proof_gen_ir
