"""The transfer kernel: proving a value-transfer GenerationInputs.

Counterpart: ethproof_tpu/evm/transfer.py:1 (`derive_pi_words`,
`build_kernel`, `prove_transfer`, `verify_transfer`, `check_trie_binding`,
`TxProof`), in its host-checked binding form: `binding=None` with
`sizes.keccak is None`, the five-table proof. The STARK proves the
account-state arithmetic (nonce/balance/fee transition) against public
inputs; the state-root transition is checked on the host
(`check_trie_binding`), and account identity (path == keccak(address)) by
re-deriving the public inputs (`derive_pi_words`). The in-circuit MPT
binding (`evm/binding.py`, the Keccak/KeccakSponge pair) comes with the
seven-table transfer: any other `binding` raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..fri.config import StarkConfig
from ..hash.keccak import keccak256
from ..stark.multi import MultiProof
from ..tables.all import (
    TABLE_NAMES,
    CircuitSizeError,
    TableSizes,
    kernel_counts,
    prove_all_tables,
    verify_all_tables,
)
from ..tables.cpu import CpuStark
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from ..witness.mpt import decode_account, encode_account
from ..witness.types import GenerationInputs
from .gas import intrinsic_gas
from .kasm import KAsm, le_word
from .tx import decode_tx

# public-input word layout
PI_SENDER_NONCE_PRE = 0
PI_SENDER_BAL_PRE = 1
PI_RECV_BAL_PRE = 2
PI_MINER_BAL_PRE = 3
PI_VALUE = 4
PI_FEE = 5
PI_SENDER_NONCE_POST = 6
PI_SENDER_BAL_POST = 7
PI_RECV_BAL_POST = 8
PI_MINER_BAL_POST = 9
# state roots (LE-packed 32-byte keccak roots), host-checked here
PI_STATE_ROOT_PRE = 10
PI_STATE_ROOT_POST = 11
# EIP-1559 fee split: the sender pays FEE = effective_gas_price * gas;
# the miner receives TIP = (effective_gas_price - base_fee) * gas; the
# difference is burned. Pre-London witnesses (base_fee = 0) have
# TIP == FEE. The kernel asserts TIP <= FEE; the verifier re-derives
# both from the tx + block metadata (derive_pi_words).
PI_TIP = 12
NUM_PI_WORDS = 13


# party-overlap patterns: (sender==recipient, sender==miner, recipient==miner)
OVERLAP_DISTINCT = "distinct"
OVERLAP_S_EQ_R = "s_eq_r"  # self-transfer, distinct miner
OVERLAP_S_EQ_M = "s_eq_m"  # miner pays itself fee back
OVERLAP_R_EQ_M = "r_eq_m"  # send to the miner
OVERLAP_ALL = "all_eq"  # self-transfer mined by self


def overlap_pattern(sender: bytes, recipient: bytes, miner: bytes) -> str:
    if sender == recipient == miner:
        return OVERLAP_ALL
    if sender == recipient:
        return OVERLAP_S_EQ_R
    if sender == miner:
        return OVERLAP_S_EQ_M
    if recipient == miner:
        return OVERLAP_R_EQ_M
    return OVERLAP_DISTINCT


def build_kernel(overlap: str = OVERLAP_DISTINCT, pi_words: Optional[List[int]] = None) -> KAsm:
    """The per-transaction kernel (transfer arithmetic). pi_words=None
    builds the program-only (verifier) form; the instruction stream is a
    pure function of `overlap`.

    EVM semantics: deduct value+fee from the sender (with sufficiency
    checks), credit value to the recipient, credit fee to the miner —
    sequentially, so overlapping parties see earlier credits. The PI
    convention for overlapped roles: their pre/post words duplicate the
    single underlying account's values, and the kernel asserts the
    duplication."""
    e = KAsm(concrete=pi_words is not None)
    pv = pi_words if pi_words is not None else [None] * NUM_PI_WORDS

    s_nonce = e.load_pi(PI_SENDER_NONCE_PRE, pv[PI_SENDER_NONCE_PRE])
    s_bal = e.load_pi(PI_SENDER_BAL_PRE, pv[PI_SENDER_BAL_PRE])
    r_bal = e.load_pi(PI_RECV_BAL_PRE, pv[PI_RECV_BAL_PRE])
    m_bal = e.load_pi(PI_MINER_BAL_PRE, pv[PI_MINER_BAL_PRE])
    value = e.load_pi(PI_VALUE, pv[PI_VALUE])
    fee = e.load_pi(PI_FEE, pv[PI_FEE])
    tip = e.load_pi(PI_TIP, pv[PI_TIP])
    one = e.const(1)
    nonce_post = e.add(s_nonce, one)
    e.assert0(e.lt(s_bal, value))  # bal >= value
    after_value = e.sub(s_bal, value)
    e.assert0(e.lt(after_value, fee))  # bal - value >= fee
    e.assert0(e.lt(fee, tip))  # tip <= fee (the rest is burned)
    deducted = e.sub(after_value, fee)  # sender after full deduction

    if overlap == OVERLAP_DISTINCT:
        s_post = deducted
        r_post = e.add(r_bal, value)
        m_post = e.add(m_bal, tip)
    elif overlap == OVERLAP_S_EQ_R:
        e.assert_eq(r_bal, s_bal)  # duplicated pre word
        s_post = e.add(deducted, value)
        r_post = s_post
        m_post = e.add(m_bal, tip)
    elif overlap == OVERLAP_S_EQ_M:
        e.assert_eq(m_bal, s_bal)
        s_post = e.add(deducted, tip)
        r_post = e.add(r_bal, value)
        m_post = s_post
    elif overlap == OVERLAP_R_EQ_M:
        e.assert_eq(m_bal, r_bal)
        s_post = deducted
        r_post = e.add(e.add(r_bal, value), tip)
        m_post = r_post
    elif overlap == OVERLAP_ALL:
        e.assert_eq(r_bal, s_bal)
        e.assert_eq(m_bal, s_bal)
        s_post = e.add(e.add(deducted, value), tip)
        r_post = s_post
        m_post = s_post
    else:
        raise ValueError(f"unknown overlap pattern {overlap}")

    e.assert_eq(e.load_pi(PI_SENDER_NONCE_POST, pv[PI_SENDER_NONCE_POST]), nonce_post)
    e.assert_eq(e.load_pi(PI_SENDER_BAL_POST, pv[PI_SENDER_BAL_POST]), s_post)
    e.assert_eq(e.load_pi(PI_RECV_BAL_POST, pv[PI_RECV_BAL_POST]), r_post)
    e.assert_eq(e.load_pi(PI_MINER_BAL_POST, pv[PI_MINER_BAL_POST]), m_post)
    e.finalize_ts()
    return e


def transfer_cpu_stark(overlap: str = OVERLAP_DISTINCT) -> CpuStark:
    return CpuStark(build_kernel(overlap).prog, NUM_PI_WORDS)


def _acct_key(addr: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr))


@dataclass
class TxProof:
    """A per-transaction proof: the five-table multi-proof plus the
    statement it proves (PI words and the witness for the host checks)."""

    multi: Optional[MultiProof]
    pi_words: List[int]
    gen_inputs: GenerationInputs
    sender: bytes
    recipient: bytes
    miner: bytes

    @property
    def overlap(self) -> str:
        return overlap_pattern(self.sender, self.recipient, self.miner)


def _empty_account() -> dict:
    return {
        "nonce": 0,
        "balance": 0,
        "storage_root": PartialTrie().hash(),
        "code_hash": keccak256(b""),
    }


def derive_pi_words(gi: GenerationInputs) -> Tuple[List[int], bytes, bytes, bytes]:
    """-> (pi_words, sender, recipient, miner). Raises on non-transfers.

    Overlapping parties follow sequential EVM semantics: deduct
    value+fee from the sender, credit value to the recipient, credit fee
    to the miner — later credits see earlier ones. Overlapped roles'
    PI words duplicate the single account's values (kernel-asserted)."""
    assert gi.signed_txn is not None, "dummy payloads have no kernel run"
    tx = decode_tx(gi.signed_txn)
    assert len(tx.to) == 20, "contract creation is not a transfer"
    # EIP-155/2930/1559: a replay-protected tx must target this chain
    assert tx.chain_id in (None, gi.block_metadata.block_chain_id), (
        f"tx chain id {tx.chain_id} != block chain id "
        f"{gi.block_metadata.block_chain_id}"
    )
    sender = tx.sender()
    recipient = tx.to
    miner = gi.block_metadata.block_beneficiary
    state = gi.tries.state_trie

    def acct(addr: bytes) -> dict:
        raw = state.get(_acct_key(addr))
        return decode_account(raw) if raw is not None else _empty_account()

    s_acc = decode_account(state.get(_acct_key(sender)))
    gas_used = gi.gas_used_after - gi.gas_used_before
    # consensus: an EOA transfer runs no code — gas is exactly intrinsic
    assert gas_used == intrinsic_gas(tx), (
        f"transfer gas_used {gas_used} != intrinsic {intrinsic_gas(tx)}"
    )
    base_fee = gi.block_metadata.block_base_fee
    fee = tx.effective_gas_price(base_fee) * gas_used
    tip = tx.miner_tip_per_gas(base_fee) * gas_used
    assert tx.nonce == s_acc["nonce"], "tx nonce mismatch"

    balances = {sender: s_acc["balance"]}
    balances.setdefault(recipient, acct(recipient)["balance"])
    balances.setdefault(miner, acct(miner)["balance"])
    pi = [0] * NUM_PI_WORDS
    pi[PI_SENDER_NONCE_PRE] = s_acc["nonce"]
    pi[PI_SENDER_BAL_PRE] = balances[sender]
    pi[PI_RECV_BAL_PRE] = balances[recipient]
    pi[PI_MINER_BAL_PRE] = balances[miner]
    pi[PI_VALUE] = tx.value
    pi[PI_FEE] = fee
    pi[PI_TIP] = tip
    assert balances[sender] >= tx.value + fee, "insufficient balance"
    balances[sender] -= tx.value + fee
    balances[recipient] += tx.value
    balances[miner] += tip
    pi[PI_SENDER_NONCE_POST] = s_acc["nonce"] + 1
    pi[PI_SENDER_BAL_POST] = balances[sender]
    pi[PI_RECV_BAL_POST] = balances[recipient]
    pi[PI_MINER_BAL_POST] = balances[miner]
    pi[PI_STATE_ROOT_PRE] = le_word(state.hash())
    pi[PI_STATE_ROOT_POST] = le_word(gi.trie_roots_after.state_root)
    return pi, sender, recipient, miner


def check_trie_binding(proof: TxProof) -> bool:
    """Re-derive the post state root from the witness tries + PI words."""
    gi = proof.gen_inputs
    state = gi.tries.state_trie.copy()
    # the first payload of a block must root at the parent/checkpoint state
    if gi.txn_number_before == 0 and state.hash() != gi.checkpoint_state_trie_root:
        return False
    pi = proof.pi_words

    def upsert(addr: bytes, nonce: int, balance: int) -> None:
        key = _acct_key(addr)
        raw = state.get(key)
        acc = _empty_account() if raw is None else decode_account(raw)
        acc["nonce"], acc["balance"] = nonce, balance
        state.insert(key, encode_account(acc))

    # one upsert per DISTINCT account; overlapped roles' PI words are
    # kernel-asserted duplicates of the primary role's values
    finals = {proof.sender: (pi[PI_SENDER_NONCE_POST], pi[PI_SENDER_BAL_POST])}
    if proof.recipient not in finals:
        finals[proof.recipient] = (_nonce_of(gi, proof.recipient), pi[PI_RECV_BAL_POST])
    if proof.miner not in finals:
        finals[proof.miner] = (_nonce_of(gi, proof.miner), pi[PI_MINER_BAL_POST])
    for addr, (nonce, balance) in finals.items():
        upsert(addr, nonce, balance)
    return state.hash() == gi.trie_roots_after.state_root


def _nonce_of(gi: GenerationInputs, addr: bytes) -> int:
    raw = gi.tries.state_trie.get(_acct_key(addr))
    return decode_account(raw)["nonce"] if raw is not None else 0


def prove_transfer(
    gi: GenerationInputs,
    config: StarkConfig,
    sizes: Optional[TableSizes] = None,
    binding: object = None,
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxProof:
    """Prove one transfer on `device` (None: the CUDA card).

    sizes: explicit TableSizes with keccak=None (None: the test-tier
    defaults, without the keccak pair). binding: only None (host-checked
    trie binding). `phase_times`: see `tables.all.prove_all_tables`."""
    if binding is not None:
        raise NotImplementedError(
            f"binding={binding!r}: in-circuit trie binding comes with the seven-table "
            "transfer; only binding=None (host-checked) is ported"
        )
    if sizes is None:
        sizes = TableSizes(keccak=None)
    if not isinstance(sizes, TableSizes):
        raise NotImplementedError(
            f"sizes={type(sizes).__name__}: only explicit TableSizes are ported"
        )
    if sizes.keccak is not None:
        raise NotImplementedError(
            "sizes.keccak must be None: the Keccak/KeccakSponge pair comes with the "
            "seven-table transfer"
        )

    pi, sender, recipient, miner = derive_pi_words(gi)
    kasm = build_kernel(overlap_pattern(sender, recipient, miner), pi)
    counts = kernel_counts(kasm.prog, kasm.hash_requests())
    for name in TABLE_NAMES:
        log = getattr(sizes, name)
        if counts[name] > (1 << log):
            raise CircuitSizeError(f"{name} needs {counts[name]} rows > 2^{log}")

    multi, _ = prove_all_tables(
        CpuStark(kasm.prog, NUM_PI_WORDS), pi, sizes, config,
        hash_requests=kasm.hash_requests(), kernel_witness=kasm.witness,
        device=device, phase_times=phase_times,
    )
    return TxProof(
        multi=multi,
        pi_words=pi,
        gen_inputs=gi,
        sender=sender,
        recipient=recipient,
        miner=miner,
    )


def verify_transfer(proof: TxProof, config: StarkConfig, device=None) -> bool:
    """PI re-derivation + the five-table STARK + the host trie binding.
    `device` is where the tables' fixed-column caps are committed."""
    # 1. public inputs must re-derive from the witness (sender recovery,
    #    fee computation, pre-state reads)
    try:
        pi, sender, recipient, miner = derive_pi_words(proof.gen_inputs)
    except (AssertionError, NotImplementedError, ValueError):
        return False
    if pi != proof.pi_words or sender != proof.sender:
        return False
    if recipient != proof.recipient or miner != proof.miner:
        return False
    # 2. the STARK proof of the kernel execution — the program is rebuilt
    #    from the statement (the overlap pattern)
    if proof.multi is None:
        return False
    cpu = transfer_cpu_stark(overlap_pattern(sender, recipient, miner))
    if not verify_all_tables(cpu, proof.pi_words, proof.multi, config, device):
        return False
    # 3. trie binding: PI words produce the claimed post state root
    return check_trie_binding(proof)
