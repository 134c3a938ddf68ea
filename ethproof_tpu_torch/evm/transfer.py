"""The transfer kernel: proving a value-transfer GenerationInputs.

Counterpart: ethproof_tpu/evm/transfer.py:1 (`derive_pi_words`,
`pi_bindings_for_overlap`, `build_kernel`, `transfer_cpu_stark`,
`prove_transfer`, `verify_transfer`, `check_trie_binding`,
`_binding_finals`, `TxProof`), with the reference's binding modes.

Soundness layering: the STARK proves the account-state ARITHMETIC
(nonce/balance/fee transition) against public inputs, and — when a
`binding_shape` is set (the default for witnesses inside the envelope) —
the state-root transition itself: the kernel hashes the touched MPT path
nodes through the KeccakSponge CTL and verifies containment/transition
in-circuit (evm/binding.py), making PI_STATE_ROOT_PRE/POST STARK-verified
(seven tables). `check_trie_binding` remains as host-side defense in depth
and as the fallback for witnesses outside the binding envelope
(trie-restructuring updates, absent accounts) or sizes without the Keccak
pair (five tables). Account IDENTITY (path == keccak(address)) is
host-checked via `derive_pi_words` re-derivation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from ..fri.config import StarkConfig
from ..hash.keccak import keccak256
from ..runtime.prover_state import CircuitConfig
from ..stark.multi import MultiProof
from ..tables.all import (
    CircuitSizeError,
    TableSizes,
    kernel_counts,
    prove_all_tables,
    verify_all_tables,
)
from ..tables.cpu import CpuStark
from ..trie.nibbles import Nibbles
from ..trie.trie import PartialTrie
from ..witness.mpt import EMPTY_CODE_HASH, decode_account, encode_account
from ..witness.types import GenerationInputs
from .binding import (
    PRODUCTION_SHAPE,
    BindingWitness,
    KernelShape,
    PiBinding,
    Unsupported,
    build_binding_witness,
    emit_binding,
    region_words_needed,
)
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
# state roots (LE-packed 32-byte keccak roots); with in-circuit binding
# these are STARK-verified against the witness tries (evm/binding.py)
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


def pi_bindings_for_overlap(overlap: str) -> List[PiBinding]:
    """Distinct touched accounts in sequential application order, with
    each one's PI binding (evm/binding.py). Overlapped roles collapse to
    the primary account — the transfer kernel's duplication asserts keep
    all role PI words consistent with the single trie update."""
    sender = PiBinding(
        bal_pre_pi=PI_SENDER_BAL_PRE,
        bal_post_pi=PI_SENDER_BAL_POST,
        nonce_pre_pi=PI_SENDER_NONCE_PRE,
        nonce_post_pi=PI_SENDER_NONCE_POST,
    )
    recv = PiBinding(bal_pre_pi=PI_RECV_BAL_PRE, bal_post_pi=PI_RECV_BAL_POST)
    miner = PiBinding(bal_pre_pi=PI_MINER_BAL_PRE, bal_post_pi=PI_MINER_BAL_POST)
    return {
        OVERLAP_DISTINCT: [sender, recv, miner],
        OVERLAP_S_EQ_R: [sender, miner],
        OVERLAP_S_EQ_M: [sender, recv],
        OVERLAP_R_EQ_M: [sender, recv],
        OVERLAP_ALL: [sender],
    }[overlap]


def build_kernel(
    overlap: str = OVERLAP_DISTINCT,
    shape: Optional[KernelShape] = None,
    pi_words: Optional[List[int]] = None,
    bw: Optional[BindingWitness] = None,
) -> KAsm:
    """The per-transaction kernel: transfer arithmetic plus (with `shape`)
    the in-circuit MPT binding section. pi_words=None builds the
    program-only (verifier) form; the instruction stream is a pure
    function of (overlap, shape).

    EVM semantics: deduct value+fee from the sender (with sufficiency
    checks), credit value to the recipient, credit fee to the miner —
    sequentially, so overlapping parties see earlier credits. The PI
    convention for overlapped roles: their pre/post words duplicate the
    single underlying account's values, and the kernel asserts the
    duplication."""
    bindings = pi_bindings_for_overlap(overlap)
    rw = region_words_needed(shape, len(bindings)) if shape is not None else 0
    e = KAsm(concrete=pi_words is not None, region_words=rw)
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

    if shape is not None:
        emit_binding(
            e, shape, bindings, PI_STATE_ROOT_PRE, PI_STATE_ROOT_POST, bw, pi_words
        )
    e.finalize_ts()
    return e


def transfer_cpu_stark(
    overlap: str = OVERLAP_DISTINCT, shape: Optional[KernelShape] = None
) -> CpuStark:
    return CpuStark(build_kernel(overlap, shape).prog, NUM_PI_WORDS)


def _acct_key(addr: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr))


@dataclass
class TxProof:
    """A per-transaction proof: the multi-proof plus the statement it
    proves (PI words and the witness for the host checks)."""

    multi: Optional[MultiProof]
    pi_words: List[int]
    gen_inputs: GenerationInputs
    sender: bytes
    recipient: bytes
    miner: bytes
    # set when the proof's kernel includes the in-circuit MPT binding
    # section; part of the statement (the verifier rebuilds the program
    # from (overlap, binding_shape))
    binding_shape: Optional[KernelShape] = None
    # with recursion enabled, the succinct machine proof of the tx root
    # circuit (recursion/root.py); `multi` is then None (subsumed)
    root_proof: Optional[object] = None  # recursion.wrap.MachineProof

    @property
    def overlap(self) -> str:
        return overlap_pattern(self.sender, self.recipient, self.miner)


def _empty_account() -> dict:
    return {
        "nonce": 0,
        "balance": 0,
        "storage_root": PartialTrie().hash(),
        "code_hash": EMPTY_CODE_HASH,
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


def _binding_finals(gi, pi, sender: bytes, recipient: bytes, miner: bytes):
    """(key, nonce_post, balance_post) per DISTINCT account, in the same
    sequential order as pi_bindings_for_overlap."""
    finals = [(sender, pi[PI_SENDER_NONCE_POST], pi[PI_SENDER_BAL_POST])]
    if recipient != sender:
        finals.append((recipient, _nonce_of(gi, recipient), pi[PI_RECV_BAL_POST]))
    if miner != sender and miner != recipient:
        finals.append((miner, _nonce_of(gi, miner), pi[PI_MINER_BAL_POST]))
    return [(_acct_key(a), n, b) for a, n, b in finals]


def prove_transfer(
    gi: GenerationInputs,
    config: StarkConfig,
    sizes: Union[TableSizes, CircuitConfig, None] = None,
    binding: object = "auto",
    device=None,
    phase_times: Optional[Dict[str, Dict[str, float]]] = None,
) -> TxProof:
    """Prove one transfer on `device` (None: the CUDA card).

    sizes: explicit TableSizes, a CircuitConfig (per-proof fit within its
    ranges), or None for the test-tier defaults.

    binding: "auto" (in-circuit MPT binding when the witness fits the
    envelope and the keccak pair is enabled; silent host-checked
    fallback otherwise), None (host-checked only), a KernelShape
    (required — Unsupported propagates), or "require".

    `phase_times`: see `tables.all.prove_all_tables`; its "host" entry
    also receives the seconds of the binding witness and of the kernel's
    assembly."""
    host: Dict[str, float] = {}
    pi, sender, recipient, miner = derive_pi_words(gi)
    overlap = overlap_pattern(sender, recipient, miner)

    shape: Optional[KernelShape] = None
    if isinstance(binding, KernelShape):
        shape, required = binding, True
    elif binding == "require":
        shape, required = PRODUCTION_SHAPE, True
    elif binding == "auto":
        shape, required = PRODUCTION_SHAPE, False
    elif binding is None:
        shape, required = None, False
    else:
        raise ValueError(f"bad binding mode {binding!r}")
    explicit_no_keccak = isinstance(sizes, TableSizes) and sizes.keccak is None
    if explicit_no_keccak and shape is not None:
        assert not required, "in-circuit binding needs the keccak table pair"
        shape = None
    if (
        shape is not None
        and not required
        and (sizes is None or isinstance(sizes, TableSizes))
    ):
        # cheap pre-guard: the smallest bound kernel needs ~2^11 cpu rows;
        # don't build one just to discover the configured sizes can't fit
        cpu_log = sizes.cpu if isinstance(sizes, TableSizes) else TableSizes().cpu
        if (1 << cpu_log) < 2048:
            shape = None

    t0 = time.perf_counter()
    bw = None
    if shape is not None:
        try:
            bw = build_binding_witness(
                gi.tries.state_trie,
                _binding_finals(gi, pi, sender, recipient, miner),
                shape,
            )
        except Unsupported:
            if required:
                raise
            shape = None
    host["binding_witness"] = time.perf_counter() - t0

    def build(s, w):
        kasm = build_kernel(overlap, s, pi, w)
        counts = kernel_counts(kasm.prog, kasm.hash_requests())
        if isinstance(sizes, CircuitConfig):
            return kasm, TableSizes.fit(sizes, counts)
        fitted = sizes if sizes is not None else TableSizes()
        checked = ["cpu", "arithmetic", "logic", "bytepacking", "memory"]
        if s is not None and fitted.keccak is not None:
            checked += ["keccak", "keccak_sponge"]
        for name in checked:
            log = getattr(fitted, name)
            if counts[name] > (1 << log):
                raise CircuitSizeError(f"{name} needs {counts[name]} rows > 2^{log}")
        return kasm, fitted

    t0 = time.perf_counter()
    try:
        kasm, fitted = build(shape if bw else None, bw)
    except CircuitSizeError:
        # auto mode: the bound kernel outgrows the configured sizes —
        # fall back to the host-checked binding
        if required or bw is None:
            raise
        shape = bw = None
        kasm, fitted = build(None, None)
    host["kernel"] = time.perf_counter() - t0

    if phase_times is not None:
        phase_times["host"] = host
    multi, _ = prove_all_tables(
        CpuStark(kasm.prog, NUM_PI_WORDS), pi, fitted, config,
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
        binding_shape=shape if bw else None,
    )


def verify_transfer(
    proof: TxProof, config: StarkConfig, device=None, skip_stark: bool = False
) -> bool:
    """PI re-derivation + the multi-table STARK + the host trie binding.
    `device` is where the tables' fixed-column caps are committed.
    skip_stark=True checks only the host-side layers (PI re-derivation +
    trie binding) — used when a succinct block proof covers the STARK layer
    once for all transactions (runtime/ops.verify_block)."""
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
    #    from the statement (overlap pattern + binding shape); with a
    #    binding shape the STARK itself verifies the state-root
    #    transition against the PI roots
    if not skip_stark:
        if proof.multi is None:
            return False
        if proof.binding_shape is not None and not isinstance(proof.binding_shape, KernelShape):
            return False
        cpu = transfer_cpu_stark(overlap_pattern(sender, recipient, miner), proof.binding_shape)
        if not verify_all_tables(cpu, proof.pi_words, proof.multi, config, device):
            return False
    # 3. trie binding: PI words produce the claimed post state root
    return check_trie_binding(proof)
