"""Contract-call in-circuit state binding: the storage-slot chain and
the account updates run in a kasm kernel next to the EVM machine proof.

Counterpart: ethproof_tpu/evm/cbinding.py:1 (a copy).

Reference equivalent: evm_arithmetization proves the whole state-root
transition inside one proof (its kernel walks/updates both the storage
tries and the state trie in kernel memory; public values carry the trie
roots — ops/src/lib.rs:52). This re-design splits the
statement in two STARK multi-proofs that the verifier cross-checks on
shared public-input words:

  machine proof (tables/evm.py)  — "code C on calldata D yields storage
      journal J, logs, gas, success S";
  binding proof (this module)    — "applying the changed slots of J to
      the callee's storage trie and the (sender, callee, miner) account
      updates to the state trie turns state_root_pre into
      state_root_post".

The binding kernel's public inputs embed the machine's changed-slot
values verbatim, so the verifier's cross-check is pure word equality
(expected_cb_pi below re-derives every word from the witness + machine
PI). Slot/account IDENTITY (path == keccak(key/address)) stays
host-checked — the same documented tier as the transfer kernel's
binding (evm/binding.py module docstring); the post state root is
consensus-anchored, which pins the content of every proven update.

Envelope (Unsupported -> host-checked fallback, evm/contract.py):
distinct (sender, callee, miner); all touched accounts and slots exist
pre-state; no slot insert/delete (vpre != 0 and vpost != 0 for changed
slots); same-shape trie updates; path depth/node size within
KernelShape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..hash.keccak import keccak256
from ..trie.nibbles import Nibbles
from ..witness.mpt import decode_account
from ..witness.types import GenerationInputs
from .binding import (
    BindingEmitter,
    KernelShape,
    PiBinding,
    UpdateWitness,
    Unsupported,
    build_slot_update_witness,
    build_update_witness,
    region_words_needed,
)
from .kasm import KAsm, le_word

# -- public-input word layout (the binding kernel's own statement) ------------

CB_STATE_ROOT_PRE = 0
CB_STATE_ROOT_POST = 1
CB_SROOT_PRE = 2  # callee storage root before (LE-packed 32B)
CB_SROOT_POST = 3
CB_SENDER_NONCE_PRE = 4
CB_SENDER_NONCE_POST = 5
CB_SENDER_BAL_PRE = 6
CB_SENDER_BAL_POST = 7
CB_CALLEE_BAL_PRE = 8
CB_CALLEE_BAL_POST = 9
CB_MINER_BAL_PRE = 10
CB_MINER_BAL_POST = 11
CB_VALUE = 12
CB_FEE = 13  # sender-side: effective_gas_price * gas_used
CB_TIP = 14  # miner-side: (effective - base_fee) * gas_used
CB_SUCCESS = 15
CB_SLOTS = 16  # then per changed slot: (VPRE, VPOST)


def cb_num_pi_words(n_slots: int) -> int:
    return CB_SLOTS + 2 * n_slots


@dataclass
class CBindingWitness:
    """Prover-side witness: slot updates (storage trie, in key order)
    then account updates (state trie: sender, callee, miner)."""

    slots: List[UpdateWitness]
    accounts: List[UpdateWitness]


def _acct_key(addr: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr))


def _slot_key(slot: int) -> Nibbles:
    return Nibbles.from_bytes(keccak256(slot.to_bytes(32, "big")))


def changed_slots(machine_pi: List[int], mshape) -> List[Tuple[int, int, int]]:
    """(key, vpre, vpost) for journal entries the frame actually changed,
    in the machine's (ascending-key) order. Empty for reverted frames."""
    lay = mshape.pi_layout
    if not machine_pi[lay["success"]]:
        return []
    out = []
    for i in range(mshape.n_skeys):
        k = machine_pi[lay["storage"] + 4 * i]
        vpre = machine_pi[lay["storage"] + 4 * i + 2]
        vpost = machine_pi[lay["storage"] + 4 * i + 3]
        if vpre != vpost:
            out.append((k, vpre, vpost))
    return out


def expected_cb_pi(
    gi: GenerationInputs,
    machine_pi: List[int],
    mshape,
    sender: bytes,
    to: bytes,
    miner: bytes,
    gas_used: int,
) -> List[int]:
    """Re-derive the binding kernel's PI words from the witness + the
    machine's PI (pure function — the verifier's cross-check)."""
    from .tx import decode_tx

    tx = decode_tx(gi.signed_txn)
    base_fee = gi.block_metadata.block_base_fee
    fee = tx.effective_gas_price(base_fee) * gas_used
    tip = tx.miner_tip_per_gas(base_fee) * gas_used
    success = int(machine_pi[mshape.pi_layout["success"]])
    state = gi.tries.state_trie

    def bal(addr: bytes) -> int:
        raw = state.get(_acct_key(addr))
        if raw is None:
            raise Unsupported("account missing from the witness state trie")
        return decode_account(raw)["balance"]

    s_acc = decode_account(state.get(_acct_key(sender)))
    c_acc = decode_account(state.get(_acct_key(to)))
    slots = changed_slots(machine_pi, mshape)
    # the post storage root: apply changed slots to the witness trie
    for h, strie in gi.tries.storage_tries:
        if h == keccak256(to):
            break
    else:
        strie = None
    sroot_pre = c_acc["storage_root"]
    if slots:
        if strie is None:
            raise Unsupported("storage trie missing from the witness")
        st = strie.copy()
        from .binding import encode_slot_value

        for k, _vpre, vpost in slots:
            if vpost == 0:
                raise Unsupported("slot deletion restructures the trie")
            st.insert(_slot_key(k), encode_slot_value(vpost))
        sroot_post = st.hash()
    else:
        sroot_post = sroot_pre
    eff_value = tx.value if success else 0
    pi = [0] * cb_num_pi_words(len(slots))
    pi[CB_STATE_ROOT_PRE] = le_word(state.hash())
    pi[CB_STATE_ROOT_POST] = le_word(gi.trie_roots_after.state_root)
    pi[CB_SROOT_PRE] = le_word(sroot_pre)
    pi[CB_SROOT_POST] = le_word(sroot_post)
    pi[CB_SENDER_NONCE_PRE] = s_acc["nonce"]
    pi[CB_SENDER_NONCE_POST] = s_acc["nonce"] + 1
    pi[CB_SENDER_BAL_PRE] = s_acc["balance"]
    pi[CB_SENDER_BAL_POST] = s_acc["balance"] - eff_value - fee
    pi[CB_CALLEE_BAL_PRE] = c_acc["balance"]
    pi[CB_CALLEE_BAL_POST] = c_acc["balance"] + eff_value
    pi[CB_MINER_BAL_PRE] = bal(miner)
    pi[CB_MINER_BAL_POST] = bal(miner) + tip
    pi[CB_VALUE] = tx.value
    pi[CB_FEE] = fee
    pi[CB_TIP] = tip
    pi[CB_SUCCESS] = success
    for i, (_k, vpre, vpost) in enumerate(slots):
        pi[CB_SLOTS + 2 * i] = vpre
        pi[CB_SLOTS + 2 * i + 1] = vpost
    return pi


def build_contract_binding_witness(
    gi: GenerationInputs,
    machine_pi: List[int],
    mshape,
    sender: bytes,
    to: bytes,
    miner: bytes,
    pi: List[int],
    kshape: KernelShape,
) -> CBindingWitness:
    """Walk + apply every update in kernel order. Raises Unsupported when
    the witness falls outside the in-circuit envelope."""
    if sender == to or miner in (sender, to):
        raise Unsupported("overlapping parties (host-checked fallback)")
    slots = changed_slots(machine_pi, mshape)
    slot_updates: List[UpdateWitness] = []
    if slots:
        for h, strie in gi.tries.storage_tries:
            if h == keccak256(to):
                break
        else:
            raise Unsupported("storage trie missing from the witness")
        st = strie
        for k, _vpre, vpost in slots:
            uw, st = build_slot_update_witness(st, _slot_key(k), vpost, kshape)
            slot_updates.append(uw)
    accounts: List[UpdateWitness] = []
    trie = gi.tries.state_trie
    uw, trie = build_update_witness(
        trie, _acct_key(sender),
        pi[CB_SENDER_NONCE_POST], pi[CB_SENDER_BAL_POST], kshape,
    )
    accounts.append(uw)
    c_nonce = decode_account(gi.tries.state_trie.get(_acct_key(to)))["nonce"]
    sroot_post = pi[CB_SROOT_POST].to_bytes(32, "little")
    uw, trie = build_update_witness(
        trie, _acct_key(to), c_nonce, pi[CB_CALLEE_BAL_POST], kshape,
        storage_root=sroot_post,
    )
    accounts.append(uw)
    m_nonce_raw = gi.tries.state_trie.get(_acct_key(miner))
    if m_nonce_raw is None:
        raise Unsupported("miner account missing pre-state")
    m_nonce = decode_account(m_nonce_raw)["nonce"]
    uw, trie = build_update_witness(
        trie, _acct_key(miner), m_nonce, pi[CB_MINER_BAL_POST], kshape
    )
    accounts.append(uw)
    if trie.hash() != gi.trie_roots_after.state_root:
        raise Unsupported("post state root mismatch (witness inconsistent)")
    return CBindingWitness(slots=slot_updates, accounts=accounts)


def build_contract_kernel(
    n_slots: int,
    kshape: KernelShape,
    pi_words: Optional[List[int]] = None,
    bw: Optional[CBindingWitness] = None,
) -> KAsm:
    """The contract-call binding kernel. The instruction stream is a pure
    function of (n_slots, kshape) — the statement the verifier rebuilds.
    pi_words/bw None -> program-only (verifier) form."""
    rw = region_words_needed(kshape, n_slots + 3)
    k = KAsm(concrete=pi_words is not None, region_words=rw)
    em = BindingEmitter(k, kshape)
    pv = pi_words if pi_words is not None else [None] * cb_num_pi_words(n_slots)

    def pi(word: int) -> int:
        return k.load_pi(word, pv[word])

    # -- transaction arithmetic (mirrors the transfer kernel) ---------------
    success = pi(CB_SUCCESS)
    k.assert0(k.mul(success, k.sub(success, k.const(1))))  # boolean
    value = pi(CB_VALUE)
    fee = pi(CB_FEE)
    tip = pi(CB_TIP)
    eff = k.mul(success, value)  # a reverted frame keeps its value
    s_bal = pi(CB_SENDER_BAL_PRE)
    k.assert0(k.lt(s_bal, eff))
    after = k.sub(s_bal, eff)
    k.assert0(k.lt(after, fee))
    k.assert0(k.lt(fee, tip))  # tip <= fee (the rest is burned)
    k.assert_eq(pi(CB_SENDER_BAL_POST), k.sub(after, fee))
    k.assert_eq(
        pi(CB_SENDER_NONCE_POST), k.add(pi(CB_SENDER_NONCE_PRE), k.const(1))
    )
    k.assert_eq(pi(CB_CALLEE_BAL_POST), k.add(pi(CB_CALLEE_BAL_PRE), eff))
    k.assert_eq(pi(CB_MINER_BAL_POST), k.add(pi(CB_MINER_BAL_PRE), tip))

    # -- storage-slot chain: SROOT_PRE -> ... -> SROOT_POST ------------------
    root_in = pi(CB_SROOT_PRE)
    root_out_final = pi(CB_SROOT_POST)
    if n_slots == 0:
        k.assert_eq(root_in, root_out_final)
    for i in range(n_slots):
        last = i == n_slots - 1
        root_out = (
            root_out_final
            if last
            else k.wit(lambda i=i: le_word(bw.slots[i].root_post))
        )
        em.slot_update(
            bw.slots[i] if bw is not None else None,
            root_in,
            root_out,
            CB_SLOTS + 2 * i,
            CB_SLOTS + 2 * i + 1,
            pi_words,
        )
        root_in = root_out

    # -- account chain: STATE_ROOT_PRE -> ... -> STATE_ROOT_POST -------------
    bindings = [
        PiBinding(
            bal_pre_pi=CB_SENDER_BAL_PRE, bal_post_pi=CB_SENDER_BAL_POST,
            nonce_pre_pi=CB_SENDER_NONCE_PRE, nonce_post_pi=CB_SENDER_NONCE_POST,
        ),
        PiBinding(
            bal_pre_pi=CB_CALLEE_BAL_PRE, bal_post_pi=CB_CALLEE_BAL_POST,
            sroot_pre_pi=CB_SROOT_PRE, sroot_post_pi=CB_SROOT_POST,
        ),
        PiBinding(bal_pre_pi=CB_MINER_BAL_PRE, bal_post_pi=CB_MINER_BAL_POST),
    ]
    root_in = pi(CB_STATE_ROOT_PRE)
    root_out_final = pi(CB_STATE_ROOT_POST)
    for u, pib in enumerate(bindings):
        last = u == 2
        root_out = (
            root_out_final
            if last
            else k.wit(lambda u=u: le_word(bw.accounts[u].root_post))
        )
        em.update(
            bw.accounts[u] if bw is not None else None,
            root_in,
            root_out,
            pib,
            pi_words,
        )
        root_in = root_out
    k.finalize_ts()
    return k
