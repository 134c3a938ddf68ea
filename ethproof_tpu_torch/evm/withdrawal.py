"""Withdrawal-credit kernel: in-circuit proving of the padding dummies.

Counterpart: ethproof_tpu/evm/withdrawal.py:1 (a copy, on the port's
`evm/binding.py` and `evm/kasm.py`).

Reference equivalent: dummy payloads (and the final payload's attached
withdrawals) run through the PROVED kernel like any transaction —
`create_dummy_gen_input` builds a no-op GenerationInputs and
`add_withdrawals_to_txns` credits balances inside the final proof's
trie state (leader/src/padding_and_withdrawals.rs:
38-134, 147-178). Without this module those claims are
ONLY host checks (runtime/ops.verify_dummy). This module closes the
withdrawal half:

  PI layout: [ROOT_PRE, ROOT_POST] ++ per withdrawal
             (BAL_PRE, BAL_POST, AMOUNT)
  kernel:    assert BAL_POST_i == BAL_PRE_i + AMOUNT_i, then chain the
             account updates ROOT_PRE -> ... -> ROOT_POST through the
             same MPT update emitter as the transfer/contract bindings
             (evm/binding.py BindingEmitter.update; nonce/code
             preserved, balance rebound to the PI words).

Address identity (path == keccak(address)) stays host-anchored, the
same documented tier as every binding kernel. The no-withdrawal dummy
needs no kernel at all — its leaf circuit constrains root_pre ==
root_post directly (recursion/root.build_dummy_root).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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
    build_update_witness,
    region_words_needed,
)
from .kasm import KAsm, le_word

WD_ROOT_PRE = 0
WD_ROOT_POST = 1
WD_PER = 3  # (BAL_PRE, BAL_POST, AMOUNT) per withdrawal


def wd_num_pi_words(n: int) -> int:
    return 2 + WD_PER * n


def _acct_key(addr: bytes) -> Nibbles:
    return Nibbles.from_bytes(keccak256(addr))


@dataclass
class WithdrawalWitness:
    accounts: List[UpdateWitness]


def expected_wd_pi(gi: GenerationInputs) -> List[int]:
    """Re-derive the kernel's PI words from the witness (the verifier's
    cross-check): balances read from the pre-state trie, credits applied
    sequentially in withdrawal order."""
    state = gi.tries.state_trie.copy()
    pi = [0] * wd_num_pi_words(len(gi.withdrawals))
    pi[WD_ROOT_PRE] = le_word(state.hash())
    pi[WD_ROOT_POST] = le_word(gi.trie_roots_after.state_root)
    from ..witness.mpt import encode_account

    for i, (addr, amt) in enumerate(gi.withdrawals):
        raw = state.get(_acct_key(addr))
        if raw is None:
            raise Unsupported("withdrawal target missing pre-state")
        acc = decode_account(raw)
        pi[2 + WD_PER * i] = acc["balance"]
        pi[2 + WD_PER * i + 1] = acc["balance"] + amt
        pi[2 + WD_PER * i + 2] = amt
        acc["balance"] += amt
        state.insert(_acct_key(addr), encode_account(acc))
    if state.hash() != gi.trie_roots_after.state_root:
        raise Unsupported("withdrawal credits do not reach the post root")
    return pi


def build_withdrawal_witness(
    gi: GenerationInputs, pi: List[int], kshape: KernelShape
) -> WithdrawalWitness:
    accounts: List[UpdateWitness] = []
    trie = gi.tries.state_trie
    for i, (addr, _amt) in enumerate(gi.withdrawals):
        raw = trie.get(_acct_key(addr))
        if raw is None:
            raise Unsupported("withdrawal target missing pre-state")
        nonce = decode_account(raw)["nonce"]
        uw, trie = build_update_witness(
            trie, _acct_key(addr), nonce, pi[2 + WD_PER * i + 1], kshape
        )
        accounts.append(uw)
    return WithdrawalWitness(accounts=accounts)


def wd_dummy_provable(gi: GenerationInputs, kshape: KernelShape) -> bool:
    """Whether this withdrawal dummy fits the in-circuit envelope.
    Prover, verifier, pre-scan and size-fit all branch on THIS predicate
    so fold membership stays deterministic; False -> the host-checked
    tier (runtime/ops.verify_dummy), excluded from the ladder."""
    try:
        pi = expected_wd_pi(gi)
        build_withdrawal_witness(gi, pi, kshape)
        return True
    except Exception:
        return False


def build_withdrawal_kernel(
    n: int,
    kshape: KernelShape,
    pi_words: Optional[List[int]] = None,
    bw: Optional[WithdrawalWitness] = None,
) -> KAsm:
    """The withdrawal kernel program — a pure function of (n, kshape),
    the statement identity the verifier rebuilds."""
    assert n >= 1, "the no-withdrawal dummy has no kernel"
    rw = region_words_needed(kshape, n)
    k = KAsm(concrete=pi_words is not None, region_words=rw)
    em = BindingEmitter(k, kshape)
    pv = pi_words if pi_words is not None else [None] * wd_num_pi_words(n)

    def pi(word: int) -> int:
        return k.load_pi(word, pv[word])

    for i in range(n):
        bal_pre = pi(2 + WD_PER * i)
        bal_post = pi(2 + WD_PER * i + 1)
        amt = pi(2 + WD_PER * i + 2)
        k.assert_eq(bal_post, k.add(bal_pre, amt))
    root_in = pi(WD_ROOT_PRE)
    root_out_final = pi(WD_ROOT_POST)
    for i in range(n):
        last = i == n - 1
        root_out = (
            root_out_final
            if last
            else k.wit(lambda i=i: le_word(bw.accounts[i].root_post))
        )
        em.update(
            bw.accounts[i] if bw is not None else None,
            root_in,
            root_out,
            PiBinding(
                bal_pre_pi=2 + WD_PER * i, bal_post_pi=2 + WD_PER * i + 1
            ),
            pi_words,
        )
        root_in = root_out
    k.finalize_ts()
    return k
