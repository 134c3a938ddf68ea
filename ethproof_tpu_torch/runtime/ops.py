"""Proving operations: TxProof -> AggProof -> BlockProof algebra.

Counterpart: ethproof_tpu/runtime/ops.py:1 (`FatalError`, `DummyProof`,
`AggProof`, `GeneratedBlockProof`, `public_data`, `_callee_has_code`,
`tx_proof`, `agg_combine`, `block_proof`, `verify_dummy`,
`verify_aggregatable`, `verify_block`), with `device` threaded through the
provers and verifiers. The recursion ladder is not ported (the port has
its core, `recursion/`: the verifier machine and the wrap): a `recursion`
state raises NotImplementedError in `tx_proof`, as does a succinct block
in `verify_block`; dummies stay in the host-checked tier.

The aggregation is a binary tree over ADJACENT payloads; continuity of
(txn number, gas, state root) across the seam is what `agg_combine`
checks. Padding dummies (signed_txn=None) become `DummyProof`s — their
no-op claim (or withdrawal credit) is host-checked against the witness
tries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

from .. import resolve_device
from ..evm.binding import Unsupported
from ..evm.contract import EMPTY_CODE_HASH, ContractCallProof, prove_contract_call, \
    verify_contract_call
from ..evm.transfer import TxProof, _acct_key, prove_transfer, verify_transfer
from ..evm.tx import decode_tx
from ..fri.config import StarkConfig
from ..hash.keccak import keccak256
from ..tables.all import TableSizes
from ..trie.nibbles import Nibbles
from ..witness.mpt import decode_account, encode_account
from ..witness.types import GenerationInputs


class FatalError(Exception):
    """Deterministic failure — do not retry."""


@dataclass
class DummyProof:
    """A padding transaction's no-op (or withdrawal-credit) claim,
    host-checked by `verify_dummy`."""

    gen_inputs: GenerationInputs


@dataclass
class AggProof:
    left: "AggregatableProof"
    right: "AggregatableProof"
    txn_number_before: int
    txn_number_after: int
    gas_used_before: int
    gas_used_after: int
    state_root_before: bytes
    state_root_after: bytes


AggregatableProof = Union[TxProof, ContractCallProof, DummyProof, AggProof]


@dataclass
class GeneratedBlockProof:
    block_number: int
    state_root_before: bytes
    state_root_after: bytes
    agg: AggProof
    parent: Optional["GeneratedBlockProof"] = None
    succinct: Optional[object] = None  # recursion's block proof (not ported)


def public_data(p: AggregatableProof) -> Tuple[int, int, int, int, bytes, bytes]:
    """(txn_before, txn_after, gas_before, gas_after, root_before, root_after)."""
    if isinstance(p, AggProof):
        return (
            p.txn_number_before,
            p.txn_number_after,
            p.gas_used_before,
            p.gas_used_after,
            p.state_root_before,
            p.state_root_after,
        )
    gi = p.gen_inputs
    is_tx = gi.signed_txn is not None
    return (
        gi.txn_number_before,
        gi.txn_number_before + (1 if is_tx else 0),
        gi.gas_used_before,
        gi.gas_used_after,
        gi.tries.state_trie.hash(),
        gi.trie_roots_after.state_root,
    )


def _callee_has_code(gi: GenerationInputs) -> bool:
    """Dispatch: a tx to an account with code runs on the EVM machine
    (evm/contract.py); otherwise it is a value transfer."""
    try:
        tx = decode_tx(gi.signed_txn)
        if len(tx.to) != 20:
            return False
        raw = gi.tries.state_trie.get(_acct_key(tx.to))
        return raw is not None and decode_account(raw)["code_hash"] != EMPTY_CODE_HASH
    except Exception:
        return False


def tx_proof(
    gi: GenerationInputs,
    config: StarkConfig,
    sizes: "Optional[TableSizes | object]" = None,  # TableSizes | CircuitConfig
    recursion: Optional[object] = None,
    device=None,
    phase_times: Optional[dict] = None,
) -> AggregatableProof:
    """One transaction's proof on `device` (None: the CUDA card): a
    contract call (`prove_contract_call`, binding "auto") when the callee
    has code, else a transfer (`prove_transfer`, binding "auto"); a
    padding dummy's claim is host-checked. `phase_times` goes to the
    prover it dispatches to."""
    if recursion is not None:
        raise NotImplementedError("the recursion ladder (tx roots) is not ported")
    resolve_device(device)
    label = "0x" + keccak256(gi.signed_txn).hex()[:16] if gi.signed_txn else "Dummy"
    if gi.signed_txn is None:
        return DummyProof(gen_inputs=gi)
    try:
        if _callee_has_code(gi):
            # contract call: the EVM machine is the kernel
            tsz = sizes if isinstance(sizes, TableSizes) else None
            return prove_contract_call(gi, config, sizes=tsz, binding="auto",
                                       device=device, phase_times=phase_times)
        return prove_transfer(gi, config, sizes, binding="auto", device=device,
                              phase_times=phase_times)
    except (AssertionError, NotImplementedError, ValueError) as e:
        raise FatalError(f"txn proof failed for {label}: {e}") from e
    except Unsupported as e:
        # binding was REQUIRED but the witness is outside the envelope
        raise FatalError(f"binding unsupported for {label}: {e}") from e


def agg_combine(a: AggregatableProof, b: AggregatableProof) -> AggProof:
    """The Monoid combine; `empty` is deliberately absent — padding
    guarantees >= 2 leaves."""
    (tb0, ta0, gb0, ga0, rb0, ra0) = public_data(a)
    (tb1, ta1, gb1, ga1, rb1, ra1) = public_data(b)
    if ta0 != tb1 or ga0 != gb1 or ra0 != rb1:
        raise FatalError("aggregation seam mismatch (txn/gas/root chain)")
    return AggProof(
        left=a,
        right=b,
        txn_number_before=tb0,
        txn_number_after=ta1,
        gas_used_before=gb0,
        gas_used_after=ga1,
        state_root_before=rb0,
        state_root_after=ra1,
    )


def block_proof(agg: AggProof, prev: Optional[GeneratedBlockProof] = None) -> GeneratedBlockProof:
    gi = _leftmost_inputs(agg)
    if prev is not None and prev.state_root_after != agg.state_root_before:
        raise FatalError("parent block proof does not chain")
    return GeneratedBlockProof(
        block_number=gi.block_metadata.block_number,
        state_root_before=agg.state_root_before,
        state_root_after=agg.state_root_after,
        agg=agg,
        parent=prev,
    )


def _leftmost_inputs(p: AggregatableProof) -> GenerationInputs:
    while isinstance(p, AggProof):
        p = p.left
    return p.gen_inputs


# -- verification ------------------------------------------------------------


def verify_dummy(p: DummyProof) -> bool:
    gi = p.gen_inputs
    if gi.signed_txn is not None:
        return False
    if gi.gas_used_before != gi.gas_used_after:
        return False
    state = gi.tries.state_trie
    if not gi.withdrawals:
        return state.hash() == gi.trie_roots_after.state_root
    # withdrawal dummy: credit balances, then roots must match
    st = state.copy()
    for addr, amt in gi.withdrawals:
        key = Nibbles.from_bytes(keccak256(addr))
        raw = st.get(key)
        if raw is None:
            return False
        acc = decode_account(raw)
        acc["balance"] += amt
        st.insert(key, encode_account(acc))
    return st.hash() == gi.trie_roots_after.state_root


def verify_aggregatable(p: AggregatableProof, config: StarkConfig, device=None) -> bool:
    if isinstance(p, AggProof):
        (tb0, ta0, gb0, ga0, rb0, ra0) = public_data(p.left)
        (tb1, ta1, gb1, ga1, rb1, ra1) = public_data(p.right)
        if ta0 != tb1 or ga0 != gb1 or ra0 != rb1:
            return False
        if (tb0, ta1, gb0, ga1, rb0, ra1) != (
            p.txn_number_before,
            p.txn_number_after,
            p.gas_used_before,
            p.gas_used_after,
            p.state_root_before,
            p.state_root_after,
        ):
            return False
        return verify_aggregatable(p.left, config, device) and verify_aggregatable(
            p.right, config, device)
    if isinstance(p, DummyProof):
        return verify_dummy(p)
    if isinstance(p, ContractCallProof):
        return verify_contract_call(p, config, device)
    return verify_transfer(p, config, device)


def verify_block(bp: GeneratedBlockProof, config: StarkConfig,
                 recursion: Optional[object] = None, device=None) -> bool:
    """Every leaf's proof and host binding, the seams, and the parent
    chain. A succinct block proof (recursion) is not ported."""
    if bp.succinct is not None and recursion is not None:
        raise NotImplementedError("succinct block proofs (the recursion ladder) are not ported")
    if not verify_aggregatable(bp.agg, config, device):
        return False
    if bp.state_root_before != bp.agg.state_root_before:
        return False
    if bp.state_root_after != bp.agg.state_root_after:
        return False
    if bp.parent is not None:
        if not verify_block(bp.parent, config, recursion, device):
            return False
        if bp.parent.state_root_after != bp.state_root_before:
            return False
    return True
