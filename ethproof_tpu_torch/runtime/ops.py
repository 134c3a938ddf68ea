"""Proving operations: TxProof -> AggProof -> BlockProof algebra.

Counterpart: ethproof_tpu/runtime/ops.py:1 (`FatalError`, `DummyProof`,
`AggProof`, `SuccinctBlockProof`, `GeneratedBlockProof`, `public_data`,
`_callee_has_code`, `tx_proof` with its recursion branches,
`_prove_withdrawal_dummy`, `agg_combine`, `block_proof`, `verify_dummy`,
`verify_aggregatable`, `_real_txs`, `_leaves`, `verify_block` with its
succinct branch), with `device` threaded through the provers and
verifiers (None: the CUDA card; every entry point raises without one
unless the caller names the CPU).

The aggregation is a binary tree over ADJACENT payloads; continuity of
(txn number, gas, state root) across the seam is what `agg_combine`
checks. Padding dummies (signed_txn=None) become `DummyProof`s — their
no-op claim (or withdrawal credit) is host-checked against the witness
tries, or, under recursion, machine-proved and folded into the ladder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from .. import resolve_device
from ..evm.binding import Unsupported
from ..evm.contract import EMPTY_CODE_HASH, ContractCallProof, check_contract_binding, \
    prove_contract_call, verify_contract_call
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
    gen_inputs: GenerationInputs
    # under recursion the dummy's no-op (or withdrawal-credit) claim is
    # MACHINE-PROVED and joins the ladder fold (reference
    # padding_and_withdrawals.rs:147-178 runs dummies through the
    # proved kernel); None = host-checked tier (verify_dummy)
    root_proof: Optional[object] = None  # recursion.wrap.MachineProof


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
class SuccinctBlockProof:
    """One machine proof covering EVERY transaction's STARK verification
    (reference proof_gen constant-size block proofs, ops/src/lib.rs:95).

    top: the aggregation ladder's top machine proof; its 4-element public
    digest equals the balanced fold (with repeat-padding) of the per-tx
    statement digests, which verify_block re-derives host-side from the
    witness. Verification cost: one STARK verify + O(#tx) host hashing,
    independent of table sizes.

    sizes/binding_shape identify the leaf circuits (the verifier rebuilds
    the recursion ladder's vkeys from them — the reference's
    prover-state circuit digest, common/src/prover_state/mod.rs).

    block_wrap (optional): a recursion.block wrap proof chaining this
    block to its parent IN-CIRCUIT (reference block circuit,
    ops/src/lib.rs:84-101); verify_block then checks the whole chain
    through ONE machine proof instead of per-block host equalities."""

    top: object  # recursion.wrap.MachineProof
    level: int
    sizes: Optional[TableSizes] = None
    binding_shape: Optional[object] = None  # evm.binding.KernelShape
    # contract-call leaf variants (ordered; rebuilds the same ladder)
    evm_shapes: Optional[list] = None
    # in-circuit parent chaining (recursion.block.BlockWrapProof)
    block_wrap: Optional[object] = None
    # withdrawal-dummy leaf variants (credit counts, ordered)
    wd_counts: Optional[list] = None


@dataclass
class GeneratedBlockProof:
    block_number: int
    state_root_before: bytes
    state_root_after: bytes
    agg: AggProof
    parent: Optional["GeneratedBlockProof"] = None
    succinct: Optional[SuccinctBlockProof] = None


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
    recursion: Optional[object] = None,  # recursion.state.RecursionState
    device=None,
    phase_times: Optional[dict] = None,
) -> AggregatableProof:
    """One transaction's proof on `device` (None: the CUDA card): a
    contract call (`prove_contract_call`) when the callee has code, else a
    transfer (`prove_transfer`); a padding dummy's claim is host-checked.
    Without `recursion` the binding mode is "auto". With a recursion state,
    the binding follows the state (its `binding_shape` for a transfer, the
    host-checked tier for a contract call), the multi-proof is replaced by
    its tx root machine proof (`root_proof`), and a dummy's claim is
    machine-proved (the no-op leaf, or the withdrawal kernel and its root
    when the state has a binding shape and the witness fits it), every root
    proof at the state's common leaf degree (`root_log_n`, which builds the
    state's root circuits on first use). `phase_times` goes to the prover
    it dispatches to; a root proof's times go to its "root" entry."""
    resolve_device(device)
    label = "0x" + keccak256(gi.signed_txn).hex()[:16] if gi.signed_txn else "Dummy"
    root_times = None
    if recursion is not None:
        # every leaf is proved at the ladder's common degree: fix it (and
        # build every registered variant's root) before the first root
        # proof; the counterpart proves a leaf made before that at its own
        # circuit's degree, which the agg circuit then cannot verify
        # (ROADMAP Queue 3)
        _ = recursion.root_log_n
        if phase_times is not None:
            root_times = phase_times.setdefault("root", {})
    if gi.signed_txn is None:
        dp = DummyProof(gen_inputs=gi)
        if recursion is not None:
            from ..evm.withdrawal import wd_dummy_provable
            from ..recursion.root import dummy_seam

            try:
                if not gi.withdrawals:
                    root = recursion.dummy_root()
                    mp = root.prove(dummy_seam(gi), config, device, root_times)
                    mp.variant = recursion.variant_of_dummy()
                    dp.root_proof = mp
                elif recursion.binding_shape is not None and (
                    wd_dummy_provable(gi, recursion.binding_shape)
                ):
                    dp.root_proof = _prove_withdrawal_dummy(
                        gi, config, recursion, device, root_times
                    )
                # withdrawals outside the kernel envelope (or with
                # no binding shape) stay in the host-checked tier
                # (excluded from the fold; verify_dummy covers them)
            except (AssertionError, ValueError) as e:
                raise FatalError(f"dummy proof failed: {e}") from e
        return dp
    try:
        if _callee_has_code(gi):
            # contract call: the EVM machine is the kernel
            tsz = sizes if isinstance(sizes, TableSizes) else None
            if recursion is not None:
                # the evm root circuit fixes the table sizes; the
                # state-binding proof is not yet folded into the
                # succinct ladder, so succinct mode uses the host-checked
                # binding tier
                tsz = recursion.sizes
            cc_binding = None if recursion is not None else "auto"
            proof = prove_contract_call(gi, config, sizes=tsz, binding=cc_binding,
                                        device=device, phase_times=phase_times)
            if recursion is not None:
                from ..recursion.root import tx_seam

                root = recursion.evm_root(proof.shape)
                mp = root.prove(proof.multi, tx_seam(gi), config, device, root_times)
                mp.variant = recursion.variant_of_evm(proof.shape)
                proof.root_proof = mp
                proof.multi = None
            return proof
        # under recursion the kernel program must match the cached
        # root circuits, so the binding mode follows the state
        binding = recursion.binding_shape if recursion is not None else "auto"
        proof = prove_transfer(gi, config, sizes, binding=binding, device=device,
                               phase_times=phase_times)
        if recursion is not None:
            from ..recursion.root import tx_seam

            root = recursion.root(proof.overlap)
            mp = root.prove(proof.multi, tx_seam(gi), config, device, root_times)
            mp.variant = recursion.variant_of(proof.overlap)
            proof.root_proof = mp
            proof.multi = None  # the machine proof subsumes it
        return proof
    except (AssertionError, NotImplementedError, ValueError) as e:
        raise FatalError(f"txn proof failed for {label}: {e}") from e
    except Unsupported as e:
        # binding was REQUIRED but the witness is outside the envelope
        raise FatalError(f"binding unsupported for {label}: {e}") from e


def _prove_withdrawal_dummy(
    gi: GenerationInputs, config: StarkConfig, recursion, device=None,
    phase_times: Optional[dict] = None,
):
    """Prove the withdrawal-credit kernel + its root wrap for a
    withdrawal-carrying dummy (evm/withdrawal.py), on `device`."""
    from ..evm.withdrawal import (
        build_withdrawal_kernel,
        build_withdrawal_witness,
        expected_wd_pi,
        wd_num_pi_words,
    )
    from ..recursion.root import dummy_seam
    from ..tables.all import prove_all_tables
    from ..tables.cpu import CpuStark

    n = len(gi.withdrawals)
    pi = expected_wd_pi(gi)
    bw = build_withdrawal_witness(gi, pi, recursion.binding_shape)
    kasm = build_withdrawal_kernel(n, recursion.binding_shape, pi, bw)
    cpu = CpuStark(kasm.prog, wd_num_pi_words(n))
    multi, _ = prove_all_tables(
        cpu, pi, recursion.sizes, config,
        hash_requests=kasm.hash_requests(), kernel_witness=kasm.witness,
        device=device,
    )
    root = recursion.wd_roots[n]
    mp = root.prove(multi, dummy_seam(gi), config, device, phase_times)
    mp.variant = recursion.variant_of_wd(n)
    return mp


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


def verify_aggregatable(
    p: AggregatableProof, config: StarkConfig, device=None, skip_stark: bool = False
) -> bool:
    """Every leaf's proof and host binding, and the seams. skip_stark=True
    leaves each leaf's STARK to a succinct block proof (`verify_block`)."""
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
        return verify_aggregatable(p.left, config, device, skip_stark) and verify_aggregatable(
            p.right, config, device, skip_stark)
    if isinstance(p, DummyProof):
        return verify_dummy(p)
    if isinstance(p, ContractCallProof):
        if not skip_stark:
            return verify_contract_call(p, config, device)
        # succinct tier: the ladder covers the OUTER frame's statement;
        # inner call frames are not yet folded in, so their machine
        # STARKs verify directly here
        from ..tables import all as A
        from ..tables import evm as E

        for ip in p.inner_frames or []:
            if ip.multi is None:
                return False
            if not A.verify_evm_tables(
                E.EvmStark(ip.shape), ip.machine_pi, ip.multi, config, device
            ):
                return False
        return check_contract_binding(p)
    return verify_transfer(p, config, device, skip_stark=skip_stark)


def _real_txs(p: AggregatableProof) -> List:
    """Order-preserving real-transaction leaves of the agg tree
    (transfer TxProofs and ContractCallProofs alike)."""
    if isinstance(p, AggProof):
        return _real_txs(p.left) + _real_txs(p.right)
    return [p] if isinstance(p, (TxProof, ContractCallProof)) else []


def _leaves(p: AggregatableProof) -> List:
    """ALL leaves (real txs AND dummies) in order."""
    if isinstance(p, AggProof):
        return _leaves(p.left) + _leaves(p.right)
    return [p]


def _block_parts(node: GeneratedBlockProof, recursion) -> List[Tuple[List[int], List[int]]]:
    """(seam, digest) per FOLDED leaf, witness-re-derived. Fold
    membership is deterministic: real txs always; no-op dummies always;
    withdrawal dummies iff a binding shape is set (the host-checked tier
    is excluded, matching the prover)."""
    from ..evm.withdrawal import expected_wd_pi, wd_dummy_provable
    from ..recursion.root import dummy_seam, dummy_statement_digest, tx_seam, \
        tx_statement_digest
    from ..tables.cpu import pi_limbs

    parts = []
    for leaf in _leaves(node.agg):
        gl = leaf.gen_inputs
        if gl.signed_txn is not None:
            parts.append((tx_seam(gl), tx_statement_digest(pi_limbs(leaf.pi_words))))
        elif not gl.withdrawals:
            parts.append((dummy_seam(gl), dummy_statement_digest()))
        elif recursion.binding_shape is not None:
            if not wd_dummy_provable(gl, recursion.binding_shape):
                continue  # host-checked tier, not folded
            parts.append((dummy_seam(gl), tx_statement_digest(pi_limbs(expected_wd_pi(gl)))))
    return parts


def verify_block(bp: GeneratedBlockProof, config: StarkConfig,
                 recursion: Optional[object] = None, device=None) -> bool:
    """Every leaf's host binding, the seams, and the parent chain; each
    leaf's STARK on `device` (None: the CUDA card). With a succinct proof
    and a recursion state, the per-leaf STARK checks are replaced by ONE
    machine verification (on the state's device) against the
    host-recomputed statement-digest tree (cost independent of tx count /
    table sizes); a block wrap, when present, is checked over the whole
    chain the same way."""
    resolve_device(device)
    succinct = bp.succinct is not None and recursion is not None
    if not verify_aggregatable(bp.agg, config, device, skip_stark=succinct):
        return False
    if succinct:
        from ..recursion.aggregate import verify_fold

        parts = _block_parts(bp, recursion)
        if not parts:
            return False  # a succinct proof with no folded leaves is malformed
        # per-leaf (seam, digest) re-derived from the WITNESS; the proved
        # top statement must hash-match their in-circuit-chained fold
        if not verify_fold(
            recursion.ladder, bp.succinct.top, bp.succinct.level, parts, config,
        ):
            return False
        if bp.succinct.block_wrap is not None:
            # in-circuit parent chain: one wrap machine proof covers the
            # whole block chain (reference block circuit parity)
            from ..recursion.block import build_block_wraps, verify_block_chain

            chain = []
            node = bp
            while node is not None:
                pn = _block_parts(node, recursion)
                if not pn:
                    return False
                chain.append(pn)
                node = node.parent
            chain.reverse()
            wraps = build_block_wraps(recursion.ladder, bp.succinct.level, config)
            if not verify_block_chain(wraps, bp.succinct.block_wrap, chain, config):
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
