"""Recursion: the verifier machine, the wrap and the aggregation ladder.

Counterpart: ethproof_tpu/recursion/__init__.py:1. Ported: the circuit IR
(`circuit`), its compiling FieldOps (`ops_circuit`), the verifier machine
(`machine`), the verifier compiler (`verifier_circuit`), the wrap
(`wrap`), the tx roots (`root`), the aggregation ladder (`aggregate`), the
block wraps (`block`), the recursion state (`state`) and the circuits'
disk cache (`persist`).
"""

from .aggregate import AggLadder, combine_digests, expected_statement, fold_proofs, verify_fold
from .block import BlockWrapProof, BlockWraps, block_statement, build_block_wraps, \
    verify_block_chain
from .circuit import CBuilder, Circuit, Gate, interpret
from .machine import RecursionStark, generate_trace
from .root import DummyRootCircuit, TxRootCircuit, build_dummy_root, build_evm_root, \
    build_tx_root, build_withdrawal_root, dummy_seam, dummy_statement_digest, \
    leaf_statement, tx_seam, tx_statement_digest
from .state import OVERLAP_VARIANTS, RecursionState, recursion_state
from .verifier_circuit import CompiledVerifier, compile_stark_verifier
from .wrap import MachineProof, WrapCircuit, build_wrap, machine_degree, prove_circuit, verify_machine
